"""llama3-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256
[arXiv:2407.21783]."""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    head_dim=128,
    layer_pattern=(LayerSpec(mixer="attn", mlp="dense"),),
    rope_theta=500000.0,
)
