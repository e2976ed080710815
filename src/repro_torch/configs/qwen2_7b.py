"""qwen2-7b [dense]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064
— GQA, QKV bias [arXiv:2407.10671]."""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    head_dim=128,
    layer_pattern=(LayerSpec(mixer="attn", mlp="dense"),),
    rope_theta=1000000.0,
    qkv_bias=True,
)
