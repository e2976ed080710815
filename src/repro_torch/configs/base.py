"""Config system of the port: frozen dataclasses describing a model's
architecture and the serving knobs, after the JAX package's
`repro.configs.base` (the port imports nothing of it).

Each class keeps those of the reference's fields that the port reads,
under the same names and defaults; a later slice adds the fields its code
reads (MoE, MLA, Mamba, xLSTM, enc-dec, frontends, training, sharding), so
no knob here is set without effect.

Every architecture file in repro_torch/configs/<id>.py builds a ModelConfig
via these dataclasses; `repro_torch.configs.registry.get_config` finds it.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Literal

Mixer = Literal["attn", "mla", "mamba", "mlstm", "slstm"]
MlpKind = Literal["dense", "moe", "none"]


@dataclass(frozen=True)
class LayerSpec:
    mixer: Mixer = "attn"
    mlp: MlpKind = "dense"


@dataclass(frozen=True)
class Precision:
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    logits_dtype: str = "float32"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    layer_pattern: tuple[LayerSpec, ...] = (LayerSpec(),)
    first_k_dense: int = 0  # leading layers forced to dense MLP (dsv3)
    rope_theta: float = 10000.0
    qkv_bias: bool = False  # qwen2
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    kind: str = "decoder"  # decoder | encdec
    frontend: str | None = None  # vision | audio | None (stub embeddings)
    # paper-technique integration knobs
    hashed_embedding: bool = False  # CabinEmbed hashed vocab embedding
    hashed_embedding_buckets: int = 0
    hashed_embedding_k: int = 2
    precision: Precision = field(default_factory=Precision)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def layer_spec(self, i: int) -> LayerSpec:
        if i < self.first_k_dense:
            base = self.layer_pattern[i % len(self.layer_pattern)]
            return replace(base, mlp="dense")
        return self.layer_pattern[i % len(self.layer_pattern)]

    def all_layers(self) -> tuple[LayerSpec, ...]:
        return tuple(self.layer_spec(i) for i in range(self.n_layers))


@dataclass(frozen=True)
class ParallelConfig:
    """Serving knobs on one device."""

    kv_cache_dtype: str = "bfloat16"  # or int8
    # None = auto (the flash kernel on CUDA, the chunked plain version on
    # the CPU) | "kernel" (CUDA only) | "chunked" | "ref"; the JAX
    # package's values are None | "pallas" | "chunked" | "ref"
    attention_impl: str | None = None


def reduced_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests (per spec f)."""
    pattern_period = len(cfg.layer_pattern)
    n_layers = max(pattern_period, min(cfg.n_layers, 2 * pattern_period))
    return replace(
        cfg,
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=512,
        first_k_dense=min(cfg.first_k_dense, 1),
        precision=Precision(param_dtype="float32", compute_dtype="float32"),
    )
