"""Model assembly, after the JAX package's `repro.models.transformer`, for
decoder stacks whose layers are all attention + dense MLP (the dense GQA
family), with the dense or the hashed (CabinEmbed) vocabulary embedding.

Layers run in a plain Python loop; parameters are one dict per layer in
layer order (the JAX package stacks each stage's repeats for `lax.scan`;
`repro_torch.convert.lm_params_from_reference` unstacks them in the order
of `build_stages`).

Entry points:
  init_params(cfg, generator, device)   random weights, drawn on the device
  forward(...)      prefill logits
  prefill(...)      logits + caches filled with the prompt, in one pass
  init_caches(...)  empty decode caches
  decode_step(...)  one token against the caches (updated in place)
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig, ParallelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import hashed_embedding as hemb
from repro_torch.models.layers import (dense_init, dt, embed_init, matmul,
                                       mlp_apply, mlp_init, rmsnorm,
                                       rmsnorm_init)

# what each unported part of a ModelConfig waits for
_LATER = {
    "mla": "the MLA slice", "mamba": "the hybrid slice (Mamba)",
    "mlstm": "the xLSTM slice", "slstm": "the xLSTM slice",
    "moe": "the MoE slice", "none": "a later slice (layers without MLP)",
}


@dataclass(frozen=True)
class Stage:
    specs: tuple[LayerSpec, ...]
    n_repeat: int


def build_stages(cfg: ModelConfig) -> tuple[Stage, ...]:
    all_layers = cfg.all_layers()
    stages: list[Stage] = []
    i = cfg.first_k_dense
    if i:
        stages.append(Stage(all_layers[:i], 1))
    rest = all_layers[i:]
    p = len(cfg.layer_pattern)
    if rest:
        if len(rest) % p:
            # fall back to a single unrolled stage
            stages.append(Stage(tuple(rest), 1))
        else:
            stages.append(Stage(tuple(rest[:p]), len(rest) // p))
    return tuple(stages)


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError naming the slice that ports what `cfg`
    needs beyond attention + dense MLP decoder layers (either embedding)."""
    if cfg.kind != "decoder":
        raise NotImplementedError(f"{cfg.name}: kind {cfg.kind!r} waits for "
                                  "the enc-dec slice")
    if cfg.frontend is not None:
        raise NotImplementedError(f"{cfg.name}: the {cfg.frontend} frontend "
                                  "waits for the VLM / audio slice")
    for spec in cfg.all_layers():
        for part in (spec.mixer, spec.mlp):
            if part in _LATER:
                raise NotImplementedError(
                    f"{cfg.name}: {part!r} layers wait for {_LATER[part]}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _layer_init(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    pdt = dt(cfg.precision.param_dtype)
    return {"norm1": rmsnorm_init(cfg.d_model, pdt, device),
            "attn": attn.gqa_init(cfg, gen, device),
            "norm2": rmsnorm_init(cfg.d_model, pdt, device),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, pdt, device)}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> dict:
    """Random parameters with the JAX package's distributions (normal
    weights scaled by 1/sqrt(d_in), embeddings by 0.02, unit norms, zero
    biases), drawn tensor by tensor on `device` from `generator`, which
    must live on that device."""
    check_supported(cfg)
    device = resolve_device(device)
    pdt = dt(cfg.precision.param_dtype)
    if cfg.hashed_embedding:
        params = {"hashed_embed": hemb.hashed_embed_init(cfg, generator,
                                                         device)}
    else:
        params = {"embed": {"table": embed_init(generator, cfg.vocab_size,
                                                cfg.d_model, pdt, device)}}
    params["layers"] = [_layer_init(cfg, generator, device)
                        for _ in range(cfg.n_layers)]
    params["final_norm"] = rmsnorm_init(cfg.d_model, pdt, device)
    if not cfg.tie_embeddings and not cfg.hashed_embedding:
        params["lm_head"] = dense_init(generator, cfg.d_model,
                                       cfg.vocab_size, pdt, device)
    return params


def count_params(params: dict) -> int:
    def walk(x):
        if isinstance(x, torch.Tensor):
            return x.numel()
        items = x.values() if isinstance(x, dict) else x
        return sum(walk(v) for v in items)
    return walk(params)


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------


def embed_tokens(cfg: ModelConfig, params: dict, tokens: torch.Tensor
                 ) -> torch.Tensor:
    if cfg.hashed_embedding:
        return hemb.hashed_embed(cfg, params["hashed_embed"], tokens)
    return params["embed"]["table"][tokens.long()]


def lm_logits(cfg: ModelConfig, params: dict, x: torch.Tensor
              ) -> torch.Tensor:
    cdt = dt(cfg.precision.compute_dtype)
    if cfg.hashed_embedding:
        logits = hemb.hashed_logits(cfg, params["hashed_embed"], x)
    elif cfg.tie_embeddings:
        logits = matmul(x, params["embed"]["table"].t(), cdt)
    else:
        logits = matmul(x, params["lm_head"], cdt)
    return logits.to(dt(cfg.precision.logits_dtype))


# ---------------------------------------------------------------------------
# forward / prefill
# ---------------------------------------------------------------------------


def _mlp_block(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    h = rmsnorm(p["norm2"], x, cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h, dt(cfg.precision.compute_dtype))


def _run(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
         pcfg: ParallelConfig, caches: list | None) -> torch.Tensor:
    """The batch path over every layer; where `caches` is given, each
    layer's K/V is written into its cache from position 0."""
    check_supported(cfg)
    x = embed_tokens(cfg, params, tokens)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    for i, p in enumerate(params["layers"]):
        h = rmsnorm(p["norm1"], x, cfg.norm_eps)
        out, (k, v) = attn.gqa_batch(cfg, p["attn"], h, positions,
                                     impl=pcfg.attention_impl)
        if caches is not None:
            attn.write_cache(caches[i]["mixer"], k, v, 0)
        x = _mlp_block(cfg, p, x + out)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return lm_logits(cfg, params, x)


def forward(cfg: ModelConfig, params: dict, batch: dict,
            pcfg: ParallelConfig = ParallelConfig()):
    """batch: {'tokens': (B, S)}.  Returns (logits (B, S, V), aux loss 0)
    (the aux loss is the MoE router's, 0 for dense layers)."""
    logits = _run(cfg, params, batch["tokens"], pcfg, None)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                kv_dtype: str = "bfloat16", device="cuda") -> list:
    """One {'mixer': {'k', 'v'[, 'k_scale', 'v_scale']}} per layer; K/V in
    the compute dtype, or int8 with float32 scales for kv_dtype 'int8'."""
    device = resolve_device(device)
    quantized = kv_dtype == "int8"
    return [{"mixer": attn.gqa_init_cache(cfg, batch, max_len, quantized,
                                          device)}
            for _ in range(cfg.n_layers)]


def prefill(cfg: ModelConfig, params: dict, batch: dict, max_len: int,
            pcfg: ParallelConfig = ParallelConfig(),
            kv_dtype: str = "bfloat16"):
    """Logits of the prompt and caches holding its K/V, in one pass (the
    JAX package runs forward() and then replays every mixer to fill the
    caches; the logits and caches are the same)."""
    tokens = batch["tokens"]
    caches = init_caches(cfg, tokens.shape[0], max_len, kv_dtype,
                         tokens.device)
    return _run(cfg, params, tokens, pcfg, caches), caches


def decode_step(cfg: ModelConfig, params: dict, caches: list,
                tokens: torch.Tensor, pos: int):
    """tokens: (B, 1) int; pos: their position.  Returns (logits (B, 1, V),
    caches), the caches updated in place.  Attention over the cache is
    plain tensor code (`attention.gqa_decode`), as in the JAX package."""
    x = embed_tokens(cfg, params, tokens)
    for p, cache in zip(params["layers"], caches):
        h = rmsnorm(p["norm1"], x, cfg.norm_eps)
        x = x + attn.gqa_decode(cfg, p["attn"], h, cache["mixer"], pos)
        x = _mlp_block(cfg, p, x)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return lm_logits(cfg, params, x), caches
