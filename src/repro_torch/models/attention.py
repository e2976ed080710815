"""Attention mixers, after the JAX package's `repro.models.attention`: the
GQA half (multi-head attention with grouped KV heads).

Two paths:
  * batch path (prefill): full-sequence causal attention through the
    dispatcher `repro_torch.kernels.flash_attention.ops.attention` (the
    flash kernel on CUDA, its chunked plain version on the CPU);
  * decode path: one new token against a cache of K/V (optionally int8
    with a per-token-head scale), plain tensor code.  The cache is
    updated in place.

DeepSeek-style MLA waits for the MLA slice.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.models.layers import apply_rope, dense_init, dt, matmul

# ---------------------------------------------------------------------------
# KV cache quantisation
# ---------------------------------------------------------------------------


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., dh) -> int8 values + float32 scale over the last dim (round
    half to even, as jnp.round)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype
                  ) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


def gqa_init(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    d, h, hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    dh = cfg.resolved_head_dim
    pdt = dt(cfg.precision.param_dtype)
    p = {
        "wq": dense_init(gen, d, h * dh, pdt, device),
        "wk": dense_init(gen, d, hkv * dh, pdt, device),
        "wv": dense_init(gen, d, hkv * dh, pdt, device),
        "wo": dense_init(gen, h * dh, d, pdt, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h * dh,), dtype=pdt, device=device)
        p["bk"] = torch.zeros((hkv * dh,), dtype=pdt, device=device)
        p["bv"] = torch.zeros((hkv * dh,), dtype=pdt, device=device)
    return p


def _project_qkv(cfg: ModelConfig, params: dict, x: torch.Tensor):
    """x (B, S, D) -> contiguous q (B, H, S, dh), k, v (B, Hkv, S, dh) in
    the compute dtype; the bias is added in float32 before the cast."""
    cdt = dt(cfg.precision.compute_dtype)
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    out = []
    for w, bias, heads in (("wq", "bq", h), ("wk", "bk", hkv),
                           ("wv", "bv", hkv)):
        y = matmul(x, params[w], cdt)
        if cfg.qkv_bias:
            y = y + params[bias].float()
        out.append(y.reshape(b, s, heads, dh).transpose(1, 2)
                   .to(cdt).contiguous())
    return tuple(out)


def gqa_batch(cfg: ModelConfig, params: dict, x: torch.Tensor,
              positions: torch.Tensor, *, causal: bool = True,
              impl: str | None = None):
    """Prefill path.  x: (B, S, D).  Returns (out, (k, v)) with k, v the
    post-RoPE keys and values (B, Hkv, S, dh) for the cache."""
    cdt = dt(cfg.precision.compute_dtype)
    b, s, _ = x.shape
    q, k, v = _project_qkv(cfg, params, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = attn_ops.attention(q, k, v, causal=causal, impl=impl)
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.resolved_head_dim)
    out = matmul(o, params["wo"], cdt).to(x.dtype)
    return out, (k, v)


def gqa_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                   quantized: bool, device) -> dict:
    hkv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    cdt = dt(cfg.precision.compute_dtype)
    shape = (batch, hkv, max_len, dh)
    if quantized:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:3] + (1,), dtype=torch.float32,
                                   device=device),
            "v_scale": torch.zeros(shape[:3] + (1,), dtype=torch.float32,
                                   device=device),
        }
    return {"k": torch.zeros(shape, dtype=cdt, device=device),
            "v": torch.zeros(shape, dtype=cdt, device=device)}


def write_cache(cache: dict, k: torch.Tensor, v: torch.Tensor,
                start: int) -> None:
    """Store k, v (B, Hkv, n, dh) at positions start .. start + n - 1 of
    the cache, quantised where the cache is int8."""
    end = start + k.shape[2]
    if "k_scale" in cache:
        for name, x in (("k", k), ("v", v)):
            q, scale = quantize_kv(x)
            cache[name][:, :, start:end] = q
            cache[f"{name}_scale"][:, :, start:end] = scale
    else:
        cache["k"][:, :, start:end] = k.to(cache["k"].dtype)
        cache["v"][:, :, start:end] = v.to(cache["v"].dtype)


def gqa_decode(cfg: ModelConfig, params: dict, x: torch.Tensor,
               cache: dict, pos: int) -> torch.Tensor:
    """One-token decode.  x: (B, 1, D); pos: the new token's position.
    Writes its K/V into `cache` at `pos` (in place) and returns out.

    Scores run over the whole cache, masked to positions <= pos; the
    products take the cache's stored dtype and sum in float32, and the
    probabilities are cast to the cache dtype before P.V."""
    cdt = dt(cfg.precision.compute_dtype)
    b = x.shape[0]
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, k_new, v_new = _project_qkv(cfg, params, x)  # (B, *, 1, dh)
    pos_arr = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, pos_arr, cfg.rope_theta)
    k_new = apply_rope(k_new, pos_arr, cfg.rope_theta)
    write_cache(cache, k_new, v_new, pos)
    if "k_scale" in cache:
        k_all = dequantize_kv(cache["k"], cache["k_scale"], cdt)
        v_all = dequantize_kv(cache["v"], cache["v_scale"], cdt)
    else:
        k_all, v_all = cache["k"], cache["v"]

    s_max = k_all.shape[2]
    qg = q.reshape(b, hkv, h // hkv, dh)  # (B, Hkv, G, dh)
    scores = torch.matmul(qg.to(k_all.dtype).float(),
                          k_all.float().transpose(-1, -2)) / (dh ** 0.5)
    mask = torch.arange(s_max, device=x.device) <= pos
    scores = torch.where(mask, scores, -1e30)
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    ctx = torch.matmul(probs.to(v_all.dtype).float(), v_all.float())
    ctx = ctx.reshape(b, 1, h * dh).to(cdt)
    return matmul(ctx, params["wo"], cdt).to(x.dtype)
