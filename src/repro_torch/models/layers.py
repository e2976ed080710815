"""Shared neural-net building blocks, after the JAX package's
`repro.models.layers`: functions on tensors, parameters in plain dicts
laid out as the JAX package's trees, weights as (d_in, d_out).

Dtype policy, as there: parameters are made in `param_dtype`; products
take their operands in `compute_dtype` and return float32 (`matmul`);
norms, RoPE and softmax work in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int8": torch.int8}


def dt(name: str) -> torch.dtype:
    return _DTYPES[name]


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               device, scale: float | None = None) -> torch.Tensor:
    """(d_in, d_out) normal weights times `scale` (1/sqrt(d_in) by default),
    drawn in float32 on `device` and cast to `dtype`."""
    scale = scale if scale is not None else (1.0 / d_in) ** 0.5
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device)
    return w.mul_(scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype, device
               ) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=device)
    return w.mul_(0.02).to(dtype)


def matmul(x: torch.Tensor, w: torch.Tensor, compute_dtype) -> torch.Tensor:
    """x (..., d_in) @ w (d_in, d_out) with both operands in
    `compute_dtype` and a float32 result (the JAX package's
    `preferred_element_type=float32`): no rounding to `compute_dtype`
    between the product and what follows it.

    On CUDA a 16-bit product is one cuBLAS call with a float32 output;
    elsewhere the operands are widened to float32 after the cast, which
    gives the same exact products summed in float32."""
    a = x.to(compute_dtype).reshape(-1, x.shape[-1])
    b = w.to(compute_dtype)
    if a.is_cuda and compute_dtype != torch.float32:
        out = torch.mm(a, b, out_dtype=torch.float32)
    else:
        out = torch.mm(a.float(), b.float())
    return out.reshape(*x.shape[:-1], w.shape[-1])


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def mlp_init(gen: torch.Generator, d: int, d_ff: int, dtype, device) -> dict:
    return {
        "w_gate": dense_init(gen, d, d_ff, dtype, device),
        "w_up": dense_init(gen, d, d_ff, dtype, device),
        "w_down": dense_init(gen, d_ff, d, dtype, device),
    }


def mlp_apply(params: dict, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    g = matmul(x, params["w_gate"], compute_dtype)
    u = matmul(x, params["w_up"], compute_dtype)
    h = (F.silu(g) * u).to(compute_dtype)
    return matmul(h, params["w_down"], compute_dtype).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    # a Python-number base: no host-to-device copy, which would block the
    # host until the device's queue drains, twice per layer and step
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (B, H, S, Dh) (Dh even), positions: (S,) or (B, S).  Rotates the
    two halves of Dh (not interleaved pairs), angles in float32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (dh/2,)
    pos = positions.to(torch.float32)
    if positions.ndim == 1:
        angles = (pos[:, None] * freqs[None, :])[None, None]  # (1,1,S,dh/2)
    else:
        angles = pos[:, None, :, None] * freqs  # (B,1,S,dh/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
