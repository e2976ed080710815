"""Plain PyTorch versions of the flash attention kernel, after the JAX
package's `repro.kernels.flash_attention.ref.attention_ref` (materialised
softmax) and `ops.chunked_attention` (online softmax over KV blocks).

Shapes: q (B, Hq, S, Dh), k (B, Hkv, Skv, Dh), v (B, Hkv, Skv, Dh_v), Hq a
multiple of Hkv (query head h reads KV head h // (Hq / Hkv)).  Math in
float32, the causal mask fills with -1e30 and compares positions counted
from 0, the output has q's dtype."""

from __future__ import annotations

import torch

_NEG = -1e30

# The flash kernel's tolerance against these plain versions (and theirs
# against the JAX package's): float32 inputs agree to 1e-5 absolute on
# unit-scale data (float32 sums in another order); bfloat16 outputs, held
# in float32, to 2 bf16 ulps of each row's largest |value| (the output is
# rounded to bf16 once, after sums in another order, so both neighbours of
# a value near a rounding boundary are right).
F32_ATOL = 1e-5
BF16_ULPS = 2


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q (B,Hq,S,Dh), k (B,Hkv,Skv,Dh), v (B,Hkv,Skv,Dh_v) -> (B,Hq,S,Dh_v)."""
    s, dh = q.shape[2], q.shape[3]
    group = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    scores = torch.matmul(q.float(), kf.transpose(-1, -2)) / (dh ** 0.5)
    if causal:
        keep = (torch.arange(s, device=q.device)[:, None]
                >= torch.arange(k.shape[2], device=q.device)[None, :])
        scores = torch.where(keep, scores, _NEG)
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    return torch.matmul(probs, vf).to(q.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, block: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV blocks (the JAX package's off-TPU
    default): never materialises the (S, Skv) scores.  Shapes as
    `attention_ref`."""
    b, hq, s, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    blk = min(block, skv)
    while skv % blk:
        blk //= 2
    scale = 1.0 / (dh ** 0.5)
    qf = q.float()
    q_pos = torch.arange(s, device=q.device)
    acc = torch.zeros((b, hq, s, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    m = torch.full((b, hq, s, 1), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hq, s, 1), dtype=torch.float32, device=q.device)
    for j in range(skv // blk):
        kb = k[:, :, j * blk:(j + 1) * blk].float().repeat_interleave(
            group, dim=1)
        vb = v[:, :, j * blk:(j + 1) * blk].float().repeat_interleave(
            group, dim=1)
        sres = torch.matmul(qf, kb.transpose(-1, -2)) * scale
        if causal:
            k_pos = j * blk + torch.arange(blk, device=q.device)
            sres = torch.where(q_pos[:, None] >= k_pos[None, :], sres, _NEG)
        m_new = torch.maximum(m, sres.amax(dim=-1, keepdim=True))
        p = torch.exp(sres - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p, vb)
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def tolerance(want: torch.Tensor) -> torch.Tensor:
    """The stated tolerance for outputs near `want`, per row (the last
    axis): F32_ATOL for float32, BF16_ULPS ulps of the row's largest
    |value| for bfloat16 (one ulp of x is 2**(floor(log2 |x|) - 7))."""
    top = want.float().abs().amax(dim=-1, keepdim=True)
    if want.dtype == torch.float32:
        return torch.full_like(top, F32_ATOL)
    exp = torch.floor(torch.log2(top.clamp(min=1e-30))) - 7
    return BF16_ULPS * torch.exp2(exp)


def tolerance_ratio(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / tolerance(want): at most 1 is within tolerance."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise ValueError(f"got {got.dtype}{tuple(got.shape)}, want "
                         f"{want.dtype}{tuple(want.shape)}")
    err = (got.float() - want.float()).abs()
    return float((err / tolerance(want)).max()) if err.numel() else 0.0
