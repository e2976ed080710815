"""Wrapper of the flash attention kernel (`csrc/flash_attention.cu`) and
the attention dispatcher, after the JAX package's
`repro.kernels.flash_attention.ops.attention`.

The wrapper launches the kernel for CUDA tensors and takes the plain
version (`ref.attention_ref`) for CPU tensors; nothing else falls back.
The dispatcher picks by `impl`: None (the kernel on CUDA, the chunked
plain version on the CPU, as the JAX package's auto picks chunked off the
TPU), "kernel" (CUDA only: a CPU tensor raises), "chunked" or "ref"."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    attention_ref, chunked_attention, tolerance, tolerance_ratio)

DTYPES = (torch.bfloat16, torch.float32)
MAX_HEAD_DIM = 256
IMPLS = (None, "kernel", "chunked", "ref")

_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
         ctypes.c_int, ctypes.c_void_p)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Validate the kernel's inputs; True for CUDA tensors, False for CPU
    tensors.  Raises on anything the kernel does not take."""
    what = "flash_attention"
    for t in (q, k, v):
        if t.dtype not in DTYPES:
            raise TypeError(f"{what}: expected bfloat16 or float32, got "
                            f"{t.dtype}")
        if t.ndim != 4:
            raise ValueError(f"{what}: expected 4-d tensors, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: expected contiguous tensors")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"{what}: mixed dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"{what}: tensors on different devices {devices}")
    device = devices.pop()
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: unsupported device {device}")
    b, hq, _, dh = q.shape
    if k.shape[0] != b or v.shape[:3] != k.shape[:3] or k.shape[3] != dh:
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit "
                         "(B,Hq,S,Dh), (B,Hkv,Skv,Dh), (B,Hkv,Skv,Dh_v)")
    if hq % k.shape[1]:
        raise ValueError(f"{what}: Hq={hq} is not a multiple of "
                         f"Hkv={k.shape[1]}")
    if k.shape[2] == 0:
        raise ValueError(f"{what}: no keys (Skv = 0)")
    for name, d in (("Dh", dh), ("Dh_v", v.shape[3])):
        if d % 16 or not 16 <= d <= MAX_HEAD_DIM:
            raise ValueError(f"{what}: {name}={d} is not a multiple of 16 "
                             f"in [16, {MAX_HEAD_DIM}]")
    if device.type == "cpu":
        return False
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{what}: bfloat16 tensors must start on a 16-byte "
                         "boundary (the kernel copies 16-byte pieces)")
    return True


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q (B,Hq,S,Dh), k (B,Hkv,Skv,Dh), v (B,Hkv,Skv,Dh_v), bfloat16 or
    float32 -> (B,Hq,S,Dh_v) in q's dtype, float32 softmax and sums.

    On CUDA, bfloat16 runs the tensor-core kernel (both products as bf16
    mma.sync with f32 accumulation; P is rounded to bf16 for P V), float32
    the scalar f32 kernel: bf16 tensor cores cannot meet the float32
    tolerance, and no main path runs float32."""
    if not _check(q, k, v):
        return attention_ref(q, k, v, causal=causal)
    b, hq, s, dh = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    out = torch.empty((b, hq, s, dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    fn = build.function("flash_attention", "flash_attention_launch", _ARGS)
    code = fn(build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out), b,
              hq, hkv, s, skv, dh, dv, int(causal), 1.0 / (dh ** 0.5),
              int(q.dtype == torch.bfloat16), build.stream_ptr(q.device))
    build.check("flash_attention", "flash_attention", code)
    build.count_launch("flash_attention")
    return out


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, impl: str | None = None) -> torch.Tensor:
    """Dispatch: impl in {None (auto), 'kernel', 'chunked', 'ref'}."""
    if impl not in IMPLS:
        raise ValueError(f"attention impl must be one of {IMPLS}, got "
                         f"{impl!r}")
    if impl is None:
        impl = "kernel" if q.is_cuda else "chunked"
    if impl == "kernel":
        if not q.is_cuda:
            raise ValueError("attention impl 'kernel' needs CUDA tensors; "
                             "on the CPU use impl=None, 'chunked' or 'ref'")
        return flash_attention(q, k, v, causal=causal)
    if impl == "chunked":
        return chunked_attention(q, k, v, causal=causal)
    return attention_ref(q, k, v, causal=causal)
