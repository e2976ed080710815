"""Bit packing: {0,1}^d vectors <-> packed int32 words, and popcounts.

d bits live in ceil(d/32) int32 words, LSB-first: bit j lands in word
j // 32 at position j % 32, and a word whose bit 31 is set is negative.
Same layout as the JAX package's `repro.core.packing`.

The popcounts work in int64 (torch has no popcount and no uint32 shifts
on the CPU).  `popcount_rows` on a CUDA tensor launches the row-popcount
kernel (`kernels.hamming.ops.row_popcount`); everything else here is
plain tensor code that runs on either device.
"""

from __future__ import annotations

import numpy as np
import torch

LANE_BITS = 32


def packed_width(d: int) -> int:
    return (d + LANE_BITS - 1) // LANE_BITS


def _to_int32(v: torch.Tensor) -> torch.Tensor:
    """Reinterpret uint32 values held in an int64 tensor as int32."""
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack (..., d) {0,1} ints into (..., ceil(d/32)) int32, LSB-first."""
    *lead, d = bits.shape
    w = packed_width(d)
    bits = torch.nn.functional.pad(bits.to(torch.int64),
                                   (0, w * LANE_BITS - d))
    bits = bits.reshape(*lead, w, LANE_BITS)
    shifts = torch.arange(LANE_BITS, dtype=torch.int64, device=bits.device)
    return _to_int32((bits << shifts).sum(dim=-1))


def unpack_bits(words: torch.Tensor, d: int) -> torch.Tensor:
    """Inverse of pack_bits: (..., w) int32 -> (..., d) int32 in {0,1}."""
    *lead, w = words.shape
    shifts = torch.arange(LANE_BITS, dtype=torch.int64, device=words.device)
    u = words.to(torch.int64)[..., None] & 0xFFFFFFFF
    bits = (u >> shifts) & 1
    return bits.reshape(*lead, w * LANE_BITS)[..., :d].to(torch.int32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of each int32 word: int32 counts 0..32 (SWAR, in int64)."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = v + (v >> 8)
    v = v + (v >> 16)
    return (v & 0x3F).to(torch.int32)


def popcount_rows(words: torch.Tensor) -> torch.Tensor:
    """Hamming weight of each packed row: (..., w) int32 -> (...,) int32.
    A CUDA tensor goes through the row-popcount kernel."""
    if words.is_cuda:
        from repro_torch.kernels.hamming import ops

        *lead, w = words.shape
        flat = words.reshape(-1, w).contiguous()
        return ops.row_popcount(flat).reshape(lead)
    return popcount32(words).sum(dim=-1, dtype=torch.int32)


def packed_hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamming distance between packed rows (broadcasting over leading
    dims): (..., w) -> (...,) int32."""
    return popcount32(a ^ b).sum(dim=-1, dtype=torch.int32)


def packed_inner(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Bitwise inner product <a, b> between packed rows (broadcasting)."""
    return popcount32(a & b).sum(dim=-1, dtype=torch.int32)


def pad_to_multiple(x: torch.Tensor, mult: int, axis: int) -> torch.Tensor:
    """Zero-pad `axis` up to the next multiple of `mult`."""
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def pow2_bucket(n: int, floor: int = 8) -> int:
    """Next power of two >= max(n, floor): the store's capacity rule."""
    target = floor
    while target < n:
        target *= 2
    return target


def pad_rows_pow2(x: torch.Tensor, floor: int = 8) -> torch.Tensor:
    """Zero-pad leading rows up to pow2_bucket(n)."""
    n = x.shape[0]
    target = pow2_bucket(n, floor)
    if target == n:
        return x
    pad = x.new_zeros((target - n, *x.shape[1:]))
    return torch.cat([x, pad], dim=0)


def padded_take(x: torch.Tensor, rows, floor: int = 8) -> torch.Tensor:
    """Gather `rows` of x into a pow2_bucket-padded matrix on x's device.
    Pad slots replicate row 0; callers mask them by their valid count."""
    rows = np.asarray(rows, np.int64)
    perm = np.zeros(pow2_bucket(len(rows), floor), np.int64)
    perm[: len(rows)] = rows
    return x.index_select(0, torch.from_numpy(perm).to(x.device))


def np_popcount_rows(words: np.ndarray) -> np.ndarray:
    """NumPy popcount of packed rows for host-side planning:
    (N, w) int32 -> (N,) int64."""
    if words.size == 0:
        return np.zeros(words.shape[0], np.int64)
    return np.unpackbits(
        np.ascontiguousarray(words).view(np.uint8), axis=1).sum(
            axis=1, dtype=np.int64)


def np_pack_bits(bits: np.ndarray) -> np.ndarray:
    """NumPy twin of pack_bits for host-side pipelines and tests:
    (..., d) {0,1} -> (..., ceil(d/32)) int32, LSB-first."""
    *lead, d = bits.shape
    w = packed_width(d)
    pad = w * LANE_BITS - d
    if pad:
        bits = np.concatenate(
            [bits, np.zeros((*lead, pad), dtype=bits.dtype)], axis=-1)
    bits = bits.reshape(*lead, w, LANE_BITS).astype(np.uint32)
    shifts = np.arange(LANE_BITS, dtype=np.uint32)
    return np.sum(bits << shifts, axis=-1, dtype=np.uint32).astype(np.int32)
