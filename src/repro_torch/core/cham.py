"""Cham: Hamming-distance estimation from Cabin sketches.

With d bins, D = 1 - 1/d, sketch weights wu = |u~|, wv = |v~| and sketch
inner product st = <u~, v~>:

    a_hat = log(1 - wu/d) / log D
    U_hat = log(1 - (wu + wv - st)/d) / log D
    h_hat = 2 U_hat - a_hat - b_hat        (estimated HD of u', v')
    Cham  = 2 max(h_hat, 0)                (estimated HD of u, v)

Each of a_hat, b_hat and U_hat is one function of an integer count w, so
the port evaluates it once per d into an f32 table

    T[w] = _safe_log1m(w/d) / log1p(-1/d),   w = 0 .. 32 * W,

and every path (this module, the plain versions and the CUDA kernels)
computes Cham from the integer statistics by indexing that one table:

    dist = 2 * max(2 * T[wa + wb - inner] - T[wa] - T[wb], 0).

Equal statistics therefore give equal bits on every path and device, so
a top-k answer cannot flip between the kernel and its plain version at a
near-tie.  The table is built by the JAX package's f32 formula
(`repro.core.cham`), to which it agrees within f32 rounding of the logs.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core import packing

_EPS = 1e-9


def _safe_log1m(x: torch.Tensor) -> torch.Tensor:
    """log(1 - x), clamped: saturated sketches (x -> 1) clip to a full bin."""
    return torch.log(torch.clamp(1.0 - x, _EPS, 1.0))


@functools.lru_cache(maxsize=32)
def _table(d: int, n_words: int, device: torch.device) -> torch.Tensor:
    w = torch.arange(packing.LANE_BITS * n_words + 1, dtype=torch.float32)
    # full-size divisors: no scalar fast path that could round differently
    log_d = torch.log1p(torch.full((1,), -1.0 / d, dtype=torch.float32))
    x = w / torch.full_like(w, float(d))
    return (_safe_log1m(x) / log_d.expand_as(w)).to(device)


def cham_table(d: int, device="cpu", n_words: int | None = None
               ) -> torch.Tensor:
    """The f32 table T[0 .. 32 * n_words] for sketch dim d (n_words
    defaults to packed_width(d)), built on the host and kept per device.
    Callers must not write to it."""
    if n_words is None:
        n_words = packing.packed_width(d)
    return _table(int(d), int(n_words), torch.device(device))


def binhamming_from_table(table: torch.Tensor, wa: torch.Tensor,
                          wb: torch.Tensor, inner: torch.Tensor
                          ) -> torch.Tensor:
    """h_hat from integer statistics (broadcasting) through `table`, in the
    same float steps as the CUDA kernels: (2*Tu - Ta) - Tb, clamped at 0."""
    wa = wa.to(torch.int64)
    wb = wb.to(torch.int64)
    tu = table[wa + wb - inner.to(torch.int64)]
    h = (2.0 * tu - table[wa]) - table[wb]
    return torch.where(h > 0, h, torch.zeros_like(h))


def cham_from_table(table: torch.Tensor, wa: torch.Tensor, wb: torch.Tensor,
                    inner: torch.Tensor) -> torch.Tensor:
    """Cham = 2 * h_hat from integer statistics through `table`."""
    return 2.0 * binhamming_from_table(table, wa, wb, inner)


def binhamming_from_stats(wu: torch.Tensor, wv: torch.Tensor,
                          inner: torch.Tensor, d: int) -> torch.Tensor:
    """h_hat = estimated HD(u', v') from sketch statistics (broadcasting)."""
    union = wu.to(torch.int64) + wv.to(torch.int64) - inner.to(torch.int64)
    top = max(d, int(union.max()) if union.numel() else 0)
    table = cham_table(d, wu.device, packing.packed_width(top))
    return binhamming_from_table(table, wu, wv, inner)


def cham(u: torch.Tensor, v: torch.Tensor, d: int) -> torch.Tensor:
    """Cham(u~, v~) between packed rows (..., w), broadcasting."""
    wu = packing.popcount_rows(u)
    wv = packing.popcount_rows(v)
    inner = packing.popcount32(u & v).sum(dim=-1, dtype=torch.int32)
    return cham_from_table(cham_table(d, u.device, u.shape[-1]),
                           wu, wv, inner)


def sketch_stats_matrix(a: torch.Tensor, b: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pairwise (wa, wb, inner) between packed rows a (N, w) and b (M, w)."""
    from repro_torch.kernels.hamming import ops

    inner, _ = ops.pair_stats(a.contiguous(), b.contiguous(), op_ham=False)
    return packing.popcount_rows(a), packing.popcount_rows(b), inner


def cham_matrix(a: torch.Tensor, b: torch.Tensor, d: int) -> torch.Tensor:
    """All-pairs Cham: (N, w), (M, w) packed -> (N, M) float32."""
    wa, wb, inner = sketch_stats_matrix(a, b)
    return cham_from_table(cham_table(d, a.device, a.shape[-1]),
                           wa[:, None], wb[None, :], inner)


def hamming_matrix_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact pairwise HD between packed binary rows: (N, M) int32."""
    from repro_torch.kernels.hamming import ops

    _, ham = ops.pair_stats(a.contiguous(), b.contiguous(), op_inner=False)
    return ham
