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


def _stats_table(d: int, wu: torch.Tensor, wv: torch.Tensor,
                 inner: torch.Tensor) -> torch.Tensor:
    """The Cham table for d, long enough for every union wu + wv - inner."""
    union = wu.to(torch.int64) + wv.to(torch.int64) - inner.to(torch.int64)
    top = max(d, int(union.max()) if union.numel() else 0)
    return cham_table(d, wu.device, packing.packed_width(top))


def binhamming_from_stats(wu: torch.Tensor, wv: torch.Tensor,
                          inner: torch.Tensor, d: int, *,
                          obs_u: torch.Tensor | None = None,
                          obs_v: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """h_hat = estimated HD(u', v') from sketch statistics (broadcasting).

    obs_u / obs_v (keyword-only, broadcasting like wu / wv) are per-row
    observed-dimension counts under a miss model: a row whose record
    dropped categories has at most obs set bits, so the estimates are
    clamped into a_hat <= obs_u, b_hat <= obs_v and
    max(a_hat, b_hat) <= u_hat <= a_hat + b_hat before the distance is
    formed, as in the JAX package.  With both None the result is the table
    path's, bit for bit; with a mask, the clamps run in float32 on the
    table's entries."""
    table = _stats_table(d, wu, wv, inner)
    if obs_u is None and obs_v is None:
        return binhamming_from_table(table, wu, wv, inner)
    wu = wu.to(torch.int64)
    wv = wv.to(torch.int64)
    a_hat = table[wu]
    b_hat = table[wv]
    u_hat = table[wu + wv - inner.to(torch.int64)]
    if obs_u is not None:
        a_hat = torch.minimum(a_hat, obs_u.to(torch.float32))
    if obs_v is not None:
        b_hat = torch.minimum(b_hat, obs_v.to(torch.float32))
    u_hat = torch.minimum(torch.maximum(u_hat, torch.maximum(a_hat, b_hat)),
                          a_hat + b_hat)
    return torch.clamp(2.0 * u_hat - a_hat - b_hat, min=0.0)


def _packed_stats(u: torch.Tensor, v: torch.Tensor):
    return (packing.popcount_rows(u), packing.popcount_rows(v),
            packing.packed_inner(u, v))


def binhamming(u: torch.Tensor, v: torch.Tensor, d: int, *,
               obs_u: torch.Tensor | None = None,
               obs_v: torch.Tensor | None = None) -> torch.Tensor:
    """BinHamming on packed sketches (..., w), broadcasting -> estimated
    HD(u', v')."""
    wu, wv, inner = _packed_stats(u, v)
    return binhamming_from_stats(wu, wv, inner, d, obs_u=obs_u, obs_v=obs_v)


def cham(u: torch.Tensor, v: torch.Tensor, d: int, *,
         obs_u: torch.Tensor | None = None,
         obs_v: torch.Tensor | None = None) -> torch.Tensor:
    """Cham(u~, v~) = 2 * BinHamming between packed rows (..., w),
    broadcasting; obs_u / obs_v as in `binhamming_from_stats`."""
    if obs_u is not None or obs_v is not None:
        return 2.0 * binhamming(u, v, d, obs_u=obs_u, obs_v=obs_v)
    wu, wv, inner = _packed_stats(u, v)
    return cham_from_table(cham_table(d, u.device, u.shape[-1]),
                           wu, wv, inner)


def density_estimate(weight: torch.Tensor, d: int) -> torch.Tensor:
    """Estimated pre-sketch Hamming weight from a sketch weight."""
    top = max(d, int(weight.max()) if weight.numel() else 0)
    table = cham_table(d, weight.device, packing.packed_width(top))
    return table[weight.to(torch.int64)]


def inner_estimate(u: torch.Tensor, v: torch.Tensor, d: int
                   ) -> torch.Tensor:
    """Estimated <u', v'> (BinSketch's inner-product estimate)."""
    wu, wv, st = _packed_stats(u, v)
    table = _stats_table(d, wu, wv, st)
    wu = wu.to(torch.int64)
    wv = wv.to(torch.int64)
    ip = table[wu] + table[wv] - table[wu + wv - st.to(torch.int64)]
    return torch.clamp(ip, min=0.0)


def cosine_estimate(u: torch.Tensor, v: torch.Tensor, d: int
                    ) -> torch.Tensor:
    wu = density_estimate(packing.popcount_rows(u), d)
    wv = density_estimate(packing.popcount_rows(v), d)
    ip = inner_estimate(u, v, d)
    return ip / torch.clamp(torch.sqrt(wu * wv), min=_EPS)


def jaccard_estimate(u: torch.Tensor, v: torch.Tensor, d: int
                     ) -> torch.Tensor:
    wu = density_estimate(packing.popcount_rows(u), d)
    wv = density_estimate(packing.popcount_rows(v), d)
    ip = inner_estimate(u, v, d)
    return ip / torch.clamp(wu + wv - ip, min=_EPS)


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
