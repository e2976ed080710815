"""The paper's experiments on the port: one function per figure or table,
the torch twin of the JAX package's `benchmarks/bench_paper.py`.

Each function draws its rows from the port's Table-1 generator
(`repro_torch.data.synthetic`, the same arrays as the reference's for the
same seed), runs every method on `device` and asserts the ordering the
reference asserts, raising AssertionError when it does not hold.  Its
defaults are the reference's scaled twins; `data` hands it rows drawn
elsewhere (`sample`), e.g. at Table 1's full widths, and the sketch
dimensions go with them (`full_width_dim` keeps a twin's ratio of sketch
dimension to density).  Times are host seconds around work that ends in
a device synchronisation, best of `repeat` where the reference repeats.

Methods, as the reference's `benchmarks/common.py` `make_methods`: Cabin
sketches the categorical rows and estimates by Cham; BCS, H-LSH, FH and
SimHash sketch the BinEm embedding and get the same 2x Lemma-2
unbiasing, so every method estimates the categorical Hamming distance.
The all-pairs statistics come from the pair-stats kernel on packed rows
(Hamming distances of 0/1 sketches, shared bits) and FH's inner products
from a float64 product, exact integers where the reference broadcasts.
The exact distances come from the rows' supports,

    HD(x, y) = nnz_x + nnz_y - |S_x & S_y| - #{a : x_a = y_a != 0},

both intersections counted as shared bits of packed 0/1 bitmaps over the
sample's active attributes and its active (attribute, category) keys.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from fractions import Fraction

import numpy as np
import torch

from repro_torch.core import baselines as B
from repro_torch.core.cabin import CabinParams, binem, sketch_dense
from repro_torch.core.cham import cham_matrix, hamming_matrix_exact
from repro_torch.core.kmode import kmode
from repro_torch.core.metrics import ari, nmi, purity
from repro_torch.core.packing import (LANE_BITS, pack_bits, packed_width,
                                      unpack_bits)
from repro_torch.core.theory import sketch_dim, theorem2_bound
from repro_torch.data.synthetic import (TABLE1, DatasetSpec, sample_sparse,
                                        scaled_spec)
from repro_torch.device import nonzero_2d, resolve_device
from repro_torch.kernels.hamming import ops as hamming_ops

METHODS = ("cabin", "bcs", "hlsh", "fh", "sh")
BASELINES = METHODS[1:]


def _claim(cond: bool, what) -> None:
    if not cond:
        raise AssertionError(what)


def full_width_dim(d_twin: int, scale_twin: float) -> int:
    """A twin's sketch dimension at full width: d_twin / scale_twin (the
    twin's ratio of sketch dimension to density), rounded up to a multiple
    of 32."""
    d = math.ceil(Fraction(d_twin) / Fraction(str(scale_twin)))
    return -(-d // LANE_BITS) * LANE_BITS


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Sample:
    """Rows of a Table-1 twin as the generator draws them: padded COO
    (indices, values) (N, m) and labels (N,), -1 without clusters."""

    spec: DatasetSpec
    indices: np.ndarray
    values: np.ndarray
    labels: np.ndarray

    @property
    def n_rows(self) -> int:
        return self.indices.shape[0]

    def head(self, n: int) -> "Sample":
        return Sample(self.spec, self.indices[:n], self.values[:n],
                      self.labels[:n])

    def dense(self, device="cuda") -> torch.Tensor:
        """The rows as (N, n_dims) int32 on `device`, equal to the
        generator's `sample_dense`: there every slot is written at its
        index in row-major order, so a padding slot (index 0, value 0)
        after a row's entries clears attribute 0, and rows whose first
        value is 0 read 0 there.  Column 0 is worked out on the host by
        the same assignment; the rest is a scatter of the live entries."""
        idx, val = self.indices, self.values
        col0 = np.zeros(self.n_rows, np.int32)
        r0, s0 = np.nonzero(idx == 0)
        col0[r0] = val[r0, s0]
        col0 = np.where(val[:, 0] == 0, 0, col0).astype(np.int32)
        r, s = np.nonzero(val)
        dev = resolve_device(device)
        x = torch.zeros((self.n_rows, self.spec.n_dims), dtype=torch.int32,
                        device=dev)
        x[torch.from_numpy(r).to(dev),
          torch.from_numpy(idx[r, s].astype(np.int64)).to(dev)] = (
            torch.from_numpy(val[r, s].astype(np.int32)).to(dev))
        x[:, 0] = torch.from_numpy(col0).to(dev)
        return x


def sample(name: str, scale: float, n_rows: int, seed: int = 0,
           clusters: int = 0) -> Sample:
    """n_rows of Table 1's `name` scaled by `scale` (1.0: full width)."""
    spec = scaled_spec(TABLE1[name], scale)
    idx, val, labels = sample_sparse(spec, n_rows, seed=seed,
                                     cluster_centers=clusters)
    return Sample(spec, idx, val, labels)


def exact_hd_matrix(x: torch.Tensor) -> torch.Tensor:
    """All-pairs Hamming distance of categorical rows (N, n) -> (N, N)
    int32, from the rows' supports (module docstring)."""
    n = x.shape[0]
    rows, attrs = nonzero_2d(x)
    vals = x[rows, attrs].to(torch.int64)
    nnz = torch.bincount(rows, minlength=n).to(torch.int32)
    keys = attrs * (int(vals.max()) + 1 if vals.numel() else 1) + vals
    shared = 0
    for col in (attrs, keys):
        _, dense_col = torch.unique(col, return_inverse=True)
        bitmap = _bitmap(rows, dense_col, n)
        inner, _ = hamming_ops.pair_stats(bitmap, bitmap, op_ham=False)
        shared = shared + inner
    return nnz[:, None] + nnz[None, :] - shared


def _bitmap(rows: torch.Tensor, cols: torch.Tensor, n: int) -> torch.Tensor:
    """Packed 0/1 rows (n, W) int32 with bit cols[i] of row rows[i] set
    (each (row, col) at most once)."""
    w = max(1, packed_width(int(cols.max()) + 1 if cols.numel() else 1))
    words = torch.zeros(n * w, dtype=torch.int64, device=rows.device)
    words.index_add_(0, rows * w + cols // LANE_BITS,
                     torch.ones_like(cols) << (cols % LANE_BITS))
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32).view(n, w)


def _pairs(m: torch.Tensor) -> torch.Tensor:
    iu = torch.triu_indices(m.shape[0], m.shape[0], 1, device=m.device)
    return m[iu[0], iu[1]]


def rmse(est: torch.Tensor, true: torch.Tensor) -> float:
    err = _pairs(est).to(torch.float64) - _pairs(true).to(torch.float64)
    return float(torch.sqrt((err ** 2).mean()))


def mae(est: torch.Tensor, true: torch.Tensor) -> float:
    err = _pairs(est).to(torch.float64) - _pairs(true).to(torch.float64)
    return float(err.abs().mean())


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(fn, dev: torch.device, repeat: int = 1):
    """(best seconds of `repeat` calls, the last result)."""
    best, out = math.inf, None
    for _ in range(repeat):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best, out


# ---------------------------------------------------------------------------
# methods: name -> (N, n) categorical rows -> (N, N) estimated HD, float32
# ---------------------------------------------------------------------------


def _sketch_hd(y: torch.Tensor) -> torch.Tensor:
    """All-pairs Hamming distance of 0/1 sketches (N, d) -> (N, N) int32."""
    packed = pack_bits(y)
    return hamming_matrix_exact(packed, packed)


def make_methods(n_dims: int, d: int, seed: int = 0) -> dict:
    """The reference's method registry at sketch dimension d."""
    cp = CabinParams.create(n_dims, d, seed=seed)
    bp = B.BaselineParams(n_dims, d, seed)

    def cabin(x):
        sk = sketch_dense(cp, x)
        return cham_matrix(sk, sk, d)

    def bcs(u):
        return B.bcs_estimate_from_hd(bp, _sketch_hd(B.bcs_sketch(bp, u)))

    def hlsh(u):
        return B.hlsh_estimate_from_hd(bp, _sketch_hd(B.hlsh_sketch(bp, u)))

    def weights(u):
        return u.sum(dim=-1, dtype=torch.float32)

    def fh(u):
        y = B.fh_sketch(bp, u).to(torch.float64)
        w = weights(u)
        return B.fh_estimate_from_inner(y @ y.T, w[:, None], w[None, :])

    def sh(u):
        w = weights(u)
        return B.simhash_estimate_from_hd(
            bp, _sketch_hd(B.simhash_sketch(bp, u)), w[:, None], w[None, :])

    def with_binem(fn):
        return lambda x: 2.0 * fn(binem(cp, x))

    return {"cabin": cabin, "bcs": with_binem(bcs), "hlsh": with_binem(hlsh),
            "fh": with_binem(fh), "sh": with_binem(sh)}


# ---------------------------------------------------------------------------
# Figure 2 + Table 3: dimensionality-reduction speed / speedups
# ---------------------------------------------------------------------------


def fig2_table3_reduction_speed(scale=0.08, n_rows=256, *, d=512,
                                name="enron", data: Sample | None = None,
                                repeat=3, device="cuda") -> dict:
    """Sketching time of each method after a warm-up call; Table 3's
    speedup of Cabin over each baseline (none is asserted, as in the
    reference)."""
    dev = resolve_device(device)
    data = data or sample(name, scale, n_rows)
    n = data.spec.n_dims
    x = data.dense(dev)
    cp = CabinParams.create(n, d, seed=0)
    bp = B.BaselineParams(n, d, 0)
    sketchers = {
        "cabin": lambda: sketch_dense(cp, x),
        "bcs": lambda: B.bcs_sketch(bp, binem(cp, x)),
        "hlsh": lambda: B.hlsh_sketch(bp, binem(cp, x)),
        "fh": lambda: B.fh_sketch(bp, binem(cp, x)),
        "sh": lambda: B.simhash_sketch(bp, binem(cp, x)),
    }
    seconds = {}
    for method, fn in sketchers.items():
        _timed(fn, dev)  # warm-up
        seconds[method], _ = _timed(fn, dev, repeat)
    out = {"d": d, "n_dims": n, "rows": data.n_rows, "seconds": seconds}
    for method in BASELINES:
        out[f"speedup_{method}"] = seconds[method] / seconds["cabin"]
    return out


# ---------------------------------------------------------------------------
# Figure 3: RMSE vs embedding dimension
# ---------------------------------------------------------------------------


def fig3_rmse(scale=0.06, n_rows=192, dims=(128, 256, 512, 1024), *,
              names=("kos", "enron"), data: dict | None = None,
              device="cuda") -> dict:
    """RMSE of every method at each d; Cabin's RMSE at the largest d is
    within 1.25x of the best baseline's and below its RMSE at the
    smallest d."""
    dev = resolve_device(device)
    results = {}
    for ds in names:
        smp = data[ds] if data else sample(ds, scale, n_rows, seed=1)
        x = smp.dense(dev)
        true = exact_hd_matrix(x)
        for d in dims:
            for method, fn in make_methods(smp.spec.n_dims, d,
                                           seed=2).items():
                results[(ds, method, d)] = rmse(fn(x), true)
        best = min(results[(ds, m, dims[-1])] for m in BASELINES)
        _claim(results[(ds, "cabin", dims[-1])] <= best * 1.25,
               f"cabin not competitive on {ds}: {results}")
        _claim(results[(ds, "cabin", dims[-1])]
               < results[(ds, "cabin", dims[0])],
               f"cabin's RMSE does not fall with d on {ds}: {results}")
    return {f"{k[0]}.{k[1]}.d{k[2]}": v for k, v in results.items()}


# ---------------------------------------------------------------------------
# Figure 4: BinEm variance analysis
# ---------------------------------------------------------------------------


def fig4_binem_variance(scale=0.06, trials=200, *, d=256, name="nips",
                        data: Sample | None = None, device="cuda") -> dict:
    """2 HD(u', v') against HD(u, v) on one pair over `trials` seeds:
    centred (unbiased) and concentrated."""
    dev = resolve_device(device)
    data = (data or sample(name, scale, 2, seed=3)).head(2)
    x = data.dense(dev)
    hd = int((x[0] != x[1]).sum())
    t0 = time.perf_counter()
    diffs = []
    for t in range(trials):
        u = binem(CabinParams.create(data.spec.n_dims, d, seed=t), x)
        diffs.append((u[0] != u[1]).sum())
    errors = hd - 2 * torch.stack(diffs).cpu().numpy().astype(np.int64)
    sec = (time.perf_counter() - t0) / trials
    _claim(abs(errors.mean()) < 4 * errors.std() / np.sqrt(trials) + 2,
           f"BinEm biased: mean {errors.mean()}, std {errors.std()}")
    _claim(errors.std() < 2 * np.sqrt(hd) + 2,
           f"BinEm not concentrated: std {errors.std()} at HD {hd}")
    q = np.percentile(errors, [25, 50, 75])
    return {"mean": float(errors.mean()), "std": float(errors.std()),
            "hd": hd, "median": float(q[1]),
            "iqr": (float(q[0]), float(q[2])), "seconds_per_trial": sec}


# ---------------------------------------------------------------------------
# Figure 5: step-2 (BinSketch vs alternatives) variance on one pair
# ---------------------------------------------------------------------------


def fig5_step2_variance(scale=0.06, trials=64, d=512, *, name="enron",
                        data: Sample | None = None, device="cuda") -> dict:
    """Each method's error on one pair over `trials` seeds: Cabin's is
    about unbiased, with a spread in the lowest group."""
    dev = resolve_device(device)
    data = (data or sample(name, scale, 2, seed=4)).head(2)
    x = data.dense(dev)
    true = int((x[0] != x[1]).sum())
    errs = {m: [] for m in METHODS}
    for t in range(trials):
        for method, fn in make_methods(data.spec.n_dims, d,
                                       seed=100 + t).items():
            errs[method].append(fn(x)[0, 1])
    out = {}
    for method, e in errs.items():
        e = torch.stack(e).cpu().numpy().astype(np.float64) - true
        out[method] = {"mean": float(e.mean()), "std": float(e.std()),
                       "errors": e.tolist()}
    _claim(abs(out["cabin"]["mean"]) <= max(8.0, abs(out["sh"]["mean"])),
           f"cabin biased on one pair: {out}")
    _claim(out["cabin"]["std"] <= 2.0 * min(v["std"] for k, v in out.items()
                                            if k != "cabin"),
           f"cabin's spread not in the lowest group: {out}")
    return out


# ---------------------------------------------------------------------------
# Figures 6-9 + 10: clustering quality + speedup
# ---------------------------------------------------------------------------


def fig6to10_clustering(scale=0.05, n_rows=180, k=4, dims=(256, 512), *,
                        name="nytimes", data: Sample | None = None,
                        device="cuda") -> dict:
    """k-mode on Cabin, BCS and H-LSH bits against k-mode on the full
    rows: Cabin's NMI above 0.6 and its purity within 0.05 of the best
    baseline's at the largest d."""
    dev = resolve_device(device)
    data = data or sample(name, scale, n_rows, seed=5, clusters=k)
    n = data.spec.n_dims
    x = data.dense(dev)
    t_full, (truth, _) = _timed(
        lambda: kmode(x, k, seed=0, n_categories=data.spec.n_categories),
        dev)
    out = {"kmode_full_s": t_full}
    for d in dims:
        cp = CabinParams.create(n, d, seed=6)
        bp = B.BaselineParams(n, d, 6)
        u = binem(cp, x)
        reprs = {"cabin": unpack_bits(sketch_dense(cp, x), d),
                 "bcs": B.bcs_sketch(bp, u), "hlsh": B.hlsh_sketch(bp, u)}
        scores_d = {}
        for method, bits in reprs.items():
            t_sk, (pred, _) = _timed(
                lambda b=bits: kmode(b, k, seed=0, n_categories=1), dev)
            scores_d[method] = {"purity": purity(truth, pred),
                                "nmi": nmi(truth, pred),
                                "ari": ari(truth, pred), "kmode_s": t_sk}
        scores_d["cabin"]["kmode_speedup"] = (
            t_full / scores_d["cabin"]["kmode_s"])
        out[d] = scores_d
    top = out[max(dims)]
    _claim(top["cabin"]["nmi"] > 0.6, f"cabin's clustering NMI: {top}")
    best_base = max(top[m]["purity"] for m in ("bcs", "hlsh"))
    _claim(top["cabin"]["purity"] >= best_base - 0.05,
           f"cabin's purity below the baselines': {top}")
    return out


# ---------------------------------------------------------------------------
# Table 4 + Figures 11/12: all-pairs heatmap MAE + speedup
# ---------------------------------------------------------------------------


def table4_heatmap(scale=0.02, n_rows=256, d=1024, *, name="braincell",
                   data: Sample | None = None, device="cuda") -> dict:
    """MAE of every method's all-pairs heatmap: Cabin's is the best, or
    within 1.1x of the best baseline's."""
    dev = resolve_device(device)
    data = data or sample(name, scale, n_rows, seed=7)
    x = data.dense(dev)
    t_exact, true = _timed(lambda: exact_hd_matrix(x), dev)
    maes, seconds = {}, {}
    for method, fn in make_methods(data.spec.n_dims, d, seed=8).items():
        seconds[method], est = _timed(lambda fn=fn: fn(x), dev)
        maes[method] = mae(est, true)
    others = min(v for m, v in maes.items() if m != "cabin")
    _claim(maes["cabin"] <= others * 1.1, f"cabin's MAE: {maes}")
    return {"mae": maes, "seconds": seconds, "exact_s": t_exact,
            "speedup": t_exact / seconds["cabin"]}


# ---------------------------------------------------------------------------
# Theorem 2 empirical check
# ---------------------------------------------------------------------------


def theorem2_check(scale=0.06, n_rows=96, delta=0.1, *, name="kos",
                   data: Sample | None = None, device="cuda") -> dict:
    """At the paper's d = sketch_dim(s), at least 1 - delta of the pairs'
    |Cham - HD| lie within Theorem 2's bound."""
    dev = resolve_device(device)
    data = data or sample(name, scale, n_rows, seed=9)
    x = data.dense(dev)
    s = int((x != 0).sum(dim=1).max())
    d = sketch_dim(s, delta)
    cp = CabinParams.create(data.spec.n_dims, d, seed=10)
    sk = sketch_dense(cp, x)
    errors = _pairs((cham_matrix(sk, sk, d).to(torch.float64)
                     - exact_hd_matrix(x).to(torch.float64)).abs())
    bound = theorem2_bound(s, delta)
    frac = float((errors <= bound).to(torch.float64).mean())
    _claim(frac >= 1 - delta, f"Theorem 2: {frac} of the pairs within "
           f"{bound}, below {1 - delta}")
    return {"frac_within": frac, "bound": bound,
            "mean_err": float(errors.mean()), "d": d,
            "s": s}
