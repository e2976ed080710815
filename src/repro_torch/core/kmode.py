"""k-mode clustering (Huang'98): k-means analogue under Hamming distance.

The port of the JAX package's `repro.core.kmode`.  Used by the paper for
ground-truth clustering on the full categorical data and for clustering
binary sketches (binary vectors are categorical with c=2).  Two engines
share one control flow (`_kmedoids_run`), so they draw the identical rng
sequence and produce identical clusterings on the same representation:

  * `kmode_packed` — the primary engine: centres are member rows of a
    packed Cabin sketch matrix, and every distance pass (seeding,
    assignment, medoid update) streams through the all-pairs reductions
    (repro_torch.core.allpairs) on the sketches' device: the hand-written
    kernels on a card, their plain versions on the CPU.  The centre block
    lives on the device, pow2-padded once, its valid count passed along.
    `batch_rows` turns on mini-batch mode for collections too large for
    full-batch medoid updates (the documented deviation — see
    `kmode_packed`).
  * `kmode_precomputed(dist_fn, ...)` — the host oracle: `dist_fn` returns
    dense distance matrices evaluated on host per pass.  Kept for arbitrary
    representations and as the bit-level equivalence reference the device
    engine is held against.

`kmode` clusters raw categorical matrices (Hamming distances from the
rows' nonzero entries, per-attribute mode centres) on the tensor's device,
for the paper's full-data ground truth.  All entry points validate their
arguments at the API boundary and survive degenerate data (duplicate-heavy
rows, k >= the number of distinct rows, k > n) — the k-means++-style
seeding falls back to uniform sampling over not-yet-chosen rows when the
min-distance vector collapses to zero instead of crashing on an
unnormalisable distribution.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np


def _check_args(n_rows: int, k: int, n_iter: int, what: str) -> None:
    """API-boundary validation shared by every entry point: the failure
    modes used to be an obscure `int(x.max())` ValueError on empty input
    and downstream shape errors for k = 0."""
    if k < 1:
        raise ValueError(f"{what}: k must be >= 1, got {k}")
    if n_iter < 1:
        raise ValueError(f"{what}: n_iter must be >= 1, got {n_iter}")
    if n_rows < 1:
        raise ValueError(f"{what}: cannot cluster an empty matrix (0 rows)")


def _seed_indices(n: int, k: int, rng: np.random.Generator,
                  dist_to: Callable[[int], np.ndarray]) -> np.ndarray:
    """k-means++-style medoid seeding over row indices.

    `dist_to(i)` returns the (n,) distances of every row to row i; the
    running min-distance vector d weights the next draw.  Already-chosen
    rows are excluded outright (their d is 0, but a concentrated float
    distribution could still return them under `rng.choice` — duplicate
    centres make a permanently dead cluster).  When d collapses to all
    zeros (duplicate-heavy data, or k >= #distinct rows) the draw falls
    back to UNIFORM over the not-yet-chosen rows — and over all rows once
    every row is already a centre, which only happens for k > n, where
    duplicate centres are unavoidable.  On non-degenerate data the drawn
    sequence is identical to the pre-fix seeding (chosen rows already
    carried zero probability), so fixed-seed comparisons across methods
    stay valid.
    """
    chosen = [int(rng.integers(n))]
    d = np.asarray(dist_to(chosen[0]), np.float64)
    for _ in range(1, k):
        p = np.maximum(d, 0.0)
        p[np.asarray(chosen)] = 0.0
        s = p.sum()
        if s > 0.0:
            idx = int(rng.choice(n, p=p / s))
        else:
            pool = np.setdiff1d(np.arange(n), np.asarray(chosen))
            if len(pool) == 0:
                pool = np.arange(n)
            idx = int(pool[rng.integers(len(pool))])
        chosen.append(idx)
        d = np.minimum(d, dist_to(idx))
    return np.asarray(chosen, np.int64)


class _Rows:
    """kmode's distance and mode steps over a categorical tensor, on its
    device, from its nonzero entries: HD(x, c) = nnz(x) + nnz(c) -
    |S_x & S_c| - #{a : x_a = c_a != 0}, and each cluster's per-attribute
    mode from the counts of its (attribute, category) entries, ties to the
    lowest category as the reference's argmax over its count table breaks
    them.  An empty cluster keeps its previous centre.  Integer work
    throughout, so the labels and centres are the reference's."""

    def __init__(self, x: "torch.Tensor"):
        import torch

        from repro_torch.device import nonzero_2d

        self.torch = torch
        self.x = x
        self.r, self.a = nonzero_2d(x)
        self.v = x[self.r, self.a].to(torch.int64)
        self.nnz = torch.bincount(self.r, minlength=x.shape[0])

    def _hd(self, centers) -> "torch.Tensor":
        torch = self.torch
        n, k = self.x.shape[0], centers.shape[0]
        c = centers[:, self.a].to(torch.int64)  # (k, nnz)
        shared = torch.zeros((k, n), dtype=torch.int64, device=c.device)
        shared.index_add_(1, self.r, (c != 0).to(torch.int64)
                          + (c == self.v).to(torch.int64))
        c_nnz = (centers != 0).sum(dim=1)
        return self.nnz[None, :] + c_nnz[:, None] - shared

    def dist_to(self, i: int) -> np.ndarray:
        return self._hd(self.x[i:i + 1])[0].cpu().numpy().astype(np.float64)

    def rows(self, idx: np.ndarray):
        return self.x[self.torch.from_numpy(idx).to(self.x.device)]

    def to_centers(self, centers) -> np.ndarray:
        return self._hd(centers).T.to(self.torch.int32).cpu().numpy()

    def modes(self, labels: np.ndarray, k: int, prev):
        torch = self.torch
        n_attr = self.x.shape[1]
        lab = torch.from_numpy(labels).to(self.x.device)
        n_val = int(self.v.max()) + 1 if self.v.numel() else 1
        key = ((lab[self.r] * n_attr + self.a) * n_val) + self.v
        uk, cnt = torch.unique(key, return_counts=True)
        slot, cat = uk // n_val, uk % n_val
        top = torch.zeros(k * n_attr, dtype=torch.int64, device=uk.device)
        top.scatter_reduce_(0, slot, cnt, reduce="amax")
        at_top = cnt == top[slot]
        low = torch.full((k * n_attr,), n_val, dtype=torch.int64,
                         device=uk.device)
        low.scatter_reduce_(0, slot[at_top], cat[at_top], reduce="amin")
        seen = torch.zeros(k * n_attr, dtype=torch.int64, device=uk.device)
        seen.index_add_(0, slot, cnt)
        members = torch.bincount(lab, minlength=k)
        zeros = members[:, None] - seen.view(k, n_attr)
        centers = torch.where(zeros >= top.view(k, n_attr), 0,
                              low.view(k, n_attr)).to(self.x.dtype)
        empty = members == 0
        if bool(empty.any()):
            centers[empty] = prev[empty]
        return centers


def kmode(
    x,
    k: int,
    n_iter: int = 15,
    seed: int = 0,
    n_categories: int | None = None,
    n_init: int = 3,
):
    """Cluster rows of categorical matrix x into k clusters.

    Runs `n_init` k-means++-seeded restarts and keeps the one with the
    lowest within-cluster Hamming cost (standard restart practice; a single
    unlucky seeding otherwise dominates the comparison).
    Returns (labels (N,), centers (k, n_attrs)), labels numpy.  A tensor
    is clustered on its device and its centres stay there; a numpy array
    is clustered on the CPU and its centres come back as numpy.
    `n_categories` is the reference's argument: the modes are counted
    from the values present, so it changes nothing here.
    """
    import torch  # local, as in kmode_packed

    host = not isinstance(x, torch.Tensor)
    if host:
        x = torch.as_tensor(np.ascontiguousarray(x))
    if x.ndim != 2:
        raise ValueError(f"kmode: expected a 2-d matrix, got shape "
                         f"{tuple(x.shape)}")
    _check_args(x.shape[0], k, n_iter, "kmode")
    data = _Rows(x)
    n = x.shape[0]
    best = None
    for trial in range(max(n_init, 1)):
        rng = np.random.default_rng(seed * 1000 + trial)
        centers = data.rows(_seed_indices(n, k, rng, data.dist_to))
        # -1 sentinel + closing assignment: same discipline as
        # _kmedoids_run — a genuinely all-zeros first assignment (k = 1)
        # must not read as convergence, and returned labels must be an
        # assignment against the RETURNED centres
        labels = np.full(n, -1, dtype=np.int64)
        converged = False
        for _ in range(n_iter):
            new_labels = data.to_centers(centers).argmin(axis=1)
            if np.array_equal(new_labels, labels):
                converged = True
                break
            labels = new_labels
            centers = data.modes(labels, k, centers)
        dist = data.to_centers(centers)
        if not converged:
            labels = dist.argmin(axis=1)
        cost = int(dist[np.arange(n), labels].sum())
        if best is None or cost < best[0]:
            best = (cost, labels, centers)
    return best[1], best[2].cpu().numpy() if host else best[2]


# ---------------------------------------------------------------------------
# k-medoids control flow shared by the device engine and the host oracle
# ---------------------------------------------------------------------------


class KmodeResult(NamedTuple):
    """Full clustering state from the medoid engines — what an ONLINE
    consumer (repro_torch.cluster.ClusterIndex) needs to keep assigning rows
    after the fit: the labels, which rows were elected centres, and the
    centre rows themselves (host copies)."""

    labels: np.ndarray   # (n,) int64 cluster assignment per row
    medoids: np.ndarray  # (k,) int64 row index of each final centre
    centers: np.ndarray  # (k, repr_width) final centre rows


def _seed_and_install(n: int, k: int, seed: int,
                      dist_to: Callable[[int], np.ndarray],
                      set_center: Callable[[int, int], None]) -> np.ndarray:
    """Seed k medoids and install them as the initial centres — the one
    entry both the full-batch loop and the mini-batch sweep start from, so
    their rng draw sequences can never diverge."""
    rng = np.random.default_rng(seed)
    medoids = _seed_indices(n, k, rng, dist_to)
    for c in range(k):
        set_center(c, int(medoids[c]))
    return medoids


def _kmedoids_run(
    n: int,
    k: int,
    n_iter: int,
    seed: int,
    *,
    dist_to: Callable[[int], np.ndarray],
    set_center: Callable[[int, int], None],
    assign: Callable[[], np.ndarray],
    totals: Callable[[np.ndarray], np.ndarray],
) -> tuple[np.ndarray, np.ndarray]:
    """THE k-medoids loop: seeding, assignment sweeps, medoid updates —
    parameterised over a distance backend.  Both the device engine and the
    host oracle run exactly this function with the same rng, so equal
    per-pair distances imply bit-equal labels; the backends only decide
    WHERE the distance arithmetic happens.

    Empty clusters keep their current medoid (same rationale as kmode's modes).
    Returns (labels (n,), medoids (k,)) with the guarantee that `labels`
    IS a one-shot assignment against the final medoids: convergence breaks
    before any further update, and an n_iter-exhausted run (whose last
    sweep updated the medoids after the last assignment) pays one closing
    assignment pass.  The pre-assignment label state is a -1 sentinel, so
    a first sweep that genuinely assigns every row to cluster 0 (always
    true for k = 1) still elects its medoids instead of being mistaken
    for convergence against the zero-initialised labels.
    """
    medoids = _seed_and_install(n, k, seed, dist_to, set_center)
    labels = np.full(n, -1, dtype=np.int64)
    converged = False
    for _ in range(n_iter):
        new_labels = assign()
        if np.array_equal(new_labels, labels):
            converged = True
            break
        labels = new_labels
        # medoid update: member minimising total distance to cluster members
        for c in range(k):
            members = np.flatnonzero(labels == c)
            if len(members) == 0:
                continue
            midx = int(members[int(np.argmin(totals(members)))])
            medoids[c] = midx
            set_center(c, midx)
    if not converged:
        labels = assign()  # consistent with the final medoids
    return labels, medoids


def kmode_packed(
    x_packed,
    k: int,
    *,
    d: int,
    n_iter: int = 15,
    seed: int = 0,
    metric: str = "cham",
    block: int = 2048,
    batch_rows: int | None = None,
    device="cuda",
) -> KmodeResult:
    """k-medoids over PACKED Cabin sketches — the primary clustering engine.

    `x_packed` is an (n, d/32) int32 matrix of packed sketches (numpy or
    torch), moved to `device`; every distance pass streams through
    repro_torch.core.allpairs under `metric` ("cham" = estimated
    categorical HD, "hamming" = exact sketch HD): assignment is a row
    argmin against the centre block, medoid updates are streaming row sums
    over the gathered members — no (n, k) or (m, m) matrix is kept.  The
    centre block is allocated ONCE at the pow2 bucket of k on the device
    and updated in place, its valid count passed as `m_valid=k`.

    Full-batch (`batch_rows=None`) produces labels bit-identical to the
    host oracle (`kmode_precomputed` with a dense `dist_fn` of the same
    distances, summed exactly) on the same rng sequence — including on
    degenerate inputs (all-duplicate rows, k >= #distinct rows, k > n) —
    and the same bits on a card and on the CPU: the distances are the
    integer statistics' table values and `rowsum`'s totals exact sums.

    Mini-batch (`batch_rows=m`) is the DELIBERATE deviation for large n:
    each sweep processes m-row slices, refreshing each touched centre
    from the slice's own members immediately after assigning the slice,
    so a medoid pass costs O(n * m / k) pair distances instead of
    O(n^2 / k); a final full assignment pass makes the returned labels
    consistent with the final centres.  Labels are NOT bit-identical to
    full-batch (centres see the data in slice order) — use it when n^2/k
    is the bottleneck, not when comparing estimators.
    """
    import torch  # local: keep the host paths numpy-only

    from repro_torch.core import allpairs, packing
    from repro_torch.device import on_device, resolve_device

    x_dev = on_device(x_packed, resolve_device(device))
    if x_dev.ndim != 2:
        raise ValueError(
            f"kmode_packed: expected (n, d/32) packed rows, got "
            f"{tuple(x_dev.shape)}")
    x_dev = x_dev.to(torch.int32).contiguous()
    n = x_dev.shape[0]
    _check_args(n, k, n_iter, "kmode_packed")
    if batch_rows is not None and batch_rows < 1:
        raise ValueError(
            f"kmode_packed: batch_rows must be >= 1, got {batch_rows}")

    # device-resident centre block: pow2-padded once, valid count passed
    kpad = packing.pow2_bucket(k)
    centers = torch.zeros((kpad, x_dev.shape[1]), dtype=torch.int32,
                          device=x_dev.device)

    def dist_to(i: int) -> np.ndarray:
        # distances of every row to row i: argmin over a 1-row block
        _, vals = allpairs.argmin_rows(x_dev, x_dev[i:i + 1], d=d,
                                       metric=metric, block=block)
        return vals

    def set_center(c: int, i: int) -> None:
        centers[c] = x_dev[i]

    def assign_rows(rows_dev) -> np.ndarray:
        lab, _ = allpairs.argmin_rows(rows_dev, centers, d=d, metric=metric,
                                      block=block, m_valid=k)
        return lab.astype(np.int64)

    def totals(members: np.ndarray) -> np.ndarray:
        sub = x_dev.index_select(0, torch.from_numpy(members).to(
            x_dev.device))
        return allpairs.rowsum(sub, d=d, metric=metric, block=block)

    if batch_rows is None:
        labels, medoids = _kmedoids_run(
            n, k, n_iter, seed, dist_to=dist_to, set_center=set_center,
            assign=lambda: assign_rows(x_dev), totals=totals)
    else:
        medoids = _seed_and_install(n, k, seed, dist_to, set_center)
        for _ in range(n_iter):
            for lo in range(0, n, batch_rows):
                hi = min(lo + batch_rows, n)
                lab = assign_rows(x_dev[lo:hi])
                # per-batch centre refresh: each touched centre re-elects
                # its medoid from THIS slice's members only
                for c in np.unique(lab):
                    members = lo + np.flatnonzero(lab == c)
                    midx = int(members[int(np.argmin(totals(members)))])
                    medoids[c] = midx
                    set_center(int(c), midx)
        labels = assign_rows(x_dev)  # consistent with the final centres
    return KmodeResult(labels, np.asarray(medoids, np.int64),
                       centers[:k].cpu().numpy())


def kmode_precomputed(
    dist_fn,
    x_repr: np.ndarray,
    k: int,
    n_iter: int = 15,
    seed: int = 0,
    *,
    sketch_dim: int | None = None,
    metric: str = "cham",
    block: int = 2048,
    batch_rows: int | None = None,
    device="cuda",
) -> np.ndarray:
    """k-medoids-flavoured variant: centres are member rows, assignment is
    nearest-centre under an estimated distance.  Returns labels (n,) int64.

    Two modes:

    * `sketch_dim` given — x_repr is a matrix of PACKED Cabin sketches
      (n, d/32) int32 and the run is delegated to `kmode_packed` (the
      device engine above); `dist_fn` is ignored and may be None.
      `metric` / `block` / `batch_rows` / `device` pass through.

    * `sketch_dim` None — host-oracle mode: `dist_fn(a, b) -> (len(a),
      len(b))` distance matrix, evaluated on host per pass (kept for
      arbitrary representations and as the equivalence reference the
      device engine is pinned against).  `batch_rows` is not supported
      here: mini-batching is a deviation the ORACLE must not share, or
      the reference would drift with it.

    Both modes draw the identical rng sequence, so on the same
    representation they produce the same clustering.
    """
    n = np.shape(x_repr)[0]
    _check_args(n, k, n_iter, "kmode_precomputed")
    if sketch_dim is not None:
        return np.asarray(kmode_packed(
            x_repr, k, d=sketch_dim, n_iter=n_iter, seed=seed, metric=metric,
            block=block, batch_rows=batch_rows, device=device).labels)
    if dist_fn is None:
        raise ValueError(
            "kmode_precomputed: dist_fn is required without sketch_dim")
    if batch_rows is not None:
        raise ValueError("kmode_precomputed: batch_rows requires the packed "
                         "engine (pass sketch_dim=...)")

    x_repr = np.asarray(x_repr)
    centers = np.zeros((k,) + x_repr.shape[1:], dtype=x_repr.dtype)

    def dist_to(i: int) -> np.ndarray:
        return np.asarray(dist_fn(x_repr, x_repr[[i]]))[:, 0]

    def set_center(c: int, i: int) -> None:
        centers[c] = x_repr[i]

    def assign() -> np.ndarray:
        dist = np.asarray(dist_fn(x_repr, centers))
        return dist.argmin(axis=1).astype(np.int64)

    def totals(members: np.ndarray) -> np.ndarray:
        sub = np.asarray(dist_fn(x_repr[members], x_repr[members]))
        return sub.sum(axis=1)

    labels, _ = _kmedoids_run(n, k, n_iter, seed, dist_to=dist_to,
                              set_center=set_center, assign=assign,
                              totals=totals)
    return labels
