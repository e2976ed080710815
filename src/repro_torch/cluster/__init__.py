"""repro_torch.cluster: online clustering over the live index, after the
JAX package's `repro.cluster`.

`ClusterIndex` maintains k-medoid centres and per-row labels over a
`repro_torch.index` QueryEngine, assigning fresh rows as they arrive
(through the engine's own `topk_packed` k=1 serving path), tracking
per-cluster counts/weights through add/remove/compact/merge, refitting
with the k-medoid engine (`core.kmode.kmode_packed`), following spec
migrations, and surviving save/restore through the Checkpointer beside
the store.

Public API:
    ClusterIndex — attach to a QueryEngine (or `engine.cluster(k)`);
                   labels()/label_of()/assign(), counts/weights,
                   refit(n_iter), save/restore
"""

from repro_torch.cluster.online import ClusterIndex  # noqa: F401
