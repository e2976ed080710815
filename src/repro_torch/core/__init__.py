"""Core library of the PyTorch port: hashing, packing, Cabin, Cham, the
theory's bounds and the all-pairs reductions, after the JAX package's
`repro.core` (the baselines and metrics of the paper's experiments are in
`core.baselines` and `core.metrics`)."""

from repro_torch.core.allpairs import (  # noqa: F401
    argmin_rows,
    kbest_lex_merge,
    prune_factor,
    prune_score_host,
    rowsum,
    threshold_pairs,
    topk_rows,
    topk_rows_banded,
)
from repro_torch.core.cabin import (  # noqa: F401
    CabinParams,
    binem,
    binsketch,
    sketch_dense,
    sketch_sparse,
)
from repro_torch.core.cham import (  # noqa: F401
    binhamming,
    binhamming_from_stats,
    cham,
    cham_matrix,
    cham_table,
    cosine_estimate,
    density_estimate,
    hamming_matrix_exact,
    inner_estimate,
    jaccard_estimate,
)
from repro_torch.core.packing import (  # noqa: F401
    np_popcount_rows,
    np_pack_bits,
    pack_bits,
    packed_hamming,
    packed_inner,
    packed_width,
    popcount32,
    popcount_rows,
    pow2_bucket,
    unpack_bits,
)
from repro_torch.core.theory import sketch_dim, theorem2_bound  # noqa: F401
