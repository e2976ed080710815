"""Core library of the PyTorch port: hashing, packing, Cabin, Cham and the
all-pairs reductions, after the JAX package's `repro.core`."""

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
    sketch_dense,
    sketch_sparse,
)
from repro_torch.core.cham import (  # noqa: F401
    binhamming_from_stats,
    cham,
    cham_matrix,
    cham_table,
    hamming_matrix_exact,
)
from repro_torch.core.packing import (  # noqa: F401
    np_popcount_rows,
    pack_bits,
    packed_width,
    popcount32,
    popcount_rows,
    pow2_bucket,
    unpack_bits,
)
