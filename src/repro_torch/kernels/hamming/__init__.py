from repro_torch.kernels.hamming.ops import (  # noqa: F401
    dist_matrix, pair_stats, row_popcount)
from repro_torch.kernels.hamming.ref import (  # noqa: F401
    pair_stats_ref, row_popcount_ref)
