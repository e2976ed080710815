from repro_torch.kernels.cabin_build_sparse.ops import (  # noqa: F401
    cabin_build_sparse)
from repro_torch.kernels.cabin_build_sparse.ref import (  # noqa: F401
    cabin_build_sparse_ref)
