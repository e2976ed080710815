from repro_torch.kernels.cabin_build.ops import cabin_build  # noqa: F401
from repro_torch.kernels.cabin_build.ref import cabin_build_ref  # noqa: F401
