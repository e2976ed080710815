from repro_torch.kernels.topk_select.ops import topk_select  # noqa: F401
from repro_torch.kernels.topk_select.ref import topk_select_ref  # noqa: F401
