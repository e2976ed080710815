"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """torch.device(device), refusing CUDA where there is none: the port
    has no quiet CPU fallback."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def to_host(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a host numpy array."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def on_device(x, device: torch.device) -> torch.Tensor:
    """A numpy array, nested sequence or tensor as a tensor on `device`,
    dtype kept."""
    return torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x),
                           device=device)
