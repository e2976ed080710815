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


def nonzero_2d(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows, cols) int64 of a 2-d tensor's nonzero entries in row-major
    order, found in row blocks of under 2**31 elements each (the most
    torch.nonzero takes on a card)."""
    step = max(1, (2**31 - 1) // max(1, x.shape[1]))
    rows, cols = [], []
    for r0 in range(0, x.shape[0], step):
        r, c = torch.nonzero(x[r0:r0 + step], as_tuple=True)
        rows.append(r + r0)
        cols.append(c)
    if not rows:
        empty = torch.zeros(0, dtype=torch.int64, device=x.device)
        return empty, empty
    return torch.cat(rows), torch.cat(cols)
