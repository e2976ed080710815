"""Plain PyTorch version of the dense Cabin kernel: BinEm then BinSketch
(`repro_torch.core.cabin.binsketch(binem(x))`), the same function as the
JAX package's `repro.kernels.cabin_build.ref.cabin_build_ref`."""

from __future__ import annotations

import torch

from repro_torch.core.cabin import CabinParams, binem, binsketch


def cabin_build_ref(x: torch.Tensor, *, d: int, psi_seed: int, pi_seed: int
                    ) -> torch.Tensor:
    """(N, n) int32 categories (0 = missing) -> (N, ceil(d/32)) int32."""
    params = CabinParams(n_dims=x.shape[-1], sketch_dim=d, psi_seed=psi_seed,
                         pi_seed=pi_seed)
    return binsketch(params, binem(params, x))
