"""State carried across from the JAX package: Cabin parameters and a
store's arrays, taken as plain ints and numpy arrays (this package never
imports the JAX one), so that both engines can hold the same membership."""

from __future__ import annotations

import numpy as np

from repro_torch.core.cabin import CabinParams
from repro_torch.index.store import SketchSpec, SketchStore


def params_from_reference(d: dict) -> CabinParams:
    """CabinParams from the reference's fields as ints: `n_dims`,
    `sketch_dim`, `psi_seed` and `pi_seed` (e.g. `dataclasses.asdict` of a
    JAX-package CabinParams)."""
    return CabinParams(n_dims=int(d["n_dims"]),
                       sketch_dim=int(d["sketch_dim"]),
                       psi_seed=int(d["psi_seed"]), pi_seed=int(d["pi_seed"]))


def store_from_reference(packed: np.ndarray, ids: np.ndarray,
                         alive: np.ndarray, d: int, device="cuda",
                         params: CabinParams | None = None) -> SketchStore:
    """A SketchStore holding a JAX store's slots: its packed sketches
    (size, ceil(d/32)) int32, external ids (size,) and alive flags (size,),
    as numpy (the reference's `state_tree()` "sk", "ids" and "alive").
    Tombstoned slots stay tombstoned.  `params`, when given, stamps the
    store with version 0 of that sketch space."""
    spec = None if params is None else SketchSpec(0, params)
    return SketchStore.from_arrays(np.asarray(packed), np.asarray(ids),
                                   np.asarray(alive), d, device=device,
                                   spec=spec)
