"""State carried across from the JAX package: Cabin parameters, a store's
arrays and an LM's parameters, taken as plain ints and numpy arrays (this
package never imports the JAX one), so that both packages can hold the
same membership or compute the same model."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cabin import CabinParams
from repro_torch.device import resolve_device
from repro_torch.index.store import SketchSpec, SketchStore
from repro_torch.models import transformer as T


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


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    """A numpy array (bfloat16 arrays as ml_dtypes hands them out included)
    as a tensor on `device`."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def lm_params_from_reference(cfg: ModelConfig, tree: dict, device="cuda"
                             ) -> dict:
    """The port's LM parameters from the JAX package's `init_params` tree
    as numpy arrays: `embed.table` (`hashed_embed.table` for a CabinEmbed
    config), `stages[i]` (each layer's leaves
    stacked over the stage's repeat axis), `final_norm` and `lm_head`.
    Returns them unstacked, one dict per layer in layer order, so that
    both packages compute the same model."""
    device = resolve_device(device)

    def conv(x, r=None):
        if isinstance(x, dict):
            return {k: conv(v, r) for k, v in x.items()}
        return _tensor(x if r is None else np.asarray(x)[r], device)

    layers = []
    for stage, sp in zip(T.build_stages(cfg), tree["stages"]):
        for r in range(stage.n_repeat):
            layers.extend(conv(sp[f"l{i}"], r)
                          for i in range(len(stage.specs)))
    embed = "hashed_embed" if cfg.hashed_embedding else "embed"
    params = {embed: conv(tree[embed]), "layers": layers,
              "final_norm": conv(tree["final_norm"])}
    if "lm_head" in tree:
        params["lm_head"] = conv(tree["lm_head"])
    return params
