"""The Mergeable contract: one combine discipline for every index layer.

The port of the JAX package's `repro.index.mergeable`.  A sketch of A ∪ B
is the bitwise OR of the sketches of A and B, so partial indexes built
anywhere can be combined in any tree shape and served as if built in
sequence.  Every layer that holds derived state implements the contract:

  * `Mergeable`: ``merge(other) -> self`` absorbs `other`'s state into
    `self`.  `other` is never mutated, but must be discarded after a
    successful merge: re-merging it raises the id-disjointness check.
  * associativity: ``a.merge(b).merge(c)`` equals ``a.merge(b.merge(c))``
    bit for bit.
  * id-disjointness (`check_id_disjoint`): disjoint external ids keep the
    merged slot order equal to id order.
  * spec compatibility (`check_spec_compatible`): packed bits are
    meaningless across sketch specs, and a hash-seed mismatch cannot be
    seen from the bits, so every merge starts with this check, the same
    one the spec migration (index/migrate.py) runs on its own tiers.

Implementations: `SketchStore.merge`, `RawArchive.merge`,
`PartitionSet.merge`, `QueryEngine.merge` and `obs.MetricsRegistry.merge`.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np


class MergeIncompatible(ValueError):
    """Two states cannot be merged: spec mismatch, overlapping ids, or
    differing serving configuration.  A ValueError because the caller
    passed an unusable operand — nothing about either input was mutated."""


def _fmt_spec(spec) -> str:
    """One-line spec identity for error messages: version + dims + seeds
    (SketchSpec.meta() when available, repr otherwise — None included)."""
    meta = getattr(spec, "meta", None)
    if callable(meta):
        m = meta()
        return (f"spec(v{m['version']}, n_dims={m['n_dims']}, "
                f"d={m['sketch_dim']}, psi_seed={m['psi_seed']}, "
                f"pi_seed={m['pi_seed']})")
    return repr(spec)


def check_spec_compatible(a, b, *, what: str, hint: str | None = None) -> None:
    """Raise MergeIncompatible unless `a` and `b` are the SAME sketch-space
    identity (SketchSpec equality: version AND CabinParams — dims and both
    hash seeds).  `what` names the operation for the message; `hint` adds
    a remedy line.  None specs are compatible only with None (a spec-less
    store merging into a spec'd one would launder unknown bits into a
    known space)."""
    if a == b:
        return
    msg = (f"{what}: incompatible sketch specs — {_fmt_spec(a)} vs "
           f"{_fmt_spec(b)}.  Packed rows are only comparable under one "
           "spec; a hash-seed mismatch is undetectable from the bits "
           "alone and would silently corrupt every distance.")
    if hint is None and getattr(a, "params", 0) != getattr(b, "params", 1):
        hint = ("Re-sketch one side under the other's spec "
                "(QueryEngine.migrate) before merging")
    if hint:
        msg += f"  {hint}."
    raise MergeIncompatible(msg)


def check_id_disjoint(a_ids: np.ndarray, b_ids: np.ndarray, *,
                      what: str) -> None:
    """Raise MergeIncompatible if the two (ascending) external-id sets
    overlap.  Overlap means the inputs are not independent partial builds
    — most often one of them was already merged (the Mergeable contract
    says discard `other` after absorbing it)."""
    common = np.intersect1d(np.asarray(a_ids, np.int64),
                            np.asarray(b_ids, np.int64))
    if len(common):
        raise MergeIncompatible(
            f"{what}: merge inputs share {len(common)} external id(s) "
            f"(e.g. id {int(common[0])}) — inputs must be id-disjoint "
            "independent builds.  Re-merging an already-absorbed input is "
            "the usual cause; discard an input after a successful merge.")


@runtime_checkable
class Mergeable(Protocol):
    """Associative, id-disjoint, spec-checked combine (module docstring).

    ``a.merge(b)`` absorbs `b` into `a` and returns `a`; `b` is left
    readable but must be discarded (its ids are now absorbed — a second
    merge raises).  Implementations validate BEFORE mutating anything, so
    a refused (or faultinject-killed) merge leaves both inputs intact and
    the call re-runnable."""

    def merge(self, other):  # pragma: no cover - protocol signature only
        ...
