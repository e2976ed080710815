"""Checkpointing: tree save/restore with async writes, retention and
integrity verification.  The port of the JAX package's
`repro.checkpoint.checkpointer`, on the same on-disk format, so that a
step either package writes restores in the other.

Layout per step:  <dir>/step_<n>/arrays.npz  +  meta.json
Arrays are keyed by their tree path ("store/sk", "raw/offsets", ...);
meta.json stores the path list and a per-array integrity record (CRC32 of
the raw bytes, shape, dtype) written at save and verified at restore.  A
mismatch, truncation, or unreadable file raises `CheckpointCorruptError`
naming the step and the array key, and `restore(step=None)` falls back to
the newest INTACT step.

Trees are nested dicts (or lists / tuples) whose leaves are numpy arrays
or torch tensors; a tensor is copied to the host at save.  `restore`
places the arrays as tensors on `device` ("cuda" unless the caller asks
for the CPU).

Crash safety: writes land in a `.tmp_step_<n>` staging directory and are
published by one atomic os.rename; a crash mid-save leaves only the staging
dir, which the next Checkpointer construction sweeps.  The save path
carries the four ``checkpointer.save.*`` crash points
(repro_torch.runtime.faultinject).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
import zipfile
import zlib

import numpy as np
import torch

from repro_torch.device import resolve_device, to_host
from repro_torch.runtime import faultinject

# the save path's crash points, in execution order (see module docstring)
_CP_TMP_WRITTEN = faultinject.declare("checkpointer.save.tmp_written")
_CP_ARRAYS_WRITTEN = faultinject.declare("checkpointer.save.arrays_written")
_CP_META_WRITTEN = faultinject.declare("checkpointer.save.meta_written")
_CP_PUBLISHED = faultinject.declare("checkpointer.save.published")


class CheckpointCorruptError(RuntimeError):
    """A checkpoint step failed integrity verification.  Carries the step
    and the offending array key (None when the damage is file-level, e.g. a
    truncated archive or unreadable meta.json)."""

    def __init__(self, step: int, key: str | None, reason: str):
        where = f"step {step}" + (f", array {key!r}" if key else "")
        super().__init__(f"corrupt checkpoint at {where}: {reason}")
        self.step = step
        self.key = key


def _leaves(tree, prefix: tuple = ()):
    """(path, leaf) pairs in the order JAX's tree flattening gives them:
    dict keys sorted, sequences by index, None an empty subtree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    elif tree is not None:
        yield "/".join(prefix), tree


def tree_to_flat(tree) -> dict[str, np.ndarray]:
    """{"a/b": host array} of a nested tree's leaves."""
    return {path: to_host(leaf) for path, leaf in _leaves(tree)}


def flat_to_tree(flat: dict, like):
    """The tree of `like`'s structure whose leaves are `flat`'s entries
    at the same paths."""

    def build(node, prefix: tuple):
        if isinstance(node, dict):
            return {k: build(v, prefix + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, prefix + (str(i),))
                              for i, v in enumerate(node))
        if node is None:
            return None
        return flat["/".join(prefix)]

    return build(like, ())


def _array_record(a: np.ndarray) -> dict:
    return {
        "crc32": zlib.crc32(np.ascontiguousarray(a).tobytes()),
        "shape": list(a.shape),
        "dtype": str(a.dtype),
    }


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._pending: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)
        self._sweep_orphans()

    def _sweep_orphans(self) -> None:
        """Delete `.tmp_step_*` staging dirs left by a crash mid-save (a
        crashed save can never be resumed, and a later save of the same
        step must not mix its files with the corpse's)."""
        for name in os.listdir(self.directory):
            if name.startswith(".tmp_step_"):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    # -- steps --------------------------------------------------------------
    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(
                    os.path.join(self.directory, name, "meta.json")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def latest_intact_step(self) -> int | None:
        """Newest step that passes full integrity verification (None if no
        step does) — what `restore(step=None)` actually resolves to."""
        for step in reversed(self.all_steps()):
            try:
                self.verify(step)
                return step
            except CheckpointCorruptError:
                continue
        return None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree, extra_meta: dict | None = None,
             block: bool = False) -> None:
        self.wait()  # one outstanding async save at a time
        flat = tree_to_flat(tree)  # host copy happens synchronously

        def _write():
            tmp = os.path.join(self.directory, f".tmp_step_{step}")
            final = os.path.join(self.directory, f"step_{step}")
            # never build on a previous attempt's staging files
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            faultinject.crash_point(_CP_TMP_WRITTEN)
            np.savez(os.path.join(tmp, "arrays.npz"), **flat)
            faultinject.crash_point(_CP_ARRAYS_WRITTEN)
            meta = {
                "step": step,
                "time": time.time(),
                "paths": sorted(flat.keys()),
                "arrays": {k: _array_record(v) for k, v in flat.items()},
                **(extra_meta or {}),
            }
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            faultinject.crash_point(_CP_META_WRITTEN)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic publish
            faultinject.crash_point(_CP_PUBLISHED)
            self._gc()

        if self.async_save and not block:
            self._pending = threading.Thread(target=_write, daemon=True)
            self._pending.start()
        else:
            _write()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    # -- integrity ----------------------------------------------------------
    def verify(self, step: int) -> dict[str, np.ndarray]:
        """Load step `step` and verify it against its integrity record:
        every recorded path present, shapes/dtypes matching, CRC32 of the
        raw bytes equal.  Returns the verified flat host arrays.  Raises
        CheckpointCorruptError naming the step and the first offending
        array key."""
        path = os.path.join(self.directory, f"step_{step}")
        try:
            with open(os.path.join(path, "meta.json")) as f:
                meta = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise CheckpointCorruptError(step, None,
                                         f"unreadable meta.json ({e})")
        try:
            with np.load(os.path.join(path, "arrays.npz")) as data:
                flat = {k: data[k] for k in data.files}
        except (OSError, ValueError, zipfile.BadZipFile, KeyError) as e:
            # a truncated npz surfaces as BadZipFile or a zlib ValueError
            # mid-member read, depending on where the bytes stop
            raise CheckpointCorruptError(
                step, None, f"unreadable arrays.npz ({e})")
        records = meta.get("arrays")
        for key in meta.get("paths", []):
            if key not in flat:
                raise CheckpointCorruptError(
                    step, key, "array missing from arrays.npz")
            if records is None:
                continue  # pre-integrity snapshot: presence check only
            rec, a = records.get(key), flat[key]
            if rec is None:
                continue
            if list(a.shape) != rec["shape"] or str(a.dtype) != rec["dtype"]:
                raise CheckpointCorruptError(
                    step, key,
                    f"shape/dtype {a.shape}/{a.dtype} != recorded "
                    f"{tuple(rec['shape'])}/{rec['dtype']}")
            crc = zlib.crc32(np.ascontiguousarray(a).tobytes())
            if crc != rec["crc32"]:
                raise CheckpointCorruptError(
                    step, key,
                    f"CRC32 mismatch ({crc:#010x} != {rec['crc32']:#010x})")
        return flat

    def _verified(self, step: int | None) -> tuple[dict, int]:
        """The verified flat arrays of `step`, or of the newest intact
        step when `step` is None."""
        if step is not None:
            return self.verify(step), step
        steps = self.all_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        first_err: CheckpointCorruptError | None = None
        for s in reversed(steps):
            try:
                return self.verify(s), s
            except CheckpointCorruptError as e:
                first_err = first_err or e
        raise CheckpointCorruptError(
            first_err.step, first_err.key,
            f"no intact step in {self.directory} "
            f"(newest failure: {first_err})")

    # -- restore ------------------------------------------------------------
    def restore(self, like=None, step: int | None = None, device="cuda"):
        """(tree, step): the verified arrays of `step` as tensors on
        `device`, in the structure of `like` (each leaf cast to the dtype
        of `like`'s leaf at the same path), or as the flat {path: tensor}
        dict when `like` is None.

        step=None restores the newest step that passes integrity
        verification, skipping (not deleting) corrupt ones; an explicit
        step that fails verification raises CheckpointCorruptError."""
        device = resolve_device(device)
        flat, step = self._verified(step)
        tensors = {k: torch.from_numpy(np.ascontiguousarray(a)).to(device)
                   for k, a in flat.items()}
        if like is None:
            return tensors, step
        tree = flat_to_tree(tensors, like)

        def cast(ref, got):
            if isinstance(ref, dict):
                return {k: cast(ref[k], got[k]) for k in ref}
            if isinstance(ref, (list, tuple)):
                return type(ref)(cast(r, g) for r, g in zip(ref, got))
            if torch.is_tensor(ref):
                return got.to(ref.dtype)
            if hasattr(ref, "dtype"):
                return got.to(torch.as_tensor(np.zeros(0, ref.dtype)).dtype)
            return got

        return cast(like, tree), step

    def meta(self, step: int) -> dict:
        with open(os.path.join(self.directory, f"step_{step}",
                               "meta.json")) as f:
            return json.load(f)
