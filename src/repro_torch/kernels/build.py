"""Builds the CUDA kernels of `csrc/` with nvcc and loads them with ctypes.

Each `csrc/<name>.cu` becomes one shared library with a plain C interface
(`nvcc -shared`, no PyTorch headers, so a build takes seconds), placed in
`build/repro_torch/` at the root of the checkout under a name that carries
the hash of its sources and its own flags: a changed source or flag builds
anew, an unchanged one loads at once.  `build()` starts one nvcc per
missing source, all together, and waits for them.

`hamming`, `topk_select` and `cabin_build_sparse` build with
`--fmad=false`, so that no float multiply-add is contracted into an FMA
and their floats stay bit-identical to their plain versions; flash
attention, held at a tolerance, may contract.

Nothing here gives up quietly: a missing nvcc, a failed compile or a failed
launch raises RuntimeError with the compiler's output or the CUDA error.

`LAUNCHES` counts, per kernel, the launches its wrapper made: each wrapper
adds one where it launches (`count_launch`), and nowhere else, so a run
can show that its main path went through the kernels.

Kernels launch from several threads at once (bulk ingest's workers, the
front door's dispatcher): the first build and load of a library happens
under a lock, each build writes a temporary file of its own thread, and
the launch counts move under a lock.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("cabin_build", "cabin_build_sparse", "flash_attention", "hamming",
           "topk_select")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# per-source flags added to NVCC_FLAGS
EXTRA_FLAGS = {"cabin_build_sparse": ("--fmad=false",),
               "hamming": ("--fmad=false",),
               "topk_select": ("--fmad=false",)}
# the toolkit's standard install location, tried after CUDA_HOME and PATH
DEFAULT_CUDA_HOME = Path("/usr/local/cuda")

LAUNCHES = {"cabin_build": 0, "cabin_build_sparse": 0, "flash_attention": 0,
            "pair_stats": 0, "row_popcount": 0, "topk_select": 0}

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}
# held across a build and the first load of a library (re-entered by
# `function`, which builds), and around every change of LAUNCHES
_load_lock = threading.RLock()
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    """Add one launch of kernel `name` (its wrapper calls this right after
    a launch succeeds)."""
    with _count_lock:
        LAUNCHES[name] += 1


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then the default install."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = DEFAULT_CUDA_HOME / "bin" / "nvcc"
    if default.is_file():
        return str(default)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        f"{DEFAULT_CUDA_HOME}/bin): the CUDA kernels cannot be built")


def nvcc_flags(name: str) -> tuple[str, ...]:
    """The nvcc flags of `csrc/<name>.cu`."""
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def library_path(name: str) -> Path:
    """Where the built library for `csrc/<name>.cu` lives."""
    h = hashlib.sha256(" ".join(nvcc_flags(name)).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, Path]:
    """Compile every named source whose library is missing, one nvcc per
    source, all started together.  Returns name -> library path.  A
    second thread asking for the same libraries waits for the first's
    build and then finds them built."""
    with _load_lock:
        return _build(names)


def _build(names) -> dict[str, Path]:
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.is_file()}
    if not todo:
        return paths
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, out in todo.items():
        tmp = out.with_name(
            f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
        cmd = [nvcc, *nvcc_flags(name), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for name, tmp, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            errors.append(f"--- {name}.cu (nvcc exit {proc.returncode}) ---\n"
                          + log.decode(errors="replace"))
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return paths


def function(lib_name: str, fn_name: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry `fn_name` of library `lib_name` (built at first use),
    declared to take `argtypes` and return an int CUDA error code."""
    key = (lib_name, fn_name)
    fn = _fns.get(key)
    if fn is not None:
        return fn
    with _load_lock:
        fn = _fns.get(key)
        if fn is None:
            lib = _libs.get(lib_name)
            if lib is None:
                lib = ctypes.CDLL(str(build((lib_name,))[lib_name]))
                lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
                lib.repro_cuda_error_string.restype = ctypes.c_char_p
                _libs[lib_name] = lib
            fn = getattr(lib, fn_name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _fns[key] = fn
    return fn


def check(lib_name: str, kernel: str, code: int) -> None:
    """Raise if a launch entry returned a CUDA error."""
    if code:
        msg = _libs[lib_name].repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error "
                           f"{code} ({msg})")


def stream_ptr(device) -> ctypes.c_void_p:
    """PyTorch's current stream on `device`, for a launch entry."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def on_cuda(what: str, *tensors: torch.Tensor) -> bool:
    """Validate a wrapper's int32 inputs; True when they lie on one CUDA
    device (launch the kernel), False when on the CPU (plain version).
    Raises on any other dtype, layout or device."""
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: expected int32 tensors, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: expected contiguous tensors")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{what}: tensors on different devices {devices}")
    device = devices.pop()
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: unsupported device {device}")
    return device.type == "cuda"
