"""Rules of the PyTorch port that its parity tests cannot show:

  * the port and chip_smoke.py import neither JAX nor the JAX package;
  * entry points run on CUDA unless asked for the CPU, and refuse CUDA
    where there is none, with no quiet fallback;
  * the kernel loader raises when nvcc is missing, never returns None;
  * each kernel wrapper refuses tensors its kernel does not take.
"""

import ast
import inspect
from pathlib import Path

import pytest
import torch

from repro_torch import convert
from repro_torch.core import CabinParams
from repro_torch.index import QueryEngine, SketchStore
from repro_torch.kernels import build
from repro_torch.kernels.cabin_build_sparse import ops as sparse_ops
from repro_torch.kernels.hamming import ops as hamming_ops
from repro_torch.kernels.topk_select import ops as topk_ops

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            yield node.lineno, node.args[0].value


def test_port_files_exist():
    assert (ROOT / "chip_smoke.py").is_file()
    assert len(PORT_FILES) > 10


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_package_imports(path):
    bad = [(line, mod) for line, mod in _imports(path) if _forbidden(mod)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_scan_catches_forbidden_forms(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text(
        "import jax\nfrom jax import numpy\nimport repro.core\n"
        "from repro.index import QueryEngine\nimport repro_torch\n"
        "importlib.import_module('repro.core')\n")
    found = [mod for _, mod in _imports(probe) if _forbidden(mod)]
    assert found == ["jax", "jax", "repro.core", "repro.index", "repro.core"]


def test_entry_points_default_to_cuda():
    for fn in (QueryEngine.__init__, SketchStore.__init__,
               convert.store_from_reference):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_engine_without_device_raises_where_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = CabinParams.create(100, 64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        QueryEngine(params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SketchStore(64)
    assert len(QueryEngine(params, device="cpu")) == 0


def test_loader_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME", tmp_path / "cuda")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "_fns", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.function("hamming", "pair_stats_launch", ())
    assert not (tmp_path / "build").exists()


def _i32(*shape):
    return torch.arange(int(torch.tensor(shape).prod()),
                        dtype=torch.int32).reshape(shape)


WRAPPERS = {
    "cabin_build_sparse": lambda a, b: sparse_ops.cabin_build_sparse(
        a, b, d=64, psi_seed=1, pi_seed=2),
    "pair_stats": lambda a, b: hamming_ops.pair_stats(a, b),
    "row_popcount": lambda a, b: (hamming_ops.row_popcount(a),
                                  hamming_ops.row_popcount(b)),
    "topk_select": lambda a, b: topk_ops.topk_select(a, b, 2, d=64),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrappers_refuse_int64(name):
    with pytest.raises(TypeError, match="int32"):
        WRAPPERS[name](_i32(4, 4).to(torch.int64), _i32(4, 4))
    with pytest.raises(TypeError, match="int32"):
        WRAPPERS[name](_i32(4, 4), _i32(4, 4).to(torch.int64))


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrappers_refuse_non_contiguous(name):
    strided = _i32(4, 8)[:, ::2]
    assert not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        WRAPPERS[name](strided, _i32(4, 4))


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrappers_refuse_other_devices(name):
    """Only a CPU tensor reaches the plain version; anything that is not
    CUDA or CPU raises instead of falling back."""
    meta = torch.empty((4, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        WRAPPERS[name](meta, meta)


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrappers_on_cpu_run_the_plain_version_without_counting(name):
    before = dict(build.LAUNCHES)
    WRAPPERS[name](_i32(4, 4), _i32(4, 4))
    assert build.LAUNCHES == before


def test_topk_select_kernel_cap_is_enforced_only_for_the_kernel():
    q, b = _i32(2, 3), _i32(300, 3)
    vals, idxs = topk_ops.topk_select(q, b, topk_ops.MAX_K + 1, d=96)
    assert vals.shape == (2, topk_ops.MAX_K + 1)
