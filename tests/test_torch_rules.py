"""Rules of the PyTorch port that its parity tests cannot show:

  * the port and chip_smoke.py import neither JAX nor the JAX package;
  * entry points run on CUDA unless asked for the CPU, and refuse CUDA
    where there is none, with no quiet fallback;
  * the kernel loader raises when nvcc is missing, never returns None;
  * each kernel wrapper refuses tensors its kernel does not take, and
    asking for the attention kernel on the CPU raises.
"""

import ast
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs.base import ParallelConfig, reduced_for_smoke
from repro_torch.configs.registry import get_config
from repro_torch.core import CabinParams
from repro_torch.index import QueryEngine, SketchStore
from repro_torch.kernels import build
from repro_torch.kernels.cabin_build import ops as dense_ops
from repro_torch.kernels.cabin_build_sparse import ops as sparse_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import transformer as T
from repro_torch.serve import ServeEngine
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
               convert.store_from_reference, ServeEngine.__init__,
               T.init_params, T.init_caches,
               convert.lm_params_from_reference):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_engine_without_device_raises_where_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = CabinParams.create(100, 64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        QueryEngine(params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SketchStore(64)
    assert len(QueryEngine(params, device="cpu")) == 0


def test_lm_entry_points_raise_where_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_for_smoke(get_config("llama3_8b"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.init_caches(cfg, 1, 8)
    params = T.init_params(cfg, torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(cfg, params)
    assert ServeEngine(cfg, params, device="cpu").generate(
        np.ones((1, 3), np.int32), 2, 5).tokens.shape == (1, 2)


def test_attention_kernel_on_the_cpu_raises():
    cfg = reduced_for_smoke(get_config("llama3_8b"))
    params = T.init_params(cfg, torch.Generator(), device="cpu")
    tokens = torch.ones((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        T.forward(cfg, params, {"tokens": tokens},
                  ParallelConfig(attention_impl="kernel"))
    for impl in (None, "chunked", "ref"):
        T.forward(cfg, params, {"tokens": tokens},
                  ParallelConfig(attention_impl=impl))


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


def test_per_source_nvcc_flags(monkeypatch):
    """The bit-identical kernels keep --fmad=false; the rest may contract,
    and a source's own flags are part of its library's name."""
    for name in build.SOURCES:
        strict = name in ("cabin_build_sparse", "hamming", "topk_select")
        assert ("--fmad=false" in build.nvcc_flags(name)) == strict, name
        assert set(build.NVCC_FLAGS) <= set(build.nvcc_flags(name))
    assert set(build.SOURCES) == {p.stem for p in build.CSRC.glob("*.cu")}
    before = {n: build.library_path(n) for n in build.SOURCES}
    monkeypatch.setitem(build.EXTRA_FLAGS, "flash_attention", ("-lineinfo",))
    after = {n: build.library_path(n) for n in build.SOURCES}
    assert [n for n in build.SOURCES if before[n] != after[n]] == [
        "flash_attention"]


def _i32(*shape):
    return torch.arange(int(torch.tensor(shape).prod()),
                        dtype=torch.int32).reshape(shape)


WRAPPERS = {
    "cabin_build": lambda a, b: (
        dense_ops.cabin_build(a, d=64, psi_seed=1, pi_seed=2),
        dense_ops.cabin_build(b, d=64, psi_seed=1, pi_seed=2)),
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
    want = topk_ops.topk_select_ref(q, b, topk_ops.MAX_K + 1, d=96)
    assert torch.equal(vals, want[0]) and torch.equal(idxs, want[1])


def _f32(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("bad,match", [
    (lambda q: (q.to(torch.float16), q, q), "bfloat16 or float32"),
    (lambda q: (q.to(torch.int32), q, q), "bfloat16 or float32"),
    (lambda q: (q, q.to(torch.bfloat16), q), "mixed dtypes"),
    (lambda q: (q.transpose(2, 3), q, q), "contiguous"),
    (lambda q: (q.to("meta"), q.to("meta"), q.to("meta")), "device"),
    (lambda q: (q[0], q, q), "4-d"),
    (lambda q: (_f32(1, 3, 8, 16), _f32(1, 2, 8, 16), _f32(1, 2, 8, 16)),
     "multiple"),
    (lambda q: (_f32(1, 2, 8, 24), _f32(1, 2, 8, 24), _f32(1, 2, 8, 16)),
     "Dh=24"),
    (lambda q: (_f32(1, 2, 8, 272), _f32(1, 2, 8, 272), _f32(1, 2, 8, 16)),
     "Dh=272"),
    (lambda q: (q, q, _f32(1, 2, 8, 8)), "Dh_v=8"),
    (lambda q: (q, _f32(1, 2, 0, 16), _f32(1, 2, 0, 16)), "Skv = 0"),
    (lambda q: (q, _f32(1, 2, 5, 16), q), "do not fit"),
], ids=["f16", "int32", "mixed", "strided", "meta", "3d", "groups",
        "dh24", "dh272", "dv8", "no-keys", "shapes"])
def test_flash_attention_wrapper_refuses(bad, match):
    q = _f32(1, 2, 8, 16)
    with pytest.raises((TypeError, ValueError), match=match):
        flash_ops.flash_attention(*bad(q))


def test_flash_attention_wrapper_on_cpu_takes_unaligned_bfloat16():
    """Only the CUDA kernel copies 16-byte pieces; the plain version takes a
    bfloat16 tensor at any offset."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((1, 2, 8, 16), generator=gen).bfloat16()
    shifted = torch.empty(q.numel() + 1, dtype=torch.bfloat16)[1:].view(
        q.shape)
    shifted.copy_(q)
    assert shifted.data_ptr() % 16
    assert torch.equal(flash_ops.flash_attention(shifted, q, q),
                       flash_ops.attention_ref(q, q, q))


def test_flash_attention_wrapper_on_cpu_runs_the_plain_version_uncounted():
    q = torch.randn((1, 4, 8, 16), generator=torch.Generator().manual_seed(0))
    k = q[:, :2].contiguous()
    before = dict(build.LAUNCHES)
    assert torch.equal(flash_ops.flash_attention(q, k, k),
                       flash_ops.attention_ref(q, k, k))
    assert build.LAUNCHES == before
