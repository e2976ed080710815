"""The port's plain attention versions (`attention_ref`, `chunked_attention`)
against the JAX package's `attention_ref`, `chunked_attention` and the
Pallas `flash_attention` in interpret mode, on the CPU.  The flash kernel
(`csrc/flash_attention.cu`) is held against the same plain versions on
the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances, also the kernel's (`ref.tolerance`, where the reasons are):
1e-5 absolute for float32 inputs on unit-scale data, and for bfloat16
each output row within 2 bf16 ulps of the row's largest |value|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention.kernel import flash_attention as jflash
from repro.kernels.flash_attention.ref import attention_ref as jref
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops, ref


def assert_attention_close(got, want):
    """Within `ref.tolerance`, in units of which the error is reported."""
    ratio = ref.tolerance_ratio(got, want)
    assert ratio <= 1.0, f"error {ratio} x the tolerance"


def _from_jax(x, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32)).to(like.dtype)


def _inputs(b, hq, hkv, s, skv, dh, dv, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32) for shape in
            ((b, hq, s, dh), (b, hkv, skv, dh), (b, hkv, skv, dv))]
    if dtype == "bfloat16":
        jx = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrs]
        tx = [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]
    else:
        jx = [jnp.asarray(a) for a in arrs]
        tx = [torch.from_numpy(a) for a in arrs]
    return jx, tx


# (b, hq, hkv, s, skv, dh, dv): groups 1 / 2 / 4, S not a multiple of any
# block, Skv != S, Dh_v != Dh
CASES = [
    (1, 2, 2, 64, 64, 32, 32),
    (2, 4, 2, 100, 100, 16, 16),
    (1, 8, 2, 37, 37, 32, 48),
    (1, 4, 1, 72, 130, 16, 32),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_plain_versions_match_reference(case, causal, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(*case, dtype)
    got = ref.attention_ref(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype
    want = _from_jax(jref(jq, jk, jv, causal=causal), got)
    assert_attention_close(got, want)
    got_c = ref.chunked_attention(tq, tk, tv, causal=causal, block=32)
    assert_attention_close(got_c, _from_jax(jops.chunked_attention(
        jq, jk, jv, causal=causal, block=32), got))
    assert_attention_close(got_c, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", [c for c in CASES if c[3] == c[4]],
                         ids=lambda c: "x".join(map(str, c)))
def test_plain_version_matches_pallas_kernel_in_interpret_mode(case, causal,
                                                               dtype):
    """The TPU kernel takes S == Skv here, one block per sequence (its
    blocks must divide S, which the port's kernel does not require)."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(*case, dtype, seed=1)
    got = ops.flash_attention(tq, tk, tv, causal=causal)  # CPU: plain
    assert_attention_close(got, _from_jax(
        jflash(jq, jk, jv, causal=causal, interpret=True), got))


def test_dispatcher_on_the_cpu():
    (_, _, _), (q, k, v) = _inputs(1, 4, 2, 40, 40, 16, 16, "float32")
    before = dict(build.LAUNCHES)
    want = ref.attention_ref(q, k, v)
    torch.testing.assert_close(ops.attention(q, k, v), ref.chunked_attention(
        q, k, v), rtol=0, atol=0)
    torch.testing.assert_close(ops.attention(q, k, v, impl="ref"), want,
                               rtol=0, atol=0)
    assert_attention_close(ops.attention(q, k, v, impl="chunked"), want)
    with pytest.raises(ValueError, match="CUDA"):
        ops.attention(q, k, v, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        ops.attention(q, k, v, impl="pallas")
    assert build.LAUNCHES == before


def test_tolerance_is_two_bf16_ulps_per_row_or_1e_5():
    want = torch.tensor([[1.0, -0.5], [0.0, 3.0]])
    assert torch.equal(ref.tolerance(want.to(torch.bfloat16)),
                       torch.tensor([[2 * 2.0**-7], [2 * 2.0**-6]]))
    assert torch.equal(ref.tolerance(want), torch.full((2, 1), 1e-5))
    assert ref.tolerance_ratio(want + 2e-5, want) == pytest.approx(2.0,
                                                                   rel=1e-2)
