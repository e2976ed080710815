"""The port's LM serving path (repro_torch.configs / models / serve) against
the JAX package, on the CPU, for the four dense GQA configurations at
`reduced_for_smoke` size (2 layers, d_model 64, 4 heads, 2 KV heads where
the full model has more than one, head_dim 16, vocab 512, float32).

Both packages compute the same model: the JAX `init_params(PRNGKey(0))`
tree goes to numpy and through `lm_params_from_reference`.  Norm scales
and QKV biases are perturbed first (in both), so that a dropped scale or
bias shows.  Prompts come from numpy.

Tolerances: rtol = atol = 1e-4 for float32 logits and caches.  The two
packages run the same float32 operations in other summation orders (XLA's
dot vs torch.mm, and each attention's online softmax over its own KV
blocks), which moves logits of size ~4 by a few 1e-6 (measured up to
6e-6); 1e-4 leaves room for that and for nothing that is a different
function.  Greedy tokens must be equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs.registry import get_config as jget_config
from repro.models import transformer as JT
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.models import transformer as TT
from repro_torch.serve import ServeEngine

ARCHS = ("llama3_8b", "qwen2_7b", "internlm2_1_8b", "deepseek_7b")
PJ = jbase.ParallelConfig(remat="none", sequence_parallel=False)
RTOL = ATOL = 1e-4


def _perturb(tree, rng):
    """Norm scales 1 + N(0, 0.1) and biases N(0, 0.1), in place."""
    for key, val in tree.items():
        if isinstance(val, dict):
            _perturb(val, rng)
        elif key == "scale" or key in ("bq", "bk", "bv"):
            noise = rng.standard_normal(val.shape).astype(np.float32) * 0.1
            tree[key] = (val + noise).astype(val.dtype)


@functools.lru_cache(maxsize=None)
def _model(arch, bf16=False):
    cj = jbase.reduced_for_smoke(jget_config(arch))
    ct = tbase.reduced_for_smoke(treg.get_config(arch))
    if bf16:
        cj = dataclasses.replace(cj, precision=jbase.Precision())
        ct = dataclasses.replace(ct, precision=tbase.Precision())
    tree = jax.tree_util.tree_map(
        np.asarray, JT.init_params(cj, jax.random.PRNGKey(0)))
    tree["stages"] = list(tree["stages"])
    _perturb(tree, np.random.default_rng(1))
    pj = jax.tree_util.tree_map(jnp.asarray, tree)
    pt = convert.lm_params_from_reference(ct, tree, device="cpu")
    return cj, ct, pj, pt


def _tokens(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(3, cfg.vocab_size, (b, s)).astype(np.int32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def _same_fields(port, ref, where):
    """Every field of the port's dataclass equals the reference's field of
    that name, recursing into nested dataclasses and tuples of them."""
    if dataclasses.is_dataclass(port):
        for f in dataclasses.fields(port):
            _same_fields(getattr(port, f.name), getattr(ref, f.name),
                         f"{where}.{f.name}")
    elif isinstance(port, tuple):
        assert len(port) == len(ref), where
        for i, (a, b) in enumerate(zip(port, ref)):
            _same_fields(a, b, f"{where}[{i}]")
    else:
        assert port == ref, (where, port, ref)


def _dropped_at_default(port, ref, where, labels=("family",)):
    """The reference's fields the port leaves out hold their defaults in
    `ref` (other than pure labels), so leaving them out changes nothing."""
    kept = {f.name for f in dataclasses.fields(port)}
    for f in dataclasses.fields(ref):
        if f.name in kept or f.name in labels:
            continue
        default = (f.default_factory() if f.default_factory
                   is not dataclasses.MISSING else f.default)
        assert getattr(ref, f.name) == default, f"{where}.{f.name}"


def test_configs_equal_the_reference_field_for_field():
    for arch in ARCHS:
        jc, tc = jget_config(arch), treg.get_config(arch)
        _same_fields(tc, jc, arch)
        _dropped_at_default(tc, jc, arch)
        _dropped_at_default(tc.precision, jc.precision, f"{arch}.precision")
        _same_fields(tbase.reduced_for_smoke(tc),
                     jbase.reduced_for_smoke(jc), f"{arch} reduced")
    _same_fields(tbase.ParallelConfig(), jbase.ParallelConfig(),
                 "ParallelConfig")


@pytest.mark.parametrize("arch", ["deepseek_v3_671b", "dbrx_132b",
                                  "jamba_v0_1_52b", "xlstm_350m",
                                  "whisper_tiny", "phi_3_vision_4_2b"])
def test_other_architectures_name_their_slice(arch):
    with pytest.raises(NotImplementedError, match="slice"):
        treg.get_config(arch)


def test_unknown_architecture_raises_key_error():
    with pytest.raises(KeyError):
        treg.get_config("gpt2")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch):
    cj, ct, pj, pt = _model(arch)
    toks = _tokens(cj, 2, 12)
    want, _ = JT.forward(cj, pj, {"tokens": jnp.asarray(toks)}, PJ)
    got, aux = TT.forward(ct, pt, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and float(aux) == 0.0
    _close(got.numpy(), want)


def _stacked_cache(caches_j, name):
    """The reference's caches (one stage, stacked over layers) as
    (L, B, Hkv, max_len, ...)."""
    return np.asarray(caches_j[0]["l0"]["mixer"][name])


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_caches_match_reference(arch, kv_dtype):
    cj, ct, pj, pt = _model(arch)
    toks = _tokens(cj, 2, 11, seed=1)
    want, caches_j = JT.prefill(cj, pj, {"tokens": jnp.asarray(toks)}, 16,
                                PJ, kv_dtype)
    got, caches_t = TT.prefill(ct, pt, {"tokens": torch.from_numpy(toks)},
                               16, tbase.ParallelConfig(), kv_dtype)
    _close(got.numpy(), want)
    names = ["k", "v"] + (["k_scale", "v_scale"] if kv_dtype == "int8"
                          else [])
    for name in names:
        ref = _stacked_cache(caches_j, name)
        port = torch.stack([c["mixer"][name] for c in caches_t]).numpy()
        assert port.dtype == ref.dtype and port.shape == ref.shape
        if name in ("k", "v") and kv_dtype == "int8":
            np.testing.assert_array_equal(port, ref)
        else:
            _close(port, ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_logits_match_reference(arch):
    """Teacher-forced decode after a prefill: each step's logits and the
    cache it leaves equal the reference's."""
    cj, ct, pj, pt = _model(arch)
    toks = _tokens(cj, 2, 9, seed=2)
    _, caches_j = JT.prefill(cj, pj, {"tokens": jnp.asarray(toks[:, :6])},
                             12, PJ)
    _, caches_t = TT.prefill(ct, pt, {"tokens": torch.from_numpy(
        toks[:, :6])}, 12)
    for t in range(6, 9):
        want, caches_j = JT.decode_step(cj, pj, caches_j,
                                        jnp.asarray(toks[:, t:t + 1]),
                                        jnp.int32(t), PJ)
        got, caches_t = TT.decode_step(ct, pt, caches_t,
                                       torch.from_numpy(toks[:, t:t + 1]), t)
        assert got.shape == (2, 1, cj.vocab_size)
        _close(got.numpy(), want)
    port_k = torch.stack([c["mixer"]["k"] for c in caches_t]).numpy()
    _close(port_k, _stacked_cache(caches_j, "k"))


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_tokens_equal_reference(arch, kv_dtype):
    cj, ct, pj, pt = _model(arch)
    toks = _tokens(cj, 3, 7, seed=3)
    want = JServeEngine(cj, pj, dataclasses.replace(
        PJ, kv_cache_dtype=kv_dtype)).generate(jnp.asarray(toks), 5, 14)
    got = ServeEngine(ct, pt, tbase.ParallelConfig(kv_cache_dtype=kv_dtype),
                      device="cpu").generate(toks, 5, 14)
    assert got.steps == want.steps == 5
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_generate_keeps_the_logits_it_chose_from():
    cj, ct, pj, pt = _model("llama3_8b")
    toks = _tokens(cj, 2, 5, seed=4)
    engine = ServeEngine(ct, pt, device="cpu")
    res = engine.generate(toks, 3, 8, keep_logits=True)
    assert res.prefill_logits.shape == (2, 5, cj.vocab_size)
    assert res.step_logits.shape == (2, 3, cj.vocab_size)
    np.testing.assert_array_equal(res.tokens,
                                  res.step_logits.argmax(-1).numpy())
    torch.testing.assert_close(res.step_logits[:, 0],
                               res.prefill_logits[:, -1])
    with pytest.raises(ValueError, match="max_len"):
        engine.generate(toks, 4, 8)


def test_temperature_sampling_is_seeded_and_in_vocab():
    """Sampling draws from a torch.Generator: it repeats itself for one
    seed but cannot repeat the JAX package's stream, so it is checked for
    range and determinism only."""
    cj, ct, pj, pt = _model("qwen2_7b")
    engine = ServeEngine(ct, pt, device="cpu")
    toks = _tokens(cj, 2, 4, seed=5)
    a = engine.generate(toks, 4, 8, temperature=0.8, seed=11).tokens
    b = engine.generate(toks, 4, 8, temperature=0.8, seed=11).tokens
    np.testing.assert_array_equal(a, b)
    assert a.min() >= 0 and a.max() < cj.vocab_size


def test_bfloat16_forward_and_greedy_match_reference():
    """bfloat16 parameters and compute.  Both packages round to bf16 at the
    same places, but a float32 sum that lands within float32 noise of a
    bf16 rounding boundary rounds to neighbouring bf16 values in the two:
    one bf16 ulp (2**-8 of the value) there, which the following layers
    mix into every later value.  Each row of logits is held to 2**-5 of its
    largest magnitude (8 bf16 ulps at that scale; measured: 0.049 at row
    maxima near 4, 1.2%).  Greedy tokens must still be equal."""
    cj, ct, pj, pt = _model("llama3_8b", bf16=True)
    toks = _tokens(cj, 2, 10, seed=6)
    want, _ = JT.forward(cj, pj, {"tokens": jnp.asarray(toks)}, PJ)
    got, _ = TT.forward(ct, pt, {"tokens": torch.from_numpy(toks)})
    want = np.asarray(want, np.float32)
    err = np.abs(got.numpy() - want).max(-1)
    assert (err <= 2**-5 * np.abs(want).max(-1)).all(), err.max()
    want = JServeEngine(cj, pj, PJ).generate(jnp.asarray(toks), 4, 14)
    got = ServeEngine(ct, pt, device="cpu").generate(toks, 4, 14)
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_init_params_shapes_and_scales_match_reference():
    """The port's own random init: the reference's tree shapes and dtypes
    (unstacked), and its distributions (weights of std 1/sqrt(d_in),
    embeddings of std 0.02, unit norms)."""
    cj, ct, _, pt = _model("qwen2_7b")
    gen = torch.Generator().manual_seed(0)
    mine = TT.init_params(ct, gen, device="cpu")

    def leaves(tree, prefix=""):
        if isinstance(tree, torch.Tensor):
            yield prefix, tree
        elif isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}/{k}")
        else:
            for i, v in enumerate(tree):
                yield from leaves(v, f"{prefix}/{i}")

    want = {k: (v.shape, v.dtype) for k, v in leaves(pt)}
    got = {k: (v.shape, v.dtype) for k, v in leaves(mine)}
    assert got == want
    assert TT.count_params(mine) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(
            JT.init_params(cj, jax.random.PRNGKey(0))))
    wq = mine["layers"][0]["attn"]["wq"]
    assert abs(float(wq.std()) - ct.d_model ** -0.5) < 0.1 * ct.d_model ** -0.5
    assert abs(float(mine["embed"]["table"].std()) - 0.02) < 0.002
    assert torch.equal(mine["final_norm"]["scale"],
                       torch.ones(ct.d_model))
    assert not mine["layers"][0]["attn"]["bq"].any()
