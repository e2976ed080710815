"""CabinEmbed (the hashed vocabulary embedding) on the port's LM against the
JAX package, on the CPU, at `reduced_for_smoke(llama3_8b)` size (2 layers,
d_model 64, vocab 512, float32) with 64 buckets and k = 2, the
reference's own smoke test settings (`tests/test_models_smoke.py`).

Both packages compute the same model: the JAX `init_params(PRNGKey(0))`
tree goes to numpy and through `lm_params_from_reference`, which carries
`hashed_embed.table` across.  Bucket ids and signs, and the embeddings
(gathers and signs of the same table), are bit-identical; logits and
caches are held to rtol = atol = 1e-4 as in `test_torch_lm.py` (the same
float32 operations in other summation orders); greedy tokens are equal.
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
from repro.models import hashed_embedding as JH
from repro.models import transformer as JT
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.models import hashed_embedding as TH
from repro_torch.models import transformer as TT
from repro_torch.serve import ServeEngine

PJ = jbase.ParallelConfig(remat="none", sequence_parallel=False)
RTOL = ATOL = 1e-4
HASHED = dict(hashed_embedding=True, hashed_embedding_buckets=64,
              hashed_embedding_k=2)


def _configs(k=2, buckets=64, arch="llama3_8b"):
    kw = dict(HASHED, hashed_embedding_k=k, hashed_embedding_buckets=buckets)
    cj = dataclasses.replace(jbase.reduced_for_smoke(jget_config(arch)),
                             **kw)
    ct = dataclasses.replace(tbase.reduced_for_smoke(treg.get_config(arch)),
                             **kw)
    return cj, ct


@functools.lru_cache(maxsize=None)
def _model(k=2):
    cj, ct = _configs(k)
    tree = jax.tree_util.tree_map(
        np.asarray, JT.init_params(cj, jax.random.PRNGKey(0)))
    tree["stages"] = list(tree["stages"])
    pj = jax.tree_util.tree_map(jnp.asarray, tree)
    pt = convert.lm_params_from_reference(ct, tree, device="cpu")
    return cj, ct, tree, pj, pt


def _tokens(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL)


def test_config_fields_default_as_the_reference():
    for f in ("hashed_embedding", "hashed_embedding_buckets",
              "hashed_embedding_k"):
        want = jbase.ModelConfig.__dataclass_fields__[f].default
        assert tbase.ModelConfig.__dataclass_fields__[f].default == want
    cj, ct = _configs()
    for f in HASHED:
        assert getattr(ct, f) == getattr(cj, f)


@pytest.mark.parametrize("j", [0, 1, 3])
def test_buckets_and_signs_bit_identical(j):
    cj, ct = _configs(k=4, buckets=16384)
    ids = np.arange(128256, dtype=np.int32)
    bj, sj = JH._bucket_and_sign(cj, jnp.asarray(ids), j)
    bt, st = TH._bucket_and_sign(ct, torch.from_numpy(ids), j)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("k", [1, 2, 3])
def test_hashed_embed_bit_identical_and_logits_close(k):
    cj, ct, _, pj, pt = _model(k)
    toks = _tokens(cj, 3, 9, seed=k)
    want = JH.hashed_embed(cj, pj["hashed_embed"], jnp.asarray(toks))
    got = TH.hashed_embed(ct, pt["hashed_embed"], torch.from_numpy(toks))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = np.random.default_rng(k).standard_normal((2, 5, ct.d_model)
                                                  ).astype(np.float32)
    want = JH.hashed_logits(cj, pj["hashed_embed"], jnp.asarray(x))
    got = TH.hashed_logits(ct, pt["hashed_embed"], torch.from_numpy(x))
    assert got.shape == (2, 5, ct.vocab_size) and got.dtype == torch.float32
    _close(got.numpy(), want)


@pytest.mark.parametrize("k", [1, 2])
def test_forward_logits_match_reference(k):
    cj, ct, _, pj, pt = _model(k)
    toks = _tokens(cj, 2, 12)
    want, _ = JT.forward(cj, pj, {"tokens": jnp.asarray(toks)}, PJ)
    got, aux = TT.forward(ct, pt, {"tokens": torch.from_numpy(toks)})
    assert float(aux) == 0.0
    _close(got.numpy(), want)


def test_prefill_and_decode_match_reference():
    cj, ct, _, pj, pt = _model()
    toks = _tokens(cj, 2, 8, seed=3)
    lj, cache_j = JT.prefill(cj, pj, {"tokens": jnp.asarray(toks)}, 16, PJ)
    lt, cache_t = TT.prefill(ct, pt, {"tokens": torch.from_numpy(toks)}, 16)
    _close(lt.numpy(), lj)
    nxt = _tokens(cj, 2, 1, seed=4)
    dj, _ = JT.decode_step(cj, pj, cache_j, jnp.asarray(nxt), 8)
    dt_, _ = TT.decode_step(ct, pt, cache_t, torch.from_numpy(nxt), 8)
    _close(dt_.numpy(), dj)


def test_generate_greedy_tokens_equal_reference():
    cj, ct, _, pj, pt = _model()
    toks = _tokens(cj, 2, 10, seed=5)
    want = JServeEngine(cj, pj, PJ).generate(jnp.asarray(toks), 6, 20)
    got = ServeEngine(ct, pt, device="cpu").generate(toks, 6, 20)
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_init_params_shapes_match_reference():
    cj, ct, tree, _, pt = _model()
    mine = TT.init_params(ct, torch.Generator().manual_seed(0), device="cpu")
    assert "embed" not in mine and "lm_head" not in mine
    table = mine["hashed_embed"]["table"]
    assert table.shape == (64, ct.d_model) and table.dtype == torch.float32
    assert abs(float(table.std()) - 0.02) < 0.004
    assert TT.count_params(mine) == TT.count_params(pt) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(tree))
    TT.check_supported(ct)


def test_convert_carries_the_hashed_table():
    _, ct, tree, _, pt = _model()
    np.testing.assert_array_equal(pt["hashed_embed"]["table"].numpy(),
                                  tree["hashed_embed"]["table"])
    with pytest.raises(KeyError):
        convert.lm_params_from_reference(
            dataclasses.replace(ct, hashed_embedding=False), tree,
            device="cpu")
