"""Checkpoints of the PyTorch port: the Checkpointer's contracts, the
engine's save / restore and migration journal, and snapshots carried
across between the port and the JAX package in both directions.

  * round trip of nested trees of numpy arrays and tensors, retention
    (`keep`), the orphan sweep, async save;
  * corruption (CRC, shape, truncation) is named and skipped;
  * the four ``checkpointer.save.*`` crash points in raise mode (and one
    in exit mode, in a child process only), the engine's crash matrix over
    the migration's points: recovery from disk finds an intact step and
    ends bit-identical to the never-crashed run;
  * engine save / restore and journal resume are bit-identical;
  * a ``repro.index.v2`` snapshot (with or without a migration in flight)
    written by either package restores in the other, and a reference
    ``repro.index.v1`` snapshot restores in the port;
  * `metric` / `keep_raw` overrides on restore are refused, and the
    restore entry points run on CUDA unless asked for the CPU.
"""

import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_merge import (assert_answers_as_jax,
                              assert_same_answers, assert_same_store,
                              jax_engine, port_engine, rows, tparams)
from test_torch_migrate import D_NEW, JP_NEW
from test_torch_parity import assert_ids_equal_but_ties

from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
from repro.index import QueryEngine as JaxEngine
from repro_torch.checkpoint import (CheckpointCorruptError, Checkpointer,
                                    flat_to_tree, tree_to_flat)
from repro_torch.index import QueryEngine
from repro_torch.runtime import faultinject

SRC = str(Path(__file__).resolve().parents[1] / "src")
SAVE_POINTS = ("checkpointer.save.tmp_written",
               "checkpointer.save.arrays_written",
               "checkpointer.save.meta_written",
               "checkpointer.save.published")
MIGRATE_POINTS = ("migrate.start", "migrate.batch.resketched",
                  "migrate.batch.committed", "migrate.fold",
                  "migrate.published")


@pytest.fixture(autouse=True)
def fi_clean():
    yield
    faultinject.disarm()
    faultinject.record_hits(False)
    faultinject.clear_hits()


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.random((5, 7)).astype(np.float32),
            "ids": np.arange(seed, seed + 4, dtype=np.int64),
            "sub": {"t": torch.arange(6, dtype=torch.int32).reshape(2, 3),
                    "alive": np.array([True, False])}}


def _assert_tree(flat, seed):
    want = tree_to_flat(_tree(seed))
    assert sorted(flat) == sorted(want) == ["ids", "sub/alive", "sub/t", "w"]
    for k, v in want.items():
        got = flat[k].numpy() if torch.is_tensor(flat[k]) else flat[k]
        assert got.dtype == v.dtype, k
        np.testing.assert_array_equal(got, v)


# ---------------------------------------------------------------------------
# the Checkpointer
# ---------------------------------------------------------------------------


def test_round_trip_keep_and_async(tmp_path):
    d = str(tmp_path)
    ck = Checkpointer(d, keep=2, async_save=True)
    for step in range(4):
        ck.save(step, _tree(step))
    ck.wait()
    assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
    flat, step = ck.restore(device="cpu")
    assert step == 3
    _assert_tree(flat, 3)
    like = {"w": torch.zeros(1, dtype=torch.float64),
            "ids": np.zeros(0, np.int32),
            "sub": {"t": torch.zeros(1, dtype=torch.int64),
                    "alive": np.zeros(0, bool)}}
    tree, step = ck.restore(like, step=2, device="cpu")
    assert step == 2 and tree["w"].dtype == torch.float64
    assert tree["ids"].dtype == torch.int32
    assert tree["sub"]["t"].dtype == torch.int64
    np.testing.assert_array_equal(tree["ids"].numpy(), np.arange(2, 6))
    assert flat_to_tree({"a/0": 1, "a/1": 2}, {"a": [0, 0]}) == {"a": [1, 2]}
    # the reference's Checkpointer reads the port's steps
    jflat, jstep = JaxCheckpointer(d, async_save=False).restore()
    assert jstep == 3
    _assert_tree(jflat, 3)


def test_orphan_staging_dirs_are_swept(tmp_path):
    d = str(tmp_path)
    Checkpointer(d, async_save=False).save(0, _tree(0), block=True)
    orphan = os.path.join(d, ".tmp_step_7")
    os.makedirs(orphan)
    with open(os.path.join(orphan, "arrays.npz"), "w") as f:
        f.write("torn")
    ck = Checkpointer(d, async_save=False)
    assert not os.path.exists(orphan)
    assert ck.restore(device="cpu")[1] == 0


def _corrupt_array(directory, step, key, mutate):
    path = os.path.join(directory, f"step_{step}", "arrays.npz")
    with np.load(path) as data:
        flat = {k: data[k].copy() for k in data.files}
    flat[key] = mutate(flat[key])
    np.savez(path, **flat)


def test_corruption_is_named_and_skipped(tmp_path):
    d = str(tmp_path)
    ck = Checkpointer(d, keep=10, async_save=False)
    ck.save(0, _tree(0), block=True)
    ck.save(1, _tree(1), block=True)
    _corrupt_array(d, 1, "w", lambda a: a + 1)
    with pytest.raises(CheckpointCorruptError) as ei:
        ck.verify(1)
    assert ei.value.step == 1 and ei.value.key == "w"
    assert "CRC32" in str(ei.value)
    with pytest.raises(CheckpointCorruptError):
        ck.restore(step=1, device="cpu")
    flat, step = ck.restore(device="cpu")
    assert step == 0 and ck.latest_intact_step() == 0
    _assert_tree(flat, 0)
    ck.save(2, _tree(2), block=True)
    _corrupt_array(d, 2, "ids", lambda a: a[:2])
    with pytest.raises(CheckpointCorruptError) as ei:
        ck.verify(2)
    assert ei.value.key == "ids" and "shape" in str(ei.value)
    ck.save(3, _tree(3), block=True)
    npz = os.path.join(d, "step_3", "arrays.npz")
    with open(npz, "r+b") as f:
        f.truncate(os.path.getsize(npz) // 2)
    with pytest.raises(CheckpointCorruptError) as ei:
        ck.verify(3)
    assert ei.value.step == 3 and ei.value.key is None
    _corrupt_array(d, 0, "w", lambda a: a * 2)
    with pytest.raises(CheckpointCorruptError, match="no intact step"):
        ck.restore(device="cpu")


@pytest.mark.parametrize("point", SAVE_POINTS)
def test_save_crash_points_recover_the_newest_intact_step(tmp_path, point):
    """A crash at each stage of the save: recovery sees the previous step
    (before the publish) or the new one (after it), never a torn mix, and
    the next Checkpointer sweeps the staging dir."""
    d = str(tmp_path)
    ck = Checkpointer(d, async_save=False)
    ck.save(0, _tree(0), block=True)
    with faultinject.armed(point):
        with pytest.raises(faultinject.InjectedCrash):
            ck.save(1, _tree(1), block=True)
    ck2 = Checkpointer(d, async_save=False)
    assert not any(n.startswith(".tmp_step_") for n in os.listdir(d))
    flat, step = ck2.restore(device="cpu")
    expect = 1 if point == "checkpointer.save.published" else 0
    assert step == expect
    _assert_tree(flat, expect)


def test_exit_mode_crash_mid_save_in_a_child_process(tmp_path):
    d = str(tmp_path)
    Checkpointer(d, async_save=False).save(0, _tree(0), block=True)
    child = (
        "import numpy as np\n"
        "from repro_torch.checkpoint import Checkpointer\n"
        f"ck = Checkpointer({d!r}, async_save=False)\n"
        "ck.save(1, {'w': np.ones((5, 7), np.float32)}, block=True)\n"
        "print('AFTER', flush=True)\n")
    env = dict(os.environ, PYTHONPATH=SRC,
               REPRO_CRASH_POINT="checkpointer.save.arrays_written",
               REPRO_CRASH_MODE="exit")
    proc = subprocess.run([sys.executable, "-c", child], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == faultinject.EXIT_CODE, proc.stderr
    assert "AFTER" not in proc.stdout
    flat, step = Checkpointer(d, async_save=False).restore(device="cpu")
    assert step == 0 and not any(n.startswith(".tmp_step_")
                                 for n in os.listdir(d))
    _assert_tree(flat, 0)


def test_restore_entry_points_default_to_cuda(tmp_path, monkeypatch):
    for fn in (Checkpointer.restore, QueryEngine.restore):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    eng = port_engine()
    eng.add_dense(rows(4, 1))
    eng.save(str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Checkpointer(str(tmp_path)).restore()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        QueryEngine.restore(str(tmp_path))
    assert len(QueryEngine.restore(str(tmp_path), device="cpu")) == 4


# ---------------------------------------------------------------------------
# the engine's snapshots
# ---------------------------------------------------------------------------


def _history(eng, x):
    ids = eng.add_dense(x[:30])
    eng.remove(ids[::7])
    eng.compact()
    eng.add_dense(x[30:])
    eng.remove([31])


@pytest.mark.parametrize("metric", ["cham", "hamming"])
def test_engine_save_restore_is_bit_identical(tmp_path, metric):
    x = rows(40, 3)
    eng = port_engine(metric=metric)
    _history(eng, x)
    eng.shard(n_shards=3)
    eng.save(str(tmp_path), step=4)
    res = QueryEngine.restore(str(tmp_path), device="cpu", band_rows=16,
                              cache_entries=0)
    assert res.metric == metric and res.spec == eng.spec
    assert_same_store(res, eng)
    assert res.store.state_meta() == eng.store.state_meta()
    for k, v in eng.raw.state_tree().items():
        np.testing.assert_array_equal(res.raw.state_tree()[k], v)
    q = rows(4, 9)
    assert_same_answers(res, eng, q)
    np.testing.assert_array_equal(res.add_dense(x[:2]), eng.add_dense(x[:2]))
    assert_same_answers(res, eng, q)


def test_journal_resume_is_bit_identical(tmp_path):
    x = rows(30, 9)
    journal = str(tmp_path / "journal")
    eng = port_engine()
    eng.add_dense(x[:24])
    eng.migrate(d=D_NEW, batch_rows=8, drive="manual", journal_dir=journal,
                journal_every=1, journal_keep=10)
    eng.migration_step()
    eng.add_dense(x[24:])  # into the fresh tier
    eng.migration_step()  # journaled with the fresh rows
    res = QueryEngine.restore(journal, device="cpu", band_rows=16,
                              cache_entries=0)
    assert res.migrating and res.migration.rows_migrated == 16
    assert res.migration.cursor == eng.migration.cursor
    np.testing.assert_array_equal(res.ids(), eng.ids())
    q = rows(4, 10)
    assert_same_answers(res, eng, q)
    for e in (res, eng):
        e.migrate_all()
    assert_same_store(res, eng)
    assert_same_answers(res, eng, q)
    assert res.d == D_NEW


def _crash_baseline(metric, journal, x):
    eng = port_engine(metric=metric)
    ids = eng.add_dense(x)
    eng.remove(ids[1:3])
    eng.save(journal, step=0, keep=20)
    return eng


@pytest.mark.parametrize("metric", ["cham", "hamming"])
@pytest.mark.parametrize("point", MIGRATE_POINTS + ("store.compact",))
def test_engine_crash_matrix_loses_no_acked_row(tmp_path, point, metric):
    """A crash at every migration / compaction point, recovery from the
    journal directory alone, the migration finished: every acked row is
    there and the answers equal the never-crashed run bit for bit."""
    x = rows(26, 31)
    journal = str(tmp_path / "journal")
    eng = _crash_baseline(metric, journal, x)
    expected = eng.ids().copy()
    faultinject.record_hits(True)
    with faultinject.armed(point):
        with pytest.raises(faultinject.InjectedCrash) as ei:
            if point == "store.compact":
                eng.compact()
            else:
                eng.migrate(d=D_NEW, batch_rows=7, drive="manual",
                            journal_dir=journal, journal_every=1,
                            journal_keep=20)
                eng.migrate_all()
    assert ei.value.point == point
    res = QueryEngine.restore(journal, device="cpu", band_rows=16,
                              cache_entries=0)
    np.testing.assert_array_equal(np.sort(res.ids()), expected)
    if res.migrating:
        res.migrate_all()
    elif res.spec.version == 0:
        res.migrate(d=D_NEW, drive="eager")
    assert res.spec.version == 1 and res.d == D_NEW
    ref = port_engine(JP_NEW, metric=metric)
    ids = ref.add_dense(x)
    ref.remove(ids[1:3])
    assert_same_answers(res, ref, rows(4, 77))


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["cham", "hamming"])
def test_snapshots_cross_between_the_packages(tmp_path, metric):
    """v2 written by either package restores in the other: equal store and
    archive arrays, and answers under the parity contract."""
    x = rows(40, 5)
    ref, got = jax_engine(metric=metric), port_engine(metric=metric)
    for e in (ref, got):
        _history(e, x)
    ref.save(str(tmp_path / "jax"))
    got.save(str(tmp_path / "port"))
    port_from_jax = QueryEngine.restore(str(tmp_path / "jax"), device="cpu",
                                        band_rows=16, cache_entries=0)
    jax_from_port = JaxEngine.restore(str(tmp_path / "port"), band_rows=16,
                                      cache_entries=0)
    for a, b in ((port_from_jax, ref), (got, jax_from_port)):
        assert_same_store(a, b)
        assert a.spec.meta() == b.spec.meta()
        ta, tb = a.raw.state_tree(), b.raw.state_tree()
        for k in tb:
            np.testing.assert_array_equal(ta[k], tb[k])
    q = rows(4, 6)
    assert_answers_as_jax(port_from_jax, ref, q)
    assert_answers_as_jax(got, jax_from_port, q)
    metas = [json.load(open(tmp_path / w / "step_0" / "meta.json"))
             for w in ("jax", "port")]
    assert metas[0]["arrays"] == metas[1]["arrays"]
    assert ({k: v for k, v in metas[0].items() if k != "time"}
            == {k: v for k, v in metas[1].items() if k != "time"})


@pytest.mark.parametrize("metric", ["cham", "hamming"])
def test_mid_migration_snapshots_cross_between_the_packages(tmp_path,
                                                            metric):
    x = rows(36, 7)
    ref, got = jax_engine(metric=metric), port_engine(metric=metric)
    for e in (ref, got):
        e.add_dense(x[:28])
        e.migrate(d=D_NEW, batch_rows=6, drive="manual")
        e.migration_step()
        e.add_dense(x[28:])
    ref.save(str(tmp_path / "jax"))
    got.save(str(tmp_path / "port"))
    port_from_jax = QueryEngine.restore(str(tmp_path / "jax"), device="cpu",
                                        band_rows=16, cache_entries=0)
    jax_from_port = JaxEngine.restore(str(tmp_path / "port"), band_rows=16,
                                      cache_entries=0)
    assert port_from_jax.migration.meta() == ref.migration.meta()
    assert jax_from_port.migration.meta() == got.migration.meta()
    q = rows(4, 8)
    assert_same_answers(port_from_jax, got, q)
    gi, gd = port_from_jax.topk(q, 5)
    ri, rd = jax_from_port.topk(q, 6)
    if metric == "hamming":
        np.testing.assert_array_equal(gi, ri[:, :5])
        np.testing.assert_array_equal(gd, rd[:, :5])
    else:
        np.testing.assert_allclose(gd, rd[:, :5], rtol=1e-6)
        assert_ids_equal_but_ties(gi, ri[:, :5], rd)
    for e in (port_from_jax, jax_from_port):
        e.migrate_all()
    assert_same_store(port_from_jax, jax_from_port)
    assert_answers_as_jax(port_from_jax, jax_from_port, q)


@pytest.mark.parametrize("metric", ["cham", "hamming"])
def test_a_reference_v1_snapshot_restores_in_the_port(tmp_path, metric):
    """The reference's pre-migration format: the store alone at the top
    level of the tree, its spec in the meta; the port restores it with an
    empty raw archive, as the reference does."""
    x = rows(30, 11)
    ref = jax_engine(metric=metric)
    ids = ref.add_dense(x)
    ref.remove(ids[::4])
    p = ref.params
    meta = {"format": "repro.index.v1", "metric": metric,
            "n_dims": p.n_dims, "sketch_dim": p.sketch_dim,
            "psi_seed": p.psi_seed, "pi_seed": p.pi_seed,
            **ref.store.state_meta()}
    JaxCheckpointer(str(tmp_path), async_save=False).save(
        0, ref.store.state_tree(), extra_meta=meta, block=True)
    got = QueryEngine.restore(str(tmp_path), device="cpu", band_rows=16,
                              cache_entries=0)
    back = JaxEngine.restore(str(tmp_path), band_rows=16, cache_entries=0)
    assert got.params == tparams(ref.params) and len(got.raw) == 0
    assert_same_store(got, back)
    assert_answers_as_jax(got, back, rows(4, 12))
    with pytest.raises(ValueError, match="metric is fixed"):
        QueryEngine.restore(str(tmp_path), device="cpu", metric="hamming")


def test_restore_refuses_overrides_and_foreign_directories(tmp_path):
    eng = port_engine()
    eng.add_dense(rows(5, 1))
    eng.save(str(tmp_path / "idx"))
    for kw in ({"metric": "hamming"}, {"keep_raw": False}):
        with pytest.raises(ValueError, match="fixed by the snapshot"):
            QueryEngine.restore(str(tmp_path / "idx"), device="cpu", **kw)
    with pytest.raises(FileNotFoundError):
        QueryEngine.restore(str(tmp_path / "empty"), device="cpu")
    Checkpointer(str(tmp_path / "model"), async_save=False).save(
        0, _tree(0), block=True)
    with pytest.raises(ValueError, match="not an index snapshot"):
        QueryEngine.restore(str(tmp_path / "model"), device="cpu")
