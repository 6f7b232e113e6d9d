"""Sharded ALS of the port against the JAX package's, on the CPU.

The JAX side trains over the eight virtual CPU devices of
``tests/conftest.py``; the port over eight CPU slots of one mesh. The
cases are those of ``tests/test_als.py``'s ``TestShardedParity`` and
``tests/test_checkpoint.py``'s ``TestShardedALSResume``: the per-shard
layouts must be bitwise the JAX package's with one merged geometry, the
factors within 1e-4 of the JAX sharded train and within 2e-3 of the dense
float64 reference, and a resumed run equal to a straight one.
"""

from __future__ import annotations

import numpy as np
import pytest

import predictionio_tpu.models.als as jax_als
import predictionio_tpu.models.als_sharded as jax_sh
from predictionio_tpu_torch.models import als
from predictionio_tpu_torch.models import als_sharded as sh
from predictionio_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from predictionio_tpu_torch.utils.checkpoint import TrainCheckpointer
from tests.test_als import _ref_als, _zipf_coo


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh(MeshConfig({"data": 8}), devices=["cpu"] * 8)


def _coo(kind: str):
    """(u, i, r, n_u, n_i) of the sharded cases of tests/test_als.py."""
    if kind == "uniform":  # not divisible by 8 (test_sharded_matches_dense_reference)
        rng = np.random.default_rng(9)
        n_u, n_i = 41, 26
        uu = rng.integers(0, n_u, 400).astype(np.int32)
        ii = rng.integers(0, n_i, 400).astype(np.int32)
        keep = np.unique(uu.astype(np.int64) * n_i + ii, return_index=True)[1]
        uu, ii = uu[keep], ii[keep]
        return uu, ii, rng.uniform(1, 5, len(uu)).astype(np.float32), n_u, n_i
    if kind == "skewed":  # one user owns most ratings (the seg bucket)
        rng = np.random.default_rng(11)
        n_u, n_i = 33, 17
        uu = np.concatenate([np.zeros(16, np.int32),
                             rng.integers(1, n_u, 120).astype(np.int32)])
        ii = np.concatenate([np.arange(16, dtype=np.int32) % n_i,
                             rng.integers(0, n_i, 120).astype(np.int32)])
        keep = np.unique(uu.astype(np.int64) * n_i + ii, return_index=True)[1]
        uu, ii = uu[keep], ii[keep]
        return uu, ii, rng.uniform(1, 5, len(uu)).astype(np.float32), n_u, n_i
    if kind == "dense":  # zipf users, duplicates kept (the dense head)
        rng = np.random.default_rng(12)
        n_u, n_i, nnz = 33, 17, 400
        uu = (rng.zipf(1.3, nnz) % n_u).astype(np.int32)
        ii = rng.integers(0, n_i, nnz).astype(np.int32)
        return uu, ii, rng.uniform(1, 5, nnz).astype(np.float32), n_u, n_i
    if kind == "uneven":
        rng = np.random.default_rng(1)
        n_u, n_i = 37, 23
        return (rng.integers(0, n_u, 300).astype(np.int32),
                rng.integers(0, n_i, 300).astype(np.int32),
                rng.uniform(1, 5, 300).astype(np.float32), n_u, n_i)
    c = _zipf_coo(28, 41, 26, 500)
    return c.user_idx, c.item_idx, c.rating, c.n_users, c.n_items


def _both(kind: str):
    arrays = _coo(kind)
    return als.RatingsCOO(*arrays), jax_als.RatingsCOO(*arrays)


@pytest.fixture()
def geometry(request, monkeypatch):
    """The module constants each case shrinks, in BOTH packages."""
    kind = request.param
    for mod in (als, jax_als):
        if kind == "skewed":
            monkeypatch.setattr(mod, "_LADDER", (2, 8))
            monkeypatch.setattr(mod, "_C_MAX", 8)
        if kind == "dense":
            monkeypatch.setattr(mod, "_DENSE_MIN_COUNT", 6)
    return kind


def _sides_equal(mine, theirs) -> None:
    assert mine.geometry == theirs.geometry
    np.testing.assert_array_equal(mine.perm, theirs.perm)
    np.testing.assert_array_equal(mine.inv_perm, theirs.inv_perm)
    assert (mine.dense is None) == (theirs.dense is None)
    if mine.dense is not None:
        for f in ("w_cnt", "w_val", "counts"):
            np.testing.assert_array_equal(getattr(mine.dense, f),
                                          getattr(theirs.dense, f))
    for a, b in zip(mine.buckets, theirs.buckets):
        for f in ("other_idx", "vals", "mask", "counts", "seg", "seg_off"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                assert x.dtype == y.dtype, f
                np.testing.assert_array_equal(x, y)


KINDS = ["uniform", "skewed", "dense", "uneven", "zipf"]


@pytest.mark.parametrize("geometry", KINDS, indirect=True)
@pytest.mark.parametrize("n_dev", [2, 8])
def test_layout_is_bitwise_the_jax_packages_shard_by_shard(geometry, n_dev):
    coo, jcoo = _both(geometry)
    mine, theirs = sh.als_prepare_sharded(coo, n_dev), jax_sh.als_prepare_sharded(jcoo, n_dev)
    assert (mine.n_dev, mine.block_u, mine.block_i, mine.nnz) == \
        (theirs.n_dev, theirs.block_u, theirs.block_i, theirs.nnz)
    for side in ("u_sides", "i_sides"):
        assert len({s.geometry for s in getattr(mine, side)}) == 1
        for a, b in zip(getattr(mine, side), getattr(theirs, side)):
            _sides_equal(a, b)
    if geometry == "skewed":
        assert any(b.seg is not None for b in mine.u_sides[0].buckets)
    if geometry == "dense":
        assert mine.u_sides[0].dense is not None and mine.u_sides[0].dense.nb > 0


def test_single_device_layout_still_equals_the_jax_packages():
    coo, jcoo = _both("zipf")
    mine, theirs = als.als_prepare(coo), jax_als.als_prepare(jcoo)
    _sides_equal(mine.u_side, theirs.u_side)
    _sides_equal(mine.i_side, theirs.i_side)


@pytest.mark.parametrize("geometry", KINDS, indirect=True)
@pytest.mark.parametrize("implicit", [False, True])
def test_factors_match_the_jax_sharded_train_and_float64(geometry, implicit,
                                                         mesh8, cpu_mesh):
    coo, jcoo = _both(geometry)
    if implicit:
        coo.rating = jcoo.rating = np.abs(coo.rating)
    kw = dict(rank=4, iterations=2, reg=0.1, seed=2, implicit=implicit, alpha=2.0)
    U, V = als.als_train(coo, als.ALSParams(**kw), mesh=mesh8)
    Uj, Vj = jax_sh.als_train_sharded(jcoo, jax_als.ALSParams(**kw), cpu_mesh)
    np.testing.assert_allclose(U, Uj, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(V, Vj, rtol=1e-4, atol=1e-4)
    if not implicit:
        Ur, Vr = _ref_als(jcoo, jax_als.ALSParams(**kw))
        np.testing.assert_allclose(U, Ur, rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(V, Vr, rtol=2e-3, atol=2e-3)


def test_iterations_zero_solves_u_from_the_initial_v(mesh8, cpu_mesh):
    coo, jcoo = _both("zipf")
    kw = dict(rank=4, iterations=0, reg=0.1, seed=2)
    U, V = als.als_train(coo, als.ALSParams(**kw), mesh=mesh8)
    Uj, Vj = jax_sh.als_train_sharded(jcoo, jax_als.ALSParams(**kw), cpu_mesh)
    np.testing.assert_allclose(U, Uj, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(V, als.init_factors(coo.n_items, 4, 2))
    np.testing.assert_array_equal(V, Vj)
    U1, _ = als.als_train(coo, als.ALSParams(**kw), device="cpu")
    np.testing.assert_allclose(U, U1, rtol=1e-5, atol=1e-5)
    assert np.abs(U).max() > 0


def test_als_train_many_over_a_mesh(mesh8, cpu_mesh):
    coo, jcoo = _both("uniform")
    grid = [dict(rank=4, iterations=2, reg=r, seed=2) for r in (0.05, 0.5)]
    mine = als.als_train_many(coo, [als.ALSParams(**g) for g in grid], mesh=mesh8)
    theirs = jax_als.als_train_many(jcoo, [jax_als.ALSParams(**g) for g in grid],
                                    mesh=cpu_mesh)
    for (U, V), (Uj, Vj), g in zip(mine, theirs, grid):
        np.testing.assert_allclose(U, Uj, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(V, Vj, rtol=1e-4, atol=1e-4)
        one = als.als_train(coo, als.ALSParams(**g), mesh=mesh8)
        np.testing.assert_array_equal(U, one[0])


def test_a_one_slot_mesh_runs_the_single_device_path():
    coo, _ = _both("zipf")
    p = als.ALSParams(rank=4, iterations=2, reg=0.1, seed=2)
    U, V = als.als_train(coo, p, mesh=make_mesh(MeshConfig({"data": 8}), devices=["cpu"]))
    U1, V1 = als.als_train(coo, p, device="cpu")
    np.testing.assert_array_equal(U, U1)
    np.testing.assert_array_equal(V, V1)
    [(Um, Vm)] = als.als_train_many(coo, [p], mesh=make_mesh(devices=["cpu"]))
    np.testing.assert_array_equal(Um, U1)


def test_the_mesh_must_match_the_layout(mesh8):
    coo, _ = _both("zipf")
    prep = sh.als_prepare_sharded(coo, 4)
    with pytest.raises(ValueError, match="prepared for 4 devices but the mesh has 8"):
        sh.als_train_sharded_prepared(prep, als.ALSParams(rank=4), mesh8)
    with pytest.raises(ValueError, match="'data' axis"):
        sh.als_train_sharded(coo, als.ALSParams(rank=4),
                             make_mesh(MeshConfig({"shards": 2}), devices=["cpu"] * 2))


# -- resume (tests/test_checkpoint.py TestShardedALSResume) -------------------


def _resume_coo():
    rng = np.random.default_rng(11)
    n_u, n_i, nnz = 48, 30, 500
    return als.RatingsCOO(rng.integers(0, n_u, nnz).astype(np.int32),
                          rng.integers(0, n_i, nnz).astype(np.int32),
                          rng.uniform(1, 5, nnz).astype(np.float32), n_u, n_i)


def test_resume_matches_straight_run(tmp_path, mesh8):
    prep = sh.als_prepare_sharded(_resume_coo(), 8)
    p8 = als.ALSParams(rank=4, iterations=8, reg=0.1, seed=2)
    U_ref, V_ref = sh.als_train_sharded_prepared(prep, p8, mesh8)
    # "crash" after 4 of 8 iterations (two 2-iteration blocks saved)
    ck = TrainCheckpointer(str(tmp_path / "als"))
    sh.als_train_sharded_prepared(prep, als.ALSParams(rank=4, iterations=4, reg=0.1,
                                                      seed=2),
                                  mesh8, checkpointer=ck, checkpoint_every=2)
    assert ck.all_steps() == [2, 4]
    # restart: restores step 4, runs the remaining 4
    ck = TrainCheckpointer(str(tmp_path / "als"))
    U, V = sh.als_train_sharded_prepared(prep, p8, mesh8, checkpointer=ck,
                                         checkpoint_every=2)
    assert ck.latest_step() == 8
    np.testing.assert_array_equal(U, U_ref)
    np.testing.assert_array_equal(V, V_ref)


def test_resume_after_final_checkpoint_does_not_retrain(tmp_path, mesh8, monkeypatch):
    prep = sh.als_prepare_sharded(_resume_coo(), 8)
    p = als.ALSParams(rank=4, iterations=4, reg=0.1, seed=2)
    U_ref, V_ref = sh.als_train_sharded_prepared(
        prep, p, mesh8, checkpointer=TrainCheckpointer(str(tmp_path / "als")),
        checkpoint_every=2)
    calls = {"n": 0}
    make_half = sh._make_half

    def counting(*a, **k):
        half = make_half(*a, **k)

        def counted(*args):
            calls["n"] += 1
            return half(*args)

        return counted

    monkeypatch.setattr(sh, "_make_half", counting)
    U, V = sh.als_train_sharded_prepared(
        prep, p, mesh8, checkpointer=TrainCheckpointer(str(tmp_path / "als")),
        checkpoint_every=2)
    assert calls["n"] == 0, "a fully checkpointed run must not retrain"
    np.testing.assert_array_equal(U, U_ref)
    np.testing.assert_array_equal(V, V_ref)


def test_stale_layout_falls_back_to_fresh(tmp_path, mesh8):
    prep = sh.als_prepare_sharded(_resume_coo(), 8)
    TrainCheckpointer(str(tmp_path / "als")).save(
        3, {"U": np.zeros((5, 3), np.float32), "V": np.zeros((7, 9), np.float32)})
    p = als.ALSParams(rank=4, iterations=3, reg=0.1, seed=2)
    U_ref, _ = sh.als_train_sharded_prepared(prep, p, mesh8)
    ck = TrainCheckpointer(str(tmp_path / "als"))
    with pytest.warns(RuntimeWarning, match="stale"):
        U, _ = sh.als_train_sharded_prepared(prep, p, mesh8, checkpointer=ck,
                                             checkpoint_every=2)
    np.testing.assert_array_equal(U, U_ref)
    assert ck.all_steps() == [2, 3]


def test_a_sharded_checkpoint_is_not_restored_by_the_single_device_path(tmp_path, mesh8):
    """The sharded checkpoint holds the padded per-shard layout: the
    single-device path finds its geometry stale and starts over."""
    coo = _resume_coo()
    p = als.ALSParams(rank=4, iterations=4, reg=0.1, seed=2)
    sh.als_train_sharded_prepared(sh.als_prepare_sharded(coo, 8), p, mesh8,
                                  checkpointer=TrainCheckpointer(str(tmp_path / "als")),
                                  checkpoint_every=2)
    U_ref, _ = als.als_train(coo, p, device="cpu")
    with pytest.warns(RuntimeWarning, match="stale"):
        U, _ = als.als_train(coo, p, device="cpu",
                             checkpointer=TrainCheckpointer(str(tmp_path / "als")),
                             checkpoint_every=2)
    np.testing.assert_array_equal(U, U_ref)
