"""The port's ALS training (predictionio_tpu_torch.models.als) held against
the JAX package's, on the CPU.

- ``als_prepare``: the port's copy must give the reference's host layout
  bitwise, field by field (dense head and seg bucket forced by shrinking
  both modules' width ladder and dense threshold, as the JAX package's
  own tests do).
- ``als_train_prepared(device="cpu")`` against the JAX
  ``als_train_prepared`` with its fused Pallas kernel in interpret mode
  (``PIO_PALLAS_GRAM=interpret``) and with its XLA path (``=0``), from the
  same ``init_factors`` start: rtol/atol 1e-4, the tolerance the JAX
  package holds its own two paths to (tests/test_als.py::TestFusedGram);
  bf16 gathers at the JAX package's bf16 tolerance (rtol 0.15, atol 0.1,
  tests/test_als.py::test_bf16_gather), since bf16 rounding flips
  differently in the two programs' iterates.

Data crosses between the packages as numpy arrays.
"""

import dataclasses

import numpy as np
import pytest
import torch

import predictionio_tpu.models.als as jax_als
import predictionio_tpu_torch.models.als as port_als

TOL = 1e-4
BF16_TOL = dict(rtol=0.15, atol=0.1)


def _zipf(seed, n_u, n_i, nnz, dedupe=True):
    rng = np.random.default_rng(seed)
    uu = (rng.zipf(1.3, nnz) % n_u).astype(np.int32)
    ii = (rng.zipf(1.3, nnz) % n_i).astype(np.int32)
    if dedupe:
        keep = np.unique(uu.astype(np.int64) * n_i + ii, return_index=True)[1]
        uu, ii = uu[keep], ii[keep]
    rr = rng.uniform(1, 5, len(uu)).astype(np.float32)
    return uu, ii, rr, n_u, n_i


def _coos(data):
    return (jax_als.RatingsCOO(*data), port_als.RatingsCOO(*data))


def _shrink(monkeypatch, ladder=(2, 8), dense_min=10):
    """Force the seg bucket and the dense head at test size, in both
    packages (the layout code reads these module globals)."""
    for mod in (jax_als, port_als):
        monkeypatch.setattr(mod, "_LADDER", ladder)
        monkeypatch.setattr(mod, "_C_MAX", ladder[-1])
        monkeypatch.setattr(mod, "_DENSE_MIN_COUNT", dense_min)


def _assert_same_side(mine, theirs):
    assert mine.n == theirs.n
    for name in ("perm", "inv_perm"):
        a, b = getattr(mine, name), getattr(theirs, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (mine.dense is None) == (theirs.dense is None)
    if mine.dense is not None:
        assert mine.dense.geometry == theirs.dense.geometry
        for name in ("w_cnt", "w_val", "counts"):
            a, b = getattr(mine.dense, name), getattr(theirs.dense, name)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert len(mine.buckets) == len(theirs.buckets)
    for a, b in zip(mine.buckets, theirs.buckets):
        assert a.geometry == b.geometry
        for name in ("other_idx", "vals", "mask", "counts", "seg", "seg_off"):
            x, y = getattr(a, name), getattr(b, name)
            assert (x is None) == (y is None)
            if x is not None:
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("shrink", [False, True], ids=["ladder", "seg_and_dense"])
def test_prepare_gives_the_reference_layout_bitwise(monkeypatch, shrink):
    if shrink:
        _shrink(monkeypatch)
    data = _zipf(23, 40, 25, 700, dedupe=False)  # duplicates kept
    jcoo, pcoo = _coos(data)
    theirs, mine = jax_als.als_prepare(jcoo), port_als.als_prepare(pcoo)
    if shrink:
        assert mine.u_side.dense is not None
        assert any(b.seg is not None for b in mine.u_side.buckets)
    assert (mine.n_users, mine.n_items, mine.nnz) == \
        (theirs.n_users, theirs.n_items, theirs.nnz)
    assert mine.geometry == theirs.geometry
    _assert_same_side(mine.u_side, theirs.u_side)
    _assert_same_side(mine.i_side, theirs.i_side)


# case → (data, params, shrink the layout?)
CASES = {
    "explicit": (dict(seed=21, n_u=60, n_i=40, nnz=900),
                 dict(rank=8, iterations=2, reg=0.1, seed=2), False),
    "implicit": (dict(seed=22, n_u=50, n_i=30, nnz=700),
                 dict(rank=8, iterations=2, reg=0.1, seed=2, implicit=True,
                      alpha=2.0), False),
    "plain_lambda": (dict(seed=24, n_u=50, n_i=30, nnz=700),
                     dict(rank=6, iterations=2, reg=0.1, seed=3,
                          weighted_reg=False), False),
    "seg_and_dense": (dict(seed=23, n_u=40, n_i=25, nnz=700),
                      dict(rank=4, iterations=2, reg=0.1, seed=2), True),
    "bf16_gather": (dict(seed=25, n_u=50, n_i=30, nnz=700),
                    dict(rank=6, iterations=2, reg=0.05, seed=2,
                         bf16_gather=True), False),
    "recover_u": (dict(seed=21, n_u=60, n_i=40, nnz=900),
                  dict(rank=8, iterations=0, reg=0.1, seed=2), False),
}


@pytest.mark.parametrize("gram_mode", ["interpret", "0"])
@pytest.mark.parametrize("case", list(CASES))
def test_train_matches_jax(monkeypatch, case, gram_mode):
    data_kw, p_kw, shrink = CASES[case]
    if shrink:
        _shrink(monkeypatch)
    jcoo, pcoo = _coos(_zipf(**data_kw))
    monkeypatch.setenv("PIO_PALLAS_GRAM", gram_mode)
    Uj, Vj = jax_als.als_train_prepared(jax_als.als_prepare(jcoo),
                                        jax_als.ALSParams(**p_kw))
    prep = port_als.als_prepare(pcoo)
    if shrink:
        assert prep.u_side.dense is not None
        assert any(b.seg is not None for b in prep.u_side.buckets)
    U, V = port_als.als_train_prepared(prep, port_als.ALSParams(**p_kw),
                                       device="cpu")
    assert U.dtype == np.float32 and V.dtype == np.float32
    assert U.shape == Uj.shape and V.shape == Vj.shape
    tol = BF16_TOL if p_kw.get("bf16_gather") else dict(rtol=TOL, atol=TOL)
    np.testing.assert_allclose(U, Uj, **tol)
    np.testing.assert_allclose(V, Vj, **tol)


def test_zero_rating_entities_get_zero_factors():
    # user 3 and item 4 have no ratings at all
    coo = port_als.RatingsCOO(np.array([0, 1, 2], np.int32),
                              np.array([0, 1, 2], np.int32),
                              np.array([1.0, 2.0, 3.0], np.float32), 5, 6)
    U, V = port_als.als_train(coo, port_als.ALSParams(rank=4, iterations=3, reg=0.1),
                              device="cpu")
    assert np.isfinite(U).all() and np.isfinite(V).all()
    assert np.allclose(U[3], 0) and np.allclose(V[4], 0)


def test_u_recovery_from_given_item_factors():
    """iterations=0 from V0 is the final U half-step: U of a 3-iteration
    run equals the U recovered from the 2-iteration run's V."""
    prep = port_als.als_prepare(_coos(_zipf(21, 60, 40, 900))[1])
    p = port_als.ALSParams(rank=8, iterations=2, reg=0.1, seed=2)
    _, V2 = port_als.als_train_prepared(prep, p, device="cpu")
    U3, _ = port_als.als_train_prepared(
        prep, dataclasses.replace(p, iterations=3), device="cpu")
    U_re, V_re = port_als.als_train_prepared(
        prep, dataclasses.replace(p, iterations=0), device="cpu", V0=V2)
    np.testing.assert_array_equal(V_re, V2)
    np.testing.assert_allclose(U_re, U3, rtol=1e-6, atol=1e-6)


def test_training_converges_on_low_rank_data():
    rng = np.random.default_rng(0)
    n_u, n_i = 100, 70
    R = rng.normal(size=(n_u, 5)) @ rng.normal(size=(n_i, 5)).T
    uu, ii = np.nonzero(rng.random((n_u, n_i)) < 0.3)
    coo = port_als.RatingsCOO(uu.astype(np.int32), ii.astype(np.int32),
                              R[uu, ii].astype(np.float32), n_u, n_i)
    U, V = port_als.als_train(coo, port_als.ALSParams(rank=8, iterations=12, reg=0.05),
                              device="cpu")
    pred = port_als.predict_ratings(U, V, coo.user_idx, coo.item_idx)
    assert float(np.sqrt(np.mean((pred - coo.rating) ** 2))) < 0.3


def test_full_f32_precision_is_restored():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with port_als.full_f32():
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)


def test_no_card_and_no_cpu_request_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    coo = port_als.RatingsCOO(np.array([0], np.int32), np.array([0], np.int32),
                              np.array([1.0], np.float32), 1, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_als.als_train(coo, port_als.ALSParams(rank=2, iterations=1))
