"""Parity of the port's fused gather → weighted Gram
(predictionio_tpu_torch.ops.gram) with the JAX package's Pallas kernel
(interpret mode) and its XLA path.

Both sides get the same numpy inputs, made like the JAX package's own
tests (tests/test_ops.py::TestGatherGram): uniform weights in [0, 2) with
a fifth of the slots zeroed like pad entries, indices over 999 factor
rows (repeats included). Tolerance: rtol/atol 1e-5 in f32 (the sums run
in another order); bf16 factors at the JAX test's tolerance (rtol 5e-2,
atol 1e-1: products of two bf16-rounded values drift about 1%).

The CUDA kernel itself runs only on the card (chip_smoke.py); here the
wrapper takes its plain version because the tensors lie on the CPU.
"""

import ast
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops.gram import gather_gram as jax_gather_gram
from predictionio_tpu.ops.gram import gather_gram_xla
from predictionio_tpu_torch import ops
from predictionio_tpu_torch.ops import _build
from predictionio_tpu_torch.ops.gram import (LINE, MAX_SPLIT, MIN_CHUNK, NARROW,
                                             gather_gram, gather_gram_ref, gram_plan)

TOL = 1e-5


def _data(R, C, k, n_other=999, seed=0):
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((n_other, k)).astype(np.float32)
    idx = rng.integers(0, n_other, (R, C)).astype(np.int32)
    wo = rng.uniform(0, 2, (R, C)).astype(np.float32)
    wb = rng.uniform(0, 2, (R, C)).astype(np.float32)
    wo[rng.uniform(size=(R, C)) < 0.2] = 0.0
    wb[wo == 0.0] = 0.0
    return F, idx, wo, wb


def _port(F, idx, wo, wb, dtype=torch.float32):
    A, b = gather_gram(torch.from_numpy(F).to(dtype), torch.from_numpy(idx),
                       torch.from_numpy(wo), torch.from_numpy(wb))
    return A.numpy(), b.numpy()


@pytest.mark.parametrize("k", [4, 10])
@pytest.mark.parametrize("C", [8, 32])
@pytest.mark.parametrize("R", [0, 1, 13])
def test_matches_jax_kernel_and_xla_path(R, C, k):
    F, idx, wo, wb = _data(R, C, k, seed=R + C + k)
    A, b = _port(F, idx, wo, wb)
    assert A.shape == (R, k, k) and b.shape == (R, k)
    assert A.dtype == np.float32 and b.dtype == np.float32
    theirs = [gather_gram_xla(jnp.asarray(F), jnp.asarray(idx), jnp.asarray(wo),
                              jnp.asarray(wb))]
    if R:  # the Pallas kernel's interpret mode wants a non-empty grid
        theirs.append(jax_gather_gram(jnp.asarray(F), jnp.asarray(idx),
                                      jnp.asarray(wo), jnp.asarray(wb),
                                      interpret=True))
    else:
        Aj, bj = jax_gather_gram(jnp.asarray(F), jnp.asarray(idx),
                                 jnp.asarray(wo), jnp.asarray(wb))
        assert Aj.shape == A.shape and bj.shape == b.shape
    for Aj, bj in theirs:
        np.testing.assert_allclose(A, np.asarray(Aj), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(b, np.asarray(bj), rtol=TOL, atol=TOL)


def test_bf16_factors_match_jax_kernel():
    F, idx, wo, wb = _data(13, 32, 8, seed=4)
    A, b = _port(F, idx, wo, wb, dtype=torch.bfloat16)
    assert A.dtype == np.float32  # accumulation stays f32
    Aj, bj = jax_gather_gram(jnp.asarray(F, jnp.bfloat16), jnp.asarray(idx),
                             jnp.asarray(wo), jnp.asarray(wb), interpret=True)
    np.testing.assert_allclose(A, np.asarray(Aj), rtol=5e-2, atol=1e-1)
    np.testing.assert_allclose(b, np.asarray(bj), rtol=5e-2, atol=1e-1)
    # and against the f32 factors at the same drift bound
    A32, b32 = _port(F, idx, wo, wb)
    np.testing.assert_allclose(A, A32, rtol=5e-2, atol=1e-1)
    np.testing.assert_allclose(b, b32, rtol=5e-2, atol=1e-1)


def test_float64_reference_and_inert_pad_slots():
    F, idx, wo, wb = _data(7, 32, 5, seed=3)
    G = F[idx].astype(np.float64)
    A64 = np.einsum("rc,rck,rcl->rkl", wo.astype(np.float64), G, G)
    b64 = np.einsum("rc,rck->rk", wb.astype(np.float64), G)
    A, b = _port(F, idx, wo, wb)
    np.testing.assert_allclose(A, A64, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(b, b64, rtol=TOL, atol=TOL)
    # pad slots (index 0, weight 0) add exactly nothing
    idx_p = np.concatenate([idx, np.zeros((7, 8), np.int32)], axis=1)
    zeros = np.zeros((7, 8), np.float32)
    Ap, bp = _port(F, idx_p, np.concatenate([wo, zeros], 1),
                   np.concatenate([wb, zeros], 1))
    np.testing.assert_array_equal(Ap, A)
    np.testing.assert_array_equal(bp, b)


def test_wrapper_on_cpu_takes_plain_version_and_counts_nothing():
    F, idx, wo, wb = _data(5, 16, 6, seed=9)
    args = [torch.from_numpy(a) for a in (F, idx, wo, wb)]
    before = gather_gram.launches
    A, b = gather_gram(*args)
    Ar, br = gather_gram_ref(*args)
    assert torch.equal(A, Ar) and torch.equal(b, br)
    assert gather_gram.launches == before  # CPU calls are not launches
    assert gather_gram in ops.LAUNCH_COUNTERS


@pytest.mark.parametrize("shapes, match", [
    (((10, 4), (3, 8), (3, 8), (3, 7)), "needs F"),
    (((10,), (3, 8), (3, 8), (3, 8)), "needs F"),
])
def test_wrapper_rejects_bad_shapes(shapes, match):
    F, idx, wo, wb = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError, match=match):
        gather_gram(F, idx.int(), wo, wb)


def test_wrapper_refuses_other_devices():
    F = torch.zeros(4, 3, device="meta")
    idx = torch.zeros(2, 8, dtype=torch.int32, device="meta")
    w = torch.zeros(2, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        gather_gram(F, idx, w, w)


def test_source_names_the_tpu_kernel_and_its_bound():
    src = (_build.CSRC / "gather_gram.cu").read_text()
    assert "predictionio_tpu/ops/gram.py" in src and "Bound" in src
    assert "pio_gather_gram" in src and "cublas" not in src.lower()
    # chunks are summed in a fixed order: no atomic, so reruns are bitwise
    assert "atomicAdd" not in src and "atom." not in src
    cmd = _build.nvcc_command(_build.CSRC / "gather_gram.cu", _build.BUILD_DIR / "x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd


# the ML-20M layout's buckets (R, C) at rank 64, both sides (chip_smoke.py
# phase 5's generator); only the two C = 8,192 buckets split
ML20M_BUCKETS = [(1024, 2048), (1837, 512), (5369, 128), (19813, 32), (105312, 8),
                 (42, 8192), (384, 8192), (1536, 2048), (6144, 512), (24576, 128),
                 (1, 32)]


def _chunks(plan, C):
    return [(s * plan.chunk, min(C, (s + 1) * plan.chunk)) for s in range(plan.split)]


@pytest.mark.parametrize("R, C", ML20M_BUCKETS + [
    (1, 0), (1, 1), (7, 8), (4097, 8), (4097, 32), (1, 33), (1, 8192), (13, 2048),
    (1, 2048), (1023, 4096), (3, 100_000), (1, 1100), (384, 8191)])
def test_plan_covers_every_slot_once(R, C):
    plan = gram_plan(R, C)
    assert plan == gram_plan(R, C)              # the shape alone decides
    assert 1 <= plan.split <= MAX_SPLIT and plan.rows_per_block >= 1
    covered = np.zeros(C, np.int64)
    for lo, hi in _chunks(plan, C):
        assert lo < hi or C == 0                # no empty chunk
        covered[lo:hi] += 1
    assert (covered == 1).all()
    if plan.split > 1:                          # whole lines, one row a block
        assert plan.chunk % LINE == 0
        assert plan.rows_per_block == 1 and C >= 2 * MIN_CHUNK
    else:
        assert plan.chunk == C
    if R < 2 * 1024 or C > NARROW:              # small buckets, wide rows:
        assert plan.rows_per_block == 1         # a row a block


def test_plan_splits_only_the_wide_ml20m_buckets_and_packs_the_narrow():
    plans = {(R, C): gram_plan(R, C) for R, C in ML20M_BUCKETS}
    assert {rc for rc, p in plans.items() if p.split > 1} == {(42, 8192), (384, 8192)}
    assert plans[(42, 8192)].split * 42 >= 132  # the seg bucket fills the SMs
    assert plans[(105312, 8)].rows_per_block > 1
    assert plans[(19813, 32)].rows_per_block > 1
    assert plans[(24576, 128)].rows_per_block == 1
    assert plans[(6144, 512)].rows_per_block == 1
    assert plans[(1, 32)].rows_per_block == 1


def _holed(R, C, k, seed):
    """_data with a run of zero weights mid-row in every third row (whole
    tiles at wide C) and every fifth row from the third all zero."""
    F, idx, wo, wb = _data(R, C, k, seed=seed)
    wo[::3, C // 8:C // 2] = 0.0
    wb[::3, C // 8:C // 2] = 0.0
    wo[2::5] = 0.0
    wb[2::5] = 0.0
    return F, idx, wo, wb


@pytest.mark.parametrize("R, C, k", [(7, 32, 10), (11, 300, 6), (3, 1100, 4)])
def test_zero_runs_and_all_zero_rows_match_float64_and_jax(R, C, k):
    F, idx, wo, wb = _holed(R, C, k, seed=R * C + k)
    A, b = _port(F, idx, wo, wb)
    G = F[idx].astype(np.float64)
    A64 = np.einsum("rc,rck,rcl->rkl", wo.astype(np.float64), G, G)
    b64 = np.einsum("rc,rck->rk", wb.astype(np.float64), G)
    np.testing.assert_allclose(A, A64, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(b, b64, rtol=TOL, atol=TOL)
    Aj, bj = gather_gram_xla(jnp.asarray(F), jnp.asarray(idx), jnp.asarray(wo),
                             jnp.asarray(wb))
    np.testing.assert_allclose(A, np.asarray(Aj), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(b, np.asarray(bj), rtol=TOL, atol=TOL)
    dead = np.arange(2, R, 5)                   # rows with no weight
    assert not A[dead].any() and not b[dead].any()


def test_gram_module_reexports_rows_gram_without_a_cycle():
    gram = importlib.import_module("predictionio_tpu_torch.ops.gram")
    rows = importlib.import_module("predictionio_tpu_torch.ops.rows_gram")
    assert gram.rows_gram is rows.rows_gram
    assert gram.rows_gram_ref is rows.rows_gram_ref
    from predictionio_tpu_torch.ops.gram import rows_gram, rows_gram_ref  # noqa: F401
    tree = ast.parse(open(rows.__file__).read())
    imported = [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    imported += [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names]
    assert not any(m.endswith("gram") and "rows_gram" not in m for m in imported)
