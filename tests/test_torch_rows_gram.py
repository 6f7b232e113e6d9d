"""Parity of the port's weighted Gram over a pre-gathered block
(predictionio_tpu_torch.ops.rows_gram) with the JAX package's Pallas
kernel (interpret mode), its XLA path and float64 numpy.

Both sides get the same numpy inputs, made like the JAX package's own
tests (tests/test_ops.py::TestRowsGram): standard normal F_g, uniform
weights in [0, 2). Tolerance: rtol/atol 1e-5, the JAX tests' own (the
sums run in another order); bf16 blocks at the tolerance of the port's
gather_gram bf16 test (rtol 5e-2, atol 1e-1) against the f32 block, and
1e-5 against rows_gram_xla of the same bf16 values (both widen to f32).

The CUDA kernel itself runs only on the card (chip_smoke.py); here the
wrapper takes its plain version because the tensors lie on the CPU. Its
plan (rows_plan: split wide rows, packed narrow rows) is plain Python and
is checked here, and the parity tests run at shapes where it splits and
where it packs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops.gram import rows_gram as jax_rows_gram
from predictionio_tpu.ops.gram import rows_gram_xla
from predictionio_tpu_torch import ops
from predictionio_tpu_torch.ops import _build
from predictionio_tpu_torch.ops.rows_gram import (LINE, MAX_PACK, MAX_SPLIT, MIN_CHUNK,
                                                  NARROW, PACK_ROWS, SPLIT_BLOCKS, rows_gram,
                                                  rows_gram_ref, rows_plan)

TOL = 1e-5


def _data(R, W, k, seed=0):
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((R, W, k)).astype(np.float32)
    wo = rng.uniform(0, 2, (R, W)).astype(np.float32)
    wb = rng.uniform(0, 2, (R, W)).astype(np.float32)
    return F, wo, wb


def _port(F, wo, wb, dtype=torch.float32):
    A, b = rows_gram(torch.from_numpy(F).to(dtype), torch.from_numpy(wo),
                     torch.from_numpy(wb))
    return A.numpy(), b.numpy()


def _numpy64(F, wo, wb):
    F64 = F.astype(np.float64)
    A = np.einsum("rw,rwk,rwl->rkl", wo.astype(np.float64), F64, F64)
    b = np.einsum("rw,rwk->rk", wb.astype(np.float64), F64)
    return A, b


@pytest.mark.parametrize("R, W, k", [(32, 16, 8), (7, 5, 3), (20, 4, 4),
                                     (9, 1, 6)])
def test_matches_jax_kernel_xla_path_and_float64(R, W, k):
    F, wo, wb = _data(R, W, k, seed=R + W + k)
    A, b = _port(F, wo, wb)
    assert A.shape == (R, k, k) and b.shape == (R, k)
    assert A.dtype == np.float32 and b.dtype == np.float32
    args = (jnp.asarray(F), jnp.asarray(wo), jnp.asarray(wb))
    theirs = [rows_gram_xla(*args), jax_rows_gram(*args, interpret=True),
              _numpy64(F, wo, wb)]
    for Aj, bj in theirs:
        np.testing.assert_allclose(A, np.asarray(Aj), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(b, np.asarray(bj), rtol=TOL, atol=TOL)


def test_no_rows_gives_empty_results():
    F, wo, wb = _data(0, 8, 5)
    A, b = _port(F, wo, wb)
    assert A.shape == (0, 5, 5) and b.shape == (0, 5)
    Aj, bj = rows_gram_xla(jnp.asarray(F), jnp.asarray(wo), jnp.asarray(wb))
    assert Aj.shape == A.shape and bj.shape == b.shape


def test_bf16_block_is_widened_like_the_xla_path():
    F, wo, wb = _data(13, 32, 8, seed=4)
    A, b = _port(F, wo, wb, dtype=torch.bfloat16)
    assert A.dtype == np.float32  # accumulation stays f32
    Fb = jnp.asarray(F, jnp.bfloat16)
    Aj, bj = rows_gram_xla(Fb, jnp.asarray(wo), jnp.asarray(wb))
    np.testing.assert_allclose(A, np.asarray(Aj), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(b, np.asarray(bj), rtol=TOL, atol=TOL)
    # and against the f32 block at the bf16 drift bound
    A32, b32 = _port(F, wo, wb)
    np.testing.assert_allclose(A, A32, rtol=5e-2, atol=1e-1)
    np.testing.assert_allclose(b, b32, rtol=5e-2, atol=1e-1)


def test_zero_weights_add_exactly_nothing_and_A_is_symmetric():
    F, wo, wb = _data(6, 12, 5, seed=5)
    A, b = _port(F, wo, wb)
    # the same rows with 8 more slots of zero weight
    pad = np.random.default_rng(6).standard_normal((6, 8, 5)).astype(np.float32)
    zeros = np.zeros((6, 8), np.float32)
    Ap, bp = _port(np.concatenate([F, pad], 1), np.concatenate([wo, zeros], 1),
                   np.concatenate([wb, zeros], 1))
    np.testing.assert_allclose(Ap, A, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(bp, b, rtol=TOL, atol=TOL)
    Fi = np.round(F * 2).astype(np.float32)  # integer data: exact sums
    Ai, _ = _port(Fi, np.round(wo), wb)
    np.testing.assert_array_equal(Ai, Ai.transpose(0, 2, 1))


def test_wrapper_on_cpu_takes_plain_version_and_counts_nothing():
    F, wo, wb = _data(5, 16, 6, seed=9)
    args = [torch.from_numpy(a) for a in (F, wo, wb)]
    before = rows_gram.launches
    A, b = rows_gram(*args)
    Ar, br = rows_gram_ref(*args)
    assert torch.equal(A, Ar) and torch.equal(b, br)
    assert rows_gram.launches == before  # CPU calls are not launches
    assert rows_gram in ops.LAUNCH_COUNTERS and "rows_gram" in ops.KERNELS
    assert ops.rows_gram is rows_gram and "rows_gram" in ops.__all__


@pytest.mark.parametrize("shapes", [((3, 8, 4), (3, 7), (3, 8)),
                                    ((3, 8, 4), (3, 8), (2, 8)),
                                    ((24, 4), (3, 8), (3, 8)),
                                    ((3, 8, 4), (3, 8, 1), (3, 8))])
def test_wrapper_rejects_bad_shapes(shapes):
    F, wo, wb = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError, match="needs F_g"):
        rows_gram(F, wo, wb)


def test_wrapper_refuses_other_devices():
    F = torch.zeros(2, 8, 3, device="meta")
    w = torch.zeros(2, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        rows_gram(F, w, w)


def test_source_names_the_tpu_kernel_and_its_bound():
    src = (_build.CSRC / "rows_gram.cu").read_text()
    assert "predictionio_tpu/ops/gram.py" in src and "Bound" in src
    assert "pio_rows_gram" in src and "cublas" not in src.lower()
    assert "#include \"" not in src  # self-contained: the build digests this file alone
    cmd = _build.nvcc_command(_build.CSRC / "rows_gram.cu", _build.BUILD_DIR / "x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd


# the chunks (R, W) that chip_smoke.py phase 6 cuts from the ML-20M layout
# at rank 64 (row chunks of at most 2^26 values), both sides
ML20M_CHUNKS = [(512, 2048), (1837, 512), (5369, 128), (19813, 32), (105312, 8),
                (42, 8192), (128, 8192), (2048, 512), (8192, 128), (1, 32)]


def _chunks(plan, W):
    return [(s * plan.chunk, min(W, (s + 1) * plan.chunk)) for s in range(plan.split)]


@pytest.mark.parametrize("R, W", ML20M_CHUNKS + [
    (1, 1), (7, 8), (4096, 8), (4097, 32), (1, 33), (1, 1024), (20, 1024), (20, 2048),
    (1, 8192), (128, 8191), (3, 100_000), (1, 1100), (1023, 4096)])
def test_plan_covers_every_slot_once(R, W):
    plan = rows_plan(R, W)
    assert plan == rows_plan(R, W)              # the shape alone decides
    assert 1 <= plan.split <= MAX_SPLIT and 1 <= plan.rows_per_block <= MAX_PACK
    covered = np.zeros(W, np.int64)
    for lo, hi in _chunks(plan, W):
        assert lo < hi                          # no empty chunk
        covered[lo:hi] += 1
    assert (covered == 1).all()
    if plan.split > 1:                          # whole lines, one row a block
        assert plan.chunk % LINE == 0 and plan.rows_per_block == 1
    else:
        assert plan.chunk == W


@pytest.mark.parametrize("W", [1, 8, 32, 33, 512, 1023, 1024, 2048, 8192])
def test_plan_splits_only_few_row_wide_and_packs_only_many_row_narrow(W):
    for R in (1, 3, 42, 128, 512, 1023, 1024, 4095, 4096, 4097, 105312):
        plan = rows_plan(R, W)
        wide, few = W >= 2 * MIN_CHUNK, R < SPLIT_BLOCKS
        narrow, many = W <= NARROW, R >= PACK_ROWS
        assert (plan.split > 1) == (wide and few), (R, W, plan)
        assert (plan.rows_per_block > 1) == (narrow and many), (R, W, plan)
        assert plan.split == 1 or plan.rows_per_block == 1  # never both


def test_plan_of_the_ml20m_chunks():
    plans = {(R, W): rows_plan(R, W) for R, W in ML20M_CHUNKS}
    assert {rw for rw, p in plans.items() if p.split > 1} == {
        (512, 2048), (42, 8192), (128, 8192)}
    assert {rw for rw, p in plans.items() if p.rows_per_block > 1} == {
        (19813, 32), (105312, 8)}
    for R in (1, 42, 128):                      # few-row chunks fill the 132 SMs
        assert R * rows_plan(R, 8192).split >= min(132, 16 * R)
    assert rows_plan(42, 8192).split * 42 >= 132


def _holed(R, W, k, seed):
    """_data with a quarter of pad at the end of each row, a run of zero
    weights mid-row in every third row and every fifth row from the third
    all zero."""
    F, wo, wb = _data(R, W, k, seed=seed)
    for w in (wo, wb):
        w[:, W - W // 4:] = 0.0
        w[::3, W // 8:W // 2] = 0.0
        w[2::5] = 0.0
    return F, wo, wb


@pytest.mark.parametrize("R, W, k, path", [
    (1, 1024, 4, "split"), (3, 1024, 6, "split"), (1, 8192, 3, "split"),
    (3, 8192, 4, "split"), (4096, 8, 4, "packed"), (4097, 32, 3, "packed")])
def test_planned_shapes_match_jax_kernel_xla_path_and_float64(R, W, k, path):
    plan = rows_plan(R, W)
    assert (plan.split > 1 if path == "split" else plan.rows_per_block > 1)
    F, wo, wb = _holed(R, W, k, seed=R + W + k)
    A, b = _port(F, wo, wb)
    A64, b64 = _numpy64(F, wo, wb)
    args = (jnp.asarray(F), jnp.asarray(wo), jnp.asarray(wb))
    theirs = [rows_gram_xla(*args), jax_rows_gram(*args, interpret=True), (A64, b64)]
    # max|dA| / max|A64|, as chip_smoke.py holds the kernel on the card
    for Aj, bj in theirs:
        assert np.abs(A - np.asarray(Aj)).max() <= TOL * np.abs(A64).max()
        assert np.abs(b - np.asarray(bj)).max() <= TOL * np.abs(b64).max()
    dead = np.arange(2, R, 5)                   # rows with no weight
    assert not A[dead].any() and not b[dead].any()
