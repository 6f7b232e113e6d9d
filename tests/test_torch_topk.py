"""Parity of the port's score → top-k (predictionio_tpu_torch.ops.topk)
with the JAX package's Pallas kernel (interpret mode) and its XLA path.

Both sides get the same numpy inputs. On small nonzero integers every
score is exact in f32, so indices must match element for element, ties
included (lowest column index first). On Gaussian data the summation
order differs, so values agree within rtol/atol 1e-5 and indices agree
except where the two candidates' float64 scores lie within 1e-5.

The CUDA kernel itself runs only on the card (chip_smoke.py); here the
wrapper takes its plain version because the tensors lie on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops.topk import score_topk as jax_score_topk
from predictionio_tpu.ops.topk import score_topk_xla
from predictionio_tpu_torch import ops
from predictionio_tpu_torch.ops import _build
from predictionio_tpu_torch.ops.topk import _mask_pad_rows, score_topk, score_topk_ref

TOL = 1e-5

# (B, N, d, k, tile, n_valid, rows_valid): the TestScoreTopK shapes of
# tests/test_ops.py, plus n_valid < Np with rows_valid < B
SHAPES = {
    "exact_tile_multiple": (4, 256, 16, 10, 64, 0, None),
    "ragged_tail": (3, 200, 8, 7, 64, 0, None),
    "single_tile": (2, 40, 4, 5, 64, 0, None),
    "masked_cols_and_pad_rows": (6, 256, 8, 12, 64, 200, 4),
    # the kernel's k <= 32 path and its boundary with the k > 32 path
    "k1_d64": (4, 256, 64, 1, 64, 0, None),
    "k32_d64": (5, 300, 64, 32, 64, 0, 3),
    "k33_d64": (5, 300, 64, 33, 64, 0, 3),
    # fewer valid columns than k: masked columns fill the list in index order
    "n_valid_below_k": (4, 256, 8, 12, 64, 5, 3),
    # the kernel's k > 32 path (a bar from the chunks' J-th keys, then a
    # sort of what reaches it): num 50 and 100 serve at k = 64 and 128
    "k64_d64": (4, 300, 64, 64, 64, 0, 3),
    "k100_d16_masked_cols": (3, 500, 16, 100, 128, 450, None),
    "k128_d64": (5, 700, 64, 128, 128, 0, 4),
    "k100_n_valid_below_k": (3, 400, 16, 100, 128, 60, 2),
    # num 1,000 serves at k = 1,024
    "k1000_d8": (2, 1500, 8, 1000, 128, 0, None),
    "k1024_d64": (3, 2000, 64, 1024, 128, 1900, 2),
}

#: shapes held against the XLA path only: the Pallas body unrolls k
#: selection rounds per tile (predictionio_tpu/ops/topk.py:89), so interpret
#: mode at k = 1,000 and more is too slow for the tier-1 run
XLA_ONLY = {"k1000_d8", "k1024_d64"}

#: shapes with fewer valid columns than k (see _PALLAS_REPEATS_MASKED)
N_VALID_BELOW_K = {"n_valid_below_k", "k100_n_valid_below_k"}


def _data(kind, B, N, d, seed):
    """Q (B, d) and V (N, d): "integer" and "ties" draw small nonzero
    integers (every score exact in f32), "ties" with V made of three
    distinct rows repeated, so most scores tie; "gaussian" draws normals."""
    rng = np.random.default_rng(seed)
    if kind == "gaussian":
        def draw(shape):
            return rng.standard_normal(shape).astype(np.float32)
    else:
        def draw(shape):  # nonzero, so no score is a signed zero
            return (rng.integers(1, 4, shape) * rng.choice([-1, 1], shape)
                    ).astype(np.float32)
    Q = draw((B, d))
    if kind == "ties":
        return Q, draw((3, d))[rng.integers(0, 3, N)]
    return Q, draw((N, d))


def _jax_topk(Q, V, k, tile, n_valid, rows_valid, pallas=True):
    """The JAX package's two paths, as its own tests run them on the CPU:
    the XLA path, then (unless ``pallas`` is False) the Pallas kernel."""
    rv = None if rows_valid is None else jnp.int32(rows_valid)
    xla = score_topk_xla(jnp.asarray(Q), jnp.asarray(V), k, n_valid=n_valid,
                         rows_valid=rv)
    yield np.asarray(xla[0]), np.asarray(xla[1])
    if pallas:
        n_pad = -V.shape[0] % tile
        Vp = np.concatenate([V, np.zeros((n_pad, V.shape[1]), np.float32)])
        v, i = jax_score_topk(jnp.asarray(Q), jnp.asarray(Vp), k, tile=tile,
                              n_valid=n_valid or V.shape[0], rows_valid=rv,
                              interpret=True)
        yield np.asarray(v), np.asarray(i)


def _scores64(Q, V, n_valid, rows_valid):
    S = Q.astype(np.float64) @ V.astype(np.float64).T
    if rows_valid is not None:
        S[rows_valid:] = 0.0
    if n_valid:
        S[:, n_valid:] = -3.0e38
    return S


def _assert_near_tie_equal(idx, ref_idx, S):
    diff = idx != ref_idx
    got = np.take_along_axis(S, idx.astype(np.int64), axis=1)
    want = np.take_along_axis(S, ref_idx.astype(np.int64), axis=1)
    assert np.all(np.abs(got - want)[diff] <= TOL)


#: the JAX package's Pallas kernel knocks a chosen candidate out by setting
#: it to -3e38, the mask value, so with fewer than k columns above the mask
#: it picks the first knocked-out column again and repeats an index; its
#: XLA path and the port fill the list with the masked columns in order
_PALLAS_REPEATS_MASKED = pytest.mark.xfail(
    strict=True, raises=AssertionError,
    reason="JAX Pallas score_topk repeats an index when n_valid < k "
           "(predictionio_tpu/ops/topk.py:96); the XLA path is checked first")


@pytest.mark.parametrize("kind", ["integer", "gaussian", "ties"])
@pytest.mark.parametrize("shape", [
    pytest.param(name, marks=_PALLAS_REPEATS_MASKED) if name in N_VALID_BELOW_K else name
    for name in SHAPES])
def test_ref_matches_pallas_and_xla(shape, kind):
    B, N, d, k, tile, n_valid, rows_valid = SHAPES[shape]
    Q, V = _data(kind, B, N, d, seed=len(shape))
    vals, idx = score_topk_ref(torch.from_numpy(Q), torch.from_numpy(V), k,
                               n_valid=n_valid, rows_valid=rows_valid)
    vals, idx = vals.numpy(), idx.numpy()
    assert vals.shape == (B, k) and idx.dtype == np.int32
    real = B if rows_valid is None else rows_valid
    S = _scores64(Q, V, n_valid, rows_valid)
    for jv, ji in _jax_topk(Q, V, k, tile, n_valid, rows_valid,
                            pallas=shape not in XLA_ONLY):
        if kind != "gaussian":
            np.testing.assert_array_equal(idx[:real], ji[:real])
            np.testing.assert_array_equal(vals[:real], jv[:real])
        else:
            np.testing.assert_allclose(vals[:real], jv[:real], rtol=TOL, atol=TOL)
            _assert_near_tie_equal(idx[:real], ji[:real], S[:real])
    # pad rows: all-zero scores (== so -0.0 and 0.0 agree), then the masked
    # columns' -3e38 where n_valid < k; idx 0..k-1
    pad_vals = np.where(np.arange(k) < (n_valid or N), 0.0, -3.0e38).astype(np.float32)
    assert np.all(vals[real:] == pad_vals)
    assert np.all(idx[real:] == np.arange(k))


def test_ties_go_to_lowest_index():
    Q = torch.ones(2, 3)
    V = torch.zeros(10, 3)
    V[[2, 5, 7]] = 1.0  # three equal best items, then seven equal zeros
    vals, idx = score_topk_ref(Q, V, 6)
    assert idx[0].tolist() == [2, 5, 7, 0, 1, 3]
    assert vals[0].tolist() == [3.0, 3.0, 3.0, 0.0, 0.0, 0.0]


def test_masked_columns_score_neg():
    Q = torch.ones(1, 2)
    V = -torch.ones(8, 2)
    vals, idx = score_topk_ref(Q, V, 8, n_valid=5)
    assert idx[0].tolist() == [0, 1, 2, 3, 4, 5, 6, 7]
    assert torch.all(vals[0, 5:] == torch.tensor(-3.0e38))
    assert torch.all(vals[0, :5] == -2.0)


def test_mask_pad_rows():
    Q = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    out = _mask_pad_rows(Q, 2)
    assert torch.equal(out[:2], Q[:2]) and torch.equal(out[2:], torch.zeros(2, 3))


def test_wrapper_on_cpu_takes_plain_version_and_counts_nothing():
    Q, V = _data("gaussian", 5, 300, 8, seed=7)
    Qt, Vt = torch.from_numpy(Q), torch.from_numpy(V)
    ids = torch.tensor([4, 0, 0, 2], dtype=torch.int32)
    before = score_topk.launches
    vals, idx = score_topk(Qt, Vt, 9, n_valid=280, rows_valid=3, ids=ids)
    rv, ri = score_topk_ref(Qt[ids.long()], Vt, 9, n_valid=280, rows_valid=3)
    assert torch.equal(vals, rv) and torch.equal(idx, ri)
    out = (torch.empty(4, 9), torch.empty(4, 9, dtype=torch.int32))
    got = score_topk(Qt, Vt, 9, n_valid=280, rows_valid=3, ids=ids, out=out)
    assert got[0] is out[0] and torch.equal(out[1], ri)
    assert score_topk.launches == before  # CPU calls are not launches
    assert score_topk in ops.LAUNCH_COUNTERS


@pytest.mark.parametrize("k", [33, 1024])
def test_wrapper_on_cpu_takes_plain_version_above_32(k):
    """The kernel's k > 32 path: on the CPU the plain version, no launch."""
    Q, V = _data("gaussian", 5, 1100, 8, seed=8)
    Qt, Vt = torch.from_numpy(Q), torch.from_numpy(V)
    ids = torch.tensor([4, 0, 0, 2], dtype=torch.int32)
    before = score_topk.launches
    out = (torch.empty(4, k), torch.empty(4, k, dtype=torch.int32))
    got = score_topk(Qt, Vt, k, n_valid=1080, rows_valid=3, ids=ids, out=out)
    rv, ri = score_topk_ref(Qt[ids.long()], Vt, k, n_valid=1080, rows_valid=3)
    assert got[0] is out[0] and torch.equal(out[0], rv) and torch.equal(out[1], ri)
    assert score_topk.launches == before


@pytest.mark.parametrize("kwargs, match", [
    ({"k": ops.MAX_K + 1}, "k="),
    ({"k": 0}, "k="),
    ({"k": 4, "n_valid": 2001}, "n_valid"),
    ({"k": 4, "rows_valid": 9}, "rows_valid"),
])
def test_wrapper_rejects_bad_arguments(kwargs, match):
    Q = torch.zeros(3, 4)
    V = torch.zeros(2000, 4)
    with pytest.raises(ValueError, match=match):
        score_topk(Q, V, **kwargs)


def test_wrapper_rejects_mismatched_widths():
    with pytest.raises(ValueError, match="needs Q"):
        score_topk(torch.zeros(3, 4), torch.zeros(10, 5), 2)


def test_source_has_one_kernel_pair_per_path():
    """k <= 32: select_kernel + merge_select_kernel; 32 < k <= 1,024:
    select_kernel in its bar mode + bar_merge_kernel. The first design's
    sort-everything kernels are gone, and no library sort is called."""
    src = (_build.CSRC / "score_topk.cu").read_text()
    for name in ("select_kernel", "merge_select_kernel", "bar_merge_kernel"):
        assert f"{name}<" in src or f"{name}(" in src
    for gone in ("chunk_topk_kernel", "merge_topk_kernel", "cub::", "thrust::"):
        assert gone not in src


def test_build_targets_hopper_from_package_source():
    cmd = _build.nvcc_command(_build.CSRC / "score_topk.cu", _build.BUILD_DIR / "x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    src = (_build.CSRC / "score_topk.cu").read_text()
    # the source names the TPU kernel it replaces and its bound
    assert "predictionio_tpu/ops/topk.py" in src and "Bound" in src
    assert _build.BUILD_DIR.parts[-2:] == ("build", "torch_kernels")
