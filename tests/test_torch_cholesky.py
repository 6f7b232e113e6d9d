"""Parity of the port's batched SPD solve (predictionio_tpu_torch.ops.cholesky)
with the JAX package's Pallas kernel (interpret mode), its XLA recursion
and float64 numpy.

Systems are made like the JAX package's own tests
(tests/test_ops.py::TestCholSolve / TestCholSolvePallas): A = G Gᵀ +
0.5·I with G (k, 2k) standard normal. Tolerance: rtol/atol 2e-4, the JAX
tests' own, for f32 factorisations in different orders; identity systems
give x = b exactly.

The CUDA kernel itself runs only on the card (chip_smoke.py); here the
wrapper takes its plain version because the tensors lie on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops.cholesky import _chol_solve, chol_solve_pallas
from predictionio_tpu_torch import ops
from predictionio_tpu_torch.ops import _build
from predictionio_tpu_torch.ops.cholesky import chol_solve, chol_solve_ref

TOL = 2e-4


def _spd(n, k, seed=0, ridge=0.5):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, k, 2 * k)).astype(np.float32)
    A = G @ G.transpose(0, 2, 1) + ridge * np.eye(k, dtype=np.float32)
    b = rng.standard_normal((n, k)).astype(np.float32)
    return A, b


def _port(A, b):
    return chol_solve(torch.from_numpy(A), torch.from_numpy(b)).numpy()


@pytest.mark.parametrize("k", [1, 5, 8, 10, 16, 31, 33, 63, 65])
@pytest.mark.parametrize("N", [0, 1, 3, 130])
def test_matches_jax_solves_and_numpy(N, k):
    A, b = _spd(N, k, seed=N + k)
    x = _port(A, b)
    assert x.shape == (N, k) and x.dtype == np.float32
    if N == 0:
        return
    x64 = np.linalg.solve(A.astype(np.float64), b.astype(np.float64)[..., None])[..., 0]
    np.testing.assert_allclose(x, x64, rtol=TOL, atol=TOL)
    xr = np.asarray(_chol_solve(jnp.asarray(A), jnp.asarray(b)))
    np.testing.assert_allclose(x, xr, rtol=TOL, atol=TOL)
    # the Pallas kernel pads the batch to its 128-lane tile; in interpret
    # mode it takes seconds a case beyond k = 16, so the wider k stop here
    if N == 130 and k <= 16:
        xp = np.asarray(chol_solve_pallas(jnp.asarray(A), jnp.asarray(b),
                                          interpret=True))
        np.testing.assert_allclose(x, xp, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("k", [1, 10])
def test_identity_systems_give_b(k):
    b = np.random.default_rng(k).standard_normal((6, k)).astype(np.float32)
    A = np.broadcast_to(np.eye(k, dtype=np.float32), (6, k, k)).copy()
    np.testing.assert_array_equal(_port(A, b), b)
    np.testing.assert_array_equal(
        np.asarray(chol_solve_pallas(jnp.asarray(A), jnp.asarray(b),
                                     interpret=True)), b)


def test_ill_scaled_ridge_systems():
    # ALS-like: Gram + lambda * n * I with wildly varying scales
    rng = np.random.default_rng(9)
    k, n = 8, 32
    scale = 10.0 ** rng.uniform(-2, 4, n).astype(np.float32)
    G = rng.standard_normal((n, k, k)).astype(np.float32)
    A = (G @ G.transpose(0, 2, 1)) * scale[:, None, None]
    A += (0.05 * scale)[:, None, None] * np.eye(k, dtype=np.float32)
    b = rng.standard_normal((n, k)).astype(np.float32)
    x = _port(A, b)
    x_ref = np.linalg.solve(A, b[..., None])[..., 0]
    np.testing.assert_allclose(x, x_ref, rtol=5e-3, atol=5e-4)


def test_wrapper_on_cpu_takes_plain_version_and_counts_nothing():
    A, b = _spd(4, 6, seed=2)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    before = chol_solve.launches
    assert torch.equal(chol_solve(At, bt), chol_solve_ref(At, bt))
    assert chol_solve.launches == before  # CPU calls are not launches
    assert chol_solve in ops.LAUNCH_COUNTERS


@pytest.mark.parametrize("shapes", [((3, 4, 4), (3, 5)), ((3, 4, 5), (3, 4)),
                                    ((2, 4, 4), (3, 4)), ((4, 4), (4,))])
def test_wrapper_rejects_bad_shapes(shapes):
    with pytest.raises(ValueError, match="needs A"):
        chol_solve(torch.zeros(shapes[0]), torch.zeros(shapes[1]))


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError, match="no kernel"):
        chol_solve(torch.zeros(2, 3, 3, device="meta"), torch.zeros(2, 3, device="meta"))


def test_source_names_the_tpu_kernel_and_its_bound():
    src = (_build.CSRC / "chol_solve.cu").read_text()
    assert "predictionio_tpu/ops/cholesky.py" in src and "Bound" in src
    assert "1e-30f" in src  # the reference's pivot floor
    assert "cusolver" not in src.lower() and "cublas" not in src.lower()
