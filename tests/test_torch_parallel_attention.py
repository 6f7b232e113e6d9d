"""The port's sequence-parallel attention held against the JAX package's,
on the CPU.

The JAX side runs ``ring_attention`` and ``ulysses_attention`` as
``shard_map`` programs over the eight virtual CPU devices that
``tests/conftest.py`` forces; the port runs its slot loops over a mesh
of CPU slots (``make_mesh(devices=["cpu"] * n)``). At 2, 4 and 8 slots,
on numpy-seeded inputs:

- forward outputs within ATT_TOL of the JAX package's, for plain,
  causal, key-masked (left padding and a batch row whose keys are all
  masked) and cross-length (Sq ≠ Sk) attention; a fully masked query row
  gives exact zeros, never NaN;
- gradients of a weighted sum with respect to q, k and v, by plain
  autograd, within ATT_TOL of ``jax.grad`` of the same sum, none NaN;
- both within ATT_TOL of the one-device ``attention_reference``;
- the JAX package's errors: a sequence (or, for Ulysses, a head count)
  the axis does not divide, an axis the mesh lacks; a one-slot axis is
  the local oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from predictionio_tpu.parallel.mesh import make_mesh as jax_make_mesh
from predictionio_tpu.parallel.ring_attention import ring_attention as jax_ring
from predictionio_tpu.parallel.ulysses import ulysses_attention as jax_ulysses
from predictionio_tpu_torch.parallel import (
    MeshConfig,
    attention_reference,
    make_mesh,
    ring_attention,
    ulysses_attention,
)

ATT_TOL = 1e-5

#: (Sq, Sk, causal, masked): the cases every slot count runs
CASES = {
    "plain": (16, 16, False, False),
    "causal": (16, 16, True, False),
    "masked": (16, 16, False, True),
    "causal_masked": (16, 16, True, True),
    "cross": (16, 32, False, True),
}


def _inputs(case, seed, H=8, D=4, B=3):
    Sq, Sk, causal, masked = CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, H, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, H, D)).astype(np.float32)
    km = None
    if masked:
        km = np.ones((B, Sk), bool)
        km[0, :5] = False        # left padding: causal rows 0..4 fully masked
        km[1, :] = False         # every query row of batch row 1 fully masked
        km[2] = rng.random(Sk) > 0.3
    return q, k, v, km, causal


def _meshes(n):
    return (make_mesh(MeshConfig({"data": n}), devices=["cpu"] * n),
            jax_make_mesh(JaxMeshConfig({"data": n}), devices=jax.devices("cpu")[:n]))


def _run(fn, jfn, case, n, seed):
    """(port output, port grads, JAX output, JAX grads, weights)."""
    q, k, v, km, causal = _inputs(case, seed)
    mesh, jmesh = _meshes(n)
    w = np.random.default_rng(seed + 1).standard_normal(q.shape).astype(np.float32)
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = fn(*ts, mesh=mesh, causal=causal,
             k_mask=None if km is None else torch.from_numpy(km))
    (out * torch.from_numpy(w)).sum().backward()
    jkm = None if km is None else jnp.asarray(km)

    def loss(a, b, c):
        return (jfn(a, b, c, mesh=jmesh, causal=causal, k_mask=jkm) * w).sum()

    jout = jfn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mesh=jmesh,
               causal=causal, k_mask=jkm)
    jgrads = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v))
    return (out.detach().numpy(), [t.grad.numpy() for t in ts], np.asarray(jout),
            [np.asarray(g) for g in jgrads], (q, k, v, km, causal))


def _held(out, grads, jout, jgrads, inputs):
    q, k, v, km, causal = inputs
    assert not np.isnan(out).any() and not any(np.isnan(g).any() for g in grads)
    np.testing.assert_allclose(out, jout, rtol=ATT_TOL, atol=ATT_TOL)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g, jg, rtol=ATT_TOL, atol=ATT_TOL)
    ref = attention_reference(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                              k_mask=None if km is None else torch.from_numpy(km))
    np.testing.assert_allclose(out, ref.numpy(), rtol=ATT_TOL, atol=ATT_TOL)
    if km is not None:
        assert (out[1] == 0.0).all()            # no key at all: exact zeros
        if causal:
            assert (out[0, :5] == 0.0).all()    # only padded keys before them


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("n", [2, 4, 8])
def test_ring_attention_and_its_gradients_match_the_jax_ring(n, case):
    _held(*_run(ring_attention, jax_ring, case, n, seed=n))


@pytest.mark.parametrize("case", ["plain", "causal", "causal_masked"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_ulysses_attention_and_its_gradients_match_the_jax_ulysses(n, case):
    _held(*_run(ulysses_attention, jax_ulysses, case, n, seed=10 + n))


def test_indivisible_shapes_and_a_missing_axis_raise_the_jax_messages():
    q = torch.zeros(1, 12, 6, 4)
    mesh, jmesh = _meshes(8)
    jq = jnp.zeros((1, 12, 6, 4))
    for fn, jfn in ((ring_attention, jax_ring), (ulysses_attention, jax_ulysses)):
        with pytest.raises(ValueError) as mine:
            fn(q, q, q, mesh=mesh)
        with pytest.raises(ValueError) as theirs:
            jfn(jq, jq, jq, mesh=jmesh)
        assert str(mine.value) == str(theirs.value)
        with pytest.raises(ValueError) as mine:
            fn(q, q, q, mesh=mesh, axis="seq")
        with pytest.raises(ValueError) as theirs:
            jfn(jq, jq, jq, mesh=jmesh, axis="seq")
        assert str(mine.value) == str(theirs.value)
    # Ulysses needs the heads to divide too: 16 positions, 6 heads, 4 slots
    q = torch.zeros(1, 16, 6, 4)
    mesh, jmesh = _meshes(4)
    with pytest.raises(ValueError) as mine:
        ulysses_attention(q, q, q, mesh=mesh)
    with pytest.raises(ValueError) as theirs:
        jax_ulysses(jnp.zeros((1, 16, 6, 4)), jnp.zeros((1, 16, 6, 4)),
                    jnp.zeros((1, 16, 6, 4)), mesh=jmesh)
    assert str(mine.value) == str(theirs.value) == (
        "seq 16 and heads 6 must divide by mesh axis 'data' size 4")
    assert ring_attention(q, q, q, mesh=mesh).shape == q.shape


def test_a_one_slot_axis_is_the_local_oracle():
    q, k, v, km, causal = _inputs("causal_masked", 3)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    one = make_mesh(devices=["cpu"])
    want = attention_reference(*args, causal=True, k_mask=torch.from_numpy(km))
    for fn in (ring_attention, ulysses_attention):
        assert torch.equal(fn(*args, mesh=one, causal=True, k_mask=torch.from_numpy(km)),
                           want)
        assert torch.equal(fn(*args, causal=True, k_mask=torch.from_numpy(km)), want)
