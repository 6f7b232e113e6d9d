"""The port's item-sharded ANN serving held against the JAX package's, on
the CPU.

The JAX side serves over the eight virtual CPU devices that
``tests/conftest.py`` forces; the port over CPU slots (a ``shards_mesh``
over ``["cpu"] * S``, or ``parallel/distributed.initialize(slots=...)``
for the scorer selection, which builds its own mesh). Both read one
index: the JAX package builds it and the port loads its ``PIOANN01``
bytes. The cases are those of ``tests/test_ann_sharded.py``:

- ``shards=1`` through the sharded program is BITWISE the unsharded
  ``ANNScorer``, plain and with OPQ, and serves the JAX package's items;
- 2, 4 and 8 shards (the last slot padded) serve the unsharded scorer's
  items and scores bitwise, and the JAX sharded scorer's items with
  scores within 1e-5;
- the ops-level pieces: ``merge_shortlists`` is a dense top-k′ and the
  JAX package's merge, ``adc_shortlist`` with ``n_valid``/``col_offset``
  and ``rerank_partial`` index-equal to the JAX package's on data whose
  sums are exact in f32;
- a pad candidate is never served; a legacy v1 blob serves sharded;
- every bucket of a ladder, pad rows included, answers as the JAX
  sharded scorer; a warmed ladder builds nothing more;
- ``maybe_ann_scorer``'s resolution (``PIO_ANN_SHARDS``, then the
  argument, then the blob's hint), its cached reuse, too few slots
  degrading with the JAX package's warning, and one shard unsharded;
- the three ``pio_ann_shard_*`` gauges equal the JAX package's;
- a mesh over several processes is refused.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu import ann as jax_ann
from predictionio_tpu.ann.scorer import ANNScorer as JaxANNScorer
from predictionio_tpu.ann.scorer import ShardedANNScorer as JaxShardedANNScorer
from predictionio_tpu.ops import topk as jax_topk
from predictionio_tpu.server import aot as jax_aot
from predictionio_tpu.server.aot import BucketLadder as JaxBucketLadder
from predictionio_tpu_torch import ann
from predictionio_tpu_torch.ann.index import PQIndex
from predictionio_tpu_torch.ann.scorer import ANNScorer, ShardedANNScorer, load_blob_index
from predictionio_tpu_torch.ops import topk as port_topk
from predictionio_tpu_torch.parallel import distributed
from predictionio_tpu_torch.parallel.mesh import Mesh, shards_mesh
from predictionio_tpu_torch.server import aot as port_aot
from predictionio_tpu_torch.server.aot import BucketLadder
from tests.test_ann_sharded import _corpus
from tests.test_torch_ann import _quarter, _tied_inputs

SCORE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _restore_aot_counters():
    """The dispatch and cache-lookup counters and the shard gauges are
    process-wide in both packages; this module must not move what later
    files read."""
    counters = (jax_aot.EXECUTABLES._m_lookups, jax_aot._DISPATCHES,
                port_aot.EXECUTABLES._m_lookups, port_aot._DISPATCHES,
                jax_aot.ANN_SHARDS, jax_aot.ANN_SHARD_ITEMS, jax_aot.ANN_SHARD_MERGE,
                port_aot.ANN_SHARDS, port_aot.ANN_SHARD_ITEMS, port_aot.ANN_SHARD_MERGE)
    snaps = [dict(c._values) for c in counters]
    yield
    for c, snap in zip(counters, snaps):
        with c._lock:
            c._values.clear()
            c._values.update(snap)


def _pair(n=3000, seed=8, m=4, K=16, **kw):
    """(U, V, JAX index, the port's copy of it)."""
    U, V = _corpus(n=n, seed=seed)
    jidx = jax_ann.build_index(V, m, K, iters=3, sample=len(V), **kw)
    return U, V, jidx, PQIndex.from_bytes(jidx.to_bytes())


def _sharded(U, V, idx, shards, shortlist=64):
    return ShardedANNScorer(U, V, idx, shortlist=shortlist,
                            mesh=shards_mesh(shards, ["cpu"] * shards))


# -- shards=1 bitwise ----------------------------------------------------------


@pytest.mark.parametrize("opq", [False, True])
def test_one_shard_is_bitwise_the_unsharded_scorer(opq):
    U, V, jidx, idx = _pair(seed=9 if opq else 8, **({"opq": True, "opq_iters": 2}
                                                   if opq else {}))
    assert (idx.rotation is not None) == opq
    ids = np.arange(32 if not opq else 16, dtype=np.int32)
    bv, bi = ANNScorer(U, V, idx, shortlist=64, device="cpu")._topk(ids, 10)
    s1 = _sharded(U, V, idx, 1)
    assert s1.shards == 1 and s1.local_n == len(V)
    sv, si = s1._topk(ids, 10)
    assert np.array_equal(bv, sv) and np.array_equal(bi, si)   # bitwise
    jv, ji = JaxShardedANNScorer(U, V, jidx, shortlist=64, shards=1)._topk(ids, 10)
    np.testing.assert_array_equal(si, ji)
    np.testing.assert_allclose(sv, jv, rtol=SCORE_TOL, atol=SCORE_TOL)


# -- the distributed merge on real meshes ---------------------------------------


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_sharded_equals_unsharded_and_the_jax_sharded_scorer(shards):
    U, V, jidx, idx = _pair(n=3100, seed=10)   # uneven: the last slot padded
    sh = _sharded(U, V, idx, shards)
    assert sh.local_n * shards >= 3100 and len(sh._V_parts) == shards
    assert all(p.shape == (sh.local_n, V.shape[1]) for p in sh._V_parts)
    ids = np.arange(32, dtype=np.int32)
    bv, bi = ANNScorer(U, V, idx, shortlist=64, device="cpu")._topk(ids, 16)
    sv, si = sh._topk(ids, 16)
    # every global winner wins its own slot under the key order, and the
    # owner's re-rank score plus exact zeros is the unsharded score
    assert np.array_equal(bi, si) and np.array_equal(bv, sv)
    jv, ji = JaxShardedANNScorer(U, V, jidx, shortlist=64, shards=shards)._topk(ids, 16)
    np.testing.assert_array_equal(si, ji)
    np.testing.assert_allclose(sv, jv, rtol=SCORE_TOL, atol=1e-6)


def test_merge_shortlists_is_a_dense_topk_and_the_jax_merge():
    rng = np.random.default_rng(3)
    S, B, kp = 4, 8, 16
    vals = -np.sort(-rng.standard_normal((S, B, kp)).astype(np.float32), axis=-1)
    idx = rng.integers(0, 10_000, (S, B, kp)).astype(np.int32)
    mv, mi = port_topk.merge_shortlists(torch.from_numpy(vals), torch.from_numpy(idx), kp)
    assert mi.dtype == torch.int32
    jv, ji = jax_topk.merge_shortlists(jnp.asarray(vals), jnp.asarray(idx), kp)
    np.testing.assert_array_equal(mi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(mv.numpy(), np.asarray(jv))
    flat_v = np.moveaxis(vals, 0, 1).reshape(B, S * kp)
    flat_i = np.moveaxis(idx, 0, 1).reshape(B, S * kp)
    for b in range(B):
        order = np.argsort(-flat_v[b], kind="stable")[:kp]
        np.testing.assert_array_equal(mv.numpy()[b], flat_v[b][order])
        np.testing.assert_array_equal(mi.numpy()[b], flat_i[b][order])
    # one shard: the input back unchanged
    one = port_topk.merge_shortlists(torch.from_numpy(vals[:1]), torch.from_numpy(idx[:1]), kp)
    np.testing.assert_array_equal(one[0].numpy(), vals[0])
    np.testing.assert_array_equal(one[1].numpy(), idx[0])


@pytest.mark.parametrize("kprime", [1, 128])
def test_slot_shortlists_at_an_offset_merge_to_the_dense_one(kprime):
    """Four column blocks of tied quarter-valued data (the last padded),
    each scanned at its global offset with the corpus's n_valid: index-
    and value-equal to the JAX package's per-shard call, and merged they
    are the dense shortlist of the whole corpus, ties included."""
    Q, C, codes = _tied_inputs(7, N=70_001)
    N, S = codes.shape[1], 4
    local = -(-N // S)
    padded = np.concatenate([codes, np.zeros((codes.shape[0], S * local - N), np.uint8)], 1)
    parts = []
    for s in range(S):
        block = padded[:, s * local:(s + 1) * local]
        jv, ji = jax_topk.adc_shortlist(jnp.asarray(Q), jnp.asarray(C), jnp.asarray(block),
                                        kprime, n_valid=N, col_offset=s * local)
        pv, pi = port_topk.adc_shortlist(torch.from_numpy(Q), torch.from_numpy(C),
                                         torch.from_numpy(block), kprime, n_valid=N,
                                         col_offset=s * local)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
        assert pi.numpy().max() < N
        parts.append((pv, pi))
    mv, mi = port_topk.merge_shortlists(torch.stack([v for v, _ in parts]),
                                        torch.stack([i for _, i in parts]), kprime)
    dv, di = port_topk.adc_shortlist(torch.from_numpy(Q), torch.from_numpy(C),
                                     torch.from_numpy(codes), kprime)
    np.testing.assert_array_equal(mi.numpy(), di.numpy())
    np.testing.assert_array_equal(mv.numpy(), dv.numpy())
    # the defaults leave the one-device call byte-identical
    ov, oi = port_topk.adc_shortlist(torch.from_numpy(Q), torch.from_numpy(C),
                                     torch.from_numpy(codes), kprime, n_valid=0,
                                     col_offset=None)
    assert torch.equal(ov, dv) and torch.equal(oi, di)


def test_rerank_partial_sums_to_the_exact_rerank():
    rng = np.random.default_rng(8)
    Q = _quarter(rng, (6, 8))
    V = _quarter(rng, (3000, 8), -2, 3)
    short = np.stack([rng.choice(3000, 200, replace=False) for _ in range(6)]).astype(np.int32)
    total = None
    for s in range(4):
        block = V[s * 750:(s + 1) * 750]
        part = port_topk.rerank_partial(torch.from_numpy(Q), torch.from_numpy(block),
                                        torch.from_numpy(short), s * 750)
        want = jax_topk.rerank_partial(jnp.asarray(Q), jnp.asarray(block),
                                       jnp.asarray(short), s * 750)
        np.testing.assert_array_equal(part.numpy(), np.asarray(want))
        total = part if total is None else total + part
    np.testing.assert_array_equal(total.numpy(), np.einsum("bd,bqd->bq", Q, V[short]))


def test_pad_candidates_never_served():
    """k′·S beyond the corpus forces pad rows through the merge."""
    U, V, jidx, idx = _pair(n=50, seed=11, K=8)
    sh = _sharded(U, V, idx, 4, shortlist=16)
    assert sh.local_n * 4 > 50 and sh.shortlist == sh.local_n == 13
    ids = np.arange(8, dtype=np.int32)
    _, si = sh._topk(ids, 8)
    assert si.max() < 50
    _, ji = JaxShardedANNScorer(U, V, jidx, shortlist=16, shards=4)._topk(ids, 8)
    np.testing.assert_array_equal(si, ji)


def test_a_legacy_v1_blob_serves_sharded():
    U, V, jidx, idx = _pair(n=600, seed=14)
    assert idx.rotation is None and not idx.meta.get("shards")
    ids = np.arange(8, dtype=np.int32)
    bv, bi = ANNScorer(U, V, idx, shortlist=64, device="cpu")._topk(ids, 8)
    sv, si = _sharded(U, V, idx, 2)._topk(ids, 8)
    assert np.array_equal(bi, si)


# -- pad masking across AOT buckets ---------------------------------------------


def test_every_bucket_answers_as_the_jax_sharded_scorer():
    U, V, jidx, idx = _pair(n=2600, seed=16)
    sh = _sharded(U, V, idx, 4)
    jsh = JaxShardedANNScorer(U, V, jidx, shortlist=64, shards=4)
    base = ANNScorer(U, V, idx, shortlist=64, device="cpu")
    # the same buckets on both port scorers: a batch's padded size is
    # part of what its products round
    sh.warm_buckets(BucketLadder([4, 8, 16]), ks=(8,))
    base.warm_buckets(BucketLadder([4, 8, 16]), ks=(8,))
    jsh.warm_buckets(JaxBucketLadder([4, 8, 16]), ks=(8,))
    for B in (1, 3, 4, 5, 8, 11, 16):   # off-bucket → pad rows
        ids = np.arange(B, dtype=np.int32)
        got = sh.recommend_batch(ids, 8)
        assert len(got) == B
        for (gi, gv), (wi, wv), (bi, bv) in zip(got, jsh.recommend_batch(ids, 8),
                                                base.recommend_batch(ids, 8)):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_allclose(gv, wv, rtol=SCORE_TOL, atol=1e-6)
            np.testing.assert_array_equal(gi, bi)
            np.testing.assert_array_equal(gv, bv)


def test_a_warmed_ladder_builds_nothing_more():
    U, V, _, idx = _pair(n=2400, seed=17)
    sh = _sharded(U, V, idx, 2)
    sh.warm_buckets(BucketLadder([8, 16]), ks=(8,))
    sh.recommend_batch(np.arange(8, dtype=np.int32), 8)
    before = port_aot.EXECUTABLES.counts().get("compile", 0)
    dispatched = port_aot._DISPATCHES.get(("16", "ann"))
    for B in (2, 8, 13, 16):
        sh.recommend_batch(np.arange(B, dtype=np.int32), 8)
    assert port_aot.EXECUTABLES.counts().get("compile", 0) == before
    assert port_aot._DISPATCHES.get(("16", "ann")) == dispatched + 2
    key = sh._aot_key(8, 8)
    assert key[0] == "ann_sharded_topk" and 2 in key and sh.local_n in key


# -- scorer selection ------------------------------------------------------------


@pytest.fixture
def eight_slots():
    distributed.initialize(slots=["cpu"] * 8)
    yield
    distributed.shutdown()


def test_the_blob_hint_selects_sharded_and_is_reused(monkeypatch, eight_slots):
    monkeypatch.setenv("PIO_ALS_SERVE", "device")
    monkeypatch.delenv("PIO_ANN_SHARDS", raising=False)
    U, V, jidx, idx = _pair(n=400, seed=18, K=8, shards=2)
    assert idx.meta.get("shards") == 2
    s = ann.maybe_ann_scorer(U, V, idx, device="cpu")
    js = jax_ann.maybe_ann_scorer(U, V, jidx)
    assert type(s) is ShardedANNScorer and type(js) is JaxShardedANNScorer
    assert s.shards == js.shards == 2
    assert ann.maybe_ann_scorer(U, V, idx, cached=s, device="cpu") is s
    assert ann.maybe_ann_scorer(U, V, idx, cached=s, shortlist=32, device="cpu") is not s


def test_env_beats_the_argument_beats_the_hint(monkeypatch, eight_slots):
    monkeypatch.setenv("PIO_ALS_SERVE", "device")
    U, V, jidx, idx = _pair(n=400, seed=19, K=8, shards=2)
    for env, arg, want in (("4", 2, 4), (None, 8, 8), (None, 0, 2), ("1", 4, 1)):
        if env is None:
            monkeypatch.delenv("PIO_ANN_SHARDS", raising=False)
        else:
            monkeypatch.setenv("PIO_ANN_SHARDS", env)
        s = ann.maybe_ann_scorer(U, V, idx, shards=arg, device="cpu")
        js = jax_ann.maybe_ann_scorer(U, V, jidx, shards=arg)
        assert type(s).__name__ == type(js).__name__
        assert getattr(s, "shards", 1) == getattr(js, "shards", 1) == want


def test_too_few_slots_degrade_with_the_jax_warning(monkeypatch, caplog):
    monkeypatch.setenv("PIO_ALS_SERVE", "device")
    monkeypatch.delenv("PIO_ANN_SHARDS", raising=False)
    U, V, jidx, idx = _pair(n=400, seed=20, K=8)
    with caplog.at_level(logging.WARNING, logger="pio.ann"):
        theirs = jax_ann.maybe_ann_scorer(U, V, jidx, shards=64)   # > 8 devices
        mine = ann.maybe_ann_scorer(U, V, idx, shards=64, device="cpu")  # one CPU slot
    assert type(theirs) is JaxANNScorer and type(mine) is ANNScorer
    said = [r.getMessage() for r in caplog.records if r.name == "pio.ann"]
    assert said == ["sharded ANN serving unavailable (mesh needs 64 devices, have 8); "
                    "serving unsharded",
                    "sharded ANN serving unavailable (mesh needs 64 devices, have 1); "
                    "serving unsharded"]
    with pytest.raises(ValueError, match="mesh needs 2 devices, have 1"):
        ShardedANNScorer(U, V, idx, shards=2, device="cpu")
    with pytest.raises(ValueError, match="needs shards >= 1"):
        ShardedANNScorer(U, V, idx, device="cpu")


def test_one_shard_means_unsharded(monkeypatch):
    monkeypatch.setenv("PIO_ALS_SERVE", "device")
    monkeypatch.delenv("PIO_ANN_SHARDS", raising=False)
    U, V, jidx, idx = _pair(n=400, seed=21, K=8)
    assert type(ann.maybe_ann_scorer(U, V, idx, shards=1, device="cpu")) is ANNScorer
    assert type(jax_ann.maybe_ann_scorer(U, V, jidx, shards=1)) is JaxANNScorer
    # the blob's hint no longer refuses at load
    hinted = PQIndex.from_bytes(_pair(n=400, seed=21, K=8, shards=4)[3].to_bytes())
    assert load_blob_index({"ann_index": hinted.to_bytes()}, None).meta["shards"] == 4


def test_the_shard_gauges_equal_the_jax_packages():
    U, V, jidx, idx = _pair(n=3100, seed=10)
    _sharded(U, V, idx, 4, shortlist=128)
    JaxShardedANNScorer(U, V, jidx, shortlist=128, shards=4)
    got = [g.get() for g in (port_aot.ANN_SHARDS, port_aot.ANN_SHARD_ITEMS,
                             port_aot.ANN_SHARD_MERGE)]
    want = [g.get() for g in (jax_aot.ANN_SHARDS, jax_aot.ANN_SHARD_ITEMS,
                              jax_aot.ANN_SHARD_MERGE)]
    assert got == want == [4, 775, 512]


def test_a_mesh_over_several_processes_is_refused():
    U, V, _, idx = _pair(n=400, seed=22, K=8)
    grid = np.empty(2, dtype=object)
    grid[0], grid[1] = torch.device("cpu"), torch.device("cpu")
    with pytest.raises(ValueError, match="runs over the slots of one process"):
        ShardedANNScorer(U, V, idx, mesh=Mesh(grid, ("shards",), np.asarray([0, 1])))
    with pytest.raises(ValueError, match='must carry a "shards" axis'):
        ShardedANNScorer(U, V, idx, mesh=Mesh(grid, ("data",)))
