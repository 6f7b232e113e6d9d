"""The port's ANN subsystem (``predictionio_tpu_torch/ann`` and the ADC
math of ``ops/topk.py``) held against the JAX package's, on the CPU.

- ``PIOANN01`` blobs, version 1 (plain PQ) and version 2 (OPQ rotation,
  shard hint), are byte-equal both ways and give equal manifests; a
  corrupt payload, structural damage and the ``ann.index.corrupt`` fault
  site are refused with ``IntegrityError`` by both packages;
- Lloyd codebooks agree within 1e-5 on well-separated data; ``encode``
  on shared codebooks agrees except on rows whose best two centroid
  distances lie within 1e-5 of each other (their count is asserted);
  the OPQ rotation is orthogonal and within 1e-4 of the JAX package's;
- ``adc_scores`` agree within 1e-5 on Gaussian data; ``adc_shortlist``
  and ``rerank_topk`` are index-equal on data whose sums are exact in
  f32 (multiples of 1/4), so ties are forced and both packages must
  break them alike: the JAX package's dense and streamed paths (N =
  70,000, d 8, m 4, K 16) against the port at its default tile width and
  two others;
- ``ANNScorer`` answers the JAX package's across AOT buckets with pad
  rows, with exclusions and with ``num`` past the shortlist (the k
  clamp); a shard count above 1 raises;
- ``pio index status`` (text, ``--json`` and ``--shards``) prints the
  JAX verb's bytes on one home, with no torch module loaded.

Data crosses between the packages as numpy arrays and bytes.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu import ann as jax_ann
from predictionio_tpu.ann import pq as jax_pq
from predictionio_tpu.ann.index import PQIndex as JaxPQIndex
from predictionio_tpu.ops import topk as jax_topk
from predictionio_tpu.server import aot as jax_aot
from predictionio_tpu.server.aot import BucketLadder as JaxBucketLadder
from predictionio_tpu.utils.faults import FAULTS as JAX_FAULTS
from predictionio_tpu.utils.integrity import IntegrityError as JaxIntegrityError
from predictionio_tpu_torch import ann
from predictionio_tpu_torch.ann import pq
from predictionio_tpu_torch.ann.index import PQIndex
from predictionio_tpu_torch.ops import topk as port_topk
from predictionio_tpu_torch.server import aot as port_aot
from predictionio_tpu_torch.server.aot import BucketLadder
from predictionio_tpu_torch.utils.faults import FAULTS as PORT_FAULTS
from predictionio_tpu_torch.utils.integrity import IntegrityError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODEBOOK_TOL = 1e-5
SCORE_TOL = 1e-5
NEAR_TIE = 1e-5   # encode: rows whose two best distances are this close
OPQ_TOL = 1e-4


@pytest.fixture(autouse=True)
def disarm_faults():
    JAX_FAULTS.disarm()
    PORT_FAULTS.disarm()
    yield
    JAX_FAULTS.disarm()
    PORT_FAULTS.disarm()


@pytest.fixture(autouse=True, scope="module")
def _restore_aot_counters():
    """The dispatch and cache-lookup counters are process-wide in both
    packages; this module's scorers must not move what later files read."""
    counters = (jax_aot.EXECUTABLES._m_lookups, jax_aot._DISPATCHES,
                port_aot.EXECUTABLES._m_lookups, port_aot._DISPATCHES)
    snaps = [dict(c._values) for c in counters]
    yield
    for c, snap in zip(counters, snaps):
        with c._lock:
            c._values.clear()
            c._values.update(snap)


def _clustered(n, d, centers, seed=0, noise=0.2):
    """Unit-norm corpus with cluster structure (the JAX tests' maker)."""
    rng = np.random.default_rng(seed)
    C = rng.standard_normal((centers, d)).astype(np.float32)
    V = (C[rng.integers(0, centers, size=n)]
         + noise * rng.standard_normal((n, d)).astype(np.float32))
    V /= np.linalg.norm(V, axis=1, keepdims=True) + 1e-9
    return V


def _separated(n, m, dsub, clusters, seed=0):
    """Per subspace, ``clusters`` tight clusters (spread 1e-5) at
    Gaussian positions of scale 10. A centroid takes whole clusters; two
    centroids seeded in one cluster may split it differently in the two
    packages, but only by points 1e-5 apart, inside the limit."""
    rng = np.random.default_rng(seed)
    cols = []
    for _ in range(m):
        centres = 10.0 * rng.standard_normal((clusters, dsub))
        cols.append(centres[rng.integers(0, clusters, n)]
                    + 1e-5 * rng.standard_normal((n, dsub)))
    return np.concatenate(cols, axis=1).astype(np.float32)


def _quarter(rng, shape, lo=-4, hi=5):
    """Multiples of 1/4 with small numerators: products and short sums of
    them are exact in f32, so both packages compute identical scores."""
    return (rng.integers(lo, hi, shape) / 4).astype(np.float32)


# -- the PIOANN01 blob ---------------------------------------------------------


def _jax_index(opq=False, shards=None):
    V = _clustered(600, 16, 12, seed=3)
    return jax_ann.build_index(V, 4, 16, iters=3, sample=600, opq=opq,
                               opq_iters=2, shards=shards)


@pytest.mark.parametrize("kind", ["v1", "v2-rotation", "v2-shards"])
def test_blobs_byte_equal_both_ways_and_manifests(kind, tmp_path):
    opq, shards = {"v1": (False, None), "v2-rotation": (True, None),
                   "v2-shards": (False, 4)}[kind]
    jidx = _jax_index(opq, shards)
    blob = jidx.to_bytes()
    pidx = PQIndex.from_bytes(blob)
    assert pidx.to_bytes() == blob
    assert JaxPQIndex.from_bytes(pidx.to_bytes()).to_bytes() == blob
    # a port-built index goes the other way
    V = _clustered(500, 16, 10, seed=4)
    built = ann.build_index(V, 4, 16, iters=3, sample=500, opq=opq, opq_iters=2,
                            shards=shards, device="cpu")
    pblob = built.to_bytes()
    assert JaxPQIndex.from_bytes(pblob).to_bytes() == pblob
    want_version = 1 if kind == "v1" else 2
    assert json.loads(pblob[12:12 + int.from_bytes(pblob[8:12], "little")])[
        "version"] == want_version
    digest = "ab" * 32
    assert ann.manifest_dict(pidx, digest) == jax_ann.manifest_dict(jidx, digest)
    # the file layout: blob + sidecar + manifest, read by the other package
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    ann.save_index(pidx, str(tmp_path / "port"))
    jax_ann.save_index(jidx, str(tmp_path / "jax"))
    for name in (ann.INDEX_BASENAME, ann.INDEX_BASENAME + ".sha256",
                 ann.MANIFEST_BASENAME):
        a = (tmp_path / "port" / name).read_bytes()
        b = (tmp_path / "jax" / name).read_bytes()
        assert a == b, name
    assert jax_ann.load_index(str(tmp_path / "port")).to_bytes() == blob
    assert ann.load_index(str(tmp_path / "jax")).to_bytes() == blob
    assert ann.load_index(str(tmp_path / "nope")) is None
    if shards:
        assert ann.shard_view(ann.manifest_dict(pidx, digest), 3) == \
            jax_ann.shard_view(jax_ann.manifest_dict(jidx, digest), 3)


def test_corrupt_blobs_and_the_fault_site_are_refused_by_both(tmp_path):
    blob = bytearray(_jax_index().to_bytes())
    blob[len(blob) // 2] ^= 0xFF   # payload damage → digest mismatch
    for cls, err in ((JaxPQIndex, JaxIntegrityError), (PQIndex, IntegrityError)):
        with pytest.raises(err, match="checksum mismatch"):
            cls.from_bytes(bytes(blob))
        with pytest.raises(err, match="corrupt"):
            cls.from_bytes(b"NOTANANN" + b"\x00" * 64)
        with pytest.raises(err, match="corrupt"):
            cls.from_bytes(bytes(blob[:20]))
    # a damaged file fails its sidecar in both packages
    ann.save_index(_jax_index(), str(tmp_path))
    path = tmp_path / ann.INDEX_BASENAME
    raw = bytearray(path.read_bytes())
    raw[-1] ^= 0x01
    path.write_bytes(bytes(raw))
    with pytest.raises(JaxIntegrityError):
        jax_ann.load_index(str(tmp_path))
    with pytest.raises(IntegrityError):
        ann.load_index(str(tmp_path))
    # the fault site flips the blob at the one load choke point
    good = _jax_index().to_bytes()
    for faults, cls, err in ((JAX_FAULTS, JaxPQIndex, JaxIntegrityError),
                             (PORT_FAULTS, PQIndex, IntegrityError)):
        faults.arm("ann.index.corrupt")
        with pytest.raises(err):
            cls.from_bytes(good)
        faults.disarm()
        assert cls.from_bytes(good).to_bytes() == good


# -- codebooks, encode, OPQ ----------------------------------------------------


def test_lloyd_codebooks_agree_on_separated_data():
    V = _separated(3000, 4, 2, 36, seed=1)
    for sample in (3000, 1000):   # the whole corpus, and a drawn sample
        jc = jax_pq.train_codebooks(V, 4, 12, iters=6, seed=5, sample=sample)
        pc = pq.train_codebooks(V, 4, 12, iters=6, seed=5, sample=sample,
                                device="cpu")
        assert pc.shape == jc.shape == (4, 12, 2)
        assert np.abs(pc - jc).max() <= CODEBOOK_TOL * np.abs(jc).max()
    # fewer rows than centroids: the seeded centroids (jittered copies
    # included) are the same draws, bit for bit
    small = V[:7]
    np.testing.assert_array_equal(pq.train_codebooks(small, 4, 12, iters=0, device="cpu"),
                                  jax_pq.train_codebooks(small, 4, 12, iters=0))
    with pytest.raises(ValueError, match="split evenly"):
        pq.train_codebooks(V, 3, 12, device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        pq.train_codebooks(V, 4, 257, device="cpu")


def test_encode_on_shared_codebooks_equal_up_to_near_ties():
    V = _clustered(20000, 16, 30, seed=2)
    C = jax_pq.train_codebooks(V, 4, 64, iters=4, sample=4000)
    jcodes = jax_pq.encode(V, C)
    pcodes = pq.encode(V, C, device="cpu")
    # the rows whose best two centroids lie within NEAR_TIE
    d = ((V.reshape(-1, 4, 1, 4).astype(np.float64) - C[None].astype(np.float64)) ** 2).sum(-1)
    two = np.sort(d, axis=-1)[..., :2]
    near = (two[..., 1] - two[..., 0] <= NEAR_TIE).any(axis=1)
    differ = (pcodes != jcodes).any(axis=1)
    assert not (differ & ~near).any()
    assert near.sum() <= 0.01 * len(V), f"{near.sum()} near-tie rows"  # 56 of 20,000
    assert pcodes.dtype == np.uint8 and pcodes.shape == (20000, 4)
    np.testing.assert_array_equal(pq.decode(pcodes, C), jax_pq.decode(pcodes, C))
    assert abs(pq.reconstruction_mse(V, C, pcodes)
               - jax_pq.reconstruction_mse(V, C, jcodes)) <= 1e-6


def test_opq_rotation_orthogonal_and_equal():
    V = _separated(2000, 4, 2, 24, seed=3)
    V = V @ np.linalg.qr(np.random.default_rng(4).standard_normal((8, 8)))[0].astype(np.float32)
    jR, jC = jax_pq.train_opq(V, 4, 8, iters=4, opq_iters=3, seed=2, sample=1500)
    pR, pC = pq.train_opq(V, 4, 8, iters=4, opq_iters=3, seed=2, sample=1500,
                          device="cpu")
    assert np.abs(pR.astype(np.float64) @ pR.T - np.eye(8)).max() <= 1e-5
    assert np.abs(pR - jR).max() <= OPQ_TOL
    assert np.abs(pC - jC).max() <= OPQ_TOL * np.abs(jC).max()
    R0, _ = pq.train_opq(V, 4, 8, iters=2, opq_iters=0, device="cpu")
    np.testing.assert_array_equal(R0, np.eye(8, dtype=np.float32))


# -- ADC scan, shortlist, re-rank ----------------------------------------------


def test_adc_scores_within_tolerance():
    rng = np.random.default_rng(6)
    Q = rng.standard_normal((5, 16)).astype(np.float32)
    C = rng.standard_normal((4, 32, 4)).astype(np.float32)
    codes = rng.integers(0, 32, (4, 5000)).astype(np.uint8)
    j = np.asarray(jax_topk.adc_scores(jnp.asarray(Q), jnp.asarray(C), jnp.asarray(codes)))
    p = port_topk.adc_scores(torch.from_numpy(Q), torch.from_numpy(C),
                             torch.from_numpy(codes)).numpy()
    assert np.abs(p - j).max() <= SCORE_TOL * np.abs(j).max()


def _tied_inputs(seed, N=70_000, d=8, m=4, K=16, B=5):
    rng = np.random.default_rng(seed)
    return (_quarter(rng, (B, d)), _quarter(rng, (m, K, d // m)),
            rng.integers(0, K, (m, N)).astype(np.uint8))


@pytest.mark.parametrize("kprime", [1, 128, 40_000])
def test_adc_shortlist_index_equal_dense_streamed_and_any_tile(kprime):
    Q, C, codes = _tied_inputs(7)
    args = (jnp.asarray(Q), jnp.asarray(C), jnp.asarray(codes), kprime)
    streamed = jax_topk.adc_shortlist(*args)            # N > 2 · 32,768
    dense = jax_topk.adc_shortlist(*args, chunk=65_536)  # one dense tile
    for jv, ji in (streamed, dense):
        np.testing.assert_array_equal(np.asarray(ji), np.asarray(streamed[1]))
    scores = np.asarray(jax_topk.adc_scores(*args[:3]))
    boundary = [int((scores[b] == scores[b, np.asarray(streamed[1])[b, -1]]).sum())
                for b in range(len(Q))]
    assert max(boundary) > 1       # the k′-th score is shared: ties are forced
    for tile in (None, 4096, 32_768, 70_000):
        pv, pi = port_topk.adc_shortlist(torch.from_numpy(Q), torch.from_numpy(C),
                                         torch.from_numpy(codes), kprime, tile=tile)
        assert pi.dtype == torch.int32
        np.testing.assert_array_equal(pi.numpy(), np.asarray(streamed[1]))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(streamed[0]))


def test_rerank_topk_index_equal_with_ties():
    rng = np.random.default_rng(8)
    Q = _quarter(rng, (6, 8))
    V = _quarter(rng, (3000, 8), -2, 3)
    short = np.stack([rng.choice(3000, 200, replace=False) for _ in range(6)]).astype(np.int32)
    jv, ji = jax_topk.rerank_topk(jnp.asarray(Q), jnp.asarray(V), jnp.asarray(short), 50)
    pv, pi = port_topk.rerank_topk(torch.from_numpy(Q), torch.from_numpy(V),
                                   torch.from_numpy(short), 50)
    exact = np.einsum("bd,bqd->bq", Q, V[short])
    assert max(len(np.unique(r)) for r in exact) < 200   # ties inside the shortlists
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


# -- the scorer ----------------------------------------------------------------


def _scorers(n=2500, d=16, shortlist=256, seed=8):
    V = _clustered(n, d, 40, seed=seed)
    rng = np.random.default_rng(seed + 1)
    U = V[rng.integers(0, n, size=64)] + 0.1 * rng.standard_normal((64, d)).astype(np.float32)
    U /= np.linalg.norm(U, axis=1, keepdims=True) + 1e-9
    jidx = jax_ann.build_index(V, 4, 64, iters=5, sample=n, opq=True, opq_iters=2)
    pidx = PQIndex.from_bytes(jidx.to_bytes())
    return (U, V, jax_ann.ANNScorer(U, V, jidx, shortlist=shortlist),
            ann.ANNScorer(U, V, pidx, shortlist=shortlist, device="cpu"))


def _same(got, want):
    for (pi, pv), (ji, jv) in zip(got, want):
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_allclose(pv, jv, rtol=0, atol=SCORE_TOL)


def test_scorer_answers_across_buckets_with_pad_rows():
    U, V, js, ps = _scorers()
    for s in (js, ps):
        warm = s.warm_buckets(JaxBucketLadder([2, 4, 8]) if s is js
                              else BucketLadder([2, 4, 8]), ks=(10,))
        assert warm["targets"] == 3
    jit0 = sum(v for k, v in port_aot._DISPATCHES._values.items() if k[1] == "jit")
    ann0 = sum(v for k, v in port_aot._DISPATCHES._values.items() if k[1] == "ann")
    singles = {u: ps.recommend(u, 10) for u in range(8)}
    for B in (1, 2, 3, 5, 7, 8):   # every bucket, padded and full
        ids = np.arange(B, dtype=np.int32)
        got = ps.recommend_batch(ids, 10)
        _same(got, js.recommend_batch(ids, 10))
        for u, (iv, vv) in enumerate(got):
            np.testing.assert_array_equal(iv, singles[u][0])
            np.testing.assert_array_equal(vv, singles[u][1])
    # every batch snaps to a warmed bucket (B = 1 to 2): 8 singles and 6
    # batches, all on "ann", no warm-up gap
    assert sum(v for k, v in port_aot._DISPATCHES._values.items()
               if k[1] == "ann") - ann0 == 14
    assert sum(v for k, v in port_aot._DISPATCHES._values.items()
               if k[1] == "jit") - jit0 == 0


def test_scorer_exclusion_and_the_k_clamp():
    U, V, js, ps = _scorers(shortlist=20)
    ids = np.arange(5, dtype=np.int32)
    excl = [np.arange(3), None, np.asarray([7, 8, 9]), np.arange(40), None]
    _same(ps.recommend_batch(ids, 6, exclude=excl), js.recommend_batch(ids, 6, exclude=excl))
    # num past the shortlist: k clamps to k′ in both
    got = ps.recommend_batch(ids, 50)
    _same(got, js.recommend_batch(ids, 50))
    assert all(len(iv) == 20 for iv, _ in got)
    iv, _ = ps.recommend(3, 5, exclude=got[3][0][:2])
    assert not set(iv) & set(got[3][0][:2])
    with pytest.raises(ValueError, match="user rows"):
        ps.recommend_batch(np.asarray([64]), 5)


def test_maybe_ann_scorer_policy_and_shards(monkeypatch):
    V = _clustered(2500, 16, 40, seed=8)
    U = V[:64].copy()
    idx = ann.build_index(V, 4, 16, iters=2, sample=2500, device="cpu")
    monkeypatch.delenv("PIO_ALS_SERVE", raising=False)
    monkeypatch.delenv("PIO_ANN_SHARDS", raising=False)
    assert ann.maybe_ann_scorer(U, V, None, device="cpu") is None
    s = ann.maybe_ann_scorer(U, V, idx, device="cpu")
    assert isinstance(s, ann.ANNScorer)
    assert ann.maybe_ann_scorer(U, V, idx, s, device="cpu") is s
    assert ann.maybe_ann_scorer(U, V, idx, s, shortlist=64, device="cpu") is not s
    assert ann.maybe_ann_scorer(U[:10], V[:100], None, device="cpu") is None
    monkeypatch.setenv("PIO_ALS_SERVE", "host")
    assert ann.maybe_ann_scorer(U, V, idx, device="cpu") is None
    monkeypatch.setenv("PIO_ALS_SERVE", "device")
    for how in ("arg", "env", "hint"):
        hinted = PQIndex.from_bytes(idx.to_bytes())
        kw = {}
        if how == "arg":
            kw["shards"] = 2
        elif how == "env":
            monkeypatch.setenv("PIO_ANN_SHARDS", "4")
        else:
            hinted.meta["shards"] = 2
        with pytest.raises(ValueError, match="item 8"):
            ann.maybe_ann_scorer(U, V, hinted, device="cpu", **kw)
        monkeypatch.delenv("PIO_ANN_SHARDS", raising=False)
    with pytest.raises(ValueError, match="not ported"):
        ann.ShardedANNScorer(U, V, idx, shards=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ann.ANNScorer(U, V, idx)
    with pytest.raises(ValueError, match="index covers"):
        ann.ANNScorer(U, V[:100], idx, device="cpu")


# -- pio index status ----------------------------------------------------------


@pytest.fixture(scope="module")
def index_home(tmp_path_factory):
    """A home whose latest instance is the port's similar-product with a
    PQ index beside model.bin (and an older JAX instance, unindexed)."""
    from predictionio_tpu.storage.registry import Storage as JaxStorage
    from predictionio_tpu.storage.registry import StorageConfig as JaxStorageConfig
    from predictionio_tpu_torch.core.workflow import SIMILARPRODUCT_FACTORY, run_train
    from predictionio_tpu_torch.storage.registry import Storage, StorageConfig
    from tests.test_templates import seed_views

    home = str(tmp_path_factory.mktemp("pio_index"))
    seed_views(JaxStorage(JaxStorageConfig(home=home)), "IdxApp")
    variant = {"id": "default", "engineFactory": SIMILARPRODUCT_FACTORY,
               "datasource": {"params": {"appName": "IdxApp"}},
               "algorithms": [{"name": "als", "params": {
                   "rank": 8, "numIterations": 3, "ann": True, "annM": 4, "annK": 16}}]}
    iid = run_train(SIMILARPRODUCT_FACTORY, variant=variant,
                    storage=Storage(StorageConfig(home=home)), device="cpu")
    return home, iid


def _index_status(home, package, *args):
    if package == "jax":
        code = ("import sys\nfrom predictionio_tpu.tools import cli\n"
                "cli.main(sys.argv[1:])\n")
    else:
        code = ("import sys\nfrom predictionio_tpu_torch.tools import cli\n"
                "cli.main(sys.argv[1:])\n"
                "bad = [m for m in sys.modules if m == 'torch' or m.startswith('torch.')]\n"
                "assert not bad, bad[:5]\n")
    env = dict(os.environ, PIO_HOME=home, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code, "index", "status", *args],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    return proc.returncode, proc.stdout


@pytest.mark.parametrize("args", [(), ("--json",), ("--shards", "4"),
                                  ("--json", "--shards", "3")])
def test_index_status_is_the_jax_verb_without_torch(index_home, args):
    home, iid = index_home
    jrc, jout = _index_status(home, "jax", *args)
    prc, pout = _index_status(home, "port", *args)
    assert jrc == prc == 0, pout
    assert pout == jout
    assert iid in pout and "verified" in pout


def test_index_status_reports_a_mismatch_alike(index_home, tmp_path):
    import shutil

    from predictionio_tpu_torch.storage.registry import Storage, StorageConfig

    home, iid = index_home
    twin = str(tmp_path / "home")
    shutil.copytree(home, twin)
    algo_dir = os.path.join(Storage(StorageConfig(home=twin)).models.model_dir(iid), "als")
    with open(os.path.join(algo_dir, ann.INDEX_BASENAME), "ab") as f:
        f.write(b"\x00")
    outs = [_index_status(twin, pkg, "--engine-instance-id", iid) for pkg in ("jax", "port")]
    assert outs[0] == outs[1] and "MISMATCH" in outs[1][1]
