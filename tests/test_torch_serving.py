"""The port's serving slice held against the JAX package, on the CPU.

An instance trained by the JAX package's ``run_train`` in a temporary
PIO_HOME (SQLite meta, LOCALFS models) is deployed by both packages —
the port with ``device="cpu"`` — with ``PIO_ALS_SERVE=device`` so that
both take the resident-scorer path on the 20-item catalog. Queries,
padded batches and the HTTP server must give the same items in the same
order, scores within rtol 1e-5. Data crosses between the packages as
numpy arrays and bytes.
"""

import asyncio
import json
import os
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

from predictionio_tpu.core.workflow import prepare_deploy as jax_prepare_deploy
from predictionio_tpu.core.workflow import run_train
from predictionio_tpu.models.als import ResidentScorer as JaxResidentScorer
from predictionio_tpu.server.aot import PAD as JAX_PAD
from predictionio_tpu.storage.registry import Storage as JaxStorage
from predictionio_tpu.storage.registry import StorageConfig as JaxStorageConfig
from predictionio_tpu.templates.recommendation import engine as jax_rec
from predictionio_tpu.utils.bimap import BiMap as JaxBiMap
from predictionio_tpu_torch.core.workflow import (
    RECOMMENDATION_FACTORY,
    DeployedEngine,
    prepare_deploy,
)
from predictionio_tpu_torch.models.als import (
    ResidentScorer,
    maybe_resident_scorer,
    recommend,
    serve_topk_batch,
)
from predictionio_tpu_torch.server import aot
from predictionio_tpu_torch.server.aot import PAD, BucketLadder
from predictionio_tpu_torch.server.engine_server import EngineServer
from predictionio_tpu_torch.storage import registry as port_registry
from predictionio_tpu_torch.storage.models import IntegrityError, LocalFSModelStore
from predictionio_tpu_torch.storage.registry import Storage, StorageConfig
from predictionio_tpu_torch.templates.recommendation import engine as port_rec
from predictionio_tpu_torch.tools import cli
from predictionio_tpu_torch.utils.bimap import BiMap
from tests.test_workflow import FACTORY, VARIANT, seed_ratings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
USERS = [str(u) for u in range(30)] + ["no-such-user"]


@pytest.fixture(scope="module")
def home(tmp_path_factory):
    """A PIO_HOME holding one instance trained by the JAX package."""
    home = str(tmp_path_factory.mktemp("pio_home"))
    st = JaxStorage(JaxStorageConfig(home=home))
    seed_ratings(st)
    run_train(FACTORY, variant=VARIANT, storage=st, use_mesh=False)
    return home


@pytest.fixture()
def serve_on_device(monkeypatch):
    monkeypatch.setenv("PIO_ALS_SERVE", "device")


def _port_storage(home):
    return Storage(StorageConfig(home=home))


def _assert_same_answer(mine, theirs):
    assert [s["item"] for s in mine["itemScores"]] == \
        [s["item"] for s in theirs["itemScores"]]
    np.testing.assert_allclose([s["score"] for s in mine["itemScores"]],
                               [s["score"] for s in theirs["itemScores"]],
                               rtol=RTOL)


# -- the slice against the JAX package ----------------------------------------


@pytest.mark.parametrize("factory", [FACTORY, RECOMMENDATION_FACTORY])
def test_query_parity_on_jax_trained_instance(home, serve_on_device, factory):
    jax_eng = jax_prepare_deploy(FACTORY, storage=JaxStorage(JaxStorageConfig(home=home)),
                                 variant_id="default")
    eng = prepare_deploy(factory, storage=_port_storage(home),
                         variant_id="default", device="cpu")
    assert isinstance(eng, DeployedEngine)
    assert eng.instance.id == jax_eng.instance.id
    scorer = eng.models[0]._device_scorer()
    assert isinstance(scorer, ResidentScorer) and scorer.device.type == "cpu"
    for user in USERS:
        for num in (1, 4, 20):
            q = {"user": user, "num": num}
            _assert_same_answer(eng.query(q), jax_eng.query(q))
    # the rating-prediction shape is answered per query, host-side
    q = {"user": "3", "item": "5"}
    np.testing.assert_allclose(eng.query(q)["itemScores"][0]["score"],
                               jax_eng.query(q)["itemScores"][0]["score"],
                               rtol=RTOL)


def test_batch_query_parity_with_pads(home, serve_on_device):
    jax_eng = jax_prepare_deploy(FACTORY, storage=JaxStorage(JaxStorageConfig(home=home)))
    eng = prepare_deploy(FACTORY, storage=_port_storage(home), device="cpu")
    qs = [{"user": "1", "num": 3}, {"user": "7", "num": 5},
          {"user": "no-such-user"}, {"user": "2", "item": "4"},
          {"user": "28", "num": 16}]
    pads = [1, 3]
    mine = eng.batch_query([PAD if i in pads else q for i, q in enumerate(qs)])
    theirs = jax_eng.batch_query(
        [JAX_PAD if i in pads else q for i, q in enumerate(qs)])
    for i, (m, t) in enumerate(zip(mine, theirs)):
        if i in pads:
            assert m is PAD and t is JAX_PAD
        else:
            _assert_same_answer(m, t)


def test_engine_server_http_parity(home, serve_on_device):
    from predictionio_tpu.server.engine_server import EngineServer as JaxEngineServer

    jax_srv = JaxEngineServer(engine_factory=FACTORY,
                              storage=JaxStorage(JaxStorageConfig(home=home)),
                              host="127.0.0.1", port=0, batching=True)
    srv = EngineServer(engine_factory=FACTORY, storage=_port_storage(home),
                       host="127.0.0.1", port=0, batching=True,
                       aot_buckets="1,4,16", device="cpu")
    assert srv._warmup.wait(60) and srv._warmup.ready

    def post(port, body):
        req = urllib.request.Request(f"http://127.0.0.1:{port}/queries.json",
                                     data=body)
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def get(port, path):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return json.loads(r.read())

    async def drive():
        await jax_srv.http.start()
        await srv.http.start()
        jp, pp = jax_srv.http.bound_port, srv.http.bound_port
        bodies = [json.dumps({"user": str(u % 30), "num": 1 + u % 7}).encode()
                  for u in range(24)]
        outs = await asyncio.gather(*(
            asyncio.to_thread(post, p, b) for b in bodies for p in (pp, jp)))
        bad = await asyncio.gather(*(asyncio.to_thread(post, pp, b) for b in (
            b"{not json", b"", json.dumps({"num": 2}).encode())))
        status = await asyncio.to_thread(get, pp, "/")
        await jax_srv.http.stop()
        await srv.http.stop()
        srv._batcher.stop()
        jax_srv._batcher.stop()
        return outs, bad, status

    outs, bad, status = asyncio.run(drive())
    for (ms, mine), (js, theirs) in zip(outs[0::2], outs[1::2]):
        assert ms == js == 200
        _assert_same_answer(mine, theirs)
    assert [code for code, _ in bad] == [400, 400, 400]
    assert all("message" in body for _, body in bad)
    assert status["status"] == "alive" and status["queryCount"] == 24
    assert status["warmup"]["state"] == "ready"


def test_engine_server_503_while_warming(home, serve_on_device, monkeypatch):
    srv = EngineServer(engine_factory=FACTORY, storage=_port_storage(home),
                       host="127.0.0.1", port=0, device="cpu")
    srv._warmup = aot.AOTWarmup(BucketLadder([1]))  # never started: idle

    async def ask():
        from predictionio_tpu_torch.server.http import Request

        return await srv._queries(Request("POST", "/queries.json", {}, {},
                                          b'{"user": "1"}'))

    resp = asyncio.run(ask())
    assert resp.status == 503 and int(resp.headers["Retry-After"]) >= 1
    assert "warming" in json.loads(resp.body)["message"]


# -- on-disk compatibility ----------------------------------------------------


def _factors(seed=0, n_users=6, n_items=9, rank=4):
    rng = np.random.default_rng(seed)
    U = rng.standard_normal((n_users, rank)).astype(np.float32)
    V = rng.standard_normal((n_items, rank)).astype(np.float32)
    users = {f"u{i}": i for i in range(n_users)}
    items = {f"i{j}": j for j in range(n_items)}
    return U, V, users, items


def test_model_blob_round_trips_both_ways():
    U, V, users, items = _factors()
    jax_algo = jax_rec.ALSAlgorithm(jax_rec.ALSAlgorithmParams())
    port_algo = port_rec.ALSAlgorithm(port_rec.ALSAlgorithmParams())
    jax_blob = jax_algo.save_model(
        jax_rec.ALSModel(U, V, JaxBiMap(users), JaxBiMap(items)), None)
    port_blob = port_algo.save_model(
        port_rec.ALSModel(U, V, BiMap(users), BiMap(items)), None)
    assert port_blob == jax_blob  # byte for byte
    mine = port_algo.load_model(jax_blob, None)
    theirs = jax_algo.load_model(port_blob, None)
    for m in (mine, theirs):
        np.testing.assert_array_equal(m.U, U)
        np.testing.assert_array_equal(m.V, V)
        assert m.user_ids.to_dict() == users and m.item_ids.to_dict() == items


def test_jax_trained_instance_reads_from_storage(home):
    jst = JaxStorage(JaxStorageConfig(home=home))
    pst = _port_storage(home)
    ei = pst.meta.get_latest_completed_engine_instance(FACTORY, "default")
    jei = jst.meta.get_latest_completed_engine_instance(FACTORY, "default")
    assert ei is not None and ei.id == jei.id and ei.status == "COMPLETED"
    assert ei.start_time == jei.start_time and ei.engine_factory == FACTORY
    assert pst.models.get(ei.id) == jst.models.get(ei.id)


def test_port_written_instance_reads_in_jax_package(tmp_path):
    from predictionio_tpu_torch.storage.meta import EngineInstance, utcnow

    pst = _port_storage(str(tmp_path))
    now = utcnow()
    ei = EngineInstance(
        id=pst.meta.new_instance_id(), status="COMPLETED", start_time=now,
        end_time=now, engine_factory=RECOMMENDATION_FACTORY,
        engine_variant="default", batch="", env={}, mesh_conf={},
        data_source_params="{}", preparator_params="{}",
        algorithms_params="[]", serving_params="{}")
    pst.meta.insert_engine_instance(ei)
    pst.models.put(ei.id, b"blob")
    jst = JaxStorage(JaxStorageConfig(home=str(tmp_path)))
    got = jst.meta.get_latest_completed_engine_instance(RECOMMENDATION_FACTORY,
                                                        "default")
    assert got.id == ei.id
    # both store the time at millisecond precision
    assert got.start_time == pst.meta.get_engine_instance(ei.id).start_time
    assert abs((got.start_time - ei.start_time).total_seconds()) < 1e-3
    assert jst.models.get(ei.id) == b"blob"  # digest sidecar verified


def test_localfs_refuses_corrupt_blob(tmp_path):
    store = LocalFSModelStore(str(tmp_path))
    store.put("x", b"good bytes")
    with open(os.path.join(str(tmp_path), "x", "model.bin"), "wb") as f:
        f.write(b"evil bytes")
    with pytest.raises(IntegrityError):
        store.get("x")


def test_unknown_factory_raises(home):
    with pytest.raises(ValueError, match="no counterpart"):
        prepare_deploy("predictionio_tpu.templates.no_such_template.engine:engine_factory",
                       storage=_port_storage(home), device="cpu")


def test_train_is_the_next_slice(tmp_path):
    """Slice 2 has landed: the port's ALSAlgorithm trains, on the device
    Engine.train gives it, a model its own predict serves."""
    from predictionio_tpu_torch.controller import WorkflowContext

    ratings = [port_rec.Rating(u, i, r) for u, i, r in (
        ("a", "x", 5.0), ("a", "y", 1.0), ("b", "x", 4.0), ("b", "z", 2.0))]
    td = port_rec.TrainingData.from_ratings(ratings)
    algo = port_rec.ALSAlgorithm(port_rec.ALSAlgorithmParams(rank=2, num_iterations=3))
    algo.device = torch.device("cpu")
    ctx = WorkflowContext(storage=_port_storage(str(tmp_path)), device=algo.device)
    algo.sanity_check(td)
    model = algo.train(ctx, td)
    assert model.U.shape == (2, 2) and model.V.shape == (3, 2)
    assert np.isfinite(model.U).all() and np.isfinite(model.V).all()
    assert len(algo.predict(model, {"user": "a", "num": 2})["itemScores"]) == 2
    with pytest.raises(ValueError, match="empty"):
        algo.sanity_check(port_rec.TrainingData.from_ratings([]))


# -- the resident scorer ------------------------------------------------------


@pytest.mark.parametrize("n_items, num, excl", [
    (100, 5, None),
    (30, 6, [3, 11, 29]),
    (1500, 1100, [7]),   # k above the kernel's 1024: the dense path
])
def test_resident_scorer_matches_jax_scorer(n_items, num, excl):
    rng = np.random.default_rng(n_items)
    U = rng.standard_normal((12, 8)).astype(np.float32)
    V = rng.standard_normal((n_items, 8)).astype(np.float32)
    mine = ResidentScorer(U, V, device="cpu")
    theirs = JaxResidentScorer(U, V)
    users = np.asarray([0, 5, 11], np.int32)
    exclude = None if excl is None else [np.asarray(excl)] * 3
    for (mi, mv), (ti, tv) in zip(mine.recommend_batch(users, num, exclude),
                                  theirs.recommend_batch(users, num, exclude)):
        np.testing.assert_array_equal(mi, ti)
        np.testing.assert_allclose(mv, tv, rtol=RTOL, atol=RTOL)
    iv, vv = mine.recommend(5, 4)
    ri, rv = recommend(U, V, 5, 4)
    np.testing.assert_array_equal(iv, ri)
    np.testing.assert_allclose(vv, rv, rtol=RTOL)


def test_warm_buckets_and_padded_dispatch_are_exact():
    rng = np.random.default_rng(3)
    U = rng.standard_normal((40, 8)).astype(np.float32)
    V = rng.standard_normal((50, 8)).astype(np.float32)
    sc = ResidentScorer(U, V, device="cpu")
    stats = sc.warm_buckets(BucketLadder([1, 4, 8]), ks=(16,))
    assert stats["targets"] == 3 and stats["compiled"] + stats["cached"] == 3
    assert sc.bucket_ladder.buckets == (1, 4, 8)
    _, before = aot.DEVICE_LATENCY.sum_count(("8", "aot"))
    users = np.asarray([3, 1, 4, 1, 5], np.int32)  # 5 rows → bucket 8
    padded = sc.recommend_batch(users, 5)
    _, after = aot.DEVICE_LATENCY.sum_count(("8", "aot"))
    assert after == before + 1
    for u, (iv, vv) in zip(users, padded):
        ai, av = sc.recommend(int(u), 5)
        # padding never perturbs a row (the CPU's matmul may round a row
        # differently at another batch size; the kernel is checked
        # bitwise on the card)
        np.testing.assert_array_equal(iv, ai)
        np.testing.assert_allclose(vv, av, rtol=1e-6)


def test_predict_ratings_and_pad_helpers_match_jax():
    from predictionio_tpu.models.als import predict_ratings as jax_predict_ratings
    from predictionio_tpu.server.aot import strip_pads as jax_strip_pads
    from predictionio_tpu_torch.models.als import init_factors, predict_ratings
    from predictionio_tpu.models.als import init_factors as jax_init_factors

    U = init_factors(7, 4, seed=5)
    np.testing.assert_array_equal(U, jax_init_factors(7, 4, seed=5))
    V = init_factors(9, 4, seed=6)
    users, items = np.asarray([0, 3, 6]), np.asarray([8, 0, 4])
    np.testing.assert_array_equal(predict_ratings(U, V, users, items),
                                  jax_predict_ratings(U, V, users, items))
    assert aot.strip_pads(["a", PAD, "b", PAD]) == (["a", "b"], [0, 2])
    assert jax_strip_pads(["a", JAX_PAD, "b", JAX_PAD]) == (["a", "b"], [0, 2])
    assert aot.is_pad(PAD) and not aot.is_pad(JAX_PAD)


def test_serving_dispatch_is_traced_when_tracing_is_on():
    from predictionio_tpu_torch.utils import tracing

    rng = np.random.default_rng(5)
    sc = ResidentScorer(rng.standard_normal((4, 3)).astype(np.float32),
                        rng.standard_normal((6, 3)).astype(np.float32),
                        device="cpu")
    assert tracing.span("off") is tracing.NOOP_SPAN and tracing.exemplar() is None
    tracing.TRACER.configure(enabled=True)
    try:
        with tracing.root_span("test.root", trace_id="ab" * 16) as root:
            sc.recommend(1, 2)
            assert tracing.exemplar() == root.trace_id
        spans = tracing.TRACER.ring.spans(trace_id="ab" * 16)[::-1]
    finally:
        tracing.TRACER.configure(enabled=False)
    names = [d["name"] for d in spans]
    assert names == ["serving.device", "test.root"]
    assert spans[0]["parentId"] == spans[1]["spanId"]
    assert spans[0]["attrs"] == {"bucket": 1, "k": 6, "path": "jit"}
    assert tracing.extract_headers(
        {"traceparent": "00-" + "cd" * 16 + "-" + "ef" * 8 + "-01"}) == \
        ("cd" * 16, "ef" * 8, True)


def test_unwarmed_dispatch_has_the_jax_packages_path_label():
    """The same unwarmed query in both packages records its dispatch
    under the same (bucket, path) labels of ``pio_aot_dispatch_total``."""
    from predictionio_tpu.server import aot as jax_aot

    rng = np.random.default_rng(6)
    U = rng.standard_normal((5, 4)).astype(np.float32)
    V = rng.standard_normal((7, 4)).astype(np.float32)

    def grown(counter, before):
        return {k for k, v in counter._values.items() if v > before.get(k, 0)}

    labels = {}
    for name, counter, scorer in (
            ("jax", jax_aot._DISPATCHES, lambda: JaxResidentScorer(U, V)),
            ("port", aot._DISPATCHES, lambda: ResidentScorer(U, V, device="cpu"))):
        sc = scorer()
        before = dict(counter._values)
        sc.recommend(2, 3)
        labels[name] = grown(counter, before)
    assert labels["port"] == labels["jax"] == {("1", "jit")}


def test_scorer_cache_follows_the_factors(serve_on_device):
    U = np.ones((3, 2), np.float32)
    V = np.ones((4, 2), np.float32)
    first = maybe_resident_scorer(U, V, device="cpu")
    assert maybe_resident_scorer(U, V, first, device="cpu") is first
    assert maybe_resident_scorer(U.copy(), V, first, device="cpu") is not first


def test_serve_topk_batch_skips_pads_and_unknown_users():
    rng = np.random.default_rng(4)
    U = rng.standard_normal((3, 4)).astype(np.float32)
    V = rng.standard_normal((10, 4)).astype(np.float32)
    sc = ResidentScorer(U, V, device="cpu")
    inv = {j: f"i{j}" for j in range(10)}
    out = serve_topk_batch(sc, {"a": 0, "b": 2}, inv,
                           [{"user": "a", "num": 2}, PAD, {"user": "zz"},
                            {"user": "b", "num": 3}],
                           fallback=lambda q: {"fallback": True})
    assert out[1] is None and out[2] == {"itemScores": []}
    assert [s["item"] for s in out[0]["itemScores"]] == \
        [f"i{j}" for j in recommend(U, V, 0, 2)[0]]
    assert len(out[3]["itemScores"]) == 3


# -- device rules -------------------------------------------------------------


def test_no_card_and_no_cpu_request_raises(monkeypatch, home):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    U = np.ones((3, 2), np.float32)
    V = np.ones((4, 2), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ResidentScorer(U, V)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prepare_deploy(FACTORY, storage=_port_storage(home))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EngineServer(engine_factory=FACTORY, storage=_port_storage(home),
                     port=0)


#: modules the walk below must reach (the ANN package, the two-tower model
#: and template, the integrity helpers, the classification slice, e2, CCO
#: with the universal template and sequential rec with its attention and
#: template, and Ulysses attention), so a rename cannot drop them
MUST_WALK = ("predictionio_tpu_torch.ann.index", "predictionio_tpu_torch.ann.pq",
             "predictionio_tpu_torch.ann.scorer", "predictionio_tpu_torch.models.two_tower",
             "predictionio_tpu_torch.templates.twotower.engine",
             "predictionio_tpu_torch.utils.integrity", "predictionio_tpu_torch.utils.jaxpickle",
             "predictionio_tpu_torch.data.pipeline",
             "predictionio_tpu_torch.ops.segment", "predictionio_tpu_torch.models.naive_bayes",
             "predictionio_tpu_torch.models.lbfgs", "predictionio_tpu_torch.models.linear",
             "predictionio_tpu_torch.models.forest",
             "predictionio_tpu_torch.templates.classification.engine",
             "predictionio_tpu_torch.templates.textclassification.engine",
             "predictionio_tpu_torch.templates.vanilla.engine",
             "predictionio_tpu_torch.e2.naivebayes", "predictionio_tpu_torch.e2.markov",
             "predictionio_tpu_torch.e2.external",
             "predictionio_tpu_torch.models.cco",
             "predictionio_tpu_torch.templates.universal.engine",
             "predictionio_tpu_torch.parallel.ring_attention",
             "predictionio_tpu_torch.parallel.ulysses",
             "predictionio_tpu_torch.models.seq_rec",
             "predictionio_tpu_torch.templates.sequentialrec.engine",
             "predictionio_tpu_torch.data.replication",
             "predictionio_tpu_torch.server.repl_server",
             "predictionio_tpu_torch.server.trainer",
             "predictionio_tpu_torch.tools.supervise",
             "predictionio_tpu_torch.server.slo", "predictionio_tpu_torch.server.router",
             "predictionio_tpu_torch.server.remediate",
             "predictionio_tpu_torch.server.autoscale",
             "predictionio_tpu_torch.tools.dashboard", "predictionio_tpu_torch.tools.admin")


def test_port_and_chip_smoke_import_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import predictionio_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke, serving_ab\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.startswith('jaxlib') or m == 'predictionio_tpu'\n"
        "       or m.startswith('predictionio_tpu.') or m.split('.')[0] in ('flax', 'optax')]\n"
        f"missing = [m for m in {MUST_WALK!r} if m not in names]\n"
        "print(len(names), bad, missing)\n"
        "sys.exit(1 if bad or missing else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# -- the deploy verb ----------------------------------------------------------


def test_cli_deploy_builds_the_server_from_flags(home, serve_on_device):
    engine_dir = os.path.join(REPO, "predictionio_tpu_torch", "templates",
                              "recommendation")
    args = cli.build_parser().parse_args([
        "deploy", "--engine-dir", engine_dir, "--ip", "127.0.0.1",
        "--port", "0", "--batching", "--batch-max", "8",
        "--batch-wait-ms", "1", "--aot-buckets", "auto", "--aot-topk", "4",
        "--device", "cpu"])
    port_registry.set_storage(_port_storage(home))
    try:
        srv = cli.make_server(args)
    finally:
        port_registry.set_storage(None)
    assert srv._batcher.max_batch == 8 and srv._warmup.ladder.buckets == (1, 2, 4, 8)
    assert srv._warmup.wait(60) and srv._warmup.ready
    assert srv.deployed.instance.engine_factory == FACTORY
    assert srv.deployed.query({"user": "1", "num": 2})["itemScores"]
