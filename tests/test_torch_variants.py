"""Multi-model serving held against the JAX package's, on the CPU.

Each unit case runs once on each package (``pkg`` is ``jax`` or
``torch``): the cases of ``tests/test_variants.py`` for ``VariantSet``
(over a real model registry, with stub engines), ``VariantScoreboard``
and the micro-batcher's per-arm groups, written once against the
package's modules. Then the packages against each other: ``parse_weights``
gives equal specs and equal errors, ``weighted_assign`` equal arms for
10,000 entities under two salts, a model registry written by either
package is read by the other (manifest bytes equal after the same
operations), and the ``models`` and ``variants`` verbs print the same
lines on twin homes.

The twin servers: the JAX package trains two instances in one home and
registers them as generations 1 (promoted) and 2; the home is copied, and
a JAX ``EngineServer`` and a port one (``device="cpu"``) serve
``variants="champion:1,challenger:1"`` from the twins. One request script
must give equal ``X-PIO-Variant`` headers, equal answer items (scores
within 1e-5 relative, the tolerance of ``tests/test_torch_serving.py``),
equal ``/variants`` documents (times aside) and the same answers to
``/variants/weights``, ``/feedback.json`` and ``/reload?variant=`` with
and without ``variant.reload.partial``. The port's own check: each arm
answers from its own instance's factors, which differ.
"""

import asyncio
import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

from predictionio_tpu.core.workflow import run_train as jax_run_train
from predictionio_tpu.server import aot as jax_aot
from predictionio_tpu.server import variant_metrics as jax_vm
from predictionio_tpu.server import variants as jax_variants
from predictionio_tpu.server.batching import MicroBatcher as JaxMicroBatcher
from predictionio_tpu.server.engine_server import EngineServer as JaxEngineServer
from predictionio_tpu.storage import models as jax_models
from predictionio_tpu.storage import registry as jax_registry
from predictionio_tpu.storage.registry import Storage as JaxStorage
from predictionio_tpu.storage.registry import StorageConfig as JaxStorageConfig
from predictionio_tpu.tools import cli as jax_cli
from predictionio_tpu.utils import faults as jax_faults
from predictionio_tpu_torch.server import aot as port_aot
from predictionio_tpu_torch.server import variant_metrics as port_vm
from predictionio_tpu_torch.server import variants as port_variants
from predictionio_tpu_torch.server.batching import MicroBatcher
from predictionio_tpu_torch.server.engine_server import EngineServer
from predictionio_tpu_torch.storage import models as port_models
from predictionio_tpu_torch.storage import registry as port_registry
from predictionio_tpu_torch.storage.registry import Storage, StorageConfig
from predictionio_tpu_torch.tools import cli
from predictionio_tpu_torch.utils import faults as port_faults
from tests.test_torch_cli import Twins
from tests.test_torch_event_server import ServerThread
from tests.test_torch_ops_surface import jcall
from tests.test_workflow import FACTORY, VARIANT, seed_ratings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PACKAGES = {
    "jax": types.SimpleNamespace(
        variants=jax_variants, vm=jax_vm, MicroBatcher=JaxMicroBatcher,
        aot=jax_aot, models=jax_models, Storage=JaxStorage,
        StorageConfig=JaxStorageConfig, FAULTS=jax_faults.FAULTS),
    "torch": types.SimpleNamespace(
        variants=port_variants, vm=port_vm, MicroBatcher=MicroBatcher,
        aot=port_aot, models=port_models, Storage=Storage,
        StorageConfig=StorageConfig, FAULTS=port_faults.FAULTS),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


@pytest.fixture(autouse=True)
def _disarm_faults():
    for p in PACKAGES.values():
        p.FAULTS.disarm()
    yield
    for p in PACKAGES.values():
        p.FAULTS.disarm()


# -- the packages against each other --------------------------------------------


SPECS = ["champion:9,challenger:1", "a=1,b=3", "champion@3:90,canary@5:10",
         "champion:1,shadow:0", " x:2 , y:0.5 ", "", "champion", "champion:",
         "champion:x", "champion:9,champion:1", "Champ!on:9", "a:0,b:0",
         "a:-1,b:2", "a@x:1"]


def _parsed(variants, spec):
    try:
        return [(s.name, s.weight, s.gen) for s in variants.parse_weights(spec)]
    except variants.VariantError as e:
        return ("VariantError", str(e))


def test_parse_weights_equal_results_and_errors():
    for spec in SPECS:
        assert _parsed(port_variants, spec) == _parsed(jax_variants, spec), spec


@pytest.mark.parametrize("salt", ["pio", "t"])
def test_weighted_assign_equal_for_10000_entities(salt):
    for arms in ([("champion", 9.0), ("challenger", 1.0)],
                 [("a", 1.0), ("b", 1.0), ("c", 2.0)]):
        jax = [jax_variants.weighted_assign(f"u{i}", arms, salt) for i in range(10_000)]
        port = [port_variants.weighted_assign(f"u{i}", arms, salt) for i in range(10_000)]
        assert port == jax
        assert len(set(port)) == len(arms)
    queries = [{"user": "42", "num": 10}, {"item": 7}, {"num": 10}, {"uid": None, "id": 3},
               ["not", "a", "dict"]]
    assert [port_variants.entity_of(q) for q in queries] == \
        [jax_variants.entity_of(q) for q in queries]


def _registry_ops(models, root):
    """The same registry writes, through one package's class; returns the
    manifest's bytes and what the reads say."""
    reg = models.ModelRegistry(root, retain=2)
    g1 = reg.register("i1", b"blob-1", token=3, created_us=1_000)
    g2 = reg.register("i2", b"blob-2", created_us=2_000)
    reg.promote(g1, now_us=3_000)
    reg.promote(g2, token=4, now_us=4_000)
    g3 = reg.register("i3", b"blob-3", created_us=5_000)
    reg.mark(g3, "refused")
    reg.register("i4", b"blob-4", created_us=6_000)
    rolled = reg.rollback()
    with pytest.raises(models.FencedWriteError):
        reg.register("i5", b"stale", token=1)
    with open(os.path.join(root, "registry.json"), "rb") as f:
        manifest = f.read()
    return manifest, rolled, reg.generations(), sorted(os.listdir(root))


def test_registry_manifests_are_byte_equal_and_cross_read(tmp_path):
    jax = _registry_ops(jax_models, str(tmp_path / "jax"))
    port = _registry_ops(port_models, str(tmp_path / "port"))
    assert port == jax
    # each package reads what the other wrote: blobs, champion, lookups
    for reader, root in ((jax_models, tmp_path / "port"), (port_models, tmp_path / "jax")):
        reg = reader.ModelRegistry(str(root))
        assert reg.champion()["instance_id"] == "i1"
        assert reg.get_blob(1) == b"blob-1" and reg.find_gen("i4") == 4
        assert reg.fence_token() == 4 and reg.orphan_dirs() == []
    for name in ("model.bin", "model.bin.sha256"):
        for gen in ("gen-000001", "gen-000004"):
            with open(tmp_path / "jax" / gen / name, "rb") as a, \
                    open(tmp_path / "port" / gen / name, "rb") as b:
                assert a.read() == b.read()
    # a corrupt generation is refused by both
    with open(tmp_path / "port" / "gen-000004" / "model.bin", "wb") as f:
        f.write(b"rotten")
    with pytest.raises(port_models.IntegrityError):
        port_models.ModelRegistry(str(tmp_path / "port")).get_blob(4)
    with pytest.raises(Exception, match="checksum mismatch"):
        jax_models.ModelRegistry(str(tmp_path / "port")).get_blob(4)


def test_find_gen_reads_a_jax_registry_and_creates_nothing(tmp_path):
    home = str(tmp_path / "home")
    os.makedirs(home)
    assert port_models.find_gen(home, "i1") is None
    assert os.listdir(home) == []
    reg = jax_models.model_registry(JaxStorage(JaxStorageConfig(home=home)))
    reg.register("i1", b"a")
    gen = reg.register("i1", b"b")
    assert port_models.find_gen(home, "i1") == reg.find_gen("i1") == gen
    assert port_models.find_gen(home, "i9") is None


# -- VariantSet, stub engines over a real registry (tests/test_variants.py) ----


class FakeDeployed:
    def __init__(self, iid):
        self.iid = iid

    def query(self, q):
        return {"echo": self.iid}


@pytest.fixture()
def home_storage(pkg, tmp_path):
    return pkg.Storage(pkg.StorageConfig(home=str(tmp_path)))


def _registry_with(pkg, storage, gens):
    """Register instance ids as generations; the first is promoted."""
    reg = pkg.models.model_registry(storage)
    out = []
    for i, iid in enumerate(gens):
        g = reg.register(iid, f"blob-{iid}".encode())
        if i == 0:
            reg.promote(g)
        out.append(g)
    return reg, out


def _varset(pkg, storage, spec="champion:9,challenger:1", prepare=None):
    return pkg.variants.VariantSet(
        storage, spec, prepare=prepare or (lambda iid: FakeDeployed(iid)))


def _failing_for(bad):
    def prepare(iid):
        if iid == bad:
            raise RuntimeError("challenger blob corrupt")
        return FakeDeployed(iid)
    return prepare


def test_resolution_champion_and_newest_challenger(pkg, home_storage):
    _registry_with(pkg, home_storage, ["i-champ", "i-cand1", "i-cand2"])
    vs = _varset(pkg, home_storage)
    vs.load()
    assert vs.get("champion").instance_id == "i-champ"
    assert vs.get("challenger").instance_id == "i-cand2"
    assert vs.get("champion").serving() and vs.get("challenger").serving()


def test_pinned_generation(pkg, home_storage):
    _, gens = _registry_with(pkg, home_storage, ["i1", "i2", "i3"])
    vs = _varset(pkg, home_storage, f"champion:9,canary@{gens[1]}:1")
    vs.load()
    assert vs.get("canary").gen == gens[1] and vs.get("canary").instance_id == "i2"


def test_retired_generations_are_not_challengers(pkg, home_storage):
    reg, gens = _registry_with(pkg, home_storage, ["i1", "i2", "i3"])
    reg.mark(gens[2], "rolled_back")
    vs = _varset(pkg, home_storage)
    vs.load()
    assert vs.get("challenger").instance_id == "i2"


def test_default_arm_load_failure_propagates(pkg, home_storage):
    with pytest.raises(pkg.variants.VariantError):
        _varset(pkg, home_storage).load()


def test_failed_challenger_folds_into_default(pkg, home_storage):
    _registry_with(pkg, home_storage, ["i-champ", "i-cand"])
    vs = _varset(pkg, home_storage, prepare=_failing_for("i-cand"))
    vs.load()
    assert vs.get("challenger").state == "failed"
    assert vs.effective_weights() == [("champion", 10.0)]
    assert all(vs.choose(str(i)) == "champion" for i in range(50))


def test_choose_override_must_be_serving(pkg, home_storage):
    _registry_with(pkg, home_storage, ["i-champ", "i-cand"])
    vs = _varset(pkg, home_storage)
    vs.load()
    assert vs.choose("u1", override="challenger") == "challenger"
    with pytest.raises(pkg.variants.VariantError):
        vs.choose("u1", override="nope")


def test_assign_skew_fault_lands_everything_on_default(pkg, home_storage):
    _registry_with(pkg, home_storage, ["i-champ", "i-cand"])
    vs = _varset(pkg, home_storage, "champion:1,challenger:1")
    vs.load()
    challenger_users = [str(i) for i in range(200)
                        if vs.choose(str(i)) == "challenger"]
    assert challenger_users
    pkg.FAULTS.arm("variant.assign.skew", error="skew drill")
    assert all(vs.choose(u) == "champion" for u in challenger_users)


def test_set_weights_probe_then_apply(pkg, home_storage):
    _registry_with(pkg, home_storage, ["i-champ", "i-cand"])
    vs = _varset(pkg, home_storage)
    vs.load()
    for bad in ({"champion": 1, "ghost": 1}, {"champion": 0}, {}):
        with pytest.raises(pkg.variants.VariantError):
            vs.set_weights(bad)
    before = vs.weights_epoch
    assert vs.set_weights({"champion": 7, "challenger": 3}) == [
        ("champion", 7.0), ("challenger", 3.0)]
    assert vs.weights_epoch == before + 1
    assert dict(vs.set_weights({"champion": 1}))["champion"] == 1.0
    assert vs.get("challenger").spec.weight == 0.0


def test_set_weights_refuses_failed_arm(pkg, home_storage):
    _registry_with(pkg, home_storage, ["i-champ", "i-cand"])
    vs = _varset(pkg, home_storage, prepare=_failing_for("i-cand"))
    vs.load()
    with pytest.raises(pkg.variants.VariantError):
        vs.set_weights({"champion": 1, "challenger": 1})


def test_reload_partial_fault_fails_closed_to_100_0(pkg, home_storage):
    _registry_with(pkg, home_storage, ["i-champ", "i-cand"])
    vs = _varset(pkg, home_storage)
    vs.load()
    pkg.FAULTS.arm("variant.reload.partial", error="mid-swap kill")
    out = vs.reload_variant("challenger")
    assert out["outcome"] == "failed" and vs.get("challenger").state == "failed"
    assert vs.get("challenger").deployed is None
    assert vs.effective_weights() == [("champion", 10.0)]
    assert vs.get("champion").serving()
    pkg.FAULTS.disarm()
    assert vs.reload_variant("challenger")["outcome"] == "promoted"
    assert dict(vs.effective_weights()) == {"champion": 9.0, "challenger": 1.0}


def test_default_arm_reload_failure_keeps_last_good(pkg, home_storage):
    _registry_with(pkg, home_storage, ["i-champ", "i-cand"])
    vs = _varset(pkg, home_storage)
    vs.load()
    old = vs.get("champion").deployed
    pkg.FAULTS.arm("variant.reload.partial", error="mid-swap kill")
    assert vs.reload_variant("champion")["outcome"] == "rolled_back"
    assert vs.get("champion").deployed is old and vs.get("champion").serving()


def test_reload_probe_failure_counts_as_swap_failure(pkg, home_storage):
    _registry_with(pkg, home_storage, ["i-champ", "i-cand"])
    vs = _varset(pkg, home_storage)
    vs.load()

    def probe(candidate):
        raise RuntimeError("probe query failed")

    assert vs.reload_variant("challenger", probe)["outcome"] == "failed"


def test_snapshot_shape(pkg, home_storage):
    _registry_with(pkg, home_storage, ["i-champ", "i-cand"])
    vs = _varset(pkg, home_storage)
    vs.load()
    snap = vs.snapshot()
    assert snap["default"] == "champion"
    arm = snap["variants"]["challenger"]
    assert arm["state"] == "ready" and arm["engineInstanceId"] == "i-cand"
    assert 0.0 < arm["effectiveWeight"] < 1.0


# -- the scoreboard (tests/test_variants.py) ------------------------------------


def test_rating_feedback_accrues_rmse(pkg):
    sb = pkg.vm.VariantScoreboard()
    sb.observe_request("challenger", 0.01, "200")
    sb.record_served("pr1", "challenger", {"itemScores": [{"item": "7", "score": 3.0}]})
    assert sb.observe_feedback(pr_id="pr1", rating=4.0, item="7") == "challenger"
    snap = sb.snapshot()["challenger"]
    assert snap["ratedPairs"] == 1 and snap["onlineRmse"] == pytest.approx(1.0)


def test_click_feedback_accrues_ctr(pkg):
    sb = pkg.vm.VariantScoreboard()
    for _ in range(4):
        sb.observe_request("champion", 0.01, "200")
    sb.record_served("pr1", "champion", {"itemScores": []})
    assert sb.observe_feedback(pr_id="pr1", clicked=True) == "champion"
    assert sb.snapshot()["champion"]["ctr"] == pytest.approx(0.25)


def test_unattributable_feedback_is_dropped(pkg):
    assert pkg.vm.VariantScoreboard().observe_feedback(pr_id="ghost", rating=5.0) is None


def test_explicit_variant_beats_unknown_prid(pkg):
    sb = pkg.vm.VariantScoreboard()
    assert sb.observe_feedback(pr_id="ghost", variant="canary", rating=2.0) == "canary"


def test_served_map_is_bounded(pkg):
    sb = pkg.vm.VariantScoreboard(capacity=10)
    for i in range(25):
        sb.record_served(f"pr{i}", "champion", {"itemScores": []})
    assert sb.resolve("pr0") is None and sb.resolve("pr24") == "champion"


def test_scoreboards_agree_on_one_stream():
    rng = np.random.default_rng(3)
    boards = [jax_vm.VariantScoreboard(capacity=50), port_vm.VariantScoreboard(capacity=50)]
    for j in range(200):
        arm = "champion" if rng.random() < 0.7 else "challenger"
        pred = {"itemScores": [{"item": str(i), "score": float(rng.normal())}
                               for i in range(3)]}
        kind = rng.integers(3)
        for sb in boards:
            sb.observe_request(arm, 0.001, "200" if j % 17 else "500")
            sb.record_served(f"p{j}", arm, pred)
            if kind == 0:
                sb.observe_feedback(pr_id=f"p{j - 5}", rating=float(j % 5), item="1")
            elif kind == 1:
                sb.observe_feedback(pr_id=f"p{j}", clicked=True)
    assert boards[1].snapshot() == boards[0].snapshot()


# -- the micro-batcher's per-arm groups (tests/test_variants.py) ----------------


def _run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


def test_groups_never_share_a_dispatch(pkg):
    dispatched = []

    def fn(queries, group):
        dispatched.append((group, list(queries)))
        return [f"{group}:{q}" for q in queries]

    async def drive():
        mb = pkg.MicroBatcher(fn, max_batch=64)
        outs = await asyncio.gather(*(mb.submit(i, group="a" if i % 2 else "b")
                                      for i in range(10)))
        mb.stop()
        return outs

    assert _run(drive()) == [f"{'a' if i % 2 else 'b'}:{i}" for i in range(10)]
    for group, queries in dispatched:
        assert all((q % 2 == 1) == (group == "a") for q in queries), (group, queries)


def test_per_group_ladder_pads_that_group_only(pkg):
    sizes = {}

    def fn(queries, group):
        sizes.setdefault(group, []).append(len(queries))
        return ["r" if q is not pkg.aot.PAD else None for q in queries]

    async def drive():
        mb = pkg.MicroBatcher(fn, max_batch=64, ladder=pkg.aot.BucketLadder((2,)))
        mb.set_group_ladder("big", pkg.aot.BucketLadder((8,)))
        a = await mb.submit("q", group="big")
        b = await mb.submit("q", group=None)
        mb.stop()
        return a, b

    assert _run(drive()) == ("r", "r")
    assert sizes == {"big": [8], None: [2]}


def test_single_arg_batch_fn_still_works(pkg):
    async def drive():
        mb = pkg.MicroBatcher(lambda queries: [q * 2 for q in queries], max_batch=8)
        out = await mb.submit(21)
        mb.stop()
        return out

    assert _run(drive()) == 42


def test_stop_clears_group_ladders(pkg):
    sizes = []

    def fn(queries, group):
        sizes.append(len(queries))
        return list(queries)

    async def drive():
        mb = pkg.MicroBatcher(fn, max_batch=8)
        mb.set_group_ladder("v", pkg.aot.BucketLadder((4,)))
        await mb.submit("q", group="v")
        mb.stop()
        assert mb._group_ladders == {}
        await mb.submit("q", group="v")
        mb.stop()

    _run(drive())
    assert sizes == [4, 1]


# -- twin servers over one home the JAX package trained --------------------------

ARMS = "champion:1,challenger:1"
USERS = [str(u) for u in range(30)]


@pytest.fixture(scope="module")
def trained_home(tmp_path_factory):
    """One home: seeded ratings, two JAX-trained instances (lambda 0.05 and
    0.5) registered as generations 1 (promoted) and 2."""
    home = str(tmp_path_factory.mktemp("variants") / "home")
    storage = JaxStorage(JaxStorageConfig(home=home))
    seed_ratings(storage)
    iids = []
    for lam in (0.05, 0.5):
        variant = dict(VARIANT, algorithms=[{"name": "als", "params": {
            "rank": 8, "numIterations": 8, "lambda": lam}}])
        iids.append(jax_run_train(FACTORY, variant=variant, storage=storage,
                                  use_mesh=False))
    reg = jax_models.model_registry(storage)
    gens = [reg.register(iid, storage.models.get(iid)) for iid in iids]
    reg.promote(gens[0])
    return home, iids, gens


@pytest.fixture()
def twins(trained_home, tmp_path, monkeypatch):
    """A JAX and a port EngineServer with variants on copies of the home."""
    monkeypatch.setenv("PIO_ALS_SERVE", "device")
    home, iids, gens = trained_home
    out = {}
    for name in ("jax", "port"):
        twin = str(tmp_path / name)
        shutil.copytree(home, twin)
        jax = name == "jax"
        storage = (JaxStorage(JaxStorageConfig(home=twin)) if jax
                   else Storage(StorageConfig(home=twin)))
        cls = JaxEngineServer if jax else EngineServer
        kw = {} if jax else {"device": "cpu"}
        out[name] = cls(engine_factory=FACTORY, storage=storage, host="127.0.0.1",
                        port=0, feedback=True, variants=ARMS, variant_salt="t", **kw)
    return out, iids, gens


def _norm_answer(code, body, headers):
    body = dict(body) if isinstance(body, dict) else body
    if isinstance(body, dict):
        body.pop("prId", None)
    return code, body, headers.get("X-PIO-Variant")


def _same_answers(a, b):
    """Equal status, arm and items; scores within 1e-5 relative."""
    (ca, ba, va), (cb, bb, vb) = a, b
    assert (ca, va) == (cb, vb)
    if "itemScores" not in (ba or {}):
        assert ba == bb
        return
    assert [x["item"] for x in ba["itemScores"]] == [x["item"] for x in bb["itemScores"]]
    assert np.allclose([x["score"] for x in ba["itemScores"]],
                       [x["score"] for x in bb["itemScores"]], rtol=1e-5)


def _variants_doc(doc):
    """/variants or /health's variants block with its times taken out."""
    doc = json.loads(json.dumps(doc))
    for arm in doc["variants"].values():
        arm.pop("swappedAt", None)
    return doc


def _script(port, faults):
    """The request script: {step: normalised answer}."""
    out = {}
    for u in USERS:
        out[f"q{u}"] = _norm_answer(*jcall(port, "POST", "/queries.json",
                                           {"user": u, "num": 4}))
    out["override"] = _norm_answer(*jcall(port, "POST", "/queries.json",
                                          {"user": "1", "num": 4},
                                          {"X-PIO-Variant": "challenger"}))
    out["ghost"] = _norm_answer(*jcall(port, "POST", "/queries.json",
                                       {"user": "1", "num": 4},
                                       {"X-PIO-Variant": "ghost"}))
    code, pred, hdrs = jcall(port, "POST", "/queries.json", {"user": "2", "num": 4})
    item = pred["itemScores"][0]["item"]
    out["rating"] = jcall(port, "POST", "/feedback.json",
                          {"prId": pred["prId"], "rating": 4.0, "item": item})[:2]
    out["click"] = jcall(port, "POST", "/feedback.json",
                         {"prId": pred["prId"], "click": True})[:2]
    out["unknown"] = jcall(port, "POST", "/feedback.json", {"prId": "ghost"})[:2]
    out["explicit"] = jcall(port, "POST", "/feedback.json",
                            {"prId": "ghost", "variant": "challenger", "click": 1})[:2]
    out["bad rating"] = jcall(port, "POST", "/feedback.json",
                              {"prId": "x", "rating": "high"})[:2]
    code, doc, _ = jcall(port, "GET", "/variants")
    online = {n: v.pop("online") for n, v in doc["variants"].items()}
    # the latency histograms differ; the counts and ratings do not
    out["variants"] = code, _variants_doc(doc), {
        n: {k: v for k, v in o.items() if k != "onlineRmse"} for n, o in online.items()}
    out["rmse set"] = {n: o["onlineRmse"] is not None for n, o in online.items()}
    out["weights ghost"] = jcall(port, "POST", "/variants/weights",
                                 {"weights": {"champion": 1, "ghost": 1}})[:2]
    out["weights bad body"] = jcall(port, "POST", "/variants/weights", {"w": 1})[:2]
    out["weights"] = jcall(port, "POST", "/variants/weights",
                           {"weights": {"champion": 3, "challenger": 1}})[:2]
    out["after weights"] = [jcall(port, "POST", "/queries.json", {"user": u, "num": 4}
                                  )[2].get("X-PIO-Variant") for u in USERS]
    faults.arm("variant.reload.partial", error="mid-swap kill")
    code, body, _ = jcall(port, "GET", "/reload?variant=challenger")
    faults.disarm()
    out["reload faulted"] = code, body
    code, health, _ = jcall(port, "GET", "/health")
    out["health failed"] = (code, health["status"], health["reason"],
                            _variants_doc(health["variants"]))
    out["failed arm's users"] = [
        _norm_answer(*jcall(port, "POST", "/queries.json", {"user": u, "num": 4}))
        for u in USERS[:8]]
    code, body, _ = jcall(port, "GET", "/reload?variant=challenger")
    out["reload"] = code, {k: v for k, v in body.items() if k != "engineInstanceId"}
    out["health healed"] = jcall(port, "GET", "/health")[1]["status"]
    out["reload ghost"] = jcall(port, "GET", "/reload?variant=ghost")[:2]
    code, body, _ = jcall(port, "GET", "/reload")
    out["reload champion"] = code, {k: v for k, v in body.items()
                                    if k != "engineInstanceId"}
    return out


def test_twin_variant_servers_answer_alike(twins):
    servers, iids, gens = twins
    got = {}
    for name, srv in servers.items():
        faults = jax_faults.FAULTS if name == "jax" else port_faults.FAULTS
        with ServerThread(srv) as t:
            got[name] = _script(t.port, faults)
    jax, port = got["jax"], got["port"]
    assert set(port) == set(jax)
    for step in jax:
        if step.startswith("q") or step in ("override", "ghost"):
            _same_answers(port[step], jax[step])
        elif step == "failed arm's users":
            for a, b in zip(port[step], jax[step]):
                _same_answers(a, b)
        else:
            assert port[step] == jax[step], step
    arms = {a[2] for k, a in port.items() if k.startswith("q")}
    assert arms == {"champion", "challenger"}
    assert port["reload faulted"][0] == 500 and port["reload faulted"][1]["swap"] == "failed"
    assert {a[2] for a in port["failed arm's users"]} == {"champion"}
    assert port["reload"][1]["swap"] == "promoted"
    assert port["reload"][1]["modelGeneration"] == gens[1]


def test_each_arm_answers_from_its_own_factors(twins):
    """Both arms share one serving program (one geometry): each batch must
    still score with its own arm's factors, which differ here."""
    servers, iids, _ = twins
    srv = servers["port"]
    champ = srv._mux.get("champion").deployed
    chal = srv._mux.get("challenger").deployed
    assert (champ.instance.id, chal.instance.id) == tuple(iids)
    with ServerThread(srv) as t:
        answers = [jcall(t.port, "POST", "/queries.json", {"user": u, "num": 4})
                   for u in USERS]
    differ = 0
    for u, (code, body, hdrs) in zip(USERS, answers):
        arm = hdrs["X-PIO-Variant"]
        own = (champ if arm == "champion" else chal).query({"user": u, "num": 4})
        other = (chal if arm == "champion" else champ).query({"user": u, "num": 4})
        assert code == 200
        assert [x["item"] for x in body["itemScores"]] == [x["item"] for x in own["itemScores"]]
        assert np.allclose([x["score"] for x in body["itemScores"]],
                           [x["score"] for x in own["itemScores"]], rtol=1e-5)
        differ += not np.allclose([x["score"] for x in body["itemScores"]],
                                  [x["score"] for x in other["itemScores"]], rtol=1e-3)
    assert differ == len(USERS)


def test_single_model_server_has_no_variant_surface(trained_home, tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_ALS_SERVE", "device")
    home, _, _ = trained_home
    twin = str(tmp_path / "home")
    shutil.copytree(home, twin)
    out = {}
    for name, srv in (
            ("jax", JaxEngineServer(engine_factory=FACTORY, host="127.0.0.1", port=0,
                                    storage=JaxStorage(JaxStorageConfig(home=twin)))),
            ("port", EngineServer(engine_factory=FACTORY, host="127.0.0.1", port=0,
                                  device="cpu", storage=Storage(StorageConfig(home=twin))))):
        with ServerThread(srv) as t:
            code, _, hdrs = jcall(t.port, "POST", "/queries.json", {"user": "2", "num": 3})
            out[name] = (code, "X-PIO-Variant" in hdrs,
                         jcall(t.port, "GET", "/variants")[:2],
                         jcall(t.port, "POST", "/feedback.json", {"prId": "x"})[:2],
                         jcall(t.port, "POST", "/variants/weights", {"weights": {}})[:2],
                         "variants" in jcall(t.port, "GET", "/health")[1])
    assert out["port"] == out["jax"]
    assert out["port"][:2] == (200, False) and out["port"][2][0] == 404


# -- the models and variants verbs ------------------------------------------------


def test_models_verbs_on_twin_homes(trained_home, tmp_path, capsys):
    home, iids, gens = trained_home
    tw = Twins(tmp_path, capsys)
    for name in ("jax", "port"):
        shutil.copytree(home, tw.homes[name])
    for argv in (("models", "list"), ("models", "list", "--json"),
                 ("models", "promote", str(gens[1])), ("models", "list"),
                 ("models", "rollback"), ("models", "rollback"),
                 ("models", "promote", "99"), ("models", "list", "--json")):
        tw.run(*argv)
    for name in ("jax", "port"):
        with open(os.path.join(tw.homes[name], "model_registry", "registry.json"), "rb") as f:
            tw.homes[name + "_manifest"] = f.read()
    assert tw.homes["port_manifest"] == tw.homes["jax_manifest"]
    # sync_meta moved the same instances to the same statuses
    statuses = {}
    for name, st in (("jax", JaxStorage(JaxStorageConfig(home=tw.homes["jax"]))),
                     ("port", Storage(StorageConfig(home=tw.homes["port"])))):
        statuses[name] = [st.meta.get_engine_instance(i).status for i in iids]
    assert statuses["port"] == statuses["jax"] == ["COMPLETED", "REGRESSED"]


def _verb(main, registry, storage, argv, capsys):
    registry.set_storage(storage)
    try:
        main(argv)
        code = 0
    except SystemExit as e:
        code = e.code
    finally:
        registry.set_storage(None)
    out = capsys.readouterr()
    return code, out.out, out.err


def test_variants_verbs_against_twin_servers(twins, capsys):
    servers, _, _ = twins
    out = {}
    for name, srv in servers.items():
        main, registry = ((jax_cli.main, jax_registry) if name == "jax"
                          else (cli.main, port_registry))
        with ServerThread(srv) as t:
            url = f"http://127.0.0.1:{t.port}"
            steps = [_verb(main, registry, srv.storage, argv, capsys) for argv in (
                ["variants", "status", "--url", url],
                ["variants", "set-weights", "champion@2:1", "--url", url],
                ["variants", "set-weights", "champion:1,ghost:1", "--url", url],
                ["variants", "set-weights", "champion:5,challenger:2", "--url", url],
                ["variants", "status", "--url", url, "--json"])]
        out[name] = [(code, text.replace(url, "{url}"), err.replace(url, "{url}"))
                     for code, text, err in steps]
        doc = json.loads(out[name][-1][1])["{url}"]
        out[name][-1] = (out[name][-1][0], _variants_doc(doc), out[name][-1][2])
    assert out["port"] == out["jax"]
    assert [s[0] for s in out["port"]] == [0, 1, 1, 0, 0]


def test_variants_verb_needs_no_torch():
    code = ("import sys\nsys.modules['torch'] = None\n"
            "from predictionio_tpu_torch.tools import cli\n"
            "try:\n    cli.main(['variants', 'status', '--url', 'http://127.0.0.1:9'])\n"
            "except SystemExit:\n    pass\n"
            "cli.main(['incidents', 'list', '--dir', sys.argv[1]])\n")
    proc = subprocess.run([sys.executable, "-c", code, os.path.join(REPO, "no-such-dir")],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "no incident bundles" in proc.stdout
