"""The port's admin server, dashboard and fleet verbs held against the
JAX package's, on the CPU: the admin API's CRUD on twin homes (the same
statuses and bodies, the same rows left behind), both dashboards over
one home with an evaluation instance (the same ``/evaluations.json`` and
table rows), the ``dashboard`` and ``adminserver`` verbs in processes of
their own, and the exit codes and lines of ``doctor`` (bundles and a
live router; 0 clean, 1 warnings, 2 firing; ``--act`` dry runs and the
fenced ``--yes``), ``router status`` and ``router reload [--rolling]``
(1 when the fleet refuses) of both CLIs.
"""

import datetime as _dt
import json
import os
import signal
import subprocess
import sys
import time

import pytest

from predictionio_tpu.storage import registry as jax_registry
from predictionio_tpu.storage.meta import EvaluationInstance as JaxEvaluationInstance
from predictionio_tpu.storage.registry import Storage as JaxStorage
from predictionio_tpu.storage.registry import StorageConfig as JaxStorageConfig
from predictionio_tpu.tools import admin as jax_admin
from predictionio_tpu.tools import cli as jax_cli
from predictionio_tpu.tools import dashboard as jax_dashboard
from predictionio_tpu.utils.incidents import IncidentStore
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.storage import registry as port_registry
from predictionio_tpu_torch.storage.registry import Storage, StorageConfig
from predictionio_tpu_torch.tools import admin as port_admin
from predictionio_tpu_torch.tools import cli as port_cli
from predictionio_tpu_torch.tools import dashboard as port_dashboard
from tests.test_servers import ServerThread, free_port, http
from tests.test_torch_router import PKG, fleet, on_loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def disarm_faults():
    for p in PKG.values():
        p.faults.disarm()
    yield
    for p in PKG.values():
        p.faults.disarm()


def _storages(tmp_path):
    return {"jax": JaxStorage(JaxStorageConfig(home=str(tmp_path / "jax"))),
            "port": Storage(StorageConfig(home=str(tmp_path / "port")))}


# -- the admin server -------------------------------------------------------------------


def test_admin_crud_matches_the_jax_server(tmp_path):
    storages = _storages(tmp_path)
    out = {}
    for pkg, mod in (("jax", jax_admin), ("port", port_admin)):
        st = storages[pkg]
        port = free_port()
        steps = []
        with ServerThread(mod.AdminServer(storage=st, host="127.0.0.1", port=port)):
            base = f"http://127.0.0.1:{port}"
            steps.append(http("GET", f"{base}/"))
            code, body = http("POST", f"{base}/cmd/app", {"name": "adm", "description": "d"})
            assert code == 201 and body["accessKey"]
            body["accessKey"] = "<key>"
            for k in body["accessKeys"]:
                k["key"] = "<key>"
            steps.append((code, body))
            steps.append(http("POST", f"{base}/cmd/app", {"name": "adm"}))
            steps.append(http("POST", f"{base}/cmd/app", {}))
            code, body = http("GET", f"{base}/cmd/app")
            for a in body["apps"]:
                for k in a["accessKeys"]:
                    k["key"] = "<key>"
            steps.append((code, body))
            app = st.meta.get_app_by_name("adm")
            st.events.insert(Event(event="buy", entity_type="user", entity_id="u1",
                                   target_entity_type="item", target_entity_id="i1")
                             if pkg == "port" else _jax_event(), app.id)
            steps.append(http("DELETE", f"{base}/cmd/app/adm/data"))
            assert list(st.events.find(app.id)) == []
            steps.append(http("DELETE", f"{base}/cmd/app/adm"))
            steps.append(http("GET", f"{base}/cmd/app/adm"))
            steps.append(http("DELETE", f"{base}/cmd/app/nope"))
            assert st.meta.get_app_by_name("adm") is None
        out[pkg] = steps
    assert out["port"] == out["jax"]
    assert [s[0] for s in out["port"]] == [200, 201, 409, 400, 200, 200, 200, 404, 404]


def _jax_event():
    from predictionio_tpu.data.event import Event as JaxEvent

    return JaxEvent(event="buy", entity_type="user", entity_id="u1",
                    target_entity_type="item", target_entity_id="i1")


def test_admin_server_reads_a_jax_written_home(tmp_path):
    st = JaxStorage(JaxStorageConfig(home=str(tmp_path)))
    app = st.meta.create_app("shop", "from jax")
    st.meta.create_access_key(app.id, key="k1")
    port = free_port()
    with ServerThread(port_admin.AdminServer(
            storage=Storage(StorageConfig(home=str(tmp_path))), host="127.0.0.1",
            port=port)):
        code, body = http("GET", f"http://127.0.0.1:{port}/cmd/app/shop")
    assert code == 200 and body["name"] == "shop" and body["id"] == app.id


# -- the dashboard ------------------------------------------------------------------------


def _seed_evaluation(home):
    st = JaxStorage(JaxStorageConfig(home=home))
    t0 = _dt.datetime(2026, 1, 2, 3, 4, 5, tzinfo=_dt.timezone.utc)
    for i, status in enumerate(("EVALCOMPLETED", "EVALUATING")):
        st.meta.insert_evaluation_instance(JaxEvaluationInstance(
            id=f"ev{i}", status=status, start_time=t0 + _dt.timedelta(minutes=i),
            end_time=(t0 + _dt.timedelta(minutes=5)) if i == 0 else None,
            evaluation_class="pkg.engine:RecEvaluation",
            engine_params_generator_class="pkg.engine:DefaultGrid", batch="", env={},
            evaluator_results="HitRate@10 0.25 <best>",
            evaluator_results_json=json.dumps({"best": 0.25}) if i == 0 else ""))


def test_dashboards_match_over_one_home(tmp_path):
    home = str(tmp_path)
    _seed_evaluation(home)
    pages = {}
    for pkg, mod, st in (
            ("jax", jax_dashboard, JaxStorage(JaxStorageConfig(home=home))),
            ("port", port_dashboard, Storage(StorageConfig(home=home)))):
        port = free_port()
        with ServerThread(mod.Dashboard(storage=st, host="127.0.0.1", port=port)):
            code, doc = http("GET", f"http://127.0.0.1:{port}/evaluations.json")
            import urllib.request

            with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=10) as r:
                page = r.read().decode()
                ctype = r.headers["Content-Type"]
        pages[pkg] = (code, doc, page, ctype)
    (jc, jdoc, jpage, jct), (pc, pdoc, ppage, pct) = pages["jax"], pages["port"]
    assert pc == jc == 200 and pct == jct
    assert pdoc == jdoc
    assert [d["id"] for d in pdoc] == ["ev1", "ev0"]
    assert pdoc[1]["resultsJSON"] == {"best": 0.25} and pdoc[0]["endTime"] is None
    # the same table; only the title names the package
    assert ppage.split("<body>")[1] == jpage.split("<body>")[1]
    assert "HitRate@10 0.25 &lt;best&gt;" in ppage


def _serve_verb(verb, port, home, path):
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", verb, "--ip",
         "127.0.0.1", "--port", str(port)], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env={**os.environ, "PIO_HOME": home})
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        try:
            return proc, http("GET", f"http://127.0.0.1:{port}{path}")
        except OSError:
            assert proc.poll() is None, proc.stdout.read()
            time.sleep(0.1)
    proc.kill()
    raise AssertionError(f"{verb} did not start")


@pytest.mark.parametrize("verb,path,want", [
    ("adminserver", "/", {"status": "alive"}),
    ("dashboard", "/evaluations.json", None),
])
def test_dashboard_and_adminserver_verbs(tmp_path, verb, path, want):
    home = str(tmp_path)
    _seed_evaluation(home)
    port = free_port()
    proc, (code, _) = _serve_verb(verb, port, home, path)
    try:
        assert code == 200
        code, doc = http("GET", f"http://127.0.0.1:{port}{path}")
        assert code == 200
        if want is not None:
            assert doc == want
        else:
            assert [d["id"] for d in doc] == ["ev1", "ev0"]
    finally:
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=30)
    name = "Admin server" if verb == "adminserver" else "Dashboard"
    assert f"[info] {name} on 127.0.0.1:{port}" in out


# -- the CLI verbs: both CLIs, exit codes and lines --------------------------------------------


def _run(pkg, argv, capsys, home):
    main = jax_cli.main if pkg == "jax" else port_cli.main
    registry = jax_registry if pkg == "jax" else port_registry
    storage = (JaxStorage(JaxStorageConfig(home=home)) if pkg == "jax"
               else Storage(StorageConfig(home=home)))
    registry.set_storage(storage)
    try:
        main(argv)
        code = 0
    except SystemExit as e:
        code = e.code
    finally:
        registry.set_storage(None)
    out = capsys.readouterr()
    return code, out.out.splitlines(), out.err.splitlines()


def _both(argv, capsys, tmp_path, monkeypatch=None):
    out = {}
    for pkg in ("jax", "port"):
        home = str(tmp_path / f"home_{pkg}")
        os.makedirs(home, exist_ok=True)
        if monkeypatch is not None:
            monkeypatch.setenv("PIO_HOME", home)
        out[pkg] = _run(pkg, argv, capsys, home)
    return out


FIRING = {
    "manifest": {"process": "router", "sloFastBurning": ["avail"],
                 "faults": {"router.replica.down": {"error": "drill"}},
                 "triggers": [{"trigger": "slo-fast-burn"}, {"trigger": "breaker-open"}]},
    "files": {"replicas.json": {"replicas": [
        {"url": "http://127.0.0.1:8001", "state": "down", "breaker": "open"},
        {"url": "http://127.0.0.1:8002", "state": "not-ready"}]},
        "metrics_history.json": {"series": {
            'pio_engine_shed_total{app="hog"}': [[1.0, 0.0], [2.0, 5.0]]}}},
}
WARN = {
    "manifest": {"process": "router"},
    "files": {"replicas.json": {"replicas": [
        {"url": "http://127.0.0.1:8002", "state": "not-ready"}]}},
}
CLEAN = {"manifest": {"process": "engine"}, "files": {}}


@pytest.fixture()
def bundles(tmp_path):
    root = str(tmp_path / "incidents")
    store = IncidentStore(root)
    ids = {}
    for name, b, ts in (("clean", CLEAN, 1.0), ("warn", WARN, 2.0), ("firing", FIRING, 3.0)):
        iid = store.new_id(1_700_000_000 + ts, name)
        store.write_bundle(iid, b["files"], b["manifest"])
        ids[name] = iid
    return root, ids


@pytest.mark.parametrize("which,code", [("clean", 0), ("warn", 1), ("firing", 2),
                                        ("latest", 2)])
def test_doctor_on_a_bundle_matches_the_jax_cli(which, code, bundles, tmp_path, capsys):
    root, ids = bundles
    iid = "latest" if which == "latest" else ids[which]
    for extra in ([], ["--json"]):
        out = _both(["doctor", "--incident", iid, "--dir", root] + extra, capsys, tmp_path)
        assert out["port"] == out["jax"]
        assert out["port"][0] == code
    if code == 0:
        assert out["port"][1][-1] == "}"
        assert json.loads("\n".join(out["port"][1]))["findings"] == []


def _untimed(doc):
    """A ``doctor --json`` document without the wall clock's ``at`` stamps
    of its remediation entries."""
    for r in doc.get("remediation") or []:
        r.pop("at", None)
    return doc


def test_doctor_act_plans_dry_and_fences_yes(bundles, tmp_path, capsys, monkeypatch):
    """``doctor --act`` on the firing bundle prints the same plan in both
    CLIs and executes nothing; ``--yes`` with another actor's
    ``remediation.lock`` in the home is refused as ``locked``."""
    root, ids = bundles
    argv = ["doctor", "--incident", ids["firing"], "--dir", root, "--act",
            "--remediations", os.path.join(REPO, "conf", "remediations.json")]
    out = _both(argv, capsys, tmp_path, monkeypatch)
    assert out["port"] == out["jax"]
    code, lines, _ = out["port"]
    assert code == 2
    assert "remediation plan (DRY RUN — pass --yes to execute):" in lines
    assert any(ln.strip().startswith("[dry-run") for ln in lines)
    out = _both(argv + ["--json"], capsys, tmp_path, monkeypatch)
    docs = {pkg: _untimed(json.loads("\n".join(out[pkg][1]))) for pkg in out}
    assert docs["port"] == docs["jax"]
    for pkg in ("jax", "port"):
        home = tmp_path / f"home_{pkg}"
        (home / "remediation.lock").write_text("12345")
    out = _both(argv + ["--yes", "--json"], capsys, tmp_path, monkeypatch)
    docs = {pkg: _untimed(json.loads("\n".join(out[pkg][1]))) for pkg in out}
    assert docs["port"] == docs["jax"]
    doc = docs["port"]
    assert doc["remediation"] and {r["result"] for r in doc["remediation"]} == {"locked"}


def test_doctor_missing_bundle_and_dead_router(tmp_path, capsys):
    out = _both(["doctor", "--incident", "nope", "--dir", str(tmp_path / "none")],
                capsys, tmp_path)
    assert out["port"][0] == out["jax"][0] == 1
    out = _both(["doctor", "--url", f"http://127.0.0.1:{free_port()}", "--timeout", "2"],
                capsys, tmp_path)
    assert out["port"][0] == out["jax"][0] == 1
    assert out["port"][2][0].startswith("[error] live diagnosis against")


def test_doctor_live_against_a_port_router(tmp_path, capsys, monkeypatch):
    """``doctor`` against a live port router: clean (0), then with one
    replica down (2, the restart playbook's finding) the same findings,
    exit code and ``--act`` plan from both CLIs."""
    with fleet("port", 2, {"hedge": False, "health_interval": 30.0,
                           "scrape_interval": 3600.0, "probe_interval": 0.0}) as (
            router, stubs, _, rt):
        base = f"http://127.0.0.1:{router.http.port}"
        out = _both(["doctor", "--url", base], capsys, tmp_path)
        assert out["port"] == out["jax"]
        assert out["port"][0] == 0
        assert out["port"][1] == [f"doctor — live fleet at {base}",
                                  "  no findings — clean bill of health"]
        router.replicas[0].state = "down"
        for extra in ([], ["--json"], ["--act"]):
            out = _both(["doctor", "--url", base] + extra, capsys, tmp_path, monkeypatch)
            assert out["port"] == out["jax"]
            assert out["port"][0] == 2
        lines = out["port"][1]
        assert f"  [FIRING] replica http://{stubs[0].url} state=down breaker=closed" in lines
        assert any(ln.strip().startswith("[dry-run") and "restart_replica" in ln
                   for ln in lines)


def test_router_status_and_reload_verbs(tmp_path, capsys):
    with fleet("port", 2, {"hedge": False, "health_interval": 0.2,
                           "ready_timeout": 10.0}) as (router, stubs, _, _rt):
        base = f"http://127.0.0.1:{router.http.port}"
        out = _both(["router", "status", "--url", base], capsys, tmp_path)
        assert out["port"][0] == out["jax"][0] == 0
        doc = json.loads("\n".join(out["port"][1]))
        assert [r["instance"] for r in doc["replicas"]] == ["stub-0", "stub-1"]
        assert sorted(doc) == sorted(json.loads("\n".join(out["jax"][1])))
        out = {}
        for pkg in ("jax", "port"):
            out[pkg] = _run(pkg, ["router", "reload", "--rolling", "--url", base], capsys,
                            str(tmp_path))
        assert out["port"][0] == out["jax"][0] == 0
        doc = json.loads("\n".join(out["port"][1]))
        assert doc["ok"] is True and doc["rolling"] is True
        assert [s.reloads for s in stubs] == [2, 2]
        stubs[1].reload_status = 500
        for pkg in ("jax", "port"):
            out[pkg] = _run(pkg, ["router", "reload", "--url", base], capsys, str(tmp_path))
        assert out["port"][0] == out["jax"][0] == 1
        assert out["port"][2] == out["jax"][2] == ["[error] fleet reload failed"]
        assert json.loads("\n".join(out["port"][1]))["ok"] is False


def test_router_serve_flags_match_the_jax_parser():
    """Every flag of the JAX CLI's ``router serve``, ``slo status``,
    ``top``, ``doctor``, ``dashboard`` and ``adminserver`` parses in the
    port's CLI with the same defaults."""
    cases = [["router", "serve"], ["router", "status"], ["router", "reload"],
             ["slo", "status"], ["top"], ["doctor"], ["dashboard"], ["adminserver"]]
    jp, pp = jax_cli.build_parser(), port_cli.build_parser()
    for argv in cases:
        j, p = vars(jp.parse_args(argv)), vars(pp.parse_args(argv))
        for d in (j, p):
            d.pop("fn")
        assert p == j, argv


def test_router_serve_refuses_pool_without_manifest(capsys, tmp_path):
    out = _both(["router", "serve", "--pool-spawn", "deploy --port {port}"], capsys,
                tmp_path)
    assert out["port"][0] == out["jax"][0] == 1
    assert out["port"][2] == out["jax"][2]
