"""The port's CLI verbs held against the JAX package's, on the CPU.

Each verb of the port (``app new|list|show|delete|data-delete|
channel-new|channel-delete``, ``accesskey new|list|delete``, ``export``,
``import``) and the JAX CLI's same verb run on twin temporary homes with
fixed ``--access-key`` values: their exit codes, printed lines and
``apps``, ``access_keys`` and ``channels`` rows must be equal (a key
``accesskey new`` generates is normalised). ``export`` of the same
events gives byte-equal files from both packages, and ``import``
round-trips through each. ``status --device cpu`` prints the backends;
without it and without a card, ``status`` exits non-zero.
``eventserver`` builds its server from the flags. ``eval`` (serial and
``--distributed``, the port with ``--device cpu``), ``eval
leaderboard``, ``evals list`` and ``evals show`` print the JAX CLI's
lines (instance ids, times and the run's walls normalised, scores
within 1e-4 relative) and write equal ``evaluation_instances`` rows;
``evals`` and ``eval leaderboard`` run in a process that cannot import
torch; ``eval`` without a card and without ``--device cpu`` exits
non-zero. Last, a small CPU quickstart: ``app new`` → event server →
HTTP posts → ``train --device cpu`` → ``deploy --device cpu``, which
answers a query.

The replicated event plane and the continuous trainer: ``eventserver
--lease-home`` builds its ``ReplNode`` from the flags and leads once
started; ``train --continuous --max-cycles 1`` (the port on ``--device
cpu``), ``train --read-from follower``, ``daemon`` and ``failover
--target`` print the JAX CLI's lines with its exit codes on twin homes,
with equal trainer state and registry manifests; ``daemon -- train
--continuous`` supervises the port's trainer in a process of its own.
"""

import json
import os
import re
import sqlite3
import subprocess
import sys

import numpy as np
import pytest
import torch

from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.storage import leaderboard as jax_lb
from predictionio_tpu.storage import registry as jax_registry
from predictionio_tpu.storage.registry import Storage as JaxStorage
from predictionio_tpu.storage.registry import StorageConfig as JaxStorageConfig
from predictionio_tpu.tools import cli as jax_cli
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.storage import leaderboard as lb
from predictionio_tpu_torch.storage import registry as port_registry
from predictionio_tpu_torch.storage.registry import Storage, StorageConfig
from predictionio_tpu_torch.tools import cli
from tests.test_torch_eval import APP, _seed
from tests.test_torch_event_server import ServerThread, request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE_DIR = os.path.join(REPO, "predictionio_tpu_torch", "templates", "recommendation")


def _run(main, registry, storage, argv, capsys):
    """One verb: (exit code, stdout lines, stderr lines)."""
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


class Twins:
    """The JAX CLI and the port's on twin homes, verb by verb."""

    def __init__(self, tmp_path, capsys):
        self.homes = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
        self.capsys = capsys
        self.keys = {"jax": [], "port": []}  # keys `accesskey new` generated

    def run(self, *argv):
        """Run ``argv`` in both; ``{home}`` in an argument is the twin's home."""
        out = {}
        for name, main, registry, storage, config in (
                ("jax", jax_cli.main, jax_registry, JaxStorage, JaxStorageConfig),
                ("port", cli.main, port_registry, Storage, StorageConfig)):
            args = [a.format(home=self.homes[name]) for a in argv]
            code, lines, err = _run(main, registry,
                                    storage(config(home=self.homes[name])),
                                    args, self.capsys)
            if argv[:2] == ("accesskey", "new"):
                self.keys[name] += [line.split("Access Key: ")[1]
                                    for line in lines if "Access Key: " in line]
            out[name] = (code, self._norm(name, lines), self._norm(name, err))
        assert out["port"] == out["jax"], argv
        return out["port"]

    def _norm(self, name, lines):
        text = "\n".join(lines).replace(self.homes[name], "{home}")
        for i, key in enumerate(self.keys[name]):
            text = text.replace(key, f"<generated{i}>")
        return text.splitlines()

    def meta_rows(self, name):
        with sqlite3.connect(os.path.join(self.homes[name], "meta.db")) as c:
            rows = {t: sorted(c.execute(f"SELECT * FROM {t}").fetchall())
                    for t in ("apps", "access_keys", "channels")}
        rows["access_keys"] = sorted(
            (f"<generated{self.keys[name].index(k)}>" if k in self.keys[name] else k,
             app, ev) for k, app, ev in rows["access_keys"])
        return rows

    def event_tables(self, name):
        with sqlite3.connect(os.path.join(self.homes[name], "events.db")) as c:
            return sorted(r[0] for r in c.execute(
                "SELECT name FROM sqlite_master WHERE type='table'"))


def _events_file(path, n=40, seed=0):
    """A JSONL dump with ids and times of its own (no wall clock in it)."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for j in range(n):
            ev = {"eventId": f"ev{j:04d}", "event": "rate", "entityType": "user",
                  "entityId": f"u{rng.integers(8)}", "targetEntityType": "item",
                  "targetEntityId": f"i{rng.integers(12)}",
                  "properties": {"rating": float(rng.integers(1, 11)) / 2},
                  "eventTime": f"2026-02-{1 + j % 28:02d}T08:{j % 60:02d}:00.250Z",
                  "creationTime": "2026-03-01T00:00:00.000Z"}
            if j % 7 == 0:
                ev["tags"] = ["t"]
            f.write(json.dumps(ev) + "\n")
    return path


def test_app_and_accesskey_verbs_match_the_jax_cli(tmp_path, capsys):
    t = Twins(tmp_path, capsys)
    dump = _events_file(str(tmp_path / "events.jsonl"))
    steps = [
        ("app", "new", "App1", "--access-key", "K1", "--description", "first app"),
        ("app", "new", "App2", "--access-key", "K2"),
        ("app", "new", "App1"),
        ("app", "list"),
        ("accesskey", "new", "App1", "--events", "rate,buy"),
        ("accesskey", "new", "App2"),
        ("accesskey", "new", "NoApp"),
        ("accesskey", "list"),
        ("accesskey", "list", "App1"),
        ("app", "channel-new", "App1", "ch1"),
        ("app", "channel-new", "App1", "ch2"),
        ("app", "channel-new", "App2", "ch1"),
        ("app", "channel-new", "NoApp", "ch1"),
        ("app", "show", "App1"),
        ("app", "channel-delete", "App1", "ch2"),
        ("app", "channel-delete", "App1", "nope"),
        ("import", "--app-name", "App1", "--input", dump),
        ("import", "--appid", "2", "--input", dump),
        ("export", "--app-name", "App1", "--output", "{home}/a1.jsonl"),
        ("app", "data-delete", "App1", "--channel", "ch1"),
        ("app", "data-delete", "App1", "--channel", "nope"),
        ("app", "data-delete", "App1"),
        ("export", "--app-name", "App1", "--output", "{home}/a1_empty.jsonl"),
        ("export", "--app-name", "NoApp", "--output", "{home}/x.jsonl"),
        ("export", "--output", "{home}/x.jsonl"),
        ("accesskey", "delete", "K2"),
        ("accesskey", "delete", "nope"),
        ("app", "show", "App2"),
        ("app", "delete", "App2"),
        ("app", "show", "App2"),
        ("app", "delete", "App2"),
        ("app", "list"),
        ("app", "show", "App1"),
    ]
    codes = [t.run(*step)[0] for step in steps]
    assert codes.count(0) == 23 and set(codes) == {0, 1}
    assert t.meta_rows("port") == t.meta_rows("jax")
    assert t.event_tables("port") == t.event_tables("jax") == ["pio_event_1",
                                                                "pio_event_1_1"]
    for name in ("a1.jsonl", "a1_empty.jsonl"):
        with open(os.path.join(t.homes["port"], name), "rb") as f:
            mine = f.read()
        with open(os.path.join(t.homes["jax"], name), "rb") as f:
            assert mine == f.read()
    assert len(mine) == 0


def test_export_is_byte_equal_and_import_round_trips(tmp_path, capsys):
    home = str(tmp_path / "home")
    dump = _events_file(str(tmp_path / "events.jsonl"), n=300, seed=1)

    def jax(*argv):
        return _run(jax_cli.main, jax_registry, JaxStorage(JaxStorageConfig(home=home)),
                    list(argv), capsys)

    def port(*argv):
        return _run(cli.main, port_registry, Storage(StorageConfig(home=home)),
                    list(argv), capsys)

    for i, verb in enumerate((jax, port, jax, port)):
        assert verb("app", "new", f"A{i}", "--access-key", f"k{i}")[0] == 0
    assert jax("import", "--app-name", "A0", "--input", dump)[1] == \
        ["[info] Imported 300 events."]
    out = {name: str(tmp_path / f"{name}.jsonl") for name in ("jax", "port")}
    assert jax("export", "--app-name", "A0", "--output", out["jax"])[0] == 0
    assert port("export", "--app-name", "A0", "--output", out["port"])[1] == \
        [f"[info] Exported 300 events to {out['port']}"]
    with open(out["jax"], "rb") as f:
        reference = f.read()
    with open(out["port"], "rb") as f:
        assert f.read() == reference
    # each package imports the other's export; either export reads it back
    assert port("import", "--app-name", "A1", "--input", out["jax"])[0] == 0
    assert jax("import", "--app-name", "A2", "--input", out["port"])[0] == 0
    for app, verb in (("A1", jax), ("A1", port), ("A2", port), ("A3", port)):
        if app == "A3":  # the port's own round trip
            assert port("import", "--app-name", "A3", "--input", out["port"])[0] == 0
        path = str(tmp_path / f"again_{app}_{verb.__name__}.jsonl")
        assert verb("export", "--app-name", app, "--output", path)[0] == 0
        with open(path, "rb") as f:
            assert f.read() == reference, (app, verb.__name__)


def test_status_prints_backends_and_needs_a_card(tmp_path, capsys, monkeypatch):
    st = Storage(StorageConfig(home=str(tmp_path)))
    code, lines, _ = _run(cli.main, port_registry, st,
                          ["status", "--device", "cpu"], capsys)
    assert code == 0
    assert lines[1:4] == ["[info] metadata: SQLITE (ok)",
                          "[info] eventdata: SQLITE (ok)",
                          "[info] modeldata: LOCALFS (ok)"]
    assert lines[4].startswith(f"[info] torch {torch.__version__}")
    assert lines[-2:] == ["[info] device: cpu", "[info] status: all systems go"]
    # verify() leaves what the JAX package's leaves behind
    jst = JaxStorage(JaxStorageConfig(home=str(tmp_path / "jax")))
    assert jst.verify() == Storage(StorageConfig(home=str(tmp_path / "jax2"))).verify()
    assert sorted(os.listdir(tmp_path / "jax")) == sorted(os.listdir(tmp_path / "jax2"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code, lines, err = _run(cli.main, port_registry, st, ["status"], capsys)
    assert code == 1 and lines == [] and "no CUDA device" in err[0]


_INSTANCE_ID = re.compile(r"\d{14}-[0-9a-f]{8}")
_TIME = re.compile(r"\d{4}-\d\d-\d\d[ T]\d\d:\d\d:\d\d(\.\d+)?\+00:00")
_WALLS = re.compile(r"wall=[\d.]+s device=[\d.]+s")
_FLOAT = re.compile(r"-?\d+\.\d+(e-?\d+)?")


def _shape(text, ids):
    """``text`` with instance ids numbered by first appearance (``ids``
    carries the numbering across calls), times and walls blanked, the
    port's module paths under the JAX package's names, and every float
    taken out: (template, floats)."""
    def number(m):
        return f"<id{ids.setdefault(m.group(0), len(ids))}>"

    text = _INSTANCE_ID.sub(number, text)
    text = _WALLS.sub("wall=<t> device=<t>", _TIME.sub("<time>", text))
    text = text.replace("predictionio_tpu_torch.", "predictionio_tpu.")
    floats = [float(m.group(0)) for m in _FLOAT.finditer(text)]
    return _FLOAT.sub("<f>", text), floats


def _assert_same_shape(mine, theirs):
    assert mine[0] == theirs[0]
    np.testing.assert_allclose(mine[1], theirs[1], rtol=1e-4)


def test_eval_verbs_match_the_jax_cli(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("PIO_EVAL_APP_NAME", APP)
    homes = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    _seed(JaxStorage(JaxStorageConfig(home=homes["jax"])), JaxEvent)
    _seed(Storage(StorageConfig(home=homes["port"])), Event)
    mods = {"jax": "predictionio_tpu.templates.recommendation.engine",
            "port": "predictionio_tpu_torch.templates.recommendation.engine"}
    ids = {"jax": {}, "port": {}}
    done = {"jax": [], "port": []}  # instance ids in order

    def both(*argv, eval_args=False):
        out = {}
        for name, main, registry, storage, config in (
                ("jax", jax_cli.main, jax_registry, JaxStorage, JaxStorageConfig),
                ("port", cli.main, port_registry, Storage, StorageConfig)):
            args = [a.format(mod=mods[name], id=done[name][-1] if done[name] else "")
                    for a in argv]
            if eval_args and name == "port":
                args += ["--device", "cpu"]
            code, lines, _ = _run(main, registry, storage(config(home=homes[name])),
                                  args, capsys)
            found = [m.group(0) for m in _INSTANCE_ID.finditer("\n".join(lines))]
            if eval_args:
                done[name].append(found[0])
            out[name] = (code, _shape("\n".join(lines), ids[name]))
        assert out["port"][0] == out["jax"][0] == 0, argv
        _assert_same_shape(out["port"][1], out["jax"][1])
        return out["port"][1][0]

    rec_eval, grid = "{mod}:RecEvaluation", "{mod}:DefaultGrid"
    serial = both("eval", rec_eval, grid, "--engine-dir", ENGINE_DIR, eval_args=True)
    assert "mode=serial grid=4" in serial and "*best*" in serial
    dist = both("eval", rec_eval, grid, "--engine-dir", ENGINE_DIR, "--distributed",
                eval_args=True)
    assert "mode=distributed" in dist and "buckets=4 compiles=4 dispatches=4" in dist
    both("eval", "leaderboard")
    both("eval", "leaderboard", "{id}")
    listed = both("evals", "list")
    assert listed.count("EVALCOMPLETED") == 2 and listed.count("+leaderboard") == 2
    both("evals", "show", "{id}")
    both("evals", "list", "--json")
    # the two paths rank the grid alike, in both packages
    for name, lb_mod in (("jax", jax_lb), ("port", lb)):
        docs = [lb_mod.read(homes[name], iid) for iid in done[name]]
        assert len({lb.digest(d) for d in docs}) == 1
    rows = {}
    for name in ("jax", "port"):
        with sqlite3.connect(os.path.join(homes[name], "meta.db")) as c:
            found = c.execute("SELECT * FROM evaluation_instances "
                              "ORDER BY startTime").fetchall()
        rows[name] = _shape(json.dumps(found), {})
    _assert_same_shape(rows["port"], rows["jax"])


def test_evals_and_eval_leaderboard_import_no_torch(tmp_path):
    code = (
        "import sys, datetime as dt\n"
        "sys.modules['torch'] = None  # poison: any import of torch fails\n"
        "from predictionio_tpu_torch.tools import cli\n"
        "from predictionio_tpu_torch.storage.registry import get_storage\n"
        "from predictionio_tpu_torch.storage.meta import EvaluationInstance\n"
        "from predictionio_tpu_torch.storage import leaderboard as lb\n"
        "st = get_storage()\n"
        "iid = st.meta.new_instance_id()\n"
        "now = dt.datetime.now(dt.timezone.utc)\n"
        "st.meta.insert_evaluation_instance(EvaluationInstance(\n"
        "    id=iid, status='FAILED', start_time=now, end_time=now,\n"
        "    evaluation_class='my.Ev', engine_params_generator_class='my.Grid',\n"
        "    batch='', env={}, evaluator_results='ValueError: boom'))\n"
        "lb.write(st.config.home, lb.build(iid, 'M', True,\n"
        "                                  [{'algorithmsParams': []}], [0.5]))\n"
        "for argv in (['evals', 'list'], ['evals', 'show', iid, '--json'],\n"
        "             ['eval', 'leaderboard'], ['eval', 'leaderboard', iid]):\n"
        "    cli.main(argv)\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] == 'torch'\n"
        "          and sys.modules[m] is not None]\n"
        "print('TORCH_FREE', loaded)\n")
    env = dict(os.environ, PIO_HOME=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "TORCH_FREE []" in proc.stdout
    assert "ValueError: boom" in proc.stdout and "digest=" in proc.stdout


def test_eval_needs_a_card_or_device_cpu(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    st = Storage(StorageConfig(home=str(tmp_path)))
    mod = "predictionio_tpu_torch.templates.recommendation.engine"
    code, lines, err = _run(cli.main, port_registry, st,
                            ["eval", f"{mod}:RecEvaluation", f"{mod}:DefaultGrid"],
                            capsys)
    assert code == 1 and lines == [] and "no CUDA device" in err[0]
    assert st.meta.list_evaluation_instances() == []


def test_cli_eventserver_builds_the_server_from_flags(tmp_path):
    args = cli.build_parser().parse_args([
        "eventserver", "--ip", "127.0.0.1", "--port", "0", "--stats",
        "--ingest-batching", "--ingest-max-batch", "64",
        "--ingest-queue-depth", "128", "--durable-acks", "--auth-cache-ttl", "5"])
    port_registry.set_storage(Storage(StorageConfig(home=str(tmp_path))))
    try:
        srv = cli.make_event_server(args)
        plain = cli.make_event_server(cli.build_parser().parse_args(
            ["eventserver", "--auth-cache-ttl", "0"]))
    finally:
        port_registry.set_storage(None)
    assert (srv.http.host, srv.http.port) == ("127.0.0.1", 0)
    assert srv.stats is not None and srv._auth_cache.ttl == 5
    assert (srv._ingest.max_batch, srv._ingest.max_queue) == (64, 128)
    assert srv.storage.events._sync == "FULL"
    assert (plain.http.host, plain.http.port) == ("0.0.0.0", 7070)
    assert plain.stats is None and plain._ingest is None and plain._auth_cache is None
    with ServerThread(srv) as s:
        assert request(s.port, "GET", "/")[1] == {"status": "alive"}


def test_quickstart_on_the_cpu(tmp_path, capsys, monkeypatch):
    """app new → event server → HTTP posts → train → deploy → a query."""
    home = str(tmp_path)
    monkeypatch.setenv("PIO_HOME", home)
    st = Storage(StorageConfig(home=home))
    code, lines, _ = _run(cli.main, port_registry, st, ["app", "new", "MyApp1"], capsys)
    assert code == 0
    key = lines[1].split("Access Key: ")[1]
    rng = np.random.default_rng(0)
    events = [{"event": "rate", "entityType": "user", "entityId": f"u{u}",
               "targetEntityType": "item", "targetEntityId": f"i{i}",
               "properties": {"rating": float(r)},
               "eventTime": f"2026-01-01T00:{j // 60:02d}:{j % 60:02d}.000Z"}
              for j, (u, i, r) in enumerate(zip(rng.integers(0, 20, 400),
                                                rng.integers(0, 15, 400),
                                                rng.integers(1, 6, 400)))]
    port_registry.set_storage(st)
    try:
        es = cli.make_event_server(cli.build_parser().parse_args(
            ["eventserver", "--ip", "127.0.0.1", "--port", "0", "--ingest-batching"]))
    finally:
        port_registry.set_storage(None)
    with ServerThread(es) as srv:
        for e in events[:20]:
            assert request(srv.port, "POST", f"/events.json?accessKey={key}", e)[0] == 201
        for s in range(20, 400, 50):
            code, body, _ = request(srv.port, "POST",
                                    f"/batch/events.json?accessKey={key}",
                                    events[s:s + 50])
            assert code == 200 and {it["status"] for it in body} == {201}
    code, lines, err = _run(cli.main, port_registry, Storage(StorageConfig(home=home)),
                            ["train", "--engine-dir", ENGINE_DIR, "--device", "cpu"],
                            capsys)
    assert code == 0 and "Training completed" in lines[-1], err
    args = cli.build_parser().parse_args([
        "deploy", "--engine-dir", ENGINE_DIR, "--ip", "127.0.0.1", "--port", "0",
        "--device", "cpu"])
    port_registry.set_storage(Storage(StorageConfig(home=home)))
    try:
        engine = cli.make_server(args)
    finally:
        port_registry.set_storage(None)
    with ServerThread(engine) as srv:
        code, answer, _ = request(srv.port, "POST", "/queries.json",
                                  {"user": "u3", "num": 4})
    assert code == 200 and len(answer["itemScores"]) == 4
    assert all(s["item"].startswith("i") for s in answer["itemScores"])


# -- replication, the continuous trainer, daemon and failover -----------------


def test_cli_eventserver_with_a_lease_home_builds_its_repl_node(tmp_path, monkeypatch):
    """``--lease-home`` makes the server a node of the replicated event
    plane, with the JAX CLI's defaults (advertise URL from the bind
    address, a node never replicating to itself)."""
    from predictionio_tpu_torch.server.repl_server import ReplNode

    monkeypatch.setenv("PIO_HOME", str(tmp_path / "home"))
    lease = str(tmp_path / "lease")
    args = cli.build_parser().parse_args([
        "eventserver", "--ip", "0.0.0.0", "--port", "7071", "--lease-home", lease,
        "--replicate-to", "http://127.0.0.1:7072/", "--replicate-to",
        "http://127.0.0.1:7071", "--lease-ttl", "1.5", "--durable-acks"])
    port_registry.set_storage(Storage(StorageConfig(home=str(tmp_path / "home"))))
    try:
        srv = cli.make_event_server(args)
        named = cli.make_event_server(cli.build_parser().parse_args([
            "eventserver", "--port", "0", "--lease-home", lease,
            "--advertise-url", "http://node-a:9000/"]))
        plain = cli.make_event_server(cli.build_parser().parse_args(
            ["eventserver", "--port", "0"]))
    finally:
        port_registry.set_storage(None)
    node = srv.repl
    assert isinstance(node, ReplNode) and node.role == "idle"
    assert node.advertise_url == "http://127.0.0.1:7071"
    assert node.peers == ["http://127.0.0.1:7072"]
    assert node.lease_ttl == 1.5 and node.home == str(tmp_path / "home")
    assert node.lease.path == os.path.join(lease, "eventplane.lease")
    assert node.lease.owner == node.advertise_url
    assert named.repl.advertise_url == "http://node-a:9000" and named.repl.peers == []
    assert plain.repl is None
    with ServerThread(named) as s:
        status, doc, _ = request(s.port, "GET", "/repl/status")
        assert status == 200 and doc["role"] == "leader" and doc["epoch"] == 1
        # an event route is served by the leader it became at start
        assert request(s.port, "GET", "/events.json")[0] == 401


def _loop_variant(path):
    with open(path, "w") as f:
        json.dump({"id": "loop",
                   "engineFactory": "predictionio_tpu.templates.recommendation.engine:engine_factory",
                   "datasource": {"params": {"appName": APP}},
                   "algorithms": [{"name": "als", "params": {
                       "rank": 4, "numIterations": 6, "lambda": 0.05, "seed": 2}}]}, f)
    return str(path)


def test_train_continuous_matches_the_jax_cli(tmp_path, capsys):
    """``train --continuous --max-cycles 1`` on twin homes: the same lines
    and exit code, the same ``trainer.state.json`` and registry manifest
    (ids and digests normalised); the port trains on ``--device cpu``."""
    import signal

    homes = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    _seed(JaxStorage(JaxStorageConfig(home=homes["jax"])), JaxEvent)
    _seed(Storage(StorageConfig(home=homes["port"])), Event)
    variant = _loop_variant(tmp_path / "variant.json")
    base = ["train", "--continuous", "--max-cycles", "1", "--no-mesh", "--engine-dir",
            ENGINE_DIR, "-e", variant, "--no-incidents", "--poll-interval", "0.2"]
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    out = {}
    try:
        for name, main, registry, storage, config, extra in (
                ("jax", jax_cli.main, jax_registry, JaxStorage, JaxStorageConfig, []),
                ("port", cli.main, port_registry, Storage, StorageConfig,
                 ["--device", "cpu"])):
            code, lines, err = _run(main, registry, storage(config(home=homes[name])),
                                    base + extra, capsys)
            out[name] = (code, [ln.replace(homes[name], "{home}") for ln in lines])
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)
    assert out["port"] == out["jax"]
    assert out["port"] == (0, [
        f"[info] Continuous trainer: app={APP!r} min_delta=1 lease={{home}}/trainer.lease",
        "[train] promoted gen=1", "[info] Continuous trainer stopped after 1 cycles."])
    # the same count; each watermark is its home's newest creation time
    # (the seeded events carry the wall clock's)
    for name, storage, config in (("jax", JaxStorage, JaxStorageConfig),
                                  ("port", Storage, StorageConfig)):
        st = storage(config(home=homes[name]))
        count, max_us = st.events.creation_stats(st.meta.get_app_by_name(APP).id, None)
        state = json.load(open(os.path.join(homes[name], "trainer.state.json")))
        assert state == {"count": count, "watermark_us": max_us} and count == 492

    def registry_doc(home):
        doc = json.load(open(os.path.join(home, "model_registry", "registry.json")))
        for e in doc["generations"]:
            e.update(instance_id="<id>", sha256="<sha>", created_us=0, promoted_us=0)
        return doc

    assert registry_doc(homes["jax"]) == registry_doc(homes["port"])
    assert registry_doc(homes["port"])["champion"] == 1


def test_train_read_from_follower_matches_the_jax_cli(tmp_path, capsys, monkeypatch):
    """``--read-from follower`` repoints the storage home at the replica
    (the instance lands there); without a replica both CLIs refuse."""
    variant = _loop_variant(tmp_path / "variant.json")
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE", "EL")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_EL_TYPE", "EVENTLOG")
    out = {}
    for name, main, registry, storage, config, extra in (
            ("jax", jax_cli.main, jax_registry, JaxStorage, JaxStorageConfig, []),
            ("port", cli.main, port_registry, Storage, StorageConfig,
             ["--device", "cpu"])):
        leader = str(tmp_path / name / "leader")
        replica = str(tmp_path / name / "replica")
        os.makedirs(leader)
        monkeypatch.setenv("PIO_HOME", replica)
        _seed(storage(config.from_env()), JaxEvent if name == "jax" else Event)
        monkeypatch.setenv("PIO_HOME", leader)
        registry.set_storage(None)
        argv = ["train", "--engine-dir", ENGINE_DIR, "-e", variant, "--no-mesh",
                "--read-from", "follower", "--replica-home", replica] + extra
        try:
            main(argv)
        finally:
            registry.set_storage(None)
        lines = capsys.readouterr().out.splitlines()
        assert os.environ["PIO_HOME"] == replica
        instances = storage(config.from_env()).meta.get_latest_completed_engine_instance(
            "predictionio_tpu.templates.recommendation.engine:engine_factory", "loop")
        assert instances is not None
        assert not os.path.exists(os.path.join(leader, "meta.db"))
        out[name] = lines[0].replace(replica, "{replica}")
        monkeypatch.setenv("PIO_HOME", leader)
        with pytest.raises(ValueError) as e:
            main(["train", "--engine-dir", ENGINE_DIR, "-e", variant, "--read-from",
                  "follower", "--replica-home", str(tmp_path / "none")] + extra)
        out[name + "-refused"] = str(e.value)
    assert out["port"] == out["jax"] == "[info] Training reads from follower home: {replica}"
    assert out["port-refused"] == out["jax-refused"]


def _daemon_lines(lines):
    return [re.sub(r"pid \d+", "pid N", ln) for ln in lines]


def test_daemon_verb_matches_the_jax_cli(tmp_path, capsys):
    """``daemon`` runs a clean child once (exit 0), gives up on a
    crashing one past ``--max-restarts`` (exit 1) and refuses an empty
    command, with the JAX CLI's lines and exit codes."""
    ok = [sys.executable, "-S", "-c", "print('child ran', flush=True)"]
    crash = [sys.executable, "-S", "-c", "raise SystemExit(4)"]
    out = {}
    for name, main, registry, storage, config in (
            ("jax", jax_cli.main, jax_registry, JaxStorage, JaxStorageConfig),
            ("port", cli.main, port_registry, Storage, StorageConfig)):
        st = storage(config(home=str(tmp_path / name)))
        runs = []
        for argv in (["daemon", "--"] + ok,
                     ["daemon", "--max-restarts", "0", "--"] + crash,
                     ["daemon", "--"]):
            code, lines, err = _run(main, registry, st, argv, capsys)
            runs.append((code, _daemon_lines(lines), err))
        out[name] = runs
    assert out["port"] == out["jax"]
    assert [r[0] for r in out["port"]] == [0, 1, 1]
    assert out["port"][0][1][-1] == "[supervise] child exited cleanly; done"
    assert out["port"][2][2] == ["[error] pio daemon: no command given"]


def test_daemon_supervises_the_port_trainer(tmp_path):
    """``daemon -- train --continuous`` in a process of its own: the
    supervised child is the port's CLI, trains on the CPU, promotes and
    exits cleanly, which ends the daemon with 0."""
    home = str(tmp_path / "home")
    _seed(Storage(StorageConfig(home=home)), Event)
    variant = _loop_variant(tmp_path / "variant.json")
    env = {**os.environ, "PIO_HOME": home, "PYTHONPATH": REPO}
    proc = subprocess.run(
        [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", "daemon", "--",
         "train", "--continuous", "--max-cycles", "1", "--engine-dir", ENGINE_DIR,
         "-e", variant, "--device", "cpu", "--no-incidents"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert f"-m predictionio_tpu_torch.tools.cli train --continuous" in proc.stdout
    assert "[train] promoted gen=1" in proc.stdout
    assert proc.stdout.rstrip().endswith("[supervise] child exited cleanly; done")
    doc = json.load(open(os.path.join(home, "model_registry", "registry.json")))
    assert doc["champion"] == 1


def test_failover_verb_matches_the_jax_cli(tmp_path, capsys):
    """``failover --target`` against a live node of each package: a
    leader answers its status (exit 0); a follower whose leader's lease is
    live refuses with 409 in both; no flag is an error in both."""
    import urllib.error

    from predictionio_tpu.server.event_server import EventServer as JaxEventServer
    from predictionio_tpu.server.repl_server import ReplNode as JaxReplNode
    from predictionio_tpu_torch.server.event_server import EventServer
    from predictionio_tpu_torch.server.repl_server import ReplNode

    out = {}
    for name, main, server_cls, node_cls, storage, config in (
            ("jax", jax_cli.main, JaxEventServer, JaxReplNode, JaxStorage,
             JaxStorageConfig),
            ("port", cli.main, EventServer, ReplNode, Storage, StorageConfig)):
        lease = str(tmp_path / name / "lease")
        servers = []
        for k, role in enumerate(("a", "b")):
            home = str(tmp_path / name / role)
            node = node_cls(lease_home=lease, advertise_url=f"http://127.0.0.1:{k + 1}",
                            home=home, lease_ttl=30.0)
            servers.append(server_cls(storage=storage(config(home=home)),
                                      host="127.0.0.1", port=0, replication=node,
                                      incident_dir=None))
        with ServerThread(servers[0]) as a:
            servers[0].repl.advertise_url = f"http://127.0.0.1:{a.port}"
            with ServerThread(servers[1]) as b:
                code, lines, err = _run(main, port_registry if name == "port"
                                        else jax_registry, None,
                                        ["failover", "--target",
                                         f"http://127.0.0.1:{a.port}"], capsys)
                doc = json.loads(lines[0])
                summary = (code, doc["role"], doc["epoch"], sorted(doc))
                with pytest.raises(urllib.error.HTTPError) as e:
                    main(["failover", "--target", f"http://127.0.0.1:{b.port}",
                          "--timeout", "5"])
                refused = e.value.code
        code2, _, err2 = _run(main, jax_registry if name == "jax" else port_registry,
                              None, ["failover"], capsys)
        out[name] = (summary, refused, code2, err2)
    assert out["port"] == out["jax"]
    assert out["port"][0][:3] == (0, "leader", 1) and out["port"][1] == 409
    assert out["port"][3] == ["[error] pio failover needs --drill or --target URL"]
