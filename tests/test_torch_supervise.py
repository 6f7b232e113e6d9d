"""The port's process supervisor held against the JAX package's, on the
CPU: crash restart with backoff and budget, health-check restarts, the
clean exit as a finished job, the pidfile, the restart and backoff
series (each case on both packages); ``normalize_command`` routing bare
verbs through the port's CLI; ``ReplicaPool``'s health-gated add,
manifest and refused last removal; and the bind retry of the port's event
server.
"""

import socket
import sys
import threading
import time
import urllib.request

import pytest

from predictionio_tpu.tools import supervise as jax_supervise
from predictionio_tpu_torch.tools import supervise as port_supervise

PKG = {"jax": jax_supervise, "port": port_supervise}
BOTH = pytest.mark.parametrize("pkg", ["jax", "port"])


def _run_in_thread(sup):
    out = {}

    def run():
        out["code"] = sup.run()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, out


@BOTH
def test_crash_restart_with_budget(tmp_path, pkg):
    marker = tmp_path / "starts.txt"
    sup = PKG[pkg].Supervisor(
        [sys.executable, "-S", "-c",
         f"open(r'{marker}', 'a').write('x'); raise SystemExit(3)"],
        max_restarts=3, restart_window=60.0, backoff=0.05, backoff_max=0.05,
        log=lambda *a: None)
    t, out = _run_in_thread(sup)
    t.join(timeout=30)
    assert not t.is_alive()
    assert out["code"] == 1
    assert marker.read_text().count("x") == 4
    assert sup.restarts == 3


@BOTH
def test_clean_stop_returns_zero(pkg):
    sup = PKG[pkg].Supervisor([sys.executable, "-S", "-c", "import time; time.sleep(60)"],
                              backoff=0.05, log=lambda *a: None)
    t, out = _run_in_thread(sup)
    time.sleep(0.8)
    sup.stop()
    t.join(timeout=15)
    assert not t.is_alive()
    assert out["code"] == 0
    assert sup._child.poll() is not None


@BOTH
def test_health_check_restarts_wedged_child(tmp_path, pkg):
    marker = tmp_path / "starts.txt"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead_port = s.getsockname()[1]
    sup = PKG[pkg].Supervisor(
        [sys.executable, "-S", "-c",
         f"open(r'{marker}', 'a').write('x');" "import time; time.sleep(60)"],
        health_url=f"http://127.0.0.1:{dead_port}/", health_interval=0.2,
        health_timeout=0.5, health_grace=1.0, max_restarts=50, backoff=0.05,
        backoff_max=0.05, log=lambda *a: None)
    t, out = _run_in_thread(sup)
    deadline = time.time() + 20
    while time.time() < deadline and sup.restarts < 2:
        time.sleep(0.1)
    sup.stop()
    t.join(timeout=15)
    assert sup.restarts >= 2
    assert marker.read_text().count("x") >= 2


@BOTH
def test_clean_exit_is_not_a_crash(tmp_path, pkg):
    marker = tmp_path / "starts.txt"
    sup = PKG[pkg].Supervisor(
        [sys.executable, "-S", "-c", f"open(r'{marker}', 'a').write('x')"],
        max_restarts=3, backoff=0.05, backoff_max=0.05, log=lambda *a: None)
    t, out = _run_in_thread(sup)
    t.join(timeout=30)
    assert not t.is_alive()
    assert out["code"] == 0 and sup.restarts == 0
    assert marker.read_text() == "x"


@BOTH
def test_pidfile_lifecycle(tmp_path, pkg):
    pidfile = tmp_path / "sup.pid"
    sup = PKG[pkg].Supervisor([sys.executable, "-S", "-c", "import time; time.sleep(60)"],
                              pidfile=str(pidfile), backoff=0.05, log=lambda *a: None)
    t, out = _run_in_thread(sup)
    deadline = time.time() + 10
    while time.time() < deadline and not pidfile.exists():
        time.sleep(0.05)
    assert pidfile.exists()
    sup.stop()
    t.join(timeout=15)
    assert not pidfile.exists()


@BOTH
def test_crash_restarts_counted_by_reason(pkg):
    mod = PKG[pkg]
    sup = mod.Supervisor([sys.executable, "-S", "-c", "raise SystemExit(3)"],
                         name="metrics-crash", max_restarts=2, restart_window=60.0,
                         backoff=0.05, backoff_max=0.05, log=lambda *a: None)
    before = mod._M_RESTARTS.get(("metrics-crash", "crash"))
    t, out = _run_in_thread(sup)
    t.join(timeout=30)
    assert out["code"] == 1
    assert mod._M_RESTARTS.get(("metrics-crash", "crash")) - before == 2
    assert mod._M_BACKOFF.get(("metrics-crash",)) == 0.0


@BOTH
def test_operator_restart_reason(pkg):
    mod = PKG[pkg]
    sup = mod.Supervisor([sys.executable, "-S", "-c", "import time; time.sleep(60)"],
                         name="metrics-op", max_restarts=5, backoff=0.05,
                         backoff_max=0.05, log=lambda *a: None)
    before = mod._M_RESTARTS.get(("metrics-op", "operator"))
    t, out = _run_in_thread(sup)
    deadline = time.time() + 10
    while time.time() < deadline and sup.child_pid() is None:
        time.sleep(0.05)
    pid = sup.child_pid()
    sup.request_restart()
    deadline = time.time() + 15
    while time.time() < deadline and sup.child_pid() in (None, pid):
        time.sleep(0.05)
    assert sup.child_pid() not in (None, pid)
    assert mod._M_RESTARTS.get(("metrics-op", "operator")) - before == 1
    assert sup._restart_times == [] and sup.last_backoff == 0.0
    sup.stop()
    t.join(timeout=15)


# -- normalize_command: everything supervised runs the port --------------------


@pytest.mark.parametrize("command,want", [
    (["--", "eventserver", "--port", "7070"],
     [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", "eventserver",
      "--port", "7070"]),
    (["train", "--continuous", "--device", "cpu"],
     [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", "train",
      "--continuous", "--device", "cpu"]),
    (["/usr/bin/python3", "server.py"], ["/usr/bin/python3", "server.py"]),
    ([sys.executable, "tool.py", "--", "-x"], [sys.executable, "tool.py", "--", "-x"]),
    (["--"], []),
])
def test_normalize_command_routes_bare_verbs_through_the_port_cli(command, want):
    assert port_supervise.normalize_command(command) == want
    jax_cmd = jax_supervise.normalize_command(command)
    assert [a.replace("predictionio_tpu.tools", "predictionio_tpu_torch.tools")
            for a in jax_cmd] == want


def test_daemon_verb_spawns_the_port_cli(monkeypatch):
    """``daemon -- train ...`` hands the Supervisor the port's CLI (argv
    read before any process starts)."""
    from predictionio_tpu_torch.tools import cli

    seen = {}

    class _Sup:
        def __init__(self, argv, **kw):
            seen["argv"], seen["kw"] = argv, kw

        def run(self):
            return 0

    monkeypatch.setattr(port_supervise, "Supervisor", _Sup)
    with pytest.raises(SystemExit) as e:
        cli.main(["daemon", "--max-restarts", "4", "--term-grace", "3", "--",
                  "train", "--continuous", "--device", "cpu"])
    assert e.value.code == 0
    assert seen["argv"] == [sys.executable, "-m", "predictionio_tpu_torch.tools.cli",
                            "train", "--continuous", "--device", "cpu"]
    assert seen["kw"]["max_restarts"] == 4 and seen["kw"]["term_grace"] == 3.0


# -- ReplicaPool ---------------------------------------------------------------

HEALTH = ("import http.server, sys\n"
          "class H(http.server.BaseHTTPRequestHandler):\n"
          "    def do_GET(self):\n"
          "        self.send_response(200); self.end_headers(); self.wfile.write(b'ok')\n"
          "    def log_message(self, *a): pass\n"
          "http.server.HTTPServer(('127.0.0.1', int(sys.argv[1])), H).serve_forever()\n")


@BOTH
def test_replica_pool_add_remove_and_manifest(tmp_path, pkg):
    mod = PKG[pkg]
    manifest = tmp_path / "fleet.txt"
    pool = mod.ReplicaPool([sys.executable, "-S", "-c", HEALTH, "{port}"],
                           str(manifest), ready_timeout=30.0, drain_grace=0.05,
                           health_grace=30.0, log=lambda *a: None)
    try:
        a = pool.add_replica()
        b = pool.add_replica()
        assert pool.size() == 2 and pool.names() == sorted([a, b])
        lines = manifest.read_text().splitlines()
        assert lines[0].startswith("#") and sorted(lines[1:]) == sorted(
            f"http://{n}" for n in (a, b))
        with urllib.request.urlopen(f"http://{a}/health", timeout=5) as r:
            assert r.status == 200
        assert {s["name"] for s in pool.snapshot()} == {a, b}
        removed = pool.remove_replica()
        assert pool.size() == 1 and removed in (a, b)
        with pytest.raises(mod.PoolError):
            pool.remove_replica()
        with pytest.raises(mod.PoolError):
            pool.restart_replica("nope:1")
    finally:
        pool.stop_all()
    assert pool.size() == 0
    assert manifest.read_text().splitlines()[1:] == []


def test_free_port_is_bindable():
    port = port_supervise.free_port()
    with socket.socket() as s:
        s.bind(("127.0.0.1", port))


# -- the port's event server retries a busy port -------------------------------


@pytest.fixture()
def port_storage(tmp_path):
    from predictionio_tpu_torch.storage.registry import Storage, StorageConfig

    return Storage(StorageConfig(home=str(tmp_path)))


def test_event_server_retries_port_in_use(port_storage):
    import asyncio

    from predictionio_tpu_torch.server.event_server import EventServer

    blocker = socket.socket()
    blocker.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    blocker.bind(("127.0.0.1", 0))
    port = blocker.getsockname()[1]
    blocker.listen(1)
    server = EventServer(storage=port_storage, host="127.0.0.1", port=port,
                         bind_retries=20, bind_retry_sec=0.1, incident_dir=None)
    loop = asyncio.new_event_loop()

    def run():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(server.http.serve_forever())

    t = threading.Thread(target=run, daemon=True)
    t.start()
    time.sleep(0.5)
    blocker.close()
    deadline = time.time() + 10
    ok = False
    while time.time() < deadline:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=1) as r:
                ok = r.status == 200
                break
        except Exception:
            time.sleep(0.1)
    assert ok, "server never bound after the port freed up"
    loop.call_soon_threadsafe(server.http.request_shutdown)
    t.join(timeout=10)
    assert not t.is_alive()


def test_event_server_without_retry_raises_at_once(port_storage):
    import asyncio

    from predictionio_tpu_torch.server.event_server import EventServer

    blocker = socket.socket()
    blocker.bind(("127.0.0.1", 0))
    port = blocker.getsockname()[1]
    blocker.listen(1)
    try:
        server = EventServer(storage=port_storage, host="127.0.0.1", port=port,
                             bind_retries=0, incident_dir=None)
        with pytest.raises(OSError):
            asyncio.new_event_loop().run_until_complete(server.http.start())
    finally:
        blocker.close()

