"""The port's replicated event plane held against the JAX package's, on the
CPU.

- Every case of ``tests/test_replication.py`` runs on both packages: WAL
  shipping across a rollover (byte-identical follower, cursor at the new
  active head, fsck-clean copies, the leader's digests in the follower's
  manifest), a tombstone on the stream, stale epochs refused without
  touching disk, a fenced leader's local appends refused, the
  ``replication.leader.partition``, ``replication.wal.torn`` and
  ``replication.follower.lag`` sites, the resend from the follower's
  cursor after a gap, the sink following a follower's 307 and bounding a
  redirect loop, ``ship --verify`` refusing a lying cold tier,
  ``select_read_home`` and fsck's replica-cursor check.
- Across packages: a JAX ``Replicator`` feeding a port ``ReplicaHome``
  and a port ``Replicator`` feeding a JAX ``ReplicaHome``, across a
  rollover and a tombstone, over twin leader logs written with the same
  ids and times: each follower equals its leader file by file (sha256),
  and the two runs have equal follower files, equal
  ``replica_state.json`` and equal WAL batch headers.
- A JAX event server leading a port follower over HTTP (one lease home,
  one access key provisioned on both homes): writes sent to the follower
  are redirected to the leader, and the follower's event log equals the
  leader's by sha256.
- The port's ``run_failover_drill`` at about 60 events, ``ok`` with the
  JAX drill's proof keys, its event servers spawned through the port's
  CLI; and ``check_replica_state`` of both packages on the same homes.
"""

import dataclasses
import hashlib
import http.server
import json
import os
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

from predictionio_tpu.data import pel_integrity as jax_pel
from predictionio_tpu.data import replication as jax_repl
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.filestore import NativeEventLogStore as JaxLog
from predictionio_tpu.server import eventsink as jax_sink
from predictionio_tpu.server import repl_server as jax_repl_server
from predictionio_tpu.utils import faults as jax_faults
from predictionio_tpu.utils.integrity import IntegrityError as JaxIntegrityError
from predictionio_tpu_torch.data import pel_integrity as port_pel
from predictionio_tpu_torch.data import replication as port_repl
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.filestore import NativeEventLogStore as PortLog
from predictionio_tpu_torch.server import eventsink as port_sink
from predictionio_tpu_torch.server import repl_server as port_repl_server
from predictionio_tpu_torch.utils import faults as port_faults
from predictionio_tpu_torch.utils.integrity import IntegrityError
from tests.test_torch_eventlog import T0

APP = 1

PKG = {
    "jax": types.SimpleNamespace(
        repl=jax_repl, log=JaxLog, Event=JaxEvent, faults=jax_faults,
        pel=jax_pel, server=jax_repl_server, sink=jax_sink,
        IntegrityError=JaxIntegrityError),
    "port": types.SimpleNamespace(
        repl=port_repl, log=PortLog, Event=Event, faults=port_faults,
        pel=port_pel, server=port_repl_server, sink=port_sink,
        IntegrityError=IntegrityError),
}
BOTH = pytest.mark.parametrize("pkg", ["jax", "port"])


@pytest.fixture(autouse=True)
def _disarm_faults():
    yield
    jax_faults.FAULTS.disarm()
    port_faults.FAULTS.disarm()


def _store(p, directory, seg_bytes=None):
    s = p.log(str(directory))
    if seg_bytes is not None:
        s.segment_bytes = seg_bytes
    return s


def _events(p, n, start=0, fixed=False):
    """``n`` rate events; with ``fixed``, ids and times of their own (so
    that twin logs of the two packages are byte-equal)."""
    import datetime as dt

    extra = lambda i: (dict(  # noqa: E731
        event_id=f"ev{i:05d}", event_time=T0 + dt.timedelta(seconds=i),
        creation_time=T0 + dt.timedelta(days=1, seconds=i)) if fixed else {})
    return [p.Event(event="rate", entity_type="user",
                    entity_id=f"u{start + i}",
                    target_entity_type="item", target_entity_id="i1",
                    properties={"n": start + i}, **extra(start + i))
            for i in range(n)]


def _link(p, replica, name="local"):
    return p.repl.FollowerLink(name, apply_fn=replica.apply_wal,
                               seal_fn=replica.apply_seal,
                               status_fn=replica.status)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _digests(directory):
    """{relative path: sha256} of every file under ``directory``."""
    out = {}
    for root, _dirs, files in os.walk(directory):
        for name in files:
            path = os.path.join(root, name)
            out[os.path.relpath(path, directory)] = hashlib.sha256(
                _read(path)).hexdigest()
    return out


# -- every case of tests/test_replication.py, on both packages -----------------


@BOTH
def test_wal_tail_across_rollover_no_dup_no_gap(tmp_path, pkg):
    p = PKG[pkg]
    st = _store(p, tmp_path / "leader", seg_bytes=4096)
    replica = p.repl.ReplicaHome(str(tmp_path / "replica"))
    st.set_replicator(p.repl.Replicator([_link(p, replica)], epoch=lambda: 1))
    for lo in range(0, 600, 50):
        st.insert_batch(_events(p, 50, start=lo), APP)
    st.insert_batch(_events(p, 3, start=600), APP)
    ns = st._ns(APP, None)
    assert ns.sealed
    for seg in ns.sealed:
        assert _read(os.path.join(replica.seg_dir("events_1"), seg.meta.file)) \
            == _read(ns.seg_path(seg))
    leader_active = _read(ns.base_path)
    assert _read(replica.active_path("events_1")) == leader_active
    assert replica.cursor("events_1") == (ns.next_id, len(leader_active))
    r = p.pel.scan_pel(replica.active_path("events_1"))
    assert r["status"] == "ok"
    total = r["records"]
    for seg in ns.sealed:
        r = p.pel.scan_pel(os.path.join(replica.seg_dir("events_1"), seg.meta.file))
        assert r["status"] == "ok"
        total += r["records"]
    assert total == 603
    doc = json.load(open(replica.manifest_path("events_1")))
    assert {row["sha256"] for row in doc["segments"]} == {
        seg.meta.sha256 for seg in ns.sealed}


@BOTH
def test_delete_tombstone_rides_the_wal_stream(tmp_path, pkg):
    p = PKG[pkg]
    st = _store(p, tmp_path / "leader")
    replica = p.repl.ReplicaHome(str(tmp_path / "replica"))
    st.set_replicator(p.repl.Replicator([_link(p, replica)], epoch=lambda: 1))
    ids = st.insert_batch(_events(p, 5), APP)
    assert st.delete(ids[2], APP)
    assert _read(replica.active_path("events_1")) == _read(st._ns(APP, None).base_path)


@BOTH
def test_stale_epoch_refused_without_touching_disk(tmp_path, pkg):
    p = PKG[pkg]
    replica = p.repl.ReplicaHome(str(tmp_path / "replica"))
    magic = p.pel.PEL_MAGIC
    replica.apply_wal(p.repl.WalBatch.build("events_1", 0, 0, magic, epoch=7))
    size_before = os.path.getsize(replica.active_path("events_1"))
    with pytest.raises(p.repl.StaleEpochError):
        replica.apply_wal(p.repl.WalBatch.build("events_1", 0, len(magic),
                                                b"late-write", epoch=6))
    assert os.path.getsize(replica.active_path("events_1")) == size_before
    assert replica.cursor("events_1") == (0, len(magic))
    replica.apply_wal(p.repl.WalBatch.build("events_1", 0, len(magic), b"x", epoch=9))
    assert replica.epoch == 9
    with pytest.raises(p.repl.StaleEpochError):
        replica.apply_seal("events_1", {"id": 0, "file": "whatever.pel",
                                        "state": "sealed", "records": 0,
                                        "bytes": 0, "sha256": None}, epoch=8)


@BOTH
def test_fenced_leader_cannot_append_locally(tmp_path, pkg):
    p = PKG[pkg]
    st = _store(p, tmp_path / "leader")
    st.insert_batch(_events(p, 2), APP)
    fenced = {"v": False}
    st.set_replicator(p.repl.Replicator([], epoch=lambda: 3,
                                        fenced=lambda: fenced["v"]))
    st.insert_batch(_events(p, 1, start=10), APP)
    fenced["v"] = True
    ns = st._ns(APP, None)
    size_before = os.path.getsize(ns.base_path)
    with pytest.raises(p.repl.FencedWriteError):
        st.insert_batch(_events(p, 1, start=11), APP)
    with pytest.raises(p.repl.FencedWriteError):
        st.delete("nonexistent", APP)
    assert os.path.getsize(ns.base_path) == size_before


@BOTH
def test_leader_partition_fault_demotes_and_fences(tmp_path, pkg):
    p = PKG[pkg]
    node = p.server.ReplNode(lease_home=str(tmp_path / "lease"),
                             advertise_url="http://127.0.0.1:1",
                             home=str(tmp_path / "home"), lease_ttl=0.09)
    p.faults.FAULTS.arm("replication.leader.partition", error="partitioned")
    try:
        node.start()
        assert node.role == "leader"
        deadline = time.monotonic() + 5.0
        while node.role != "fenced" and time.monotonic() < deadline:
            time.sleep(0.01)
        assert node.role == "fenced"

        class _Req:
            path = "/events.json"
            query = {}
        deny = node.gate(_Req())
        assert deny is not None and deny.status == 503
    finally:
        p.faults.FAULTS.disarm()
        node.stop()


@BOTH
def test_torn_wal_batch_refused_and_log_untouched(tmp_path, pkg):
    p = PKG[pkg]
    magic = p.pel.PEL_MAGIC
    replica = p.repl.ReplicaHome(str(tmp_path / "replica"))
    replica.apply_wal(p.repl.WalBatch.build("events_1", 0, 0, magic, epoch=1))
    p.faults.FAULTS.arm("replication.wal.torn")
    with pytest.raises(p.repl.WalTornError):
        replica.apply_wal(p.repl.WalBatch.build(
            "events_1", 0, len(magic), b"payload-bytes", epoch=1))
    p.faults.FAULTS.disarm()
    assert replica.cursor("events_1") == (0, len(magic))
    assert os.path.getsize(replica.active_path("events_1")) == len(magic)
    replica.apply_wal(p.repl.WalBatch.build("events_1", 0, len(magic),
                                            b"payload-bytes", epoch=1))


@BOTH
def test_follower_lag_fault_degrades_never_blocks(tmp_path, pkg):
    p = PKG[pkg]
    st = _store(p, tmp_path / "leader")
    replica = p.repl.ReplicaHome(str(tmp_path / "replica"))
    link = _link(p, replica)
    st.set_replicator(p.repl.Replicator([link], epoch=lambda: 1))
    st.insert_batch(_events(p, 3), APP)
    assert link.healthy
    p.faults.FAULTS.arm("replication.follower.lag", error="follower down")
    ids = st.insert_batch(_events(p, 3, start=10), APP)
    assert len(ids) == 3
    assert not link.healthy
    assert "follower down" in (link.last_error or "")


@BOTH
def test_wal_gap_resends_from_follower_cursor(tmp_path, pkg):
    p = PKG[pkg]
    st = _store(p, tmp_path / "leader")
    replica = p.repl.ReplicaHome(str(tmp_path / "replica"))
    st.set_replicator(p.repl.Replicator([_link(p, replica)], epoch=lambda: 1))
    st.insert_batch(_events(p, 4), APP)
    link2 = _link(p, replica, name="after-restart")
    st.set_replicator(p.repl.Replicator([link2], epoch=lambda: 2))
    st.insert_batch(_events(p, 4, start=4), APP)
    assert link2.healthy
    assert _read(replica.active_path("events_1")) == _read(st._ns(APP, None).base_path)


class _Redirector(http.server.BaseHTTPRequestHandler):
    leader_url = ""

    def do_POST(self):                                 # noqa: N802
        self.send_response(307)
        self.send_header("Location", self.leader_url + self.path)
        self.send_header("Retry-After", "0")
        self.end_headers()

    def log_message(self, *a):
        pass


class _Leader(http.server.BaseHTTPRequestHandler):
    def do_POST(self):                                 # noqa: N802
        self.rfile.read(int(self.headers.get("Content-Length", 0)))
        body = json.dumps({"eventId": "ev-307-followed"}).encode()
        self.send_response(201)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


def _serve(handler):
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@BOTH
def test_eventsink_follows_follower_307_to_leader(pkg):
    p = PKG[pkg]
    leader_srv, leader_url = _serve(_Leader)
    redirector = type("_R", (_Redirector,), {"leader_url": leader_url})
    follower_srv, follower_url = _serve(redirector)
    try:
        sink = p.sink.HTTPEventSink(follower_url, "k", retries=0)
        eid = sink.send(p.Event(event="e", entity_type="u", entity_id="1"))
        assert eid == "ev-307-followed"
    finally:
        leader_srv.shutdown()
        follower_srv.shutdown()


@BOTH
def test_eventsink_redirect_loop_is_bounded(pkg):
    p = PKG[pkg]

    class _Loop(_Redirector):
        pass

    srv, url = _serve(_Loop)
    _Loop.leader_url = url
    try:
        sink = p.sink.HTTPEventSink(url, "k", retries=0)
        with pytest.raises(RuntimeError, match="redirect not followable"):
            sink.send(p.Event(event="e", entity_type="u", entity_id="1"))
    finally:
        srv.shutdown()


class _LyingTier:
    def __init__(self, lie=True):
        self.blobs = {}
        self.lie = lie
        self.deleted = []

    def put(self, key, blob):
        self.blobs[key] = blob

    def get(self, key):
        blob = self.blobs.get(key)
        if blob is None:
            return None
        return blob[:-1] + b"\x00" if self.lie else blob

    def delete(self, key):
        self.deleted.append(key)
        self.blobs.pop(key, None)


@BOTH
def test_ship_verify_refuses_mismatched_cold_copy(tmp_path, pkg):
    p = PKG[pkg]
    st = _store(p, tmp_path / "log", seg_bytes=2048)
    for lo in range(0, 300, 50):
        st.insert_batch(_events(p, 50, start=lo), APP)
    ns = st._ns(APP, None)
    assert ns.sealed
    seg = ns.sealed[0]
    tier = _LyingTier(lie=True)
    with pytest.raises(p.IntegrityError, match="read-back"):
        ns.ship(seg, tier=tier, verify=True)
    assert os.path.exists(ns.seg_path(seg))
    assert seg.meta.state == "sealed"
    assert tier.deleted
    tier.lie = False
    assert ns.ship(seg, tier=tier, verify=True)
    assert seg.meta.state == "cold"
    assert not os.path.exists(ns.seg_path(seg))


@BOTH
def test_select_read_home(tmp_path, monkeypatch, pkg):
    select = PKG[pkg].repl.select_read_home
    leader = str(tmp_path / "leader")
    replica = str(tmp_path / "replica")
    os.makedirs(os.path.join(replica, "eventlog"))
    monkeypatch.delenv("PIO_REPL_REPLICA_HOME", raising=False)
    assert select("leader", leader, replica) == leader
    assert select("follower", leader, replica) == replica
    assert select("any", leader, replica) == replica
    assert select("any", leader, None) == leader
    monkeypatch.setenv("PIO_REPL_REPLICA_HOME", replica)
    assert select("follower", leader, None) == replica
    with pytest.raises(ValueError):
        select("follower", leader, str(tmp_path / "missing"))
    with pytest.raises(ValueError):
        select("nearest", leader, replica)


@BOTH
def test_fsck_flags_replica_cursor_past_eof(tmp_path, pkg):
    p = PKG[pkg]
    home = str(tmp_path / "home")
    replica = p.repl.ReplicaHome(home)
    replica.apply_wal(p.repl.WalBatch.build("events_1", 0, 0, p.pel.PEL_MAGIC, epoch=1))
    assert p.pel.fsck_home(home)["corrupt"] == 0
    doc = json.load(open(replica.state_path))
    doc["cursors"]["events_1"]["offset"] = 10_000
    with open(replica.state_path, "w") as f:
        json.dump(doc, f)
    rep = p.pel.fsck_home(home)
    assert rep["corrupt"] == 1
    bad = [a for a in rep["artifacts"] if a["artifact"] == "replica"]
    assert bad and "cursor" in bad[0]["errors"][0]


def test_count_frames_and_batch_headers_match(tmp_path):
    """``count_frames`` and ``WalBatch.build`` give the JAX package's
    numbers on the same bytes (a whole file, a cut mid-frame, a tail)."""
    st = _store(PKG["port"], tmp_path / "log")
    st.insert_batch(_events(PKG["port"], 40), APP)
    blob = _read(st._ns(APP, None).base_path)
    for payload, start in ((blob, True), (blob[:len(blob) // 2], True),
                           (blob[8:], False), (b"", False)):
        assert port_repl.count_frames(payload, start) == jax_repl.count_frames(payload, start)
        off = 0 if start else 8
        a = dataclasses.asdict(port_repl.WalBatch.build("events_1", 2, off, payload, 5))
        b = dataclasses.asdict(jax_repl.WalBatch.build("events_1", 2, off, payload, 5))
        assert a == b


# -- across packages -----------------------------------------------------------


def _cross_run(tmp_path, leader_pkg, follower_pkg):
    """A ``leader_pkg`` store with its Replicator feeding a
    ``follower_pkg`` ReplicaHome through a rollover and a tombstone; the
    batches are rebuilt as the follower package's ``WalBatch`` (the wire
    carries only their fields). Returns the two directories and every
    batch header."""
    lp, fp = PKG[leader_pkg], PKG[follower_pkg]
    leader_dir = tmp_path / f"{leader_pkg}_leader"
    replica = fp.repl.ReplicaHome(str(tmp_path / f"{follower_pkg}_replica"))
    headers = []

    def apply(batch):
        fields = dataclasses.asdict(batch)
        headers.append({k: v for k, v in fields.items() if k != "payload"})
        return replica.apply_wal(fp.repl.WalBatch(**fields))

    def seal(tag, meta, epoch):
        headers.append({"seal": tag, "meta": dict(meta), "epoch": epoch})
        return replica.apply_seal(tag, meta, epoch)

    link = lp.repl.FollowerLink("x", apply_fn=apply, seal_fn=seal,
                                status_fn=replica.status)
    st = _store(lp, leader_dir, seg_bytes=4096)
    st.set_replicator(lp.repl.Replicator([link], epoch=lambda: 3))
    for lo in range(0, 400, 40):
        st.insert_batch(_events(lp, 40, start=lo, fixed=True), APP)
    assert st.delete("ev00007", APP)        # a tombstone into a sealed segment
    assert st.delete("ev00395", APP)        # and one into the active file
    st.insert_batch(_events(lp, 5, start=400, fixed=True), APP)
    assert link.healthy and st._ns(APP, None).sealed
    st.close()
    # the tombstone re-sealed a segment the stream had shipped: the
    # follower's catch-up fetches it against the leader's manifest
    seg_dir = leader_dir / "events_1.peld"
    manifest = json.loads(_read(seg_dir / "segments.json"))
    healed = replica.sync_sealed("events_1", manifest,
                                 lambda tag, name: _read(seg_dir / name), 3)
    headers.append({"healed": healed})
    return leader_dir, replica, headers


def test_replication_across_packages_is_byte_identical(tmp_path):
    runs = {}
    for leader_pkg, follower_pkg in (("jax", "port"), ("port", "jax")):
        leader_dir, replica, headers = _cross_run(tmp_path, leader_pkg, follower_pkg)
        leader_files = _digests(leader_dir)
        follower_files = _digests(replica.log_dir)
        # every frame file the leader holds, the follower holds with the
        # same digest (the follower's manifest has no compaction sidecars)
        frames = {k: v for k, v in leader_files.items()
                  if k.endswith(".pel") and "quarantine" not in k}
        assert frames and {k: follower_files.get(k) for k in frames} == frames
        runs[leader_pkg] = (follower_files, _read(replica.state_path), headers)
    assert runs["jax"][0] == runs["port"][0]
    assert runs["jax"][1] == runs["port"][1]
    assert runs["jax"][2] == runs["port"][2]
    state = json.loads(runs["port"][1])
    assert state["epoch"] == 3 and state["cursors"]["events_1"]["seg"] >= 1
    assert runs["port"][2][-1]["healed"] >= 1


# -- a JAX event server leading a port follower over HTTP ----------------------


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Served:
    """One package's event server with its ReplNode, in a thread."""

    def __init__(self, pkg, home, lease_home, port, peer_url, key):
        import asyncio

        if pkg == "jax":
            from predictionio_tpu.server.event_server import EventServer
            from predictionio_tpu.storage import registry
        else:
            from predictionio_tpu_torch.server.event_server import EventServer
            from predictionio_tpu_torch.storage import registry
        self.storage = registry.Storage(registry.StorageConfig(
            home=str(home), eventdata_type="EVENTLOG"))
        app = self.storage.meta.create_app("repl-app")
        self.storage.meta.create_access_key(app.id, key=key)
        self.url = f"http://127.0.0.1:{port}"
        node = PKG[pkg].server.ReplNode(
            lease_home=str(lease_home), advertise_url=self.url, home=str(home),
            replicate_to=[peer_url], lease_ttl=1.0, catchup_interval=0.2)
        self.server = EventServer(storage=self.storage, host="127.0.0.1", port=port,
                                  replication=node, incident_dir=None)
        self.node = node
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        import asyncio

        asyncio.set_event_loop(self.loop)
        self.loop.run_until_complete(self.server.serve_forever())

    def stop(self):
        self.loop.call_soon_threadsafe(self.server.http.request_shutdown)
        self.thread.join(timeout=20)
        assert not self.thread.is_alive()
        self.storage._events.close()


def _status(url):
    with urllib.request.urlopen(url + "/repl/status", timeout=5) as r:
        return json.loads(r.read())


def _wait(pred, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            if pred():
                return
        except OSError:
            pass
        time.sleep(0.02)
    raise AssertionError("condition not reached in time")


def test_jax_event_server_leads_a_port_follower(tmp_path):
    lease = tmp_path / "lease"
    ports = {"jax": _free_port(), "port": _free_port()}
    urls = {k: f"http://127.0.0.1:{v}" for k, v in ports.items()}
    leader = _Served("jax", tmp_path / "jax_home", lease, ports["jax"],
                     urls["port"], "k1")
    follower = None
    try:
        _wait(lambda: _status(urls["jax"])["role"] == "leader")
        follower = _Served("port", tmp_path / "port_home", lease, ports["port"],
                           urls["jax"], "k1")
        _wait(lambda: _status(urls["port"])["role"] == "follower")
        sink = port_sink.HTTPEventSink(urls["port"], "k1", retries=5)
        ids = [sink.send(Event(event="rate", entity_type="user", entity_id=f"u{i}",
                               target_entity_type="item", target_entity_id="i1",
                               properties={"rating": 4.0}))
               for i in range(3)]
        ids += sink.send_batch([Event(event="rate", entity_type="user",
                                      entity_id=f"v{i}", target_entity_type="item",
                                      target_entity_id="i2",
                                      properties={"rating": 2.0})
                                for i in range(50)])
        assert len(ids) == 53 and all(ids)
        # the follower's 307 carried every write to the leader
        req = urllib.request.Request(urls["port"] + "/events.json?accessKey=k1",
                                     data=b"{}", method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=5)
        assert e.value.code == 307
        assert e.value.headers["Location"].startswith(urls["jax"] + "/events.json")
        doc = _status(urls["port"])
        assert doc["role"] == "follower" and doc["leaderUrl"] == urls["jax"]
        assert _status(urls["jax"])["replication"]["followers"][0]["healthy"]
        leader_log = _digests(tmp_path / "jax_home" / "eventlog")
        follower_log = _digests(tmp_path / "port_home" / "eventlog")
        frames = {k: v for k, v in leader_log.items() if k.endswith(".pel")}
        assert frames and {k: follower_log.get(k) for k in frames} == frames
        cur = json.loads(_read(tmp_path / "port_home" / "replica_state.json"))
        assert cur["epoch"] == 1
        assert cur["cursors"]["events_1"]["offset"] == os.path.getsize(
            tmp_path / "jax_home" / "eventlog" / "events_1.pel")
    finally:
        if follower is not None:
            follower.stop()
        leader.stop()


# -- the drill and check_replica_state -----------------------------------------


def test_port_failover_drill_spawns_the_port_cli(tmp_path, monkeypatch):
    """The drill's event servers run ``predictionio_tpu_torch.tools.cli``
    (the argv it spawns, read before any process starts)."""
    import subprocess

    seen = []

    class _Stop(Exception):
        pass

    def fake_popen(argv, **kw):
        seen.append(list(argv))
        raise _Stop()

    monkeypatch.setattr(subprocess, "Popen", fake_popen)
    with pytest.raises(_Stop):
        port_repl_server.run_failover_drill(str(tmp_path / "d"))
    assert seen[0][1:4] == ["-m", "predictionio_tpu_torch.tools.cli", "eventserver"]
    assert "--lease-home" in seen[0] and "--durable-acks" in seen[0]


def test_port_failover_drill_proves_zero_acked_loss(tmp_path):
    proof = port_repl_server.run_failover_drill(str(tmp_path / "drill"), events=60,
                                                kill_after=20)
    assert proof["ok"], proof
    assert proof["ackedLost"] == 0 and proof["acked"] == 60
    assert proof["epoch"] > proof["epochBefore"]
    assert proof["promotionMs"] < 1000.0
    assert proof["staleEpochRefused"]
    assert proof["fsck"] == {"leader": 0, "follower": 0}
    assert proof["incidentBundles"] == 1
    # the JAX drill's proof document has these keys (repl_server.py's
    # return statement), and no others
    assert set(proof) == {"acked", "ackedLost", "lostIds", "promotionMs",
                          "nodePromotionMs", "epochBefore", "epoch",
                          "staleEpochRefused", "fsck", "incidentBundles", "ok"}
    assert port_repl_server._failover_bundles(
        str(tmp_path / "drill" / "follower" / "incidents")) == \
        jax_repl_server._failover_bundles(
            str(tmp_path / "drill" / "follower" / "incidents"))


def test_check_replica_state_matches_jax(tmp_path):
    home = str(tmp_path / "home")
    replica = port_repl.ReplicaHome(home)
    assert port_pel.check_replica_state(home) == jax_pel.check_replica_state(home)
    replica.apply_wal(port_repl.WalBatch.build("events_1", 0, 0, port_pel.PEL_MAGIC,
                                               epoch=2))
    replica.apply_wal(port_repl.WalBatch.build("events_1", 0, 8, b"\x05\x00\x00\x00",
                                               epoch=2))
    for offset in (12, 10_000, 4):
        doc = json.load(open(replica.state_path))
        doc["cursors"]["events_1"]["offset"] = offset
        with open(replica.state_path, "w") as f:
            json.dump(doc, f)
        assert port_pel.check_replica_state(home) == jax_pel.check_replica_state(home)
    with open(replica.state_path, "w") as f:
        f.write("{not json")
    assert port_pel.check_replica_state(home) == jax_pel.check_replica_state(home)
    assert port_pel.check_replica_state(str(tmp_path / "none")) is None


@pytest.mark.parametrize("n", [0, 9, (40 << 10) - 1, 40 << 10, 65535, 65536, 65537,
                               65536 + 1023, 1 << 20, (4 << 20) + 3])
def test_long_crc32c_equals_the_byte_loop(n):
    """The port's split crc32c of long buffers (a WAL batch is up to 4 MB)
    equals the JAX package's byte loop, chained from any start."""
    import numpy as np

    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    for start in (0, 0x1EDC6F41):
        assert port_pel.crc32c(data, start) == jax_pel.crc32c(data, start)
    assert port_pel.crc32c(b"123456789") == 0xE3069283


def test_catch_up_hashes_a_sealed_file_once(tmp_path, monkeypatch):
    """Catch-up passes over unchanged sealed files: a row the leader has
    not digested is kept while its size matches (not fetched again each
    pass), a digested one is hashed once and not again; a copy gone stale
    is fetched again."""
    st = _store(PKG["port"], tmp_path / "leader", seg_bytes=4096)
    for lo in range(0, 300, 50):
        st.insert_batch(_events(PKG["port"], 50, start=lo), APP)
    ns = st._ns(APP, None)
    seg_dir = tmp_path / "leader" / "events_1.peld"
    fetch = lambda tag, name: _read(seg_dir / name)  # noqa: E731
    bare = json.loads(_read(seg_dir / "segments.json"))
    rows = len(bare["segments"])
    assert rows >= 2 and all(r["sha256"] is None for r in bare["segments"])
    replica = port_repl.ReplicaHome(str(tmp_path / "replica"))
    assert replica.sync_sealed("events_1", bare, fetch, 1) == rows
    assert replica.sync_sealed("events_1", bare, fetch, 1) == 0
    ns.finalize_all()
    st.close()
    digested = json.loads(_read(seg_dir / "segments.json"))
    assert all(r["sha256"] for r in digested["segments"])
    hashed = []
    real = port_repl._file_sha256
    monkeypatch.setattr(port_repl, "_file_sha256", lambda p: hashed.append(p) or real(p))
    assert replica.sync_sealed("events_1", digested, fetch, 1) == 0
    assert len(hashed) == rows
    assert replica.sync_sealed("events_1", digested, fetch, 1) == 0
    assert len(hashed) == rows
    row = digested["segments"][0]
    path = os.path.join(replica.seg_dir("events_1"), row["file"])
    with open(path, "r+b") as f:          # the follower's copy went stale
        f.seek(20)
        f.write(b"\xff")
    os.utime(path, ns=(1, 1))
    assert replica.sync_sealed("events_1", digested, fetch, 1) == 1
    assert _read(path) == _read(seg_dir / row["file"])


@pytest.mark.parametrize("batching", [False, True])
def test_a_fenced_event_server_sheds_writes_with_503(tmp_path, batching):
    """A node whose fence refuses appends (``FencedWriteError`` before a
    byte lands) answers 503 with ``Retry-After`` on a single event, with
    or without group commit, and on every item of a batch; group commit
    keeps its storage breaker closed; both packages answer alike."""
    from predictionio_tpu.server.event_server import EventServer as JaxEventServer
    from predictionio_tpu.storage import registry as jax_registry
    from predictionio_tpu_torch.server.event_server import EventServer
    from predictionio_tpu_torch.storage import registry as port_registry
    from tests.test_torch_event_server import ServerThread, request

    body = {"event": "rate", "entityType": "user", "entityId": "u1",
            "targetEntityType": "item", "targetEntityId": "i1",
            "properties": {"rating": 4.0}}
    out = {}
    for pkg, server_cls, registry in (("jax", JaxEventServer, jax_registry),
                                      ("port", EventServer, port_registry)):
        st = registry.Storage(registry.StorageConfig(home=str(tmp_path / pkg),
                                                     eventdata_type="EVENTLOG"))
        app = st.meta.create_app("fenced")
        st.meta.create_access_key(app.id, key="k")
        st.events.insert_batch([PKG[pkg].Event(event="rate", entity_type="user",
                                               entity_id="u0")], app.id)
        size = os.path.getsize(tmp_path / pkg / "eventlog" / "events_1.pel")
        st.events.set_replicator(PKG[pkg].repl.Replicator(
            [], epoch=lambda: 2, fenced=lambda: True))
        srv = server_cls(storage=st, host="127.0.0.1", port=0, incident_dir=None,
                         ingest_batching=batching)
        with ServerThread(srv) as s:
            one = request(s.port, "POST", "/events.json?accessKey=k", body)
            many = request(s.port, "POST", "/batch/events.json?accessKey=k",
                           [body, body])
        assert one[0] == 503 and one[2]["Retry-After"] == "1"
        assert "fenced" in one[1]["message"]
        assert many[0] == 200 and [d["status"] for d in many[1]] == [503, 503]
        if batching:
            assert srv._ingest.breaker.state == "closed"
        assert os.path.getsize(tmp_path / pkg / "eventlog" / "events_1.pel") == size
        st.events.close()
        out[pkg] = (one[0], one[1]["retryAfterSec"], [d["status"] for d in many[1]])
    assert out["port"] == out["jax"]


def test_catch_up_fetches_an_undigested_file_again_after_a_while(tmp_path):
    """A follower's copy of a segment the leader has not digested, gone
    bad at the same size, is replaced from the leader's bytes once
    ``REVERIFY_SECONDS`` have passed since the copy was last held against them
    (one file a pass, the one held longest ago), and not before."""
    st = _store(PKG["port"], tmp_path / "leader", seg_bytes=4096)
    for lo in range(0, 300, 50):
        st.insert_batch(_events(PKG["port"], 50, start=lo), APP)
    seg_dir = tmp_path / "leader" / "events_1.peld"
    fetched = []

    def fetch(tag, name):
        fetched.append(name)
        return _read(seg_dir / name)

    bare = json.loads(_read(seg_dir / "segments.json"))
    rows = [r["file"] for r in bare["segments"]]
    assert len(rows) >= 2 and all(r["sha256"] is None for r in bare["segments"])
    now = [100.0]
    replica = port_repl.ReplicaHome(str(tmp_path / "replica"), clock=lambda: now[0])
    assert replica.sync_sealed("events_1", bare, fetch, 1) == len(rows)
    assert fetched == rows
    path = os.path.join(replica.seg_dir("events_1"), rows[1])
    with open(path, "r+b") as f:               # bit rot at rest, same size
        f.seek(20)
        f.write(bytes([f.read(1)[0] ^ 0xFF]))
    fetched.clear()
    now[0] += port_repl.REVERIFY_SECONDS - 1.0
    assert replica.sync_sealed("events_1", bare, fetch, 1) == 0
    assert fetched == []
    now[0] += 1.0
    # every row is due; the first pass holds rows[0] (equal: kept), the
    # next the damaged one
    assert replica.sync_sealed("events_1", bare, fetch, 1) == 0
    assert replica.sync_sealed("events_1", bare, fetch, 1) == 1
    assert fetched == rows[:2]
    assert _read(path) == _read(seg_dir / rows[1])


def _half_applied(tmp_path, cut=150):
    """A leader pushing in batches of 300 bytes to a follower; then ten
    events of which the follower has applied only the first ``cut`` bytes
    (a batch that ends inside a frame). Returns (leader store, replica,
    the rest of the file as one batch)."""
    p = PKG["port"]
    st = _store(p, tmp_path / "leader", seg_bytes=4096)
    replica = port_repl.ReplicaHome(str(tmp_path / "replica"))
    st.set_replicator(port_repl.Replicator([_link(p, replica)], epoch=lambda: 1,
                                           max_batch_bytes=300))
    for lo in range(0, 100, 25):
        st.insert_batch(_events(p, 25, start=lo), APP)
    st.set_replicator(None)
    st.insert_batch(_events(p, 10, start=100), APP)
    ns = st._ns(APP, None)
    tag = ns.namespace_tag()
    seg, off = replica.cursor(tag)
    data = _read(ns.base_path)
    replica.apply_wal(port_repl.WalBatch.build(tag, seg, off, data[off:off + cut], 1))
    rest = port_repl.WalBatch.build(tag, seg, off + cut, data[off + cut:], 1)
    return st, replica, rest


def test_log_view_stops_at_the_acked_cursor_and_never_cuts_the_replica(tmp_path):
    """A view of a follower's home holds the whole frames below its acked
    cursor, leaves the follower's files as they are (the engine's open
    would cut the frame the last batch split: shown on a copy), sees each
    later batch and seal on ``refresh``, keeps its sealed segments'
    engine handles across generations, keeps the home's snapshot-cache
    identity and refuses writes."""
    import shutil

    st, replica, rest = _half_applied(tmp_path)
    home = str(tmp_path / "replica")
    files = _digests(replica.log_dir)
    view = port_repl.LogView(home)
    assert view.creation_stats(APP)[0] == 101
    assert len(list(view.find(APP))) == 101
    assert _digests(replica.log_dir) == files
    assert view.cache_identity == "eventlog:" + os.path.abspath(replica.log_dir)
    # opening the replica's own files through the engine cuts them
    shutil.copytree(replica.log_dir, tmp_path / "opened")
    assert PortLog(str(tmp_path / "opened")).creation_stats(APP)[0] == 101
    assert (_digests(tmp_path / "opened")["events_1.pel"]
            != files["events_1.pel"])
    assert not view.refresh()                      # nothing moved
    replica.apply_wal(rest)
    assert view.refresh()
    assert view.creation_stats(APP) == st.creation_stats(APP)
    # a seal moves the active file into the follower's segment directory
    st.set_replicator(port_repl.Replicator([_link(PKG["port"], replica)],
                                           epoch=lambda: 1))
    for lo in range(110, 400, 50):
        st.insert_batch(_events(PKG["port"], 50, start=lo), APP)
    assert view.refresh()
    assert view.creation_stats(APP) == st.creation_stats(APP)
    assert view.creation_stats(APP)[0] == 410 and st._ns(APP, None).sealed
    assert sorted(e.entity_id for e in view.find(APP)) == sorted(
        e.entity_id for e in st.find(APP))
    # the sealed segments' engine handles carry over to the next generation
    handles = [seg.handle for seg in view._ns(APP, None).sealed]
    assert handles and all(handles)
    st.insert_batch(_events(PKG["port"], 5, start=410), APP)
    assert view.refresh() and view.creation_stats(APP) == st.creation_stats(APP)
    assert [seg.handle for seg in view._ns(APP, None).sealed] == handles
    with pytest.raises(port_repl.ReadOnlyViewError):
        view.insert_batch(_events(PKG["port"], 1, start=900), APP)
    lead, foll = _digests(tmp_path / "leader"), _digests(replica.log_dir)
    assert foll and all(lead[k] == v for k, v in foll.items())   # untouched by the view
    views = os.path.join(home, port_repl.LOG_VIEWS_DIR)
    assert len(os.listdir(views)) == 1
    view.close()
    assert os.listdir(views) == []


def test_log_view_of_a_home_that_leads_reads_whole_frames(tmp_path):
    """Once the node was promoted (``leading`` in its replica state), or
    where no replica state exists (a leader's home), a view reads to the
    last whole frame, past the cursors, and still leaves a split frame
    in place; a view of a dead reader is removed by the next one."""
    import subprocess
    import sys

    st, replica, rest = _half_applied(tmp_path)
    home = str(tmp_path / "replica")
    replica.leading = True
    replica._save_state()
    with open(replica.active_path("events_1"), "ab") as f:
        f.write(rest.payload[:-7])                   # appends past the cursor
    size = os.path.getsize(replica.active_path("events_1"))
    dead = subprocess.run([sys.executable, "-c", "import os; print(os.getpid())"],
                          capture_output=True, text=True, check=True)
    stale = os.path.join(home, port_repl.LOG_VIEWS_DIR, f"{dead.stdout.strip()}-0000")
    os.makedirs(stale)
    view = port_repl.LogView(home)
    assert not os.path.exists(stale)
    assert view.creation_stats(APP)[0] == 109
    assert os.path.getsize(replica.active_path("events_1")) == size
    with open(replica.active_path("events_1"), "ab") as f:
        f.write(rest.payload[-7:])
    assert view.refresh() and view.creation_stats(APP) == st.creation_stats(APP)
    # the doc JAX reads: the same cursors, and a key it ignores
    doc = json.loads(_read(replica.state_path))
    assert doc["leading"] is True and jax_repl.ReplicaHome(home).cursors == replica.cursors
    # a follower's apply clears the flag
    replica.leading = False
    replica._save_state()
    assert "leading" not in json.loads(_read(replica.state_path))
    os.unlink(replica.state_path)
    plain = port_repl.LogView(home)
    assert plain.creation_stats(APP) == st.creation_stats(APP)
    view.close()
    plain.close()
