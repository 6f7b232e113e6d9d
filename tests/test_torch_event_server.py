"""The port's event server held against the JAX package's, on the CPU.

Each server runs on its own temporary ``PIO_HOME`` (SQLite meta and
events) and port 0, with the same app, access keys and channel. One
request script goes to both: single and batch posts, GET with every
filter, get and delete by id, the auth failures (missing, bad, Bearer
and Basic keys), a key's permitted events, channels, a batch of 51 and
one of mixed validity, reserved-event misuse, malformed JSON,
``stats.json`` and the SegmentIO and MailChimp webhooks. The status
codes and JSON bodies must be equal, and so must the SQLite rows of the
event tables, with generated event ids and ``creationTime`` normalised
(every event the script posts carries its own ``eventTime``).

The port's own cases mirror ``tests/test_servers.py::TestEventServerAPI``
and ``tests/test_ingest.py``: group commit, one commit for an all-valid
batch, 429 with ``Retry-After`` and recovery, a poison event that does
not fail its siblings, 503 once the storage breaker opens, the drain on
shutdown, the auth cache's hits and its invalidation by the meta epoch,
and 64 concurrent clients on the SQLite store. Events one package's
server writes are read equal by the other package's ``find()``.
"""

import asyncio
import base64
import http.client
import json
import re
import sqlite3
import threading
import time
import urllib.parse

import pytest

from predictionio_tpu.server.event_server import EventServer as JaxEventServer
from predictionio_tpu.storage.registry import Storage as JaxStorage
from predictionio_tpu.storage.registry import StorageConfig as JaxStorageConfig
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.events import MemoryEventStore, SqliteEventStore
from predictionio_tpu_torch.server.event_server import EventServer
from predictionio_tpu_torch.server.ingest import IngestOverload, WriteCoalescer
from predictionio_tpu_torch.storage.meta import MetaStore, meta_epoch
from predictionio_tpu_torch.storage.models import MemoryModelStore
from predictionio_tpu_torch.storage.registry import Storage, StorageConfig
from predictionio_tpu_torch.utils.metrics import REGISTRY

KEY = "parityKey1"
VIEW_KEY = "parityViewKey"


class ServerThread:
    """Run an event or engine server (port 0) on its own loop and thread."""

    def __init__(self, server):
        self.server = server
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        asyncio.set_event_loop(self.loop)
        self.loop.run_until_complete(self.server.serve_forever())

    def __enter__(self):
        self.thread.start()
        deadline = time.monotonic() + 30
        while self.server.http._server is None:
            assert self.thread.is_alive(), "server thread died"
            assert time.monotonic() < deadline, "server did not start"
            time.sleep(0.01)
        self.port = self.server.http.bound_port
        return self

    def __exit__(self, *exc):
        self.loop.call_soon_threadsafe(self.server.http.request_shutdown)
        self.thread.join(timeout=30)
        assert not self.thread.is_alive(), "server did not stop"
        self.loop.close()


def request(port, method, path, body=None, headers=None, raw=None):
    """One request on a new connection: (status, JSON body, headers)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        data = raw if raw is not None else (
            None if body is None else json.dumps(body).encode())
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        payload = resp.read()
        return resp.status, (json.loads(payload) if payload else None), resp.headers
    finally:
        conn.close()


def _mem_storage(events_store=None):
    st = Storage(StorageConfig(metadata_type="MEMORY", eventdata_type="MEMORY",
                               modeldata_type="MEMORY"))
    st._meta = MetaStore(":memory:")
    st._events = events_store or MemoryEventStore()
    st._models = MemoryModelStore()
    return st


def _setup_app(st, name="IngestApp"):
    app = st.meta.create_app(name)
    st.events.init_channel(app.id)
    return app, st.meta.create_access_key(app.id).key


def _ev(m, **extra):
    return {"event": "view", "entityType": "user", "entityId": str(m),
            "targetEntityType": "item", "targetEntityId": "x", **extra}


# -- the request script, against both packages ---------------------------------


def _t(i):
    """A distinct eventTime per scripted event (no ties in find order)."""
    return f"2026-03-01T10:{i // 60:02d}:{i % 60:02d}.{i:03d}Z"


def _rate(i, user, item, rating, **extra):
    return {"event": "rate", "entityType": "user", "entityId": user,
            "targetEntityType": "item", "targetEntityId": item,
            "properties": {"rating": rating}, "eventTime": _t(i), **extra}


def request_script(call):
    """The scripted requests; ``call(method, path, body=None, headers=None,
    raw=None)`` returns (status, JSON body) and is recorded by the caller."""
    k = f"accessKey={KEY}"
    call("GET", "/")
    call("POST", "/events.json", {"event": "x"})
    call("POST", "/events.json?accessKey=wrong", {"event": "x"})
    call("POST", "/events.json", _rate(0, "u0", "i0", 1.0),
         headers={"Authorization": "Bearer wrong"})
    # single posts, one with a client-given id, tags and prId
    ids = []
    for i, (u, it, r) in enumerate([("u1", "i1", 5.0), ("u1", "i2", 3.5),
                                    ("u2", "i1", 2.0), ("u3", "i3", 4.0)]):
        _, body = call("POST", f"/events.json?{k}", _rate(i + 1, u, it, r))
        ids.append(body["eventId"])
    call("POST", f"/events.json?{k}",
         _rate(5, "u2", "i4", 1.5, eventId="clientid5", tags=["a", "b"], prId="p1"))
    call("POST", f"/events.json?{k}",
         {"event": "$set", "entityType": "item", "entityId": "i1",
          "properties": {"genre": "drama"}, "eventTime": _t(6)})
    # Bearer and Basic keys
    call("POST", "/events.json", _rate(7, "u4", "i2", 4.5),
         headers={"Authorization": f"Bearer {KEY}"})
    basic = base64.b64encode(f"{KEY}:".encode()).decode()
    call("POST", "/events.json", _rate(8, "u4", "i3", 3.0),
         headers={"Authorization": f"Basic {basic}"})
    # reserved-event misuse and malformed bodies
    call("POST", f"/events.json?{k}",
         {"event": "$set", "entityType": "item", "entityId": "i1",
          "targetEntityType": "item", "targetEntityId": "i2",
          "properties": {"a": 1}, "eventTime": _t(9)})
    call("POST", f"/events.json?{k}",
         {"event": "$unset", "entityType": "item", "entityId": "i1",
          "eventTime": _t(10)})
    call("POST", f"/events.json?{k}",
         {"event": "$bogus", "entityType": "u", "entityId": "1"})
    call("POST", f"/events.json?{k}", {"event": "rate", "entityType": "user"})
    call("POST", f"/events.json?{k}", raw=b"{not json")
    call("POST", f"/events.json?{k}", _rate(11, "u5", "i1", 1.0, bogusField=1))
    # a key's permitted events
    call("POST", f"/events.json?accessKey={VIEW_KEY}", _rate(12, "u5", "i1", 1.0))
    call("POST", f"/events.json?accessKey={VIEW_KEY}",
         {"event": "view", "entityType": "user", "entityId": "u5",
          "targetEntityType": "item", "targetEntityId": "i9", "eventTime": _t(13)})
    # channels
    call("POST", f"/events.json?{k}&channel=backtest", _rate(14, "u6", "i6", 2.5))
    call("POST", f"/events.json?{k}&channel=nope", _rate(15, "u6", "i6", 2.5))
    call("GET", f"/events.json?{k}&channel=backtest")
    call("GET", f"/events.json?{k}&channel=nope")
    # batches: all valid, mixed validity, 51, not a list, malformed
    call("POST", f"/batch/events.json?{k}",
         [_rate(20 + j, f"u{7 + j % 3}", f"i{j}", 0.5 + j) for j in range(5)])
    call("POST", f"/batch/events.json?{k}",
         [_rate(30, "u8", "i8", 3.0), {"event": ""},
          {"event": "$unset", "entityType": "item", "entityId": "i1",
           "eventTime": _t(31)},
          _rate(32, "u9", "i9", 4.0)])
    call("POST", f"/batch/events.json?accessKey={VIEW_KEY}",
         [_rate(33, "u9", "i1", 1.0),
          {"event": "view", "entityType": "user", "entityId": "u9",
           "targetEntityType": "item", "targetEntityId": "i2", "eventTime": _t(34)}])
    call("POST", f"/batch/events.json?{k}", [_rate(40, "u1", "i1", 1.0)] * 51)
    call("POST", f"/batch/events.json?{k}", {"event": "rate"})
    call("POST", f"/batch/events.json?{k}", raw=b"[{")
    call("POST", f"/batch/events.json?{k}", [])
    # GET with each filter
    for q in ("", "&limit=-1", "&limit=2", "&limit=-1&reversed=true",
              "&limit=3&reversed=1", f"&startTime={_t(3)}",
              f"&untilTime={_t(5)}", f"&startTime={_t(2)}&untilTime={_t(21)}",
              "&entityType=item", "&entityType=user&entityId=u1",
              "&event=rate&limit=-1", "&event=view", "&targetEntityType=item",
              "&targetEntityId=i1&limit=-1",
              "&entityType=user&entityId=u2&targetEntityType=item&targetEntityId=i4",
              "&startTime=yesterday", "&limit=many", "&entityId=nobody"):
        call("GET", f"/events.json?{k}{q}")
    call("GET", f"/events.json?accessKey={VIEW_KEY}&limit=-1")
    call("GET", "/events.json", headers={"Authorization": f"Bearer {KEY}"})
    call("GET", "/events.json")
    # get and delete by id
    call("GET", f"/events/{ids[0]}.json?{k}")
    call("GET", f"/events/clientid5.json?{k}")
    call("GET", f"/events/no-such-id.json?{k}")
    call("GET", f"/events/{ids[0]}.json?accessKey=wrong")
    call("DELETE", f"/events/{ids[1]}.json?{k}")
    call("DELETE", f"/events/{ids[1]}.json?{k}")
    call("GET", f"/events/{ids[1]}.json?{k}")
    call("DELETE", f"/events/{ids[2]}.json")
    # webhooks
    call("GET", f"/webhooks/segmentio.json?{k}")
    call("GET", f"/webhooks/nope.json?{k}")
    call("GET", "/webhooks/segmentio.json")
    call("POST", f"/webhooks/segmentio.json?{k}",
         {"type": "track", "userId": "u42", "event": "signup",
          "properties": {"plan": "pro"}, "timestamp": _t(50)})
    call("POST", f"/webhooks/segmentio.json?{k}",
         {"type": "identify", "anonymousId": "anon7",
          "traits": {"name": "Ada"}, "timestamp": _t(51)})
    call("POST", f"/webhooks/segmentio.json?{k}", {"type": "nope"})
    call("POST", f"/webhooks/segmentio.json?{k}", raw=b"{oops")
    form = {"type": "subscribe", "fired_at": "2026-03-01 11:00:00",
            "data[email]": "ada@example.com", "data[id]": "x1",
            "data[list_id]": "L9"}
    call("POST", f"/webhooks/mailchimp.json?{k}",
         raw=urllib.parse.urlencode(form).encode(),
         headers={"Content-Type": "application/x-www-form-urlencoded"})
    call("POST", f"/webhooks/mailchimp.json?{k}",
         raw=urllib.parse.urlencode({"type": "unknown"}).encode())
    call("POST", f"/webhooks/nope.json?{k}", {})
    call("GET", "/stats.json")
    call("GET", f"/events.json?{k}&limit=-1")
    call("GET", "/no/such/route")


_HEX_ID = re.compile(r"^[0-9a-f]{32}$")


class Normaliser:
    """Generated event ids → their order of first sight; creation and
    start times → a placeholder."""

    def __init__(self):
        self.ids = {}

    def id(self, value):
        if isinstance(value, str) and _HEX_ID.match(value):
            return self.ids.setdefault(value, f"<id{len(self.ids)}>")
        return value

    def path(self, path):
        return re.sub(r"[0-9a-f]{32}", lambda m: self.id(m.group(0)), path)

    def body(self, obj):
        if isinstance(obj, list):
            return [self.body(x) for x in obj]
        if isinstance(obj, dict):
            out = {}
            for key, val in obj.items():
                if key == "eventId":
                    out[key] = self.id(val)
                elif key in ("creationTime", "startTime"):
                    out[key] = "<time>"
                else:
                    out[key] = self.body(val)
            return out
        return obj

    def rows(self, home):
        """Every event table's rows, ids mapped, creation times dropped."""
        with sqlite3.connect(f"{home}/events.db") as c:
            tables = sorted(r[0] for r in c.execute(
                "SELECT name FROM sqlite_master WHERE type='table'"))
            out = {}
            for t in tables:
                rows = c.execute(f"SELECT * FROM {t}").fetchall()
                # id, ..., creationTime, creationTimeIso last
                out[t] = sorted((self.id(r[0]),) + r[1:11] for r in rows)
        return out


def _seed_meta(st):
    app = st.meta.create_app("ParityApp", "the script's app")
    st.events.init_channel(app.id)
    st.meta.create_access_key(app.id, key=KEY)
    st.meta.create_access_key(app.id, events=["view"], key=VIEW_KEY)
    ch = st.meta.create_channel(app.id, "backtest")
    st.events.init_channel(app.id, ch.id)
    return app


def _run_script(server):
    log = []
    with ServerThread(server) as srv:
        def call(method, path, body=None, headers=None, raw=None):
            status, payload, _ = request(srv.port, method, path, body, headers, raw)
            log.append((method, path, status, payload))
            return status, payload

        request_script(call)
    return log


@pytest.mark.parametrize("batching", [False, True], ids=["per_event", "group_commit"])
def test_request_script_parity(tmp_path, batching):
    homes = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    jst = JaxStorage(JaxStorageConfig(home=homes["jax"]))
    pst = Storage(StorageConfig(home=homes["port"]))
    _seed_meta(jst)
    _seed_meta(pst)
    logs = {
        "jax": _run_script(JaxEventServer(storage=jst, host="127.0.0.1", port=0,
                                          stats=True, plugins=[],
                                          ingest_batching=batching)),
        "port": _run_script(EventServer(storage=pst, host="127.0.0.1", port=0,
                                        stats=True, ingest_batching=batching)),
    }
    norm = {name: Normaliser() for name in logs}
    got = {name: [(m, norm[name].path(p), s, norm[name].body(b)) for m, p, s, b in log]
           for name, log in logs.items()}
    assert len(got["port"]) == len(got["jax"]) == 73
    for mine, theirs in zip(got["port"], got["jax"]):
        assert mine == theirs
    statuses = {s for _, _, s, _ in got["port"]}
    assert statuses >= {200, 201, 400, 401, 403, 404}
    # the mixed batches are answered per item
    per_item = [[it["status"] for it in b] for m, p, s, b in logs["port"]
                if p.startswith("/batch/") and s == 200]
    assert per_item == [[201] * 5, [201, 400, 400, 201], [403, 201], []]
    rows = {name: norm[name].rows(homes[name]) for name in homes}
    assert rows["port"] == rows["jax"]
    assert sum(len(r) for r in rows["port"].values()) >= 15


# -- the port's own cases ----------------------------------------------------------


def test_quickstart_ingestion_contract():
    st = _mem_storage()
    app, key = _setup_app(st)
    with ServerThread(EventServer(storage=st, host="127.0.0.1", port=0,
                                  stats=True)) as srv:
        p = srv.port
        assert request(p, "GET", "/")[1] == {"status": "alive"}
        assert request(p, "POST", "/events.json", {"event": "x"})[0] == 401
        ev = {"event": "rate", "entityType": "user", "entityId": "u1",
              "targetEntityType": "item", "targetEntityId": "i1",
              "properties": {"rating": 5.0}}
        code, body, _ = request(p, "POST", f"/events.json?accessKey={key}", ev)
        assert code == 201 and body["eventId"]
        eid = body["eventId"]
        code, body, _ = request(p, "POST", f"/events.json?accessKey={key}",
                                {"event": "$bogus", "entityType": "u", "entityId": "1"})
        assert code == 400 and "reserved" in body["message"]
        code, body, _ = request(p, "POST", f"/batch/events.json?accessKey={key}",
                                [ev, {"event": ""}])
        assert code == 200 and [it["status"] for it in body] == [201, 400]
        assert request(p, "POST", f"/batch/events.json?accessKey={key}",
                       [ev] * 51)[0] == 400
        code, got, _ = request(p, "GET", f"/events/{eid}.json?accessKey={key}")
        assert code == 200 and got["event"] == "rate"
        code, lst, _ = request(p, "GET", f"/events.json?accessKey={key}&event=rate")
        assert code == 200 and len(lst) == 2
        assert request(p, "DELETE", f"/events/{eid}.json?accessKey={key}")[0] == 200
        assert request(p, "GET", f"/events/{eid}.json?accessKey={key}")[0] == 404
        code, stats, _ = request(p, "GET", "/stats.json")
        assert code == 200 and stats["appStats"][0]["appId"] == app.id
    counter = REGISTRY.counter("pio_events_ingested_total", "Events accepted/rejected",
                               ("app_id", "status"))
    assert counter._values[(str(app.id), "201")] >= 2
    assert REGISTRY.histogram("pio_event_insert_seconds",
                              "Single-event insert latency").sum_count()[1] >= 2


def test_coalescer_groups_by_app_channel():
    commits = []

    class RecordingStore(MemoryEventStore):
        def insert_batch(self, events, app_id, channel_id=None):
            commits.append((app_id, channel_id, len(events)))
            time.sleep(0.01)  # service time: arrivals coalesce
            return super().insert_batch(events, app_id, channel_id)

    store = RecordingStore()

    async def main():
        c = WriteCoalescer(store)
        evs = [Event(event="view", entity_type="user", entity_id=str(i),
                     target_entity_type="item", target_entity_id="x",
                     properties={"i": i}) for i in range(40)]
        ids = await asyncio.gather(*[c.submit(e, 1, None if i % 2 else 7)
                                     for i, e in enumerate(evs)])
        assert len(set(ids)) == 40
        await c.aclose()
        return c

    c = asyncio.run(main())
    # far fewer commits than events, each of one namespace
    assert c.submitted == 40 and c.batches < c.submitted
    assert {(a, ch) for a, ch, _ in commits} == {(1, None), (1, 7)}
    assert len(list(store.find(1, None))) == 20 and len(list(store.find(1, 7))) == 20


def test_coalescer_overload_and_reuse():
    class SlowStore(MemoryEventStore):
        def insert_batch(self, events, app_id, channel_id=None):
            time.sleep(0.05)
            return super().insert_batch(events, app_id, channel_id)

    store = SlowStore()
    ev = Event(event="view", entity_type="user", entity_id="u",
               target_entity_type="item", target_entity_id="x")

    async def main():
        c = WriteCoalescer(store, max_queue=1)
        results = await asyncio.gather(*[c.submit(ev.with_id(), 1) for _ in range(6)],
                                       return_exceptions=True)
        overloads = [r for r in results if isinstance(r, IngestOverload)]
        oks = [r for r in results if isinstance(r, str)]
        assert overloads and oks and len(overloads) + len(oks) == 6
        assert c.rejected == len(overloads)
        await c.aclose()
        # a server that stops and serves again keeps working
        await c.submit(ev.with_id(), 1)
        await c.aclose()
        return len(oks) + 1

    acked = asyncio.run(main())
    assert len(list(store.find(1))) == acked


class _CountingStore(MemoryEventStore):
    """Counts commits; the port's ``insert`` is an ``insert_batch`` of one,
    so the batch commits are ``batch_calls - insert_calls``."""

    def __init__(self):
        super().__init__()
        self.batch_calls = self.insert_calls = 0

    def insert(self, event, app_id, channel_id=None):
        self.insert_calls += 1
        return super().insert(event, app_id, channel_id)

    def insert_batch(self, events, app_id, channel_id=None):
        self.batch_calls += 1
        return super().insert_batch(events, app_id, channel_id)


def test_all_valid_batch_is_one_commit_and_mixed_falls_back():
    store = _CountingStore()
    st = _mem_storage(store)
    app, key = _setup_app(st)
    with ServerThread(EventServer(storage=st, host="127.0.0.1", port=0)) as srv:
        path = f"/batch/events.json?accessKey={key}"
        code, body, _ = request(srv.port, "POST", path, [_ev(m) for m in range(10)])
        assert code == 200 and [it["status"] for it in body] == [201] * 10
        assert (store.batch_calls - store.insert_calls, store.insert_calls) == (1, 0)
        code, body, _ = request(srv.port, "POST", path, [_ev(1), {"event": ""}, _ev(2)])
        assert [it["status"] for it in body] == [201, 400, 201]
        # the mixed batch went event by event
        assert (store.batch_calls - store.insert_calls, store.insert_calls) == (1, 2)
    assert len(list(st.events.find(app.id))) == 12


def _post_from_threads(port, key, n, body_of=_ev):
    results = {}
    # every post leaves together, so they reach the coalescer at once
    # even on a loaded machine
    start = threading.Barrier(n)

    def worker(m):
        start.wait(timeout=60)
        status, body, headers = request(port, "POST", f"/events.json?accessKey={key}",
                                        body_of(m))
        results[m] = (status, body, headers.get("Retry-After"))

    threads = [threading.Thread(target=worker, args=(m,)) for m in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    return results


def test_queue_full_returns_429_and_recovers():
    class SlowStore(MemoryEventStore):
        def insert_batch(self, events, app_id, channel_id=None):
            time.sleep(0.1)
            return super().insert_batch(events, app_id, channel_id)

    st = _mem_storage(SlowStore())
    app, key = _setup_app(st)
    with ServerThread(EventServer(storage=st, host="127.0.0.1", port=0,
                                  ingest_batching=True,
                                  ingest_queue_depth=2)) as srv:
        results = _post_from_threads(srv.port, key, 20)
        statuses = [s for s, _, _ in results.values()]
        assert set(statuses) <= {201, 429} and 429 in statuses
        for status, body, retry_after in results.values():
            if status == 429:
                assert float(retry_after) >= 1 and "retryAfterSec" in body
        # once the queue drains, a single POST succeeds
        deadline = time.monotonic() + 10
        while request(srv.port, "POST", f"/events.json?accessKey={key}",
                      _ev("recovered"))[0] != 201:
            assert time.monotonic() < deadline, "never recovered from 429"
            time.sleep(0.2)
    # only acked events were stored (shed requests wrote nothing)
    assert len(list(st.events.find(app.id))) == statuses.count(201) + 1


def test_poison_event_does_not_fail_siblings():
    class PoisonStore(MemoryEventStore):
        def insert(self, event, app_id, channel_id=None):
            if event.properties.get("poison"):
                raise RuntimeError("poisoned event")
            return super().insert(event, app_id, channel_id)

        def insert_batch(self, events, app_id, channel_id=None):
            if any(e.properties.get("poison") for e in events):
                raise RuntimeError("poisoned batch")
            return super().insert_batch(events, app_id, channel_id)

    st = _mem_storage(PoisonStore())
    app, key = _setup_app(st)
    server = EventServer(storage=st, host="127.0.0.1", port=0, ingest_batching=True)
    with ServerThread(server) as srv:
        results = _post_from_threads(
            srv.port, key, 16,
            lambda m: _ev(m, properties={"poison": m % 4 == 0, "m": m}))
    for m, (status, body, _) in results.items():
        if m % 4 == 0:
            assert status == 500 and "poisoned" in body["message"], (m, body)
        else:
            assert status == 201, (m, body)
    stored = list(st.events.find(app.id))
    assert sorted(e.properties["m"] for e in stored) == \
        [m for m in range(16) if m % 4 != 0]
    # poison is not an outage: the breaker stays closed
    assert server._ingest.breaker.state == "closed" and server._ingest.isolations >= 1


def test_storage_failure_opens_the_breaker_503():
    class DownStore(MemoryEventStore):
        def insert_batch(self, events, app_id, channel_id=None):
            raise RuntimeError("storage down")

        def insert(self, event, app_id, channel_id=None):
            raise RuntimeError("storage down")

    st = _mem_storage(DownStore())
    app, key = _setup_app(st)
    server = EventServer(storage=st, host="127.0.0.1", port=0, ingest_batching=True)
    with ServerThread(server) as srv:
        path = f"/events.json?accessKey={key}"
        statuses = [request(srv.port, "POST", path, _ev(m))[0] for m in range(8)]
        assert statuses == [500] * 8  # threshold: 8 failed commits
        status, body, headers = request(srv.port, "POST", path, _ev(9))
        assert status == 503 and "circuit breaker open" in body["message"]
        assert int(headers["Retry-After"]) >= 1 and body["retryAfterSec"] > 0
        assert server._ingest.breaker.state == "open"
        assert server._ingest.breaker_rejected == 1
        # storage back, reset timeout elapsed: a trial commit closes it
        server._ingest.store = MemoryEventStore()
        server._ingest.breaker._opened_at -= server._ingest.breaker.reset_timeout
        assert request(srv.port, "POST", path, _ev(10))[0] == 201
        assert server._ingest.breaker.state == "closed"


def test_shutdown_drains_accepted_events():
    class SlowStore(MemoryEventStore):
        def insert_batch(self, events, app_id, channel_id=None):
            time.sleep(0.03)
            return super().insert_batch(events, app_id, channel_id)

    st = _mem_storage(SlowStore())
    app, key = _setup_app(st)
    server = EventServer(storage=st, host="127.0.0.1", port=0, ingest_batching=True)
    statuses = []

    def worker(port, m):
        try:
            statuses.append(request(port, "POST", f"/events.json?accessKey={key}",
                                    _ev(m))[0])
        except OSError:
            pass  # shutdown may cut the connection; the drain still runs

    with ServerThread(server) as srv:
        threads = [threading.Thread(target=worker, args=(srv.port, m))
                   for m in range(10)]
        for th in threads:
            th.start()
        time.sleep(0.05)  # let requests be accepted mid-commit
    for th in threads:
        th.join(timeout=10)
    # accepted == committed, and nothing acked was lost
    assert len(list(st.events.find(app.id))) == server._ingest.submitted
    assert statuses.count(201) <= server._ingest.submitted


def test_auth_cache_hit_and_epoch_invalidation():
    st = _mem_storage()
    app, key = _setup_app(st)
    counter = REGISTRY.counter("pio_authcache_total", "Auth cache lookups",
                               ("result",))
    hits0 = counter._values.get(("hit",), 0)
    with ServerThread(EventServer(storage=st, host="127.0.0.1", port=0)) as srv:
        url = f"/events.json?accessKey={key}"
        assert request(srv.port, "POST", url, _ev(1))[0] == 201  # miss, fills
        assert request(srv.port, "POST", url, _ev(2))[0] == 201  # hit
        assert counter._values.get(("hit",), 0) > hits0
        # in-process revocation is effective at once (epoch bump)
        epoch = meta_epoch()
        st.meta.delete_access_key(key)
        assert meta_epoch() == epoch + 1
        assert request(srv.port, "POST", url, _ev(3))[0] == 401
        # a channel created after a cached negative becomes visible
        key2 = st.meta.create_access_key(app.id).key
        url2 = f"/events.json?accessKey={key2}&channel=late"
        assert request(srv.port, "POST", url2, _ev(4))[0] == 400
        ch = st.meta.create_channel(app.id, "late")
        st.events.init_channel(app.id, ch.id)
        assert request(srv.port, "POST", url2, _ev(5))[0] == 201
    with ServerThread(EventServer(storage=st, host="127.0.0.1", port=0,
                                  auth_cache_ttl=0)) as srv:
        assert srv.server._auth_cache is None
        url = f"/events.json?accessKey={key2}"
        assert request(srv.port, "POST", url, _ev(6))[0] == 201


def test_webhook_post_group_commits():
    st = _mem_storage()
    app, key = _setup_app(st)
    server = EventServer(storage=st, host="127.0.0.1", port=0, ingest_batching=True)
    with ServerThread(server) as srv:
        payload = {"type": "track", "userId": "u42", "event": "signup",
                   "properties": {"plan": "pro"}}
        assert request(srv.port, "POST",
                       f"/webhooks/segmentio.json?accessKey={key}", payload)[0] == 201
    assert server._ingest.submitted == 1
    evs = list(st.events.find(app.id, event_names=["signup"]))
    assert len(evs) == 1 and evs[0].entity_id == "u42"


def test_sqlite_store_under_64_clients_exactly_once(tmp_path):
    """Group commit on the SQLite store from 64 concurrent clients: the
    executor's threads each keep their own connection. Every acked id
    is stored once, and reopening the store from disk reads them all."""
    import sys

    st = Storage(StorageConfig(home=str(tmp_path)))
    app, key = _setup_app(st)
    server = EventServer(storage=st, host="127.0.0.1", port=0, ingest_batching=True)
    acked, errors = [], []

    def worker(port, t):
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            for m in range(5):
                conn.request("POST", f"/events.json?accessKey={key}",
                             json.dumps(_ev(f"{t}-{m}", properties={"t": t, "m": m})),
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                body = json.loads(resp.read())
                assert resp.status == 201, body
                acked.append(body["eventId"])
            conn.close()
        except Exception as e:  # surfaced after join
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ServerThread(server) as srv:
            threads = [threading.Thread(target=worker, args=(srv.port, t))
                       for t in range(64)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
                assert not th.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors[:3]
    assert len(acked) == len(set(acked)) == 320 == server._ingest.submitted
    assert server._ingest.batches < 320  # the coalescer grouped them
    reopened = SqliteEventStore(str(tmp_path / "events.db"))
    assert sorted(e.event_id for e in reopened.find(app.id)) == sorted(acked)


def test_durable_acks_take_full_sync_on_every_connection(tmp_path):
    st = Storage(StorageConfig(home=str(tmp_path)))
    store = st.events
    sync = lambda: store._conn().execute("PRAGMA synchronous").fetchone()[0]
    assert sync() == 1  # NORMAL
    EventServer(storage=st, host="127.0.0.1", port=0, durable_acks=True)
    seen = []
    th = threading.Thread(target=lambda: seen.append(sync()))
    th.start()
    th.join(timeout=10)
    assert (sync(), seen) == (2, [2])  # FULL on this thread's and a new one's
    store.set_durable(False)
    assert sync() == 1


# -- across the packages -----------------------------------------------------------


def _events_via(server, key, n):
    with ServerThread(server) as srv:
        body = [_rate(i, f"u{i % 3}", f"i{i % 4}", 0.5 * (i % 10)) for i in range(n)]
        code, answer, _ = request(srv.port, "POST",
                                  f"/batch/events.json?accessKey={key}", body)
        assert code == 200 and all(it["status"] == 201 for it in answer)
        for i in range(n, n + 3):
            assert request(srv.port, "POST", f"/events.json?accessKey={key}",
                           _rate(i, "u9", "i9", 1.0))[0] == 201


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_events_one_server_writes_the_other_package_reads(tmp_path, writer):
    home = str(tmp_path)
    jst = JaxStorage(JaxStorageConfig(home=home))
    app = _seed_meta(jst)
    pst = Storage(StorageConfig(home=home))
    if writer == "port":
        _events_via(EventServer(storage=pst, host="127.0.0.1", port=0,
                                ingest_batching=True), KEY, 12)
    else:
        _events_via(JaxEventServer(storage=jst, host="127.0.0.1", port=0,
                                   plugins=[], ingest_batching=True), KEY, 12)
    mine = [e.to_json() for e in pst.events.find(app.id)]
    theirs = [e.to_json() for e in jst.events.find(app.id)]
    assert len(mine) == 15 and mine == theirs
    assert pst.meta.get_access_key(KEY).app_id == app.id
