"""The port's EVENTLOG backend held against the JAX package's, on the CPU.

Both packages build the same ``eventlog.cc`` (the port's copy is byte
for byte the JAX package's) and open ``NativeEventLogStore`` on twin
directories. On them:

- one script of store calls (``insert``, ``insert_batch``, an overwrite
  by id, ``get``, ``delete``, ``find`` with every filter, ``limit`` and
  ``reversed``, ``aggregate_properties``, ``wipe``), with one writer
  shard and with three, gives equal answers, and with explicit ids and
  times the log files are byte-equal;
- each package reads a home the other wrote (rolled into sealed
  segments): ``find``, ``get``, ``creation_stats`` and the columnar scan,
  bitwise;
- ``append_jsonl`` accepts and declines the same lines, and ``pio
  import`` gives the same events through either package;
- the rating grammar (``_NUM_RE``) keeps and drops the same values on the
  native scan, SQLite's columnar scan and the generic two-pass path;
- a line with a duplicate JSON key is declined by the native ingest in
  both packages and lands with ``json.loads``' last value;
- ``import`` and ``export`` through both CLIs give byte-equal files;
- the Recommendation template trained by the port from a JAX-written
  EVENTLOG home reads the JAX package's training data bitwise and gives
  its factors within 1e-4; the universal template's grouped read and
  ``BatchView`` are the JAX package's;
- a failed g++ build raises; nothing serves EVENTLOG data from another
  store.
"""

import dataclasses
import datetime as dt
import io
import json
import os
import pickle

import numpy as np
import pytest

from predictionio_tpu.data import store as jax_store
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.filestore import NativeEventLogStore as JaxLog
from predictionio_tpu.storage import registry as jax_registry
from predictionio_tpu.tools import cli as jax_cli
from predictionio_tpu.tools import export_import as jax_ei
from predictionio_tpu_torch.data import store as port_store
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.filestore import NativeEventLogStore as PortLog
from predictionio_tpu_torch.storage import registry as port_registry
from predictionio_tpu_torch.tools import cli
from predictionio_tpu_torch.tools import export_import as port_ei

APP = 1
T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)

#: per package: (store class, Event class, export_import, store module,
#: registry module, CLI module)
PKG = {
    "jax": (JaxLog, JaxEvent, jax_ei, jax_store, jax_registry, jax_cli),
    "port": (PortLog, Event, port_ei, port_store, port_registry, cli),
}


def log_store(pkg: str, directory, seg_bytes=None):
    s = PKG[pkg][0](str(directory))
    if seg_bytes is not None:
        s.segment_bytes = seg_bytes
    return s


def storage(pkg: str, home, events: str = "EVENTLOG"):
    reg = PKG[pkg][4]
    return reg.Storage(reg.StorageConfig(home=str(home), eventdata_type=events))


def rate_events(pkg: str, n: int, start: int = 0, users: int = 9, items: int = 13,
                names=("rate",)):
    """Events with their own ids and times (no wall clock, no random id)."""
    E = PKG[pkg][1]
    return [E(event_id=f"ev{start + i:05d}", event=names[(start + i) % len(names)],
              entity_type="user", entity_id=f"u{(start + i) * 7 % users}",
              target_entity_type="item", target_entity_id=f"i{(start + i) * 5 % items}",
              properties={"rating": float((start + i) % 5 + 1)},
              event_time=T0 + dt.timedelta(seconds=start + i),
              creation_time=T0 + dt.timedelta(days=1, seconds=start + i))
            for i in range(n)]


def js(events):
    return [e.to_json_str() for e in events]


def cols_tuple(cols):
    """Every array and table of a ColumnarEvents, for bitwise comparison."""
    assert cols is not None
    return (cols.entity_idx.tobytes(), cols.target_idx.tobytes(),
            cols.name_idx.tobytes(), np.asarray(cols.values).tobytes(),
            cols.times_us.tobytes(), [str(s) for s in cols.entity_ids],
            [str(s) for s in cols.target_ids], [str(s) for s in cols.names])


def log_files(directory):
    """{relative path: bytes} of every file under a log directory."""
    out = {}
    for root, _dirs, files in os.walk(directory):
        for name in files:
            p = os.path.join(root, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, directory)] = f.read()
    return out


def spi_script(pkg: str, directory, shards: int):
    """The store calls of one SPI run and what each answered."""
    E = PKG[pkg][1]
    s = log_store(pkg, directory)
    if shards > 1:
        s.set_shard_policy(lambda app_id: shards)
    out = []
    ids = s.insert_batch(rate_events(pkg, 60, names=("rate", "buy", "view")), APP)
    out.append(("ids", ids))
    props = [E(event_id=f"p{i}", event=ev, entity_type="item", entity_id=f"i{i % 4}",
               properties=pr, event_time=T0 + dt.timedelta(minutes=10 + i),
               creation_time=T0 + dt.timedelta(days=2, seconds=i))
             for i, (ev, pr) in enumerate([
                 ("$set", {"cat": ["a", "b"], "price": 3}), ("$set", {"cat": ["c"]}),
                 ("$unset", {"price": None}), ("$set", {"price": 9.5}),
                 ("$delete", {}), ("$set", {"tag": "x"})])]
    out.append(("single", [s.insert(e, APP) for e in props]))
    over = dataclasses.replace(rate_events(pkg, 1, start=7)[0],
                               properties={"rating": 0.5})
    out.append(("overwrite", s.insert(over, APP)))
    out.append(("get", [None if (e := s.get(i, APP)) is None else e.to_json_str()
                        for i in ("ev00003", "ev00007", "p2", "missing")]))
    out.append(("delete", [s.delete(i, APP) for i in ("ev00011", "ev00011", "nope")]))
    for kw in ({}, {"entity_type": "user"}, {"entity_id": "u3"},
               {"event_names": ["buy", "view"]}, {"target_entity_type": "item"},
               {"target_entity_id": "i5"},
               {"start_time": T0 + dt.timedelta(seconds=10),
                "until_time": T0 + dt.timedelta(seconds=30)},
               {"limit": 7}, {"limit": 0}, {"reversed": True, "limit": 5},
               {"entity_type": "item", "reversed": True}):
        out.append((sorted(kw), js(s.find(APP, **kw))))
    agg = s.aggregate_properties(APP, "item")
    out.append(("aggregate", sorted(
        (k, json.dumps(v.properties, sort_keys=True), v.first_updated.isoformat(),
         v.last_updated.isoformat())
        for k, v in agg.items())))
    out.append(("columnar", cols_tuple(s.scan_columnar(APP, value_key="rating"))))
    out.append(("stats", s.creation_stats(APP)))
    s.close()
    files = log_files(directory)
    s = log_store(pkg, directory)
    out.append(("reopened", js(s.find(APP))))
    s.wipe(APP)
    out.append(("wiped", js(s.find(APP)), s.creation_stats(APP)))
    s.close()
    return out, files


@pytest.mark.parametrize("shards", [1, 3])
def test_store_spi_matches_jax(tmp_path, shards):
    theirs, their_files = spi_script("jax", tmp_path / "jax", shards)
    mine, my_files = spi_script("port", tmp_path / "port", shards)
    assert mine == theirs
    # explicit ids and times: the two engines wrote the same bytes
    assert sorted(my_files) == sorted(their_files)
    assert my_files == their_files
    if shards > 1:
        assert any(".s1.pel" in f or ".s2.pel" in f for f in my_files)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_each_package_reads_the_others_home(tmp_path, writer, reader):
    d = tmp_path / "log"
    w = log_store(writer, d, seg_bytes=4096)
    for lo in range(0, 900, 150):
        w.insert_batch(rate_events(writer, 150, start=lo, users=40, items=30,
                                   names=("rate", "buy")), APP)
    w.delete("ev00003", APP)  # a tombstone into a sealed segment
    ns = w._ns(APP, None)
    assert len(ns.sealed) >= 2
    ns.compact(ns.sealed[0])
    want = (js(w.find(APP)), js(w.find(APP, reversed=True, limit=9)),
            w.get("ev00600", APP).to_json_str(), w.creation_stats(APP),
            cols_tuple(w.scan_columnar(APP, value_key="rating")),
            cols_tuple(w.scan_columnar(APP, event_names=["buy"])))
    w.close()
    r = log_store(reader, d, seg_bytes=4096)
    got = (js(r.find(APP)), js(r.find(APP, reversed=True, limit=9)),
           r.get("ev00600", APP).to_json_str(), r.creation_stats(APP),
           cols_tuple(r.scan_columnar(APP, value_key="rating")),
           cols_tuple(r.scan_columnar(APP, event_names=["buy"])))
    assert r.get("ev00003", APP) is None
    r.close()
    assert got == want
    assert len(want[0]) == 899


JSONL_LINES = [
    '{"event":"rate","entityType":"user","entityId":"u1",'
    '"targetEntityType":"item","targetEntityId":"i1",'
    '"properties":{"rating":4.5},"eventTime":"2026-01-02T03:04:05Z"}',
    '',  # blank: skipped
    '{"event":"buy","entityType":"user","entityId":"u\\u221e",'
    '"targetEntityType":"item","targetEntityId":"i☂",'
    '"eventTime":"2026-01-02T03:04:05.5+05:30"}',
    '{"event":"view","entityType":"user","entityId":"u2",'
    '"targetEntityType":"item","targetEntityId":"i2",'
    '"eventTime":"2026-01-02T03:04:05.123456-08:00",'
    '"tags":["a","b"],"prId":"pr-9"}',
    '{"event":"note","entityType":"user","entityId":"u3",'
    '"properties":{"nested":{"k":[1,2]},"s":"q\\"uote"},'
    '"eventTime":"2026-01-02 03:04:05"}',
    '{"event":"$set","entityType":"user","entityId":"u4",'
    '"properties":{"plan":"pro"},"eventTime":"2026-01-03T00:00:00Z"}',
    '{"eventId":"deadbeefdeadbeefdeadbeefdeadbeef","event":"pin",'
    '"entityType":"user","entityId":"u5","eventTime":"2026-01-04T00:00:00+00:00"}',
    '\x0c',  # form feed only: blank to Python, declined by the engine
]


def normalised(events):
    """Events without the generated id and creation time."""
    out = []
    for e in events:
        d = json.loads(e.to_json_str())
        if not d["eventId"].startswith("deadbeef"):
            d.pop("eventId")
        d.pop("creationTime")
        out.append(d)
    return sorted(out, key=json.dumps)


def test_append_jsonl_with_fallback_lines(tmp_path):
    blob = ("\n".join(JSONL_LINES) + "\n").encode("utf-8")
    answers, events = {}, {}
    for pkg in PKG:
        s = log_store(pkg, tmp_path / pkg)
        answers[pkg] = s.append_jsonl(blob, len(JSONL_LINES), APP)
        s.close()
        s = log_store(pkg, tmp_path / f"{pkg}_import")
        n = PKG[pkg][2].import_events(
            APP, io.StringIO("\n".join(JSONL_LINES) + "\n"),
            storage=type("S", (), {"events": s}))
        events[pkg] = (n, normalised(s.find(APP)))
        s.close()
    assert answers["port"] == answers["jax"]
    appended, fallback = answers["port"]
    # the engine skips the blank line; the escaped id, the $set line
    # and the form feed go the Python way
    assert appended == 4 and fallback == [2, 5, 7]
    assert events["port"] == events["jax"]
    assert events["port"][0] == 6


RATINGS = [4, 4.5, "3", " 2.5 ", "1e1", "-2", "+3", ".5", "5.", "0x10", "inf",
           "nan", "NaN", "1_000", "٣", "\t4", "4\n", "", None, True, False,
           [1], {"v": 1}, "2.5e", "e5", 1e30, "1e400"]


def grammar_events(E):
    return [E(event_id=f"g{i:03d}", event="rate", entity_type="user",
              entity_id=f"u{i % 4}", target_entity_type="item",
              target_entity_id=f"i{i % 6}",
              properties={} if r is None else {"rating": r},
              event_time=T0 + dt.timedelta(seconds=i),
              creation_time=T0 + dt.timedelta(days=1, seconds=i))
            for i, r in enumerate(RATINGS)]


@pytest.mark.parametrize("backend", ["EVENTLOG", "SQLITE", "MEMORY"])
def test_value_grammar_is_one_on_every_read_path(tmp_path, backend):
    """The JAX package's EVENTLOG scan is the reference; the port's
    native scan, its SQLite columnar scan and its generic two-pass path
    (MEMORY) keep and drop the same ratings."""
    ref = storage("jax", tmp_path / "jax")
    app = ref.meta.create_app("G")
    ref.events.insert_batch(grammar_events(JaxEvent), app.id)
    want = jax_store.read_training_interactions(
        "G", value_key="rating", value_spec={"rate": "prop"}, storage=ref)
    st = storage("port", tmp_path / "port", events=backend)
    app = st.meta.create_app("G")
    st.events.insert_batch(grammar_events(Event), app.id)
    scan, _ = port_store._native_scan(st)
    assert (scan is None) == (backend == "MEMORY")
    got = port_store.read_training_interactions(
        "G", value_key="rating", value_spec={"rate": "prop"}, storage=st)
    for a, b in zip(got.arrays(), want.arrays()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got.user_ids.to_dict() == want.user_ids.to_dict()
    assert got.item_ids.to_dict() == want.item_ids.to_dict()
    kept = np.sort(want.arrays()[2])
    np.testing.assert_array_equal(kept, np.sort(np.float32(
        [4.0, 4.5, 3.0, 2.5, 10.0, -2.0, 3.0, 0.5, 5.0, 1.0, 0.0, 1e30])))
    for s in (ref, st):
        s.events.close()


DUPLICATE_KEY_LINES = [
    # properties: json.loads keeps the last value
    ('{"event":"rate","entityType":"user","entityId":"u1",'
     '"targetEntityType":"item","targetEntityId":"i1",'
     '"properties":{"rating":1,"rating":2},"eventTime":"2026-01-02T03:04:05Z"}',
     {"event": "rate", "entityId": "u1", "properties": {"rating": 2}}),
    # a top-level field
    ('{"event":"rate","event":"buy","entityType":"user","entityId":"u1",'
     '"eventTime":"2026-01-02T03:04:05Z"}',
     {"event": "buy", "entityId": "u1", "properties": {}}),
    # an escaped duplicate of the same key
    ('{"event":"rate","entityType":"user","entityId":"u1",'
     '"properties":{"\\u0072ating":1,"rating":2},"eventTime":"2026-01-02T03:04:05Z"}',
     {"event": "rate", "entityId": "u1", "properties": {"rating": 2}}),
    ('{"event":"rate","entityType":"user","entityId":"old","entityId":"new",'
     '"eventTime":"2026-01-02T03:04:05Z"}',
     {"event": "rate", "entityId": "new", "properties": {}}),
]


@pytest.mark.parametrize("line,last", DUPLICATE_KEY_LINES)
def test_duplicate_json_keys_each_path(tmp_path, line, last):
    """The native ingest declines a line with a duplicate key (the JAX
    package's engine no longer keeps the first), so every path lands
    ``json.loads``' last value."""
    assert {k: json.loads(line).get(k, {}) for k in last} == last
    for pkg in PKG:
        Log, E, ei = PKG[pkg][:3]
        assert {k: E.from_json(json.loads(line)).to_json().get(k, {})
                for k in last} == last
        s = log_store(pkg, tmp_path / pkg)
        assert s.append_jsonl((line + "\n").encode(), 1, APP) == (0, [0])
        assert ei.import_events(APP, io.StringIO(line + "\n"),
                                storage=type("S", (), {"events": s})) == 1
        (got,) = list(s.find(APP))
        assert {k: got.to_json().get(k, {}) for k in last} == last
        if "rating" in line and "targetEntityId" in line:
            assert s.scan_columnar(APP, value_key="rating").values.tolist() == [2.0]
        s.close()


def dump_file(path, n=300):
    with open(path, "w", encoding="utf-8") as f:
        for e in rate_events("port", n, users=17, items=23, names=("rate", "buy")):
            f.write(e.to_json_str() + "\n")
    return str(path)


def cli_run(pkg, home, argv, capsys):
    reg, main = PKG[pkg][4], PKG[pkg][5].main
    reg.set_storage(storage(pkg, home))
    try:
        main([a.format(home=home) for a in argv])
        code = 0
    except SystemExit as e:
        code = e.code
    finally:
        st = reg.get_storage()
        reg.set_storage(None)
        if st.config.eventdata_type == "EVENTLOG" and st._events is not None:
            st._events.close()
    out = capsys.readouterr()
    return code, out.out.replace(str(home), "{home}").splitlines()


def test_import_export_through_both_clis_byte_equal(tmp_path, capsys):
    dump = dump_file(tmp_path / "dump.jsonl")
    exports = {}
    for pkg in PKG:
        home = tmp_path / pkg
        lines = [cli_run(pkg, home, argv, capsys) for argv in (
            ("app", "new", "App1", "--access-key", "K1"),
            ("app", "new", "App2", "--access-key", "K2"),
            ("import", "--app-name", "App1", "--input", dump),
            ("export", "--app-name", "App1", "--output", "{home}/one.jsonl"),
            ("import", "--app-name", "App2", "--input", "{home}/one.jsonl"),
            ("export", "--app-name", "App2", "--output", "{home}/two.jsonl"))]
        with open(home / "one.jsonl", "rb") as f1, open(home / "two.jsonl", "rb") as f2:
            exports[pkg] = (lines, f1.read(), f2.read())
        assert os.path.isdir(home / "eventlog")
        assert not os.path.exists(home / "events.db")
    assert exports["port"] == exports["jax"]
    lines, one, two = exports["port"]
    assert one == two and one.count(b"\n") == 300
    assert [c for c, _ in lines] == [0] * 6
    # the port's export of its import is the file the JAX package exports
    # of the same dump, line for line equal to the input's events
    with open(dump, "rb") as f:
        assert sorted(f.read().splitlines()) == sorted(one.splitlines())


def test_recommendation_trained_from_a_jax_eventlog_home(tmp_path):
    from predictionio_tpu.controller.base import WorkflowContext as JaxCtx
    from predictionio_tpu.core.workflow import run_train as jax_run_train
    from predictionio_tpu.templates.recommendation import engine as jax_rec
    from predictionio_tpu_torch.controller import WorkflowContext
    from predictionio_tpu_torch.core.workflow import RECOMMENDATION_FACTORY, run_train
    from predictionio_tpu_torch.templates.recommendation import engine as port_rec
    from tests.test_workflow import FACTORY, VARIANT, seed_ratings

    home = tmp_path / "home"
    jst = storage("jax", home)
    seed_ratings(jst)
    jid = jax_run_train(FACTORY, variant=VARIANT, storage=jst, use_mesh=False)
    jst.events.close()

    pst = storage("port", home)
    theirs = jax_rec.RecDataSource(jax_rec.DataSourceParams(app_name="TestApp")) \
        .read_training(JaxCtx(storage=storage("jax", home)))
    prev = port_store.set_scan_cache(False)
    try:
        mine = port_rec.RecDataSource(port_rec.DataSourceParams(app_name="TestApp")) \
            .read_training(WorkflowContext(storage=pst))
    finally:
        port_store.set_scan_cache(prev)
    assert mine.n == theirs.n > 0
    for name in ("user_idx", "item_idx", "rating"):
        a, b = getattr(mine, name), getattr(theirs, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert mine.user_ids.to_dict() == theirs.user_ids.to_dict()
    assert mine.item_ids.to_dict() == theirs.item_ids.to_dict()

    pid = run_train(RECOMMENDATION_FACTORY,
                    variant=dict(VARIANT, engineFactory=RECOMMENDATION_FACTORY),
                    storage=pst, device="cpu")
    pst.events.close()
    U, V = {}, {}
    for name, st, algo, iid in (
            ("port", pst, port_rec.ALSAlgorithm(port_rec.ALSAlgorithmParams()), pid),
            ("jax", storage("jax", home),
             jax_rec.ALSAlgorithm(jax_rec.ALSAlgorithmParams()), jid)):
        model = algo.load_model(pickle.loads(st.models.get(iid))[0], None)
        U[name], V[name] = model.U, model.V
    np.testing.assert_allclose(U["port"], U["jax"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(V["port"], V["jax"], rtol=1e-4, atol=1e-4)


def test_universal_grouped_read_matches_jax(tmp_path):
    home = tmp_path / "home"
    jst = storage("jax", home)
    app = jst.meta.create_app("URLog")
    rng = np.random.default_rng(2)
    jst.events.insert_batch([
        JaxEvent(event=["buy", "view", "view", "like"][k % 4], entity_type="user",
                 entity_id=f"u{int(rng.integers(0, 40))}", target_entity_type="item",
                 target_entity_id=f"i{int(rng.integers(0, 30))}",
                 event_time=T0 + dt.timedelta(seconds=k))
        for k in range(1200)], app.id)
    names = ["buy", "view", "like"]
    want = jax_store.read_training_event_groups("URLog", names, storage=jst)
    jst.events.close()
    pst = storage("port", home)
    got = port_store.read_training_event_groups("URLog", names, storage=pst)
    pst.events.close()
    for n in names:
        for a, b in zip(got[0][n], want[0][n]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert got[1].to_dict() == want[1].to_dict()
    assert got[2].to_dict() == want[2].to_dict()
    assert sum(len(got[0][n][0]) for n in names) == 1200


def test_failed_gxx_build_raises(tmp_path, monkeypatch):
    from predictionio_tpu_torch import native

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_cache", {})
    monkeypatch.setenv("PATH", str(tmp_path / "no_bin"))
    with pytest.raises(native.NativeBuildError, match="g\\+\\+"):
        PortLog(str(tmp_path / "log"))
    st = storage("port", tmp_path / "home")
    with pytest.raises(native.NativeBuildError):
        st.events
    assert not os.path.exists(tmp_path / "home" / "events.db")
    # a source g++ refuses: its stderr is in the error
    bad = tmp_path / "src"
    bad.mkdir()
    (bad / "eventlog.cc").write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC_DIR", bad)
    monkeypatch.undo()
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_cache", {})
    monkeypatch.setattr(native, "_SRC_DIR", bad)
    with pytest.raises(native.NativeBuildError, match="g\\+\\+ failed for eventlog.cc"):
        native.eventlog_library()
    assert not list((tmp_path / "build").glob("*.so"))


def test_batch_view_matches_jax(tmp_path):
    """``data/view.BatchView`` over one EVENTLOG home in both packages:
    the same events, folds, groups, counts and pairs."""
    from predictionio_tpu.data.view import BatchView as JaxView
    from predictionio_tpu_torch.data.view import BatchView

    home = tmp_path / "home"
    jst = storage("jax", home)
    app = jst.meta.create_app("ViewApp")
    events = rate_events("jax", 40, names=("rate", "buy"))
    events += [JaxEvent(event_id=f"p{i}", event=ev, entity_type="item",
                        entity_id=f"i{i % 3}", properties=pr,
                        event_time=T0 + dt.timedelta(minutes=5 + i),
                        creation_time=T0 + dt.timedelta(days=2, seconds=i))
               for i, (ev, pr) in enumerate([("$set", {"a": 1}), ("$set", {"b": [2]}),
                                             ("$unset", {"a": None}), ("$delete", {})])]
    jst.events.insert_batch(events, app.id)
    jst.events.close()
    got = {}
    for pkg, View in (("jax", JaxView), ("port", BatchView)):
        st = storage(pkg, home)
        view = View("ViewApp", start_time=T0 + dt.timedelta(seconds=3), storage=st)
        got[pkg] = (
            js(view.events),
            sorted((k, json.dumps(v.properties, sort_keys=True))
                   for k, v in view.aggregate_properties("item").items()),
            {k: js(v) for k, v in view.group_by_entity("user", ["buy"]).items()},
            view.count_by_event(), view.pairs(["rate"]))
        st.events.close()
    assert got["port"] == got["jax"]
    assert got["port"][3] == {"rate": 18, "buy": 19, "$set": 2, "$unset": 1, "$delete": 1}
