"""The port's embedded indexed store (the ELASTICSEARCH backend) held
against the JAX package's, on the CPU.

The first part runs the cases of ``tests/test_indexed.py`` on the port:
term, bool, range and sorted queries, the JSONL WAL with its torn-tail
recovery, the pickled snapshot, doc values, the client, sequences, the
model store, the registry wiring and the indicator search. The second
part holds the two packages together: an index root one package writes
(events, apps, keys, channels, engine and evaluation instances, model
blobs, a WAL tail after a snapshot) the other reads, and twin roots come
out byte-equal; ``ESEventStore.scan_columnar`` is bitwise the JAX
package's and bitwise the port's SQLite scan of the same events; the
snapshot cache reaches the index through its generic probes in both
packages; ``search_similar`` gives the JAX package's hits on one CCO
model's indicators; the registry resolves ``ELASTICSEARCH`` with each
repository on its own source's ``PATH``; the CLI and a Recommendation
train run on an index root the JAX package wrote.

Both scans order by eventTime; ties break by creationTime and id on SQL
and by event id in the index (in both packages), so the SQLite
comparison's ties share a creationTime.
"""

import datetime as dt
import os
import pickle

import numpy as np
import pytest

from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.storage import indexed as jax_ix
from predictionio_tpu.storage import meta as jax_meta
from predictionio_tpu.storage import registry as jax_registry
from predictionio_tpu_torch.data.event import Event, parse_event_time
from predictionio_tpu_torch.data.events import SqliteEventStore
from predictionio_tpu_torch.storage import indexed as port_ix
from predictionio_tpu_torch.storage import meta as port_meta
from predictionio_tpu_torch.storage import registry as port_registry
from predictionio_tpu_torch.storage.indexed import (
    EmbeddedIndex,
    ESEventStore,
    ESMetaStore,
    ESModelStore,
    IndexedStorageClient,
    Sequences,
    index_indicators,
    search_similar,
)
from tests.test_torch_eventlog import cols_tuple
from tests.test_torch_snapshot import _St, outcome

IX = {"jax": jax_ix, "port": port_ix}
EV = {"jax": JaxEvent, "port": Event}
META = {"jax": jax_meta, "port": port_meta}
REG = {"jax": jax_registry, "port": port_registry}
T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
APP = 3


# -- the cases of tests/test_indexed.py, on the port ----------------------------


class TestEmbeddedIndex:
    def test_term_and_bool_queries(self):
        idx = EmbeddedIndex()
        idx.index("a", {"kind": "x", "tags": ["t1", "t2"], "n": 1})
        idx.index("b", {"kind": "x", "tags": ["t2"], "n": 5})
        idx.index("c", {"kind": "y", "tags": ["t1"], "n": 9})
        hits = idx.search(must=[("kind", "x"), ("tags", "t2")])
        assert {h[0] for h in hits} == {"a", "b"}
        hits = idx.search(must_any=[("tags", ["t1"])])
        assert {h[0] for h in hits} == {"a", "c"}
        hits = idx.search(ranges=[("n", 1, 9)])  # lo inclusive, hi exclusive
        assert {h[0] for h in hits} == {"a", "b"}
        hits = idx.search(should=[("tags", "t1", 2.0), ("tags", "t2", 1.0)])
        assert [h[0] for h in hits] == ["a", "c", "b"]
        assert hits[0][1] == 3.0

    def test_upsert_and_delete_update_postings(self):
        idx = EmbeddedIndex()
        idx.index("a", {"kind": "x"})
        idx.index("a", {"kind": "y"})
        assert idx.search(must=[("kind", "x")]) == []
        assert [h[0] for h in idx.search(must=[("kind", "y")])] == ["a"]
        assert idx.delete("a") and not idx.delete("a")
        assert idx.search() == []

    def test_sort_by_field(self):
        idx = EmbeddedIndex()
        for i, t in enumerate([3.0, 1.0, 2.0]):
            idx.index(f"d{i}", {"t": t})
        assert [h[0] for h in idx.search(sort="t")] == ["d1", "d2", "d0"]
        assert [h[0] for h in idx.search(sort="t", reverse=True)] == ["d0", "d2", "d1"]
        assert [h[0] for h in idx.search(sort="t", size=2)] == ["d1", "d2"]


class TestDurability:
    def test_wal_replay(self, tmp_path):
        p = str(tmp_path / "i.jsonl")
        idx = EmbeddedIndex(p)
        idx.index("a", {"k": "v"})
        idx.index("b", {"k": "w"})
        idx.delete("a")
        idx.close()
        idx2 = EmbeddedIndex(p)
        assert idx2.get("a") is None and idx2.get("b") == {"k": "w"}
        assert [h[0] for h in idx2.search(must=[("k", "w")])] == ["b"]

    def test_batch_with_bad_doc_is_atomic(self, tmp_path):
        p = str(tmp_path / "i.jsonl")
        idx = EmbeddedIndex(p)
        idx.index("keep", {"k": "v"})
        with pytest.raises(TypeError):
            idx.index_batch([("a", {"k": "1"}), ("bad", {"k": object()}),
                             ("b", {"k": "2"})])
        assert idx.get("a") is None and idx.get("b") is None
        with pytest.raises(TypeError):
            idx.index("solo", {"k": object()})
        assert idx.get("solo") is None
        idx.close()
        idx2 = EmbeddedIndex(p)
        assert idx2.get("keep") == {"k": "v"}
        assert idx2.get("a") is None and idx2.get("b") is None

    def test_torn_tail_recovery(self, tmp_path):
        p = str(tmp_path / "i.jsonl")
        idx = EmbeddedIndex(p)
        idx.index("a", {"k": "v"})
        idx.close()
        with open(p, "a") as f:
            f.write('{"op":"index","id":"b","doc":{"k"')  # a crash mid-append
        idx2 = EmbeddedIndex(p)
        assert idx2.get("a") == {"k": "v"} and idx2.get("b") is None

    def test_writes_after_torn_tail_survive_restart(self, tmp_path):
        p = str(tmp_path / "i.jsonl")
        idx = EmbeddedIndex(p)
        idx.index("a", {"k": "v"})
        idx.close()
        with open(p, "a") as f:
            f.write('{"op":"index","id":"b","doc":{"k')
        idx2 = EmbeddedIndex(p)
        idx2.index("c", {"k": "w"})
        idx2.index("d", {"k": "x"})
        idx2.close()
        idx3 = EmbeddedIndex(p)
        assert (idx3.get("a"), idx3.get("c"), idx3.get("d")) == (
            {"k": "v"}, {"k": "w"}, {"k": "x"})

    def test_closed_index_rejects_writes(self, tmp_path):
        idx = EmbeddedIndex(str(tmp_path / "i.jsonl"))
        idx.index("a", {"k": "v"})
        idx.close()
        with pytest.raises(ValueError):
            idx.index("b", {"k": "w"})
        with pytest.raises(ValueError):
            idx.delete("a")

    def test_compaction_bounds_log(self, tmp_path):
        p = str(tmp_path / "i.jsonl")
        idx = EmbeddedIndex(p)
        for _ in range(600):
            idx.index("a", {"k": "v"})
        idx.close()
        assert sum(1 for _ in open(p)) < 600
        assert EmbeddedIndex(p).get("a") == {"k": "v"}


class TestSnapshotRestart:
    def test_clean_close_truncates_wal(self, tmp_path):
        p = str(tmp_path / "i.jsonl")
        idx = EmbeddedIndex(p)
        idx.index_batch([(f"d{i}", {"k": i}) for i in range(500)])
        idx.close()
        assert os.path.exists(p + ".snap") and os.path.getsize(p) == 0
        idx2 = EmbeddedIndex(p)
        assert len(idx2) == 500 and idx2.get("d42") == {"k": 42}
        assert [h[0] for h in idx2.search(must=[("k", 7)])] == ["d7"]
        idx2.close()

    def test_wal_tail_replays_on_top_of_snapshot(self, tmp_path):
        p = str(tmp_path / "i.jsonl")
        idx = EmbeddedIndex(p)
        idx.index("a", {"k": "v"})
        idx.close()
        idx2 = EmbeddedIndex(p)
        idx2.index("b", {"k": "w"})
        idx2.delete("a")
        idx2._wal.close()  # a crash: no clean close
        idx2._wal = None
        idx3 = EmbeddedIndex(p)
        assert idx3.get("a") is None and idx3.get("b") == {"k": "w"}

    def test_corrupt_snapshot_recovers_from_wal(self, tmp_path):
        p = str(tmp_path / "i.jsonl")
        idx = EmbeddedIndex(p)
        idx.index("a", {"k": "v"})
        idx._wal.close()
        idx._wal = None
        with open(p + ".snap", "wb") as f:
            f.write(b"\x80garbage")
        with pytest.warns(RuntimeWarning, match="unreadable"):
            idx2 = EmbeddedIndex(p)
        assert idx2.get("a") == {"k": "v"}

    def test_crash_between_snapshot_and_truncate_is_idempotent(self, tmp_path):
        p = str(tmp_path / "i.jsonl")
        idx = EmbeddedIndex(p)
        idx.index("a", {"k": 1})
        idx.index("b", {"k": 2})
        idx.delete("a")
        idx._write_snapshot()  # the WAL is not truncated
        idx._wal.close()
        idx._wal = None
        idx2 = EmbeddedIndex(p)
        assert idx2.get("a") is None and idx2.get("b") == {"k": 2} and len(idx2) == 1


class TestDocValuesFastPaths:
    def _big_index(self):
        rng = np.random.default_rng(0)
        idx = EmbeddedIndex()
        docs = [(f"d{i}", {"ev": ["x", "y", "z"][i % 3],
                           "t": float(rng.integers(0, 1000)), "u": int(i % 50)})
                for i in range(6000)]
        idx.index_batch(docs)
        return idx, dict(docs)

    def test_range_parity(self):
        idx, docs = self._big_index()
        got = {h[0] for h in idx.search(ranges=[("t", 100.0, 300.0)])}
        assert got == {i for i, d in docs.items() if 100.0 <= d["t"] < 300.0}
        got = {h[0] for h in idx.search(must=[("ev", "x")], ranges=[("t", None, 500.0)])}
        assert got == {i for i, d in docs.items() if d["ev"] == "x" and d["t"] < 500.0}

    def test_sorted_truncation_parity(self):
        import heapq

        idx, docs = self._big_index()
        for reverse in (False, True):
            got = [h[0] for h in idx.search(must=[("ev", "y")], sort="t",
                                            reverse=reverse, size=40)]
            matches = [i for i, d in docs.items() if d["ev"] == "y"]
            pick = heapq.nlargest if reverse else heapq.nsmallest
            assert got == pick(40, matches, key=lambda i: (docs[i]["t"], i))

    def test_size_zero_is_empty_on_every_path(self):
        idx, _ = self._big_index()
        assert idx.search(must=[("ev", "x")], sort="t", size=0) == []
        assert idx.search(must=[("u", 3)], sort="t", size=0) == []
        assert idx.search(should=[("ev", "x", 1.0)], size=0) == []

    def test_sorted_truncation_missing_field_falls_back(self):
        idx = EmbeddedIndex()
        idx.index_batch([(f"d{i}", {"ev": "x", "t": float(i)}) for i in range(1000)])
        idx.index("odd", {"ev": "x"})  # no "t": partial coverage
        got = [h[0] for h in idx.search(must=[("ev", "x")], sort="t", reverse=True,
                                        size=5)]
        assert got == ["d999", "d998", "d997", "d996", "d995"]
        assert [h[0] for h in idx.search(must=[("ev", "x")], sort="t", size=3)] == \
            ["odd", "d0", "d1"]


class TestClientAndSequences:
    def test_sequences_monotonic_and_durable(self, tmp_path):
        c = IndexedStorageClient(str(tmp_path / "es"))
        s = Sequences(c)
        assert [s.next("x") for _ in range(3)] == [1, 2, 3]
        assert s.next("y") == 1
        c.close()
        assert Sequences(IndexedStorageClient(str(tmp_path / "es"))).next("x") == 4

    def test_sequences_survive_sibling_store_close(self, tmp_path):
        root = str(tmp_path / "es")
        c = IndexedStorageClient(root)
        meta = ESMetaStore(c)
        one = meta.create_app("one")
        c.close()  # the event store sharing this client shut down
        two = meta.create_app("two")
        assert two.id == one.id + 1
        meta2 = ESMetaStore(IndexedStorageClient(root))
        three = meta2.create_app("three")
        assert three.id == two.id + 1 and meta2.get_app(two.id).name == "two"

    def test_drop_and_list(self, tmp_path):
        c = IndexedStorageClient(str(tmp_path / "es"))
        c.index("one").index("a", {"x": 1})
        c.index("two").index("b", {"x": 2})
        assert c.list_indices() == ["one", "two"]
        c.drop("one")
        assert c.list_indices() == ["two"] and c.index("one").get("a") is None

    def test_model_store(self, tmp_path):
        st = ESModelStore(IndexedStorageClient(str(tmp_path / "es")))
        st.put("i1", b"\x00\x01\xff")
        st.put("i1", b"\x02")
        assert st.get("i1") == b"\x02" and st.list_ids() == ["i1"]
        assert st.delete("i1") and st.get("i1") is None


class TestRegistryWiring:
    def test_elasticsearch_type_backs_all_repos(self, tmp_path):
        cfg = port_registry.StorageConfig.from_env({
            "PIO_HOME": str(tmp_path),
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "ES",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "ES",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "ES",
            "PIO_STORAGE_SOURCES_ES_TYPE": "ELASTICSEARCH",
        })
        st = port_registry.Storage(cfg)
        assert st.verify() == {"metadata": "ELASTICSEARCH", "eventdata": "ELASTICSEARCH",
                               "modeldata": "ELASTICSEARCH"}
        app = st.meta.create_app("esapp")
        eid = st.events.insert(Event(event="rate", entity_type="user", entity_id="u",
                                     event_time=parse_event_time("2026-01-01T00:00:00Z")),
                               app.id)
        assert st.events.get(eid, app.id) is not None
        st.models.put(st.meta.new_instance_id(), b"blob")
        # the default root is <home>/es_index
        assert os.path.isdir(tmp_path / "es_index")


class TestIndicatorSearch:
    def test_reference_shaped_similarity_query(self, tmp_path):
        from predictionio_tpu_torch.utils.bimap import BiMap

        item_ids = BiMap.string_int(iter(["i0", "i1", "i2"]))
        idxs = np.array([[1, 2], [0, 2], [0, 1]], np.int32)
        vals = np.array([[1.0, -np.inf], [2.0, 3.0], [-np.inf, 4.0]], np.float32)
        c = IndexedStorageClient(str(tmp_path / "es"))
        idx = index_indicators(c, "ur_indicators", {"buy": (idxs, vals)}, item_ids)
        assert idx.get("i1")["buy"] == ["i0", "i2"]
        # only i1's list holds i0 (i2's i0 is below the threshold)
        assert [h[0] for h in search_similar(idx, {"buy": ["i0"]}, num=5)] == ["i1"]


# -- across the packages -----------------------------------------------------------


def events(pkg, n, start=0, tied=False):
    """``n`` rate/buy/view events with their own ids and times. ``tied``:
    every third pair shares an eventTime (and a creationTime)."""
    E = EV[pkg]
    out = []
    for j in range(start, start + n):
        sec = (j // 2) * 2 if tied and j % 3 == 0 else j
        out.append(E(event_id=f"e{j:05d}", event=("rate", "buy", "view")[j % 3],
                     entity_type="user", entity_id=f"u{j * 7 % 11}",
                     target_entity_type="item", target_entity_id=f"i{j * 5 % 13}",
                     properties={"rating": float(j % 5 + 1)} if j % 4 else {},
                     tags=["t"] if j % 6 == 0 else [],
                     event_time=T0 + dt.timedelta(seconds=sec, microseconds=j % 7),
                     creation_time=T0 + dt.timedelta(days=1, seconds=sec)))
    return out


def es_storage(pkg, root, home):
    reg = REG[pkg]
    return reg.Storage(reg.StorageConfig.from_env({
        "PIO_HOME": str(home),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "ES",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "ES",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "ES",
        "PIO_STORAGE_SOURCES_ES_TYPE": "ELASTICSEARCH",
        "PIO_STORAGE_SOURCES_ES_PATH": str(root),
    }))


def write_root(pkg, root):
    """One script of writes into an index root: a snapshot (clean close),
    then a WAL tail on top of it. Returns what a reader must find."""
    ix, M = IX[pkg], META[pkg]
    c = ix.IndexedStorageClient(str(root))
    meta, ev, models = ix.ESMetaStore(c), ix.ESEventStore(c), ix.ESModelStore(c)
    app = meta.create_app("App1", "first")
    key = meta.create_access_key(app.id, events=["rate"], key="K" * 64)
    ch = meta.create_channel(app.id, "backtest")
    ev.insert_batch(events(pkg, 40), app.id)
    ev.insert_batch(events(pkg, 5, start=100), app.id, ch.id)
    t = T0 + dt.timedelta(hours=1)
    ei = M.EngineInstance(
        id="20260101000000-00000001", status="COMPLETED", start_time=t, end_time=t,
        engine_factory="m:f", engine_variant="v", batch="b", env={"A": "1"},
        mesh_conf={"devices": 1}, data_source_params="{}", preparator_params="{}",
        algorithms_params="[]", serving_params="{}")
    meta.insert_engine_instance(ei)
    models.put(ei.id, bytes(range(256)) * 3)
    c.close()  # snapshot every index, truncate every WAL
    c = ix.IndexedStorageClient(str(root))
    meta, ev, models = ix.ESMetaStore(c), ix.ESEventStore(c), ix.ESModelStore(c)
    app2 = meta.create_app("App2")
    ev.insert_batch(events(pkg, 10, start=40), app.id)
    ev.delete("e00003", app.id)
    vi = M.EvaluationInstance(
        id="ev-1", status="EVALCOMPLETED", start_time=t, end_time=t,
        evaluation_class="m:E", engine_params_generator_class="m:G", batch="",
        env={}, evaluator_results="r", evaluator_results_html="<p>",
        evaluator_results_json="{}")
    meta.insert_evaluation_instance(vi)
    models.put("second", b"\x00\xff")
    # no close: the WAL tail stays on top of the snapshots
    return {"apps": [(app.id, "App1", "first"), (app2.id, "App2", "")],
            "key": (key.key, app.id, ["rate"]), "channel": (ch.id, "backtest", app.id),
            "app_id": app.id, "channel_id": ch.id, "ei": ei, "vi": vi}


def read_root(pkg, root, want):
    ix = IX[pkg]
    c = ix.IndexedStorageClient(str(root))
    meta, ev, models = ix.ESMetaStore(c), ix.ESEventStore(c), ix.ESModelStore(c)
    assert [(a.id, a.name, a.description) for a in meta.list_apps()] == want["apps"]
    k = meta.get_access_key(want["key"][0])
    assert (k.key, k.app_id, k.events) == want["key"]
    ch = meta.get_channel_by_name(want["app_id"], "backtest")
    assert (ch.id, ch.name, ch.app_id) == want["channel"]
    got = meta.get_latest_completed_engine_instance("m:f", "v")
    assert got is not None and vars(got) == vars(want["ei"])
    assert vars(meta.get_evaluation_instance("ev-1")) == vars(want["vi"])
    assert models.get(want["ei"].id) == bytes(range(256)) * 3
    assert models.list_ids() == sorted([want["ei"].id, "second"])
    found = [e.to_json() for e in ev.find(want["app_id"])]
    chan = [e.to_json() for e in ev.find(want["app_id"], want["channel_id"])]
    # the ids continue where the writer's left off
    assert meta.create_app("App3").id == want["apps"][-1][0] + 1
    c.close()
    return found, chan


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_an_index_root_one_package_wrote_the_other_reads(tmp_path, writer, reader):
    want = write_root(writer, tmp_path / "es")
    found, chan = read_root(reader, tmp_path / "es", want)
    ids = [e["eventId"] for e in found]
    assert len(found) == 49 and "e00003" not in ids and len(chan) == 5
    expect = [e.to_json() for e in sorted(
        (e for e in events(writer, 50) if e.event_id != "e00003"),
        key=lambda e: (e.event_time.timestamp(), e.event_id))]
    assert found == expect


def test_twin_roots_are_byte_equal(tmp_path):
    for pkg in IX:
        write_root(pkg, tmp_path / pkg)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert "pio_event_1.jsonl" in names and "pio_event_1.jsonl.snap" in names
    for name in names:
        a = (tmp_path / "jax" / name).read_bytes()
        b = (tmp_path / "port" / name).read_bytes()
        if name.endswith(".snap"):
            assert pickle.loads(a) == pickle.loads(b), name
        else:
            assert a == b, name


SCANS = ({}, {"value_key": "rating"}, {"event_names": ["buy", "rate"]},
         {"entity_type": "user", "target_entity_type": "item", "value_key": "rating"},
         {"start_time": T0 + dt.timedelta(seconds=5),
          "until_time": T0 + dt.timedelta(seconds=30), "value_key": "rating"})


@pytest.mark.parametrize("tied", [False, True])
def test_es_scan_columnar_is_bitwise_jax_and_sqlite(tmp_path, tied):
    stores = {pkg: IX[pkg].ESEventStore(IX[pkg].IndexedStorageClient(str(tmp_path / pkg)))
              for pkg in IX}
    sql = SqliteEventStore(str(tmp_path / "events.db"))
    for pkg, s in list(stores.items()) + [("port", sql)]:
        s.insert_batch(events(pkg, 120, tied=tied), APP)
        s.insert_batch([EV[pkg](event_id="notarget", event="rate", entity_type="user",
                                entity_id="u9", properties={"rating": 3},
                                event_time=T0, creation_time=T0)], APP)
    c0 = int((T0 + dt.timedelta(days=1)).timestamp() * 1_000_000)
    windows = ({"created_after_us": c0 + 10_000_000, "created_until_us": c0 + 80_000_000},)
    for kw in SCANS + windows:
        port = cols_tuple(stores["port"].scan_columnar(APP, **kw))
        assert port == cols_tuple(stores["jax"].scan_columnar(APP, **kw)), kw
        assert port == cols_tuple(sql.scan_columnar(APP, **kw)), kw
    for until in (None, c0 + 50_000_000, 0):
        assert stores["port"].creation_stats(APP, until_us=until) == \
            stores["jax"].creation_stats(APP, until_us=until)
    assert stores["port"].creation_stats(APP, until_us=c0 + 50_000_000) == \
        sql.creation_stats(APP, until_us=c0 + 50_000_000)
    assert stores["port"].creation_stats(99) == (0, None)
    assert stores["port"].cache_identity == "es:" + os.path.abspath(tmp_path / "port")
    assert ESEventStore(IndexedStorageClient()).cache_identity is None


def test_times_come_from_event_time_us_and_round_without_it(tmp_path):
    """Documents written before ``eventTimeUs`` existed carry float seconds
    only: their times round (``int`` would land 1 µs low for ~1% of
    values), and ``creation_stats`` declines so that the cache skips them."""
    times = [T0 + dt.timedelta(microseconds=int(x)) for x in
             np.random.default_rng(3).integers(0, 10**12, 200)]
    out = {}
    for pkg in IX:
        s = IX[pkg].ESEventStore(IX[pkg].IndexedStorageClient(str(tmp_path / pkg)))
        s.insert_batch([EV[pkg](event_id=f"x{j:03d}", event="rate", entity_type="user",
                                entity_id="u", target_entity_type="item",
                                target_entity_id=f"i{j}", event_time=t,
                                creation_time=T0) for j, t in enumerate(times)], APP)
        exact = s.scan_columnar(APP).times_us
        idx = s._idx(APP, None)
        for doc_id, _, doc in idx.search():
            doc.pop("eventTimeUs")
            doc.pop("creationTimeUs")
            idx.index(doc_id, doc)
        legacy = s.scan_columnar(APP).times_us
        out[pkg] = (exact.tobytes(), legacy.tobytes(), s.creation_stats(APP))
    want = np.array([round(t.timestamp() * 1e6) for t in sorted(times)], np.int64)
    assert out["port"] == out["jax"]
    assert out["port"][1] == want.tobytes() and out["port"][2] is None
    assert out["port"][0] == np.sort(np.array(
        [(t - dt.datetime(1970, 1, 1, tzinfo=dt.timezone.utc))
         // dt.timedelta(microseconds=1) for t in times], np.int64)).tobytes()


def test_snapshot_cache_reaches_the_index_in_both_packages(tmp_path, monkeypatch):
    from predictionio_tpu.data import store as jax_store
    from predictionio_tpu_torch.data import store as port_store

    monkeypatch.setenv("PIO_SCAN_CACHE_DIR", str(tmp_path / "scan_cache"))
    mods = {"jax": jax_store, "port": port_store}
    for m in mods.values():
        monkeypatch.setattr(m, "_scan_cache_override", None)
    seen = {}
    for pkg in ("port", "jax"):  # the JAX package reads the port's snapshot
        c = IX[pkg].IndexedStorageClient(str(tmp_path / "es"))
        s = IX[pkg].ESEventStore(c)
        if pkg == "port":
            s.insert_batch(events(pkg, 60), APP)

        def cached():
            return mods[pkg]._cached_scan(s.scan_columnar, _St(s), APP, None, None,
                                          None, None, "rating")

        def step():
            name, cols = outcome(pkg, cached)
            assert cols_tuple(cols) == cols_tuple(s.scan_columnar(APP, value_key="rating"))
            return name

        seen[pkg] = [step()]
        s.insert_batch(events(pkg, 20, start=60 if pkg == "port" else 80), APP)
        seen[pkg] += [step(), step()]
        c.close()
    assert seen == {"port": ["miss:cold", "hit:delta", "hit"],
                    "jax": ["hit", "hit:delta", "hit"]}


def test_search_similar_gives_jax_hits_on_a_cco_model(tmp_path):
    from predictionio_tpu.utils.bimap import BiMap as JaxBiMap
    from predictionio_tpu_torch.models.cco import CCOParams, cco_indicators
    from predictionio_tpu_torch.utils.bimap import BiMap

    rng = np.random.default_rng(5)
    n_users, n_items = 60, 40
    buy = (rng.integers(0, n_users, 400), rng.integers(0, n_items, 400))
    view = (rng.integers(0, n_users, 900), rng.integers(0, n_items, 900))
    indicators = cco_indicators(buy, {"buy": buy, "view": view}, n_users, n_items,
                                {"buy": n_items, "view": n_items},
                                CCOParams(max_indicators_per_item=8), device="cpu")
    keys = [f"i{j}" for j in range(n_items)]
    idx = {"port": index_indicators(IndexedStorageClient(str(tmp_path / "p")), "ur",
                                    indicators, BiMap.string_int(iter(keys))),
           "jax": jax_ix.index_indicators(jax_ix.IndexedStorageClient(str(tmp_path / "j")),
                                          "ur", indicators, JaxBiMap.string_int(iter(keys)))}
    for k in keys:
        assert idx["port"].get(k) == idx["jax"].get(k)
    for q in range(25):
        hist = {"buy": [keys[j] for j in rng.choice(n_items, 3, replace=False)],
                "view": [keys[j] for j in rng.choice(n_items, 5, replace=False)]}
        boosts = {"buy": 1.0, "view": float(q % 3) + 0.5}
        port = search_similar(idx["port"], hist, 10, boosts)
        assert port and port == jax_ix.search_similar(idx["jax"], hist, 10, boosts)


def test_each_repository_reads_its_own_source_path(tmp_path):
    env = {"PIO_HOME": str(tmp_path / "home"),
           "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "ESMETA",
           "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "ES_EVENTS",
           "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "ESMETA",
           "PIO_STORAGE_SOURCES_ESMETA_TYPE": "elasticsearch",
           "PIO_STORAGE_SOURCES_ESMETA_PATH": str(tmp_path / "meta_root"),
           "PIO_STORAGE_SOURCES_ES_EVENTS_TYPE": "ELASTICSEARCH",
           "PIO_STORAGE_SOURCES_ES_EVENTS_PATH": str(tmp_path / "event_root")}
    cfg = port_registry.StorageConfig.from_env(env)
    assert cfg.source_properties("EVENTDATA") == {
        "TYPE": "ELASTICSEARCH", "PATH": str(tmp_path / "event_root")}
    assert (cfg.metadata_type, cfg.eventdata_type, cfg.modeldata_type) == \
        ("ELASTICSEARCH",) * 3
    st = port_registry.Storage(cfg)
    app = st.meta.create_app("A")
    st.events.insert_batch(events("port", 3), app.id)
    st.models.put("m", b"x")
    assert sorted(os.listdir(tmp_path / "meta_root")) == [
        "pio_apps.jsonl", "pio_models.jsonl", "pio_sequences.jsonl"]
    assert os.listdir(tmp_path / "event_root") == ["pio_event_1.jsonl"]
    assert st.meta is not None and st.events._c is not st.meta._c
    # repositories on one root share one client
    assert port_registry.Storage(cfg).meta._c is st.meta._c
    with pytest.raises(KeyError, match="unknown EVENTDATA backend 'NOPE'"):
        _ = port_registry.Storage(port_registry.StorageConfig(eventdata_type="NOPE")).events


def test_cli_and_a_train_on_a_root_the_jax_package_wrote(tmp_path, capsys):
    """The JAX package writes an index root through its own registry; the
    port's CLI reads it (``status``, ``app list``, ``export``, byte-equal
    to the JAX CLI's export), imports into it, and trains the
    Recommendation template from it, factor for factor the train of the
    same events from SQLite."""
    from predictionio_tpu.tools import cli as jax_cli
    from predictionio_tpu_torch.core.workflow import RECOMMENDATION_FACTORY, run_train
    from predictionio_tpu_torch.tools import cli as port_cli

    root, home = tmp_path / "es", tmp_path / "home"
    jst = es_storage("jax", root, home)
    app = jst.meta.create_app("EsApp")
    jst.meta.create_access_key(app.id, key="k" * 64)
    jst.events.insert_batch(events("jax", 300), app.id)
    exported = {}
    for pkg, reg, cli in (("jax", jax_registry, jax_cli), ("port", port_registry, port_cli)):
        st = jst if pkg == "jax" else es_storage("port", root, home)
        reg.set_storage(st)
        try:
            cli.main(["export", "--app-name", "EsApp", "--output", str(tmp_path / pkg)])
            if pkg == "port":
                cli.main(["status", "--device", "cpu"])
                cli.main(["app", "list"])
                cli.main(["app", "new", "Copy"])
                cli.main(["import", "--app-name", "Copy", "--input", str(tmp_path / pkg)])
                cli.main(["export", "--app-name", "Copy", "--output", str(tmp_path / "c")])
        finally:
            reg.set_storage(None)
        exported[pkg] = (tmp_path / pkg).read_bytes()
    out = capsys.readouterr().out
    assert exported["port"] == exported["jax"] and exported["port"].count(b"\n") == 300
    assert sorted((tmp_path / "c").read_bytes().splitlines()) == \
        sorted(exported["port"].splitlines())
    for repo in ("metadata", "eventdata", "modeldata"):
        assert f"[info] {repo}: ELASTICSEARCH (ok)" in out
    assert "EsApp" in out and "Copy" in out

    variant = {"id": "default", "engineFactory": RECOMMENDATION_FACTORY,
               "datasource": {"params": {"appName": "EsApp"}},
               "algorithms": [{"name": "als", "params": {
                   "rank": 4, "numIterations": 3, "lambda": 0.05, "seed": 1}}]}
    pst = es_storage("port", root, home)
    sql = port_registry.Storage(port_registry.StorageConfig(home=str(tmp_path / "sql")))
    sql.meta.create_app("EsApp")
    sql.events.insert_batch(events("port", 300), 1)
    trained = {}
    for name, st in (("es", pst), ("sqlite", sql)):
        iid = run_train(RECOMMENDATION_FACTORY, variant=variant, storage=st, device="cpu")
        assert st.meta.get_engine_instance(iid).status == "COMPLETED"
        trained[name] = pickle.loads(st.models.get(iid))
    assert trained["es"] == trained["sqlite"]


def test_get_storage_opens_elasticsearch_from_the_environment(tmp_path, monkeypatch):
    for k, v in {"PIO_HOME": str(tmp_path / "home"),
                 "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "ES",
                 "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "ES",
                 "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "ES",
                 "PIO_STORAGE_SOURCES_ES_TYPE": "ELASTICSEARCH",
                 "PIO_STORAGE_SOURCES_ES_PATH": str(tmp_path / "es")}.items():
        monkeypatch.setenv(k, v)
    port_registry.set_storage(None)
    try:
        st = port_registry.get_storage()
        assert (type(st.meta), type(st.events), type(st.models)) == \
            (ESMetaStore, ESEventStore, ESModelStore)
        app = st.meta.create_app("Env")
        st.events.insert_batch(events("port", 4), app.id)
        assert len(list(st.events.find(app.id))) == 4
        assert sorted(os.listdir(tmp_path / "es")) == [
            "pio_apps.jsonl", "pio_event_1.jsonl", "pio_sequences.jsonl"]
        assert not (tmp_path / "home").exists()
    finally:
        port_registry.set_storage(None)
