"""The port's columnar snapshot cache and SQLite columnar scan held
against the JAX package's, on the CPU.

On twin stores (EVENTLOG and SQLite), one script of writes and cached
reads gives the same sequence of cache outcomes in both packages —
``miss:cold``, ``hit``, ``hit:delta``, ``miss:mutated``,
``miss:out_of_order``, ``miss:unsupported`` and ``bypassed`` — and after
each read the same arrays, bitwise, equal to an uncached scan. A snapshot
written by one package is a ``hit`` for the other (same npz, manifest and
key). ``run_train(scan_cache=False)`` and ``train --no-scan-cache``
read without the cache and restore the process setting. The port's
SQLite ``scan_columnar``, ``creation_stats`` and ``cache_identity`` are
the JAX package's on the same database.
"""

import datetime as dt
import os

import pytest

from predictionio_tpu.data import snapshot as jax_snap
from predictionio_tpu.data import store as jax_store
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.events import SqliteEventStore as JaxSqlite
from predictionio_tpu_torch.data import snapshot as port_snap
from predictionio_tpu_torch.data import store as port_store
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.events import SqliteEventStore as PortSqlite
from tests.test_torch_eventlog import PKG, T0, cols_tuple, log_store, storage

APP = 7
STORE = {"jax": jax_store, "port": port_store}
SNAP = {"jax": jax_snap, "port": port_snap}
SQLITE = {"jax": JaxSqlite, "port": PortSqlite}


def ev(pkg, i, name="rate", sec=None):
    E = PKG[pkg][1]
    sec = i if sec is None else sec
    return E(event_id=f"s{i:04d}", event=name, entity_type="user",
             entity_id=f"u{i % 5}", target_entity_type="item",
             target_entity_id=f"i{i % 7}", properties={"rating": float(i % 5)},
             event_time=T0 + dt.timedelta(seconds=sec),
             creation_time=T0 + dt.timedelta(days=1, seconds=i))


def open_store(pkg, backend, directory):
    if backend == "eventlog":
        return log_store(pkg, directory / "eventlog")
    os.makedirs(directory, exist_ok=True)
    return SQLITE[pkg](str(directory / "events.db"))


class _St:
    """The part of Storage the cache layer touches."""

    def __init__(self, events):
        self.events = events


class _NoStats:
    """A store that cannot answer the watermark probe."""

    cache_identity = None

    def __init__(self, inner):
        self.inner = inner

    def creation_stats(self, *a, **kw):
        return None

    def scan_columnar(self, *a, **kw):
        return self.inner.scan_columnar(*a, **kw)


def outcome(pkg, read):
    """Run one cached read; name its outcome from the package's metrics."""
    m = STORE[pkg]
    hits = m._SNAP_HITS._values.get((), 0.0)
    delta = m._SNAP_DELTA_ROWS._values.get((), 0.0)
    misses = dict(m._SNAP_MISSES._values)
    cols = read()
    if m._SNAP_HITS._values.get((), 0.0) > hits:
        name = "hit:delta" if m._SNAP_DELTA_ROWS._values.get((), 0.0) > delta else "hit"
    else:
        grew = [k[0] for k, v in m._SNAP_MISSES._values.items() if v > misses.get(k, 0.0)]
        name = f"miss:{grew[0]}" if grew else "bypassed"
    return name, cols


def cache_script(pkg, backend, directory, monkeypatch):
    monkeypatch.setenv("PIO_SCAN_CACHE_DIR", str(directory / "scan_cache"))
    m = STORE[pkg]
    monkeypatch.setattr(m, "_scan_cache_override", None)
    s = open_store(pkg, backend, directory)

    def cached(store=s, names=None):
        return m._cached_scan(store.scan_columnar, _St(store), APP, None, None,
                              None, names, "rating")

    def step(read, plain=True):
        name, cols = outcome(pkg, read)
        if plain:
            assert cols_tuple(cols) == cols_tuple(
                s.scan_columnar(APP, value_key="rating"))
        return name, cols_tuple(cols)

    out = []
    s.insert_batch([ev(pkg, i) for i in range(20)], APP)
    out.append(step(cached))                                    # miss:cold
    out.append(step(cached))                                    # hit
    s.insert_batch([ev(pkg, i) for i in range(20, 26)], APP)
    out.append(step(cached))                                    # hit:delta
    s.delete("s0003", APP)
    out.append(step(cached))                                    # miss:mutated
    s.insert(ev(pkg, 90, sec=-50), APP)
    out.append(step(cached))                                    # miss:out_of_order
    out.append(step(lambda: cached(_NoStats(s))))               # miss:unsupported
    out.append(step(lambda: m._scan_with_cache(
        s.scan_columnar, _St(s), APP, None, T0 + dt.timedelta(seconds=4), None,
        None, None, None, "rating"), plain=False))              # bypassed
    prev = m.set_scan_cache(False)
    try:
        out.append(step(lambda: m._scan_with_cache(
            s.scan_columnar, _St(s), APP, None, None, None, None, None, None,
            "rating")))                                         # bypassed
    finally:
        m.set_scan_cache(prev)
    s.close()
    return out


@pytest.mark.parametrize("backend", ["eventlog", "sqlite"])
def test_cache_outcomes_match_jax(tmp_path, monkeypatch, backend):
    got = {pkg: cache_script(pkg, backend, tmp_path / pkg, monkeypatch) for pkg in PKG}
    assert [name for name, _ in got["port"]] == [
        "miss:cold", "hit", "hit:delta", "miss:mutated", "miss:out_of_order",
        "miss:unsupported", "bypassed", "bypassed"]
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("backend", ["eventlog", "sqlite"])
def test_a_snapshot_one_package_wrote_is_a_hit_for_the_other(
        tmp_path, monkeypatch, backend, writer, reader):
    monkeypatch.setenv("PIO_SCAN_CACHE_DIR", str(tmp_path / "scan_cache"))
    for m in STORE.values():
        monkeypatch.setattr(m, "_scan_cache_override", None)
    w = open_store(writer, backend, tmp_path)
    w.insert_batch([ev(writer, i) for i in range(30)], APP)

    def cached(pkg, s):
        return outcome(pkg, lambda: STORE[pkg]._cached_scan(
            s.scan_columnar, _St(s), APP, None, None, None, None, "rating"))

    name, cols = cached(writer, w)
    assert name == "miss:cold"
    identity = w.cache_identity
    w.close()
    r = open_store(reader, backend, tmp_path)
    assert r.cache_identity == identity
    key = SNAP[reader].filter_fingerprint(identity, APP, None, None, None, None,
                                          "rating")
    assert key == SNAP[writer].filter_fingerprint(identity, APP, None, None, None,
                                                  None, "rating")
    assert SNAP[reader].load_snapshot(str(tmp_path / "scan_cache"), key) is not None
    name, got = cached(reader, r)
    assert name == "hit"
    assert cols_tuple(got) == cols_tuple(cols)
    # the reader appends and extends the writer's snapshot
    r.insert_batch([ev(reader, i) for i in range(30, 90)], APP)
    name, got = cached(reader, r)
    assert name == "hit:delta"
    assert cols_tuple(got) == cols_tuple(r.scan_columnar(APP, value_key="rating"))
    r.close()
    w = open_store(writer, backend, tmp_path)
    name, again = cached(writer, w)
    assert name == "hit"
    assert cols_tuple(again) == cols_tuple(got)
    w.close()


def test_no_scan_cache_in_run_train_and_the_cli(tmp_path, monkeypatch):
    from predictionio_tpu_torch.core.workflow import RECOMMENDATION_FACTORY, run_train
    from predictionio_tpu_torch.storage import registry as port_registry
    from predictionio_tpu_torch.tools import cli
    from tests.test_workflow import VARIANT, seed_ratings

    monkeypatch.delenv("PIO_SCAN_CACHE_DIR", raising=False)
    monkeypatch.setattr(port_store, "_scan_cache_override", None)
    home = tmp_path / "home"
    st = storage("port", home)
    seed_ratings(st)
    variant = dict(VARIANT, engineFactory=RECOMMENDATION_FACTORY,
                   algorithms=[{"name": "als", "params": {
                       "rank": 4, "numIterations": 2, "lambda": 0.05}}])
    seen = []
    real = port_store._scan_with_cache

    def spy(*a, **kw):
        seen.append(port_store.scan_cache_enabled())
        return real(*a, **kw)

    monkeypatch.setattr(port_store, "_scan_with_cache", spy)
    run_train(RECOMMENDATION_FACTORY, variant=variant, storage=st, device="cpu",
              scan_cache=False)
    assert seen == [False] and port_store._scan_cache_override is None
    assert not os.path.exists(home / "scan_cache")
    run_train(RECOMMENDATION_FACTORY, variant=variant, storage=st, device="cpu")
    assert seen == [False, True]
    assert any(f.startswith("snap_") for f in os.listdir(home / "scan_cache"))
    variant_file = tmp_path / "variant.json"
    variant_file.write_text(__import__("json").dumps(variant))
    port_registry.set_storage(st)
    try:
        cli.main(["train", "-e", str(variant_file), "--device", "cpu",
                  "--no-scan-cache"])
    finally:
        port_registry.set_storage(None)
    assert seen == [False, True, False] and port_store._scan_cache_override is None
    st.events.close()


def test_sqlite_columnar_scan_matches_jax(tmp_path):
    db = str(tmp_path / "events.db")
    jax = JaxSqlite(db)
    events = [ev("jax", i, name=("rate", "buy", "view")[i % 3], sec=(i * 7) % 40)
              for i in range(120)]
    events.append(JaxEvent(event_id="notarget", event="rate", entity_type="user",
                           entity_id="u9", properties={"rating": 3},
                           event_time=T0, creation_time=T0))
    events.append(JaxEvent(event_id="text", event="rate", entity_type="user",
                           entity_id="u9", target_entity_type="item",
                           target_entity_id="i1", properties={"rating": " 2.5"},
                           event_time=T0, creation_time=T0))
    jax.insert_batch(events, APP)
    port = PortSqlite(db)
    assert port.cache_identity == jax.cache_identity == "sqlite:" + os.path.abspath(db)
    c0 = int((T0 + dt.timedelta(days=1)).timestamp() * 1_000_000)
    for kw in ({}, {"value_key": "rating"}, {"event_names": ["buy", "rate"]},
               {"entity_type": "user", "target_entity_type": "item"},
               {"start_time": T0 + dt.timedelta(seconds=5),
                "until_time": T0 + dt.timedelta(seconds=30), "value_key": "rating"},
               {"created_after_us": c0 + 10_000000, "created_until_us": c0 + 80_000000}):
        assert cols_tuple(port.scan_columnar(APP, **kw)) == \
            cols_tuple(jax.scan_columnar(APP, **kw)), kw
    for until in (None, c0 + 50_000000, 0):
        assert port.creation_stats(APP, until_us=until) == \
            jax.creation_stats(APP, until_us=until)
    assert port.creation_stats(99) == jax.creation_stats(99) == (0, None)
    assert port.scan_columnar(99).n == jax.scan_columnar(99).n == 0
    assert PortSqlite(":memory:").cache_identity is None
