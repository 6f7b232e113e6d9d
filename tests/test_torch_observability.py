"""The port's observability and resilience modules held against the JAX
package's, on the CPU.

Each case runs once on each package (``pkg`` is ``jax`` or ``torch``):
the unit cases of ``tests/test_metrics.py``, ``test_timeseries.py``,
``test_tracing.py``, ``test_resilience.py`` (deadlines, backoff, retry,
the breaker, the fault registry) and the ``TokenBucket`` /
``TenantQuotas`` / ``FairInflight`` part of ``test_tenancy.py``, written
once against the package's modules. Then the packages against each
other: the same metric calls render the same exposition text, a span
JSONL file that either package writes is read by both packages'
``trace`` verb, and both ``atomic_write`` helpers leave the same bytes.
Each test resets both tracers and disarms both fault registries.
"""

import asyncio
import contextlib
import json
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor

import pytest

from predictionio_tpu.server import tenancy as jax_tenancy
from predictionio_tpu.storage import registry as jax_registry
from predictionio_tpu.storage.registry import Storage as JaxStorage
from predictionio_tpu.storage.registry import StorageConfig as JaxStorageConfig
from predictionio_tpu.tools import cli as jax_cli
from predictionio_tpu.utils import atomic_write as jax_atomic_write
from predictionio_tpu.utils import faults as jax_faults
from predictionio_tpu.utils import metrics as jax_metrics
from predictionio_tpu.utils import resilience as jax_resilience
from predictionio_tpu.utils import timeseries as jax_timeseries
from predictionio_tpu.utils import tracing as jax_tracing
from predictionio_tpu_torch.server import tenancy as port_tenancy
from predictionio_tpu_torch.storage import registry as port_registry
from predictionio_tpu_torch.storage.registry import Storage, StorageConfig
from predictionio_tpu_torch.tools import cli as port_cli
from predictionio_tpu_torch.utils import atomic_write as port_atomic_write
from predictionio_tpu_torch.utils import faults as port_faults
from predictionio_tpu_torch.utils import metrics as port_metrics
from predictionio_tpu_torch.utils import resilience as port_resilience
from predictionio_tpu_torch.utils import timeseries as port_timeseries
from predictionio_tpu_torch.utils import tracing as port_tracing

PACKAGES = {
    "jax": types.SimpleNamespace(
        metrics=jax_metrics, timeseries=jax_timeseries, tracing=jax_tracing,
        resilience=jax_resilience, faults=jax_faults, tenancy=jax_tenancy,
        FAULTS=jax_faults.FAULTS),
    "torch": types.SimpleNamespace(
        metrics=port_metrics, timeseries=port_timeseries, tracing=port_tracing,
        resilience=port_resilience, faults=port_faults, tenancy=port_tenancy,
        FAULTS=port_faults.FAULTS),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


@pytest.fixture(autouse=True)
def _clean_state():
    for p in PACKAGES.values():
        p.tracing.TRACER.reset()
        p.FAULTS.disarm()
    yield
    for p in PACKAGES.values():
        p.tracing.TRACER.reset()
        p.FAULTS.disarm()


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


# -- metrics -------------------------------------------------------------------


def test_counter_labels(pkg):
    c = pkg.metrics.Counter("t_total", "help text", ("app", "status"))
    c.inc(("1", "201"))
    c.inc(("1", "201"), 2)
    c.inc(("2", "400"))
    lines = c.render()
    assert "# TYPE t_total counter" in lines
    assert 't_total{app="1",status="201"} 3' in lines
    assert 't_total{app="2",status="400"} 1' in lines
    assert c.get(("1", "201")) == 3 and c.items()[0] == (("1", "201"), 3.0)


def test_histogram_buckets(pkg):
    h = pkg.metrics.Histogram("lat_seconds", "h", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.05, 0.5, 5.0):
        h.observe(v)
    lines = h.render()
    assert 'lat_seconds_bucket{le="0.01"} 1' in lines
    assert 'lat_seconds_bucket{le="0.1"} 3' in lines
    assert 'lat_seconds_bucket{le="1"} 4' in lines
    assert 'lat_seconds_bucket{le="+Inf"} 5' in lines
    assert "lat_seconds_count 5" in lines


def test_registry_get_or_create(pkg):
    r = pkg.metrics.Registry()
    c1 = r.counter("dup_total", "a")
    c1.inc()
    c2 = r.counter("dup_total", "a")
    c2.inc()
    assert c1 is c2
    assert r.render().count("# TYPE dup_total counter") == 1
    assert "dup_total 2" in r.render()
    with pytest.raises(ValueError):
        r.histogram("dup_total", "clash")


def test_registry_render(pkg):
    r = pkg.metrics.Registry()
    r.counter("a_total", "a").inc()
    r.histogram("b_seconds", "b", buckets=(1.0,)).observe(0.5)
    g = r.gauge("c_inflight", "c")
    g.inc()
    g.inc(n=2)
    g.dec()
    text = r.render()
    assert text.endswith("\n")
    assert "a_total 1" in text and "b_seconds_count 1" in text
    assert "c_inflight 2" in text


def test_histogram_labels_and_exemplar(pkg):
    h = pkg.metrics.Registry().histogram(
        "test_tracing_hist", "t", buckets=[0.1, 1.0], labelnames=("status",))
    h.observe(0.05, ("ok",), exemplar="f" * 32)
    h.observe(5.0, ("error",))
    assert h.exemplar(0.1, ("ok",)) == ("f" * 32, 0.05)
    assert h.exemplar("+Inf", ("error",)) is None
    assert h.exemplars() == [(("ok",), "0.1", "f" * 32, 0.05)]
    rendered = "\n".join(h.render())
    assert 'status="ok"' in rendered and 'le="0.1"' in rendered
    assert "f" * 32 not in rendered  # exemplars stay out of exposition


def test_build_info_labels_version_and_instance(pkg):
    g = pkg.metrics.build_info("abcdef012345")
    (key,) = [k for k, _ in g.items() if k[1] == "abcdef012345"]
    assert g.get(key) == 1 and key[0]


def test_both_registries_render_the_same_text():
    texts = []
    for p in (port_metrics, jax_metrics):
        r = p.Registry()
        c = r.counter("pio_engine_queries_total", "Queries served", ("status",))
        c.inc(("200",), 3)
        c.inc(("503",))
        r.gauge("pio_engine_reload_generation", "g").set(2)
        h = r.histogram("pio_engine_query_seconds", "q", labelnames=("status",))
        for v in (0.0004, 0.003, 0.2, 12.0):
            h.observe(v, ("200",), exemplar="ab" * 16)
        r.histogram("pio_unlabelled_seconds", "u", buckets=(1.0,))
        texts.append(r.render())
    assert texts[0] == texts[1]


# -- timeseries ----------------------------------------------------------------


def test_parse_durations(pkg):
    pd = pkg.timeseries.parse_duration
    assert pd("300") == 300.0 and pd("500ms") == 0.5 and pd("30s") == 30.0
    assert pd("5m") == 300.0 and pd("1h") == 3600.0 and pd("1d") == 86400.0
    assert pd("1.5m") == 90.0
    for bad in ("", "m5", "5x", "-3s"):
        with pytest.raises(ValueError):
            pd(bad)


def test_parse_selectors_and_render_key(pkg):
    ts = pkg.timeseries
    assert ts.parse_selector("pio_x_total") == ("pio_x_total", {})
    name, labels = ts.parse_selector('pio_x_total{a="1", b="two"}')
    assert name == "pio_x_total" and labels == {"a": "1", "b": "two"}
    for bad in ("", "{a=1}", 'x{a=1}', "na me"):
        with pytest.raises(ValueError):
            ts.parse_selector(bad)
    key = ts.render_key("pio_x_total", (("a", "1"), ("le", "+Inf")))
    assert ts.parse_selector(key) == ("pio_x_total", {"a": "1", "le": "+Inf"})


def test_prom_text_parses_exposition_and_skips_garbage(pkg):
    reg = pkg.metrics.Registry()
    reg.counter("pio_t_total", "t", ("app",)).inc(("a",), 3)
    reg.histogram("pio_t_seconds", "t", buckets=(0.1, 1.0)).observe(0.05)
    triples = pkg.timeseries.parse_prom_text(reg.render())
    assert ("pio_t_total", {"app": "a"}, 3.0) in triples
    assert ("pio_t_seconds_bucket", {"le": "0.1"}, 1.0) in triples
    assert ("pio_t_seconds_count", {}, 1.0) in triples
    text = ("# HELP x y\npio_ok_total 2\nnot a metric line at all\n"
            'pio_nan_total notanumber\n{no="name"} 3\n')
    assert pkg.timeseries.parse_prom_text(text) == [("pio_ok_total", {}, 2.0)]


def test_rings_tiers_and_label_filter(pkg):
    ts, Registry = pkg.timeseries, pkg.metrics.Registry
    store = ts.TimeSeriesStore(Registry(), tiers=((10.0, 8),), clock=FakeClock())
    store.record("g", {}, 1.0, ts=100.0)
    store.record("g", {}, 2.0, ts=105.0)
    store.record("g", {}, 3.0, ts=115.0)
    (samples,) = store.query("g", 60.0, ts=115.0).values()
    assert samples == [(105.0, 2.0), (115.0, 3.0)]
    store = ts.TimeSeriesStore(Registry(), tiers=((1.0, 5), (10.0, 10)),
                               clock=FakeClock())
    for t in range(30):
        store.record("c", {}, float(t), ts=float(t))
    (fine,) = store.query("c", 5.0, ts=29.0).values()
    assert len(fine) == 5 and fine[-1] == (29.0, 29.0)
    (coarse,) = store.query("c", 20.0, ts=29.0).values()
    assert all(b[0] - a[0] >= 10.0 for a, b in zip(coarse, coarse[1:]))
    store = ts.TimeSeriesStore(Registry(), clock=FakeClock())
    store.record("c", {"app": "a"}, 1.0, ts=100.0)
    store.record("c", {"app": "b"}, 2.0, ts=100.0)
    assert set(store.query('c{app="a"}', 60.0, ts=100.0)) == {'c{app="a"}'}
    assert store.names() == ["c"]


def test_increase_and_rate_are_reset_aware(pkg):
    store = pkg.timeseries.TimeSeriesStore(
        pkg.metrics.Registry(), tiers=((1.0, 100),), clock=FakeClock())
    for ts, v in [(0, 0.0), (1, 10.0), (2, 3.0), (3, 5.0)]:
        store.record("c", {}, v, ts=float(ts))
    assert store.increase("c", 10.0, ts=3.0) == pytest.approx(15.0)
    store.record("r", {}, 0.0, ts=0.0)
    assert store.rate("r", 10.0, ts=0.0) == 0.0
    store.record("r", {}, 30.0, ts=10.0)
    assert store.rate("r", 60.0, ts=10.0) == pytest.approx(3.0)
    for ts, v in [(0, 100.0), (5, 110.0), (10, 2.0)]:
        store.record("z", {}, v, ts=float(ts))
    assert store.rate("z", 60.0, ts=10.0) == pytest.approx(1.2)


def test_histogram_quantiles(pkg):
    reg = pkg.metrics.Registry()
    hist = reg.histogram("pio_q_seconds", "q", buckets=(0.1, 0.5, 1.0))
    store = pkg.timeseries.TimeSeriesStore(reg, tiers=((1.0, 100),),
                                           clock=FakeClock())
    store.scrape(ts=0.0)
    assert store.quantile("pio_q_seconds", 0.5, 60.0, ts=0.0) is None
    for v in (0.05, 0.2, 0.3, 0.7):
        hist.observe(v)
    store.scrape(ts=10.0)
    assert store.quantile("pio_q_seconds", 0.5, 60.0, ts=10.0) == \
        pytest.approx(0.3)
    hist.observe(5.0)
    hist.observe(5.0)
    hist.observe(5.0)
    hist.observe(5.0)
    store.scrape(ts=20.0)
    assert store.quantile("pio_q_seconds", 0.99, 60.0, ts=20.0) == \
        pytest.approx(1.0)
    with pytest.raises(ValueError):
        store.quantile("pio_q_seconds", 1.5, 60.0)


def test_scrape_and_history_payload(pkg):
    ts = pkg.timeseries
    reg = pkg.metrics.Registry()
    reg.counter("pio_c_total", "c", ("app",)).inc(("a",), 2)
    reg.gauge("pio_g", "g").set(7)
    reg.histogram("pio_h_seconds", "h", buckets=(0.5,)).observe(0.1)
    store = ts.TimeSeriesStore(reg, clock=FakeClock(1000.0))
    assert store.scrape(ts=990.0) > 0
    assert store.names() == ["pio_c_total", "pio_g", "pio_h_seconds_bucket",
                             "pio_h_seconds_count", "pio_h_seconds_sum"]
    status, payload = ts.history_payload(store, "", "")
    assert status == 400 and "pio_c_total" in payload["names"]
    status, payload = ts.history_payload(store, "pio_c_total", "bogus")
    assert status == 400 and "duration" in payload["message"]
    status, payload = ts.history_payload(store, "???", "1m")
    assert status == 400 and "selector" in payload["message"]
    status, payload = ts.history_payload(store, "pio_c_total", "1m")
    assert status == 200 and payload["windowSeconds"] == 60.0
    assert payload["series"] == {'pio_c_total{app="a"}': [[990.0, 2.0]]}


def test_scrape_loop_stall_fault_is_fail_open(pkg):
    ts = pkg.timeseries
    reg = pkg.metrics.Registry()
    reg.counter("pio_c_total", "c").inc(())
    store = ts.TimeSeriesStore(reg)

    async def drive():
        task = asyncio.create_task(ts.scrape_loop(store, 0.01))
        e0 = ts._m_scrapes.get(("error",))
        pkg.FAULTS.arm("tsdb.scrape.stall", error="drill")
        while ts._m_scrapes.get(("error",)) < e0 + 3:
            await asyncio.sleep(0.01)
        assert not store.names()
        pkg.FAULTS.disarm()
        ok0 = ts._m_scrapes.get(("ok",))
        while ts._m_scrapes.get(("ok",)) < ok0 + 2:
            await asyncio.sleep(0.01)
        task.cancel()
        with contextlib.suppress(asyncio.CancelledError):
            await task
        assert task.done()

    asyncio.run(asyncio.wait_for(drive(), timeout=10))
    assert "pio_c_total" in store.names()


# -- tracing -------------------------------------------------------------------


def test_disabled_span_is_the_noop(pkg):
    tr = pkg.tracing
    assert not tr.TRACER.enabled
    with tr.span("anything") as sp:
        assert sp is tr.NOOP_SPAN
        assert tr.current_trace_id() is None and tr.exemplar() is None
    assert len(tr.TRACER.ring) == 0


def test_nesting_errors_and_attrs(pkg):
    tr = pkg.tracing
    tr.TRACER.configure(enabled=True)
    with tr.span("outer") as outer:
        with tr.span("inner", k="v") as inner:
            assert inner.trace_id == outer.trace_id
            assert inner.parent_id == outer.span_id
            assert tr.current_span() is inner
            tr.add_attrs(records=7)
    spans = tr.TRACER.ring.trace(outer.trace_id)
    assert [s["name"] for s in spans] == ["outer", "inner"]
    assert spans[1]["attrs"] == {"k": "v", "records": 7}
    with pytest.raises(ValueError):
        with tr.span("boom") as sp:
            raise ValueError("bad input")
    d = tr.TRACER.ring.trace(sp.trace_id)[0]
    assert d["status"] == "error" and "bad input" in d["error"]
    tr.add_attrs(ignored=True)  # no current span: dropped, never raises


def test_detached_span_and_propagation(pkg):
    tr = pkg.tracing
    tr.TRACER.configure(enabled=True)
    pool = ThreadPoolExecutor(max_workers=1)
    with tr.span("request") as req:
        with tr.detached_span("commit", link_traces=[req.trace_id]) as c:
            assert c.trace_id != req.trace_id and c.parent_id is None

        def work():
            with tr.span("worker") as w:
                return w.trace_id

        assert pool.submit(work).result() != req.trace_id
    pool.shutdown()

    async def main():
        async with tr.span("request") as sp:
            in_thread = await asyncio.to_thread(tr.current_trace_id)
            return sp.trace_id, in_thread

    tid, in_thread = asyncio.run(main())
    assert in_thread == tid


def test_ring_bound_and_sampling(pkg):
    tr = pkg.tracing
    tr.TRACER.configure(enabled=True, ring_capacity=8)
    for i in range(20):
        with tr.span(f"s{i}"):
            pass
    assert len(tr.TRACER.ring) == 8
    assert tr.TRACER.ring.spans(limit=1)[0]["name"] == "s19"
    exported = []

    class Sink:
        def export(self, d):
            exported.append(d)

    tr.TRACER.configure(enabled=True, sample_rate=0.0, slow_span_ms=10_000.0,
                        exporters=[Sink()])
    with tr.span("fast-ok"):
        pass
    assert exported == []
    with pytest.raises(RuntimeError):
        with tr.span("failed"):
            raise RuntimeError("x")
    tr.TRACER.slow_span_ms = 0.0
    with tr.span("slow"):
        pass
    assert [d["name"] for d in exported] == ["failed", "slow"]
    with pytest.raises(ValueError):
        tr.TRACER.configure(enabled=True, sample_rate=1.5)


def test_traceparent_roundtrip_and_extract(pkg):
    tr = pkg.tracing
    tr.TRACER.configure(enabled=True)
    with tr.span("a") as sp:
        header = sp.traceparent()
    assert tr.parse_traceparent(header) == (sp.trace_id, sp.span_id, True)
    for bad in ("", "garbage", "ff-" + "a" * 32 + "-" + "b" * 16 + "-01",
                "00-" + "0" * 32 + "-" + "b" * 16 + "-01",
                "00-" + "a" * 32 + "-" + "0" * 16 + "-01", "00-short-span-01"):
        assert tr.parse_traceparent(bad) is None
    tp = "00-" + "a" * 32 + "-" + "b" * 16 + "-01"
    assert tr.extract_headers({"traceparent": tp, "x-pio-trace-id": "c" * 32}) \
        == ("a" * 32, "b" * 16, True)
    assert tr.extract_headers({"x-pio-trace-id": "c" * 32}) == \
        ("c" * 32, None, None)


def test_export_failures_are_contained(pkg):
    tr = pkg.tracing

    def failures():
        return sum(v for _, v in tr._M_EXPORT_FAILURES.items())

    tr.TRACER.configure(enabled=True)
    pkg.FAULTS.arm("trace.export", error="disk full")
    before = failures()
    with tr.span("guarded") as sp:
        assert sp.trace_id
    assert failures() > before
    pkg.FAULTS.disarm()

    class Broken:
        def export(self, d):
            raise OSError("enospc")

    tr.TRACER.reset()
    tr.TRACER.configure(enabled=True, exporters=[Broken()])
    before = failures()
    with tr.span("ok"):
        pass
    assert failures() == before + 1 and len(tr.TRACER.ring) == 1


def test_jsonl_exporter_writes_and_rotates(pkg, tmp_path):
    path = str(tmp_path / "spans.jsonl")
    exp = pkg.tracing.JSONLExporter(path, max_bytes=200)
    for i in range(10):
        exp.export({"traceId": "t" * 32, "name": f"s{i}", "pad": "x" * 80})
    exp.close()
    rotated = tmp_path / "spans.jsonl.1"
    assert rotated.exists()
    for p in (rotated, tmp_path / "spans.jsonl"):
        for line in p.read_text().splitlines():
            assert json.loads(line)["traceId"] == "t" * 32


def test_slow_query_log_renders_the_tree(pkg, caplog):
    tr = pkg.tracing
    tr.TRACER.configure(enabled=True, slow_query_ms=0.001)
    with caplog.at_level("WARNING", logger="pio.trace"):
        with tr.span("engine.query"):
            with tr.span("engine.predict"):
                time.sleep(0.002)
    (rec,) = [r for r in caplog.records if r.name == "pio.trace"]
    assert "slow request" in rec.getMessage()
    assert "engine.query" in rec.getMessage()
    assert "  engine.predict" in rec.getMessage()


def test_traces_payload_and_default_path(pkg):
    tr = pkg.tracing
    tr.TRACER.configure(enabled=True)
    with tr.span("a"):
        pass
    with pytest.raises(KeyError):
        with tr.span("b"):
            raise KeyError("x")
    body = tr.traces_payload(errors_only=True)
    assert body["enabled"] and body["count"] == 1
    assert body["spans"][0]["name"] == "b"
    assert tr.traces_payload(limit=1)["count"] == 1
    assert tr.default_trace_path("/h") == "/h/traces/spans.jsonl"


# -- resilience ----------------------------------------------------------------


def test_deadline(pkg):
    r = pkg.resilience
    d = r.Deadline(0.05)
    assert 0 < d.remaining() <= 0.05
    time.sleep(0.07)
    assert d.remaining() == 0.0 and d.expired()
    with pytest.raises(r.DeadlineExceeded, match="probe exceeded"):
        r.Deadline(-1.0).check("probe")
    with pytest.raises(TimeoutError):
        r.Deadline(-1.0).check()
    r.Deadline(10.0).check()


def test_backoff_delays(pkg):
    bd = pkg.resilience.backoff_delays
    g = bd(0.1, 1.0, jitter="none")
    assert [next(g) for _ in range(6)] == [0.1, 0.2, 0.4, 0.8, 1.0, 1.0]
    g = bd(0.1, 1.0, jitter="full")
    for t in (0.1, 0.2, 0.4, 0.8, 1.0):
        assert 0.0 <= next(g) <= t
    g = bd(1.0, 8.0, jitter="equal")
    for t in (1.0, 2.0, 4.0, 8.0, 8.0):
        assert t / 2 <= next(g) <= t
    with pytest.raises(ValueError, match="jitter"):
        next(bd(0.1, 1.0, jitter="bogus"))


def test_retry_with_backoff(pkg):
    r = pkg.resilience
    calls = []

    @r.retry_with_backoff(3, base=0.001, cap=0.002)
    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    assert flaky() == "ok" and len(calls) == 3
    calls.clear()

    @r.retry_with_backoff(2, base=0.001, cap=0.002)
    def broken():
        calls.append(1)
        raise RuntimeError("still down")

    with pytest.raises(RuntimeError, match="still down"):
        broken()
    assert len(calls) == 3
    calls.clear()

    @r.retry_with_backoff(3, base=0.001, retry_on=(OSError,))
    def rejects():
        calls.append(1)
        raise ValueError("deterministic")

    with pytest.raises(ValueError):
        rejects()
    assert len(calls) == 1
    calls.clear()

    @r.retry_with_backoff(3, base=0.001, retry_on=(Exception,))
    def open_breaker():
        calls.append(1)
        raise r.CircuitOpenError("dep", 5.0)

    with pytest.raises(r.CircuitOpenError):
        open_breaker()
    assert len(calls) == 1


def test_retry_deadline_async_and_retry_call(pkg):
    r = pkg.resilience
    calls = []

    @r.retry_with_backoff(50, base=0.05, cap=0.05, jitter="none",
                          deadline=0.12)
    def slow_fail():
        calls.append(1)
        raise OSError("down")

    t0 = time.perf_counter()
    with pytest.raises(OSError):
        slow_fail()
    assert time.perf_counter() - t0 < 1.0 and len(calls) < 10
    calls.clear()

    @r.retry_with_backoff(2, base=0.001)
    async def aflaky():
        calls.append(1)
        if len(calls) < 2:
            raise OSError("transient")
        return 42

    assert asyncio.run(aflaky()) == 42
    state = {"n": 0}

    def f(x):
        state["n"] += 1
        if state["n"] < 2:
            raise OSError
        return x * 2

    assert r.retry_call(f, 21, retries=2, base=0.001) == 42


def test_retry_after_parsing_and_hints(pkg):
    r = pkg.resilience
    assert r.parse_retry_after("2.5") == 2.5
    assert r.parse_retry_after(" 3 ") == 3.0 and r.parse_retry_after(30) == 30.0
    for bad in (None, "", "soon", "0", "-5", "Wed, 21 Oct 2026 07:28:00 GMT"):
        assert r.parse_retry_after(bad) is None
    e = RuntimeError("x")
    assert r.retry_after_hint(e) is None
    e.retry_after = "not-a-number"
    assert r.retry_after_hint(e) is None
    e.retry_after = 0.25
    assert r.retry_after_hint(e) == 0.25
    calls = []

    def fn():
        calls.append(1)
        if len(calls) <= 2:
            err = RuntimeError("throttled")
            err.retry_after = 0.01
            raise err
        return "ok"

    t0 = time.perf_counter()
    assert r.retry_with_backoff(3, base=0.5, cap=0.5, jitter="none")(fn)() == "ok"
    assert time.perf_counter() - t0 < 0.3


def _breaker(pkg, **kw):
    clock = FakeClock()
    kw.setdefault("failure_threshold", 3)
    kw.setdefault("reset_timeout", 10.0)
    return pkg.resilience.CircuitBreaker(f"test_{id(clock)}", clock=clock,
                                         **kw), clock


def test_breaker_trips_and_fails_fast(pkg):
    r = pkg.resilience
    b, _ = _breaker(pkg)
    b.record_failure()
    b.record_failure()
    b.record_success()
    b.record_failure()
    b.record_failure()
    assert b.state == r.CLOSED
    b.record_failure()
    assert b.state == r.OPEN and not b.admit() and b.retry_after() > 0
    calls = []
    with pytest.raises(r.CircuitOpenError):
        b.call(lambda: calls.append(1))
    assert calls == []
    b.reset()
    assert b.state == r.CLOSED and b.allow()
    assert b.call(lambda x: x + 1, 41) == 42


def test_breaker_half_open_trial_slots(pkg):
    r = pkg.resilience
    b, clock = _breaker(pkg, failure_threshold=1)
    b.record_failure()
    clock.t += 10.0
    assert b.state == r.HALF_OPEN
    assert b.admit() and b.admit()   # decoupled: reserves nothing
    assert b.allow() and not b.allow()
    b.record_failure()
    assert b.state == r.OPEN
    clock.t += 9.0
    assert b.state == r.OPEN
    clock.t += 1.0
    assert b.allow()
    b.record_success()
    assert b.state == r.CLOSED


def test_breaker_acall_and_concurrent_probe(pkg):
    r = pkg.resilience
    b, clock = _breaker(pkg, failure_threshold=1)

    async def boom():
        raise RuntimeError("down")

    async def scenario():
        with pytest.raises(RuntimeError):
            await b.acall(boom)
        with pytest.raises(r.CircuitOpenError):
            await b.acall(boom)

    asyncio.run(scenario())
    clock.t += 10.0
    barrier = threading.Barrier(16)
    results = [None] * 16

    def worker(i):
        barrier.wait()
        results[i] = b.allow()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert sum(results) == 1


# -- faults --------------------------------------------------------------------


def test_global_fault_registry_is_disarmed(pkg):
    assert pkg.FAULTS.armed is False and pkg.FAULTS.plans() == {}
    pkg.faults.inject("serving.query")  # a no-op


def test_fault_plans(pkg):
    fr = pkg.faults.FaultRegistry(env={})
    fr.hit("some.site")
    assert fr.hits("some.site") == 0
    fr.arm("svc.op", error="backend down")
    with pytest.raises(pkg.faults.FaultError, match=r"\[svc.op\] backend down"):
        fr.hit("svc.op")
    assert fr.hits("svc.op") == 1 and fr.fired("svc.op") == 1
    fr.arm("lat", latency=0.05)
    t0 = time.perf_counter()
    fr.hit("lat")
    assert time.perf_counter() - t0 >= 0.05
    fr.arm("s", error="blip", count=2)
    for _ in range(2):
        with pytest.raises(pkg.faults.FaultError):
            fr.hit("s")
    fr.hit("s")
    assert fr.fired("s") == 2 and fr.hits("s") == 3
    fr.arm("path.x")
    fr.hit("path.x")
    assert fr.hits("path.x") == 1
    fr.disarm("svc.op")
    fr.hit("svc.op")
    fr.disarm()
    assert not fr.armed and fr.plans() == {}


def test_fault_rate_is_seeded(pkg):
    def pattern(seed):
        r = pkg.faults.FaultRegistry(env={})
        r.arm("s", error="x", rate=0.5, seed=seed)
        out = []
        for _ in range(20):
            try:
                r.hit("s")
                out.append(0)
            except pkg.faults.FaultError:
                out.append(1)
        return out

    a = pattern(7)
    assert a == pattern(7) and 0 < sum(a) < 20 and pattern(8) != a


def test_fault_specs_and_env(pkg):
    fr = pkg.faults.FaultRegistry(env={})
    fr.arm_spec("a.b:latency=0.5,rate=0.25,seed=3; c.d:error=down,count=2")
    plans = fr.plans()
    assert (plans["a.b"].latency, plans["a.b"].rate, plans["a.b"].seed) == \
        (0.5, 0.25, 3)
    assert (plans["c.d"].error, plans["c.d"].count) == ("down", 2)
    for bad in ("no-colon-here", "site:bogus_key=1"):
        with pytest.raises(ValueError):
            fr.arm_spec(bad)
    env = pkg.faults.FaultRegistry(env={"PIO_FAULTS": "x.y:error=down"})
    assert env.armed
    with pytest.raises(pkg.faults.FaultError):
        env.hit("x.y")

    async def scenario():
        with pytest.raises(pkg.faults.FaultError):
            await env.ahit("x.y")

    asyncio.run(scenario())


def test_corrupt_bytes_flips_one_byte(pkg):
    data = bytes(range(64))
    assert pkg.faults.corrupt_bytes("data.corrupt.model", data) == data
    pkg.FAULTS.arm("data.corrupt.model", seed=1)
    bad = pkg.faults.corrupt_bytes("data.corrupt.model", data)
    assert len(bad) == len(data)
    assert sum(a != b for a, b in zip(bad, data)) == 1


def test_fault_registries_agree_on_the_same_spec():
    spec = "serving.query:error=x,rate=0.4,seed=11,count=5"
    out = []
    for mod in (port_faults, jax_faults):
        r = mod.FaultRegistry(env={"PIO_FAULTS": spec})
        fired = []
        for _ in range(30):
            try:
                r.hit("serving.query")
                fired.append(0)
            except mod.FaultError:
                fired.append(1)
        out.append(fired)
    assert out[0] == out[1] and sum(out[0]) == 5


# -- tenancy -------------------------------------------------------------------


def test_token_bucket(pkg):
    clk = FakeClock(100.0)
    b = pkg.tenancy.TokenBucket(rate=10.0, burst=5.0, clock=clk)
    assert b.take(5) and not b.take(1)
    assert b.retry_after(1) == pytest.approx(0.1)
    assert b.retry_after(5) == pytest.approx(0.5)
    clk.advance(0.11)
    assert b.take(1) and not b.take(1)
    clk.advance(60.0)
    assert b.take(5) and not b.take(1)  # never overfills


def test_tenant_quotas_default_and_override(pkg, tmp_path):
    clk = FakeClock(100.0)
    q = pkg.tenancy.TenantQuotas(str(tmp_path / "quotas.json"), clock=clk)
    for _ in range(100):
        assert q.admit("7", 50) == (True, 0.0)
    q.set_quota("7", rate=2.0, burst=2.0)
    assert q.admit("7")[0] and q.admit("7")[0]
    ok, ra = q.admit("7")
    assert not ok and ra == pytest.approx(0.5)
    assert q.admit("8")[0]
    q.set_quota("7", rate=None, burst=None)
    assert q.admit("7", 100)[0]


def test_tenant_quotas_describe_floors_and_garble(pkg, tmp_path):
    clk = FakeClock(100.0)
    path = tmp_path / "quotas.json"
    q = pkg.tenancy.TenantQuotas(str(path), clock=clk)
    q.set_quota("7", rate=50.0, weight=2.0, writer_shards=4, deadline_ms=750.0)
    assert q.describe("7") == {"rate": 50.0, "burst": 50.0, "weight": 2.0,
                               "writer_shards": 4, "deadline_ms": 750.0}
    q.set_quota("9", weight=-3.0, writer_shards=0, deadline_ms=-1.0)
    assert (q.weight("9"), q.writer_shards("9"), q.deadline_ms("9")) == (0.0, 1, 0.0)
    q.set_quota("5", rate=1.0, burst=5.0)
    assert q.admit("5", 5)[0]
    path.write_text("{not json", encoding="utf-8")
    clk.advance(2.0)
    ok, ra = q.admit("5", 5)
    assert not ok and ra == pytest.approx(3.0)


def test_quota_exhausted_fault(pkg, tmp_path):
    q = pkg.tenancy.TenantQuotas(str(tmp_path / "quotas.json"))
    assert q.admit("9")[0]
    pkg.FAULTS.arm("tenant.quota.exhausted", error="drill")
    ok, ra = q.admit("9")
    assert not ok and ra > 0
    pkg.FAULTS.disarm("tenant.quota.exhausted")
    assert q.admit("9")[0]


def test_fair_inflight_shares(pkg):
    FairInflight = pkg.tenancy.FairInflight
    f = FairInflight(4, clock=FakeClock(100.0))
    assert all(f.try_acquire("a") for _ in range(4))
    assert not f.try_acquire("a")
    f.release("a")
    assert f.try_acquire("a")
    f = FairInflight(4, clock=FakeClock(100.0))
    for app in ("a", "b"):
        assert f.try_acquire(app)
        f.release(app)
    assert f.try_acquire("a") and f.try_acquire("a")
    assert not f.try_acquire("a") and f.try_acquire("b")
    assert (f.inflight("a"), f.inflight("b"), f.total) == (2, 1, 3)
    assert f.snapshot() == {"a": 2, "b": 1}


def test_fair_inflight_weights_and_idle_tenants(pkg):
    FairInflight = pkg.tenancy.FairInflight
    weights = {"heavy": 3.0, "light": 1.0}
    f = FairInflight(4, weight_of=lambda a: weights.get(a, 1.0),
                     clock=FakeClock(100.0))
    for app in ("heavy", "light"):
        assert f.try_acquire(app)
        f.release(app)
    for _ in range(3):
        assert f.try_acquire("heavy")
    assert not f.try_acquire("heavy")
    assert f.try_acquire("light") and not f.try_acquire("light")
    clk = FakeClock(100.0)
    f = FairInflight(4, active_window=5.0, clock=clk)
    assert f.try_acquire("b")
    f.release("b")
    assert f.share("a") == 2
    clk.advance(6.0)
    assert f.share("a") == 4
    f.release("ghost")
    assert f.total == 0


def test_quota_files_are_shared_by_both_packages(tmp_path):
    path = str(tmp_path / "quotas.json")
    port_tenancy.TenantQuotas(path).set_quota("7", rate=3.0, weight=2.5)
    jq = jax_tenancy.TenantQuotas(path)
    assert jq.describe("7") == port_tenancy.TenantQuotas(path).describe("7")
    assert jq.weight("7") == 2.5


# -- files both packages write --------------------------------------------------


def test_atomic_writes_leave_the_same_bytes(tmp_path):
    for name, mod in (("port", port_atomic_write), ("jax", jax_atomic_write)):
        mod.atomic_write_text(str(tmp_path / f"{name}.txt"), "héllo\n")
        mod.atomic_write_bytes(str(tmp_path / f"{name}.bin"), b"\x00\x01")
        with mod.atomic_file(str(tmp_path / f"{name}.ctx"), "w") as f:
            f.write("ctx")
    for ext in ("txt", "bin", "ctx"):
        assert (tmp_path / f"port.{ext}").read_bytes() == \
            (tmp_path / f"jax.{ext}").read_bytes()
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        f"{n}.{e}" for n in ("port", "jax") for e in ("txt", "bin", "ctx"))


def _write_spans(tracing, path):
    tracing.TRACER.reset()
    tracing.TRACER.configure(enabled=True, jsonl_path=path)
    with tracing.root_span("http.request", trace_id="ab" * 16, method="POST"):
        with tracing.span("engine.query", status="200"):
            with tracing.span("engine.predict"):
                pass
    with tracing.root_span("http.request", trace_id="cd" * 16):
        with pytest.raises(RuntimeError):
            with tracing.span("engine.reload"):
                raise RuntimeError("probe failed")
    tracing.TRACER.reset()


def _trace_verb(main, registry, storage, argv, capsys):
    registry.set_storage(storage)
    try:
        main(argv)
    finally:
        registry.set_storage(None)
    return capsys.readouterr().out


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_span_jsonl_reads_in_both_trace_verbs(writer, tmp_path, capsys):
    path = str(tmp_path / "spans.jsonl")
    _write_spans(PACKAGES[writer].tracing, path)
    lines = [json.loads(s) for s in open(path)]
    assert [d["name"] for d in lines] == [
        "engine.predict", "engine.query", "http.request",
        "engine.reload", "http.request"]
    assert set(lines[0]) == {"traceId", "spanId", "parentId", "name",
                             "startUs", "durationUs", "status"}
    outs = {}
    for name, main, registry, storage, config in (
            ("jax", jax_cli.main, jax_registry, JaxStorage, JaxStorageConfig),
            ("torch", port_cli.main, port_registry, Storage, StorageConfig)):
        home = str(tmp_path / f"home_{name}")
        st = storage(config(home=home))
        tree = _trace_verb(main, registry, st,
                           ["trace", "--file", path, "--tree"], capsys)
        errs = _trace_verb(main, registry, st,
                           ["trace", "--file", path, "--errors-only"], capsys)
        one = _trace_verb(main, registry, st,
                          ["trace", "--file", path, "--trace-id", "ab" * 16,
                           "--grep", "predict"], capsys)
        outs[name] = (tree, errs, one)
    assert outs["torch"] == outs["jax"]
    tree, errs, one = outs["torch"]
    assert f"trace {'ab' * 16}:" in tree and "    engine.predict" in tree
    assert [json.loads(s)["name"] for s in errs.splitlines()] == ["engine.reload"]
    assert [json.loads(s)["name"] for s in one.splitlines()] == ["engine.predict"]


def test_trace_verb_reads_the_rotated_file_first(tmp_path, capsys):
    path = str(tmp_path / "spans.jsonl")
    with open(path + ".1", "w") as f:
        f.write(json.dumps({"traceId": "1" * 32, "name": "old"}) + "\n")
    with open(path, "w") as f:
        f.write(json.dumps({"traceId": "2" * 32, "name": "new"}) + "\n{torn")
    out = _trace_verb(port_cli.main, port_registry,
                      Storage(StorageConfig(home=str(tmp_path / "h"))),
                      ["trace", "--file", path], capsys)
    assert [json.loads(s)["name"] for s in out.splitlines()] == ["old", "new"]
    with pytest.raises(SystemExit):
        _trace_verb(port_cli.main, port_registry,
                    Storage(StorageConfig(home=str(tmp_path / "h"))),
                    ["trace", "--file", str(tmp_path / "none.jsonl")], capsys)


# -- the port's fault sites (the closure tests/test_faults_registry.py
# -- holds for the JAX package) ---------------------------------------------


def test_every_port_fault_site_is_documented_and_exercised():
    import pathlib
    import re

    root = pathlib.Path(__file__).resolve().parents[1]
    wired = set()
    for path in (root / "predictionio_tpu_torch").rglob("*.py"):
        if path.name == "faults.py":
            continue
        wired |= {a or b for a, b in re.findall(
            r'(?:faults\.inject|FAULTS\.a?hit|corrupt_bytes)\(\s*"([a-z_.]+)"'
            r'|fault_site="([a-z_.]+)"', path.read_text())}
    # the model stores build their site as models.{kind}
    wired |= {f"models.{kind}" for kind in re.findall(
        r'_init_resilience\("([a-z0-9_]+)"\)',
        (root / "predictionio_tpu_torch/storage/remote.py").read_text())}
    table = set(re.findall(r"^``([a-z0-9_.]+)``", port_faults.__doc__, re.M))
    tests = "".join(p.read_text() for p in (root / "tests").glob("test_torch_*.py"))
    assert wired == table == {"serving.query", "serving.reload", "trace.export",
                              "tsdb.scrape.stall", "tenant.quota.exhausted",
                              "eventsink.send", "ingest.commit",
                              "models.s3", "models.hdfs",
                              "variant.assign.skew", "variant.reload.partial",
                              "incident.capture.stall", "ann.index.corrupt",
                              "segments.cold", "segments.shard.hot",
                              "data.corrupt.eventlog", "data.corrupt.snapshot",
                              "data.corrupt.model", "data.corrupt.segment",
                              "train.crash", "train.lease.lost", "promote.regression",
                              "replication.follower.lag", "replication.wal.torn",
                              "replication.leader.partition",
                              "router.replica.down", "router.replica.slow",
                              "router.health.flap", "slo.probe.fail", "autoscale.flap",
                              "remediate.wrong_target", "remediate.storm"}
    assert all(f'"{site}"' in tests for site in wired)
    # every port site is one of the JAX package's documented sites
    assert wired <= set(re.findall(r"^``([a-z0-9_.]+)``", jax_faults.__doc__, re.M))
