"""Request-scoped tracing (dependency-free, fail-open): the port's copy
of the JAX package's ``utils/tracing.py``.

Every request entering :mod:`predictionio_tpu_torch.server.http` gets a
128-bit trace id, and the serving path opens nested :func:`span` blocks
under it (``engine.query``, ``engine.predict``, ``serving.device``,
``engine.reload``, ``ingest.submit``, ``storage.insert``). Spans are
linked by ``(trace_id, span_id, parent_id)``, timed with the monotonic
clock, and exported to:

- a bounded in-memory **ring buffer** (always, while tracing is
  enabled) behind ``GET /traces`` and the slow-query log;
- an optional **JSONL file** (``pio trace`` reads it) with size-based
  rotation through ``os.replace`` and a directory fsync. The lines are
  the JAX package's, so either package's ``pio trace`` reads them.

Sampling is head plus tail: the probabilistic decision is made once a
trace at its root, but a span that ends in error or crosses
``slow_span_ms`` is exported regardless.

Context propagates through :mod:`contextvars`, across ``await`` points
and through ``asyncio.to_thread``.

Tracing is disabled by default: then ``span()`` is one attribute read
returning a shared no-op handle. Every export is wrapped, so a failing
exporter (the ``trace.export`` fault site) counts
``pio_trace_export_failures_total`` and nothing else. Inbound W3C
``traceparent`` and ``X-PIO-Trace-Id`` headers are honoured; responses
carry ``X-PIO-Trace-Id``.
"""

from __future__ import annotations

import contextvars
import json
import logging
import os
import random
import re
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from predictionio_tpu_torch.utils import faults
from predictionio_tpu_torch.utils.atomic_write import fsync_dir
from predictionio_tpu_torch.utils.metrics import REGISTRY

logger = logging.getLogger("pio.trace")

_M_SPANS = REGISTRY.counter(
    "pio_trace_spans_total", "Spans finished", ("status",))
_M_EXPORT_FAILURES = REGISTRY.counter(
    "pio_trace_export_failures_total",
    "Span exports that raised (fail-open: the request was unaffected)")

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")
_TRACE_ID_RE = re.compile(r"^[0-9a-fA-F]{16,64}$")

_CURRENT: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "pio_torch_current_span", default=None)


# ids need uniqueness, not unpredictability: a Mersenne PRNG seeded
# from the OS once is ~30% cheaper per span than an os.urandom syscall
_ID_RNG = random.Random(os.urandom(16))


def new_trace_id() -> str:
    # | 1 — the all-zero trace id is invalid per W3C trace-context
    return f"{_ID_RNG.getrandbits(128) | 1:032x}"


def new_span_id() -> str:
    return f"{_ID_RNG.getrandbits(64) | 1:016x}"


class Span:
    """One timed operation. Created via :func:`span`/:func:`root_span`,
    finished (and exported) when its ``with`` block exits."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "attrs",
                 "start_us", "duration_us", "status", "error", "sampled",
                 "_t0")

    def __init__(self, name: str, trace_id: str, parent_id: Optional[str],
                 sampled: bool, attrs: Optional[Dict[str, Any]] = None) -> None:
        self.name = name
        self.trace_id = trace_id
        self.span_id = new_span_id()
        self.parent_id = parent_id
        self.sampled = sampled
        self.attrs: Dict[str, Any] = dict(attrs) if attrs else {}
        self.status = "ok"
        self.error: Optional[str] = None
        self.start_us = time.time_ns() // 1000
        self.duration_us = 0
        self._t0 = time.perf_counter_ns()

    def set_attr(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def set_error(self, message: str) -> None:
        self.status = "error"
        self.error = message

    def traceparent(self) -> str:
        flags = "01" if self.sampled else "00"
        return f"00-{self.trace_id}-{self.span_id}-{flags}"

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "parentId": self.parent_id,
            "name": self.name,
            "startUs": self.start_us,
            "durationUs": self.duration_us,
            "status": self.status,
        }
        if self.error is not None:
            d["error"] = self.error
        if self.attrs:
            d["attrs"] = self.attrs
        return d


class _SpanHandle:
    """Context manager (sync AND async) that activates a span on enter
    and finishes/exports it on exit. Exceptions mark the span ``error``
    and propagate."""

    __slots__ = ("span", "_tracer", "_token")

    def __init__(self, tracer: "Tracer", span: Span) -> None:
        self.span = span
        self._tracer = tracer
        self._token: Optional[contextvars.Token] = None

    def __enter__(self) -> Span:
        self._token = _CURRENT.set(self.span)
        return self.span

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._token is not None:
            _CURRENT.reset(self._token)
            self._token = None
        self._tracer.finish(self.span, exc_type, exc)
        return False

    async def __aenter__(self) -> Span:
        return self.__enter__()

    async def __aexit__(self, exc_type, exc, tb) -> bool:
        return self.__exit__(exc_type, exc, tb)


class _NoopSpan:
    """Shared do-nothing handle returned while tracing is disabled —
    the whole disabled-path cost of ``with span(...)`` is one attribute
    read plus this object's (empty) enter/exit."""

    __slots__ = ()
    trace_id = ""
    span_id = ""
    parent_id = None
    sampled = False
    status = "ok"

    def set_attr(self, key: str, value: Any) -> None:
        pass

    def set_error(self, message: str) -> None:
        pass

    def traceparent(self) -> str:
        return ""

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    async def __aenter__(self) -> "_NoopSpan":
        return self

    async def __aexit__(self, exc_type, exc, tb) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


# -- exporters -----------------------------------------------------------------


class RingBufferExporter:
    """Bounded deque of finished span dicts — the store behind the
    ``/traces`` endpoint and the slow-query log. Receives EVERY span
    while tracing is enabled (sampling gates only the file exporter):
    the ring's job is "what just happened", and a bounded recent window
    costs the same either way."""

    def __init__(self, capacity: int = 2048) -> None:
        self.capacity = capacity
        self._buf: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()

    def export(self, span_dict: Dict[str, Any]) -> None:
        with self._lock:
            self._buf.append(span_dict)

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()

    def spans(self, trace_id: Optional[str] = None,
              min_duration_ms: Optional[float] = None,
              errors_only: bool = False,
              limit: int = 100) -> List[Dict[str, Any]]:
        """Newest-first filtered view (the ``/traces`` contract)."""
        with self._lock:
            snap = list(self._buf)
        out: List[Dict[str, Any]] = []
        for d in reversed(snap):
            if trace_id is not None and d.get("traceId") != trace_id:
                continue
            if min_duration_ms is not None and \
                    d.get("durationUs", 0) < min_duration_ms * 1000.0:
                continue
            if errors_only and d.get("status") != "error":
                continue
            out.append(d)
            if len(out) >= limit:
                break
        return out

    def trace(self, trace_id: str) -> List[Dict[str, Any]]:
        """All buffered spans of one trace, oldest first."""
        with self._lock:
            snap = list(self._buf)
        got = [d for d in snap if d.get("traceId") == trace_id]
        got.sort(key=lambda d: d.get("startUs", 0))
        return got

    def export_by_trace_ids(self, trace_ids) -> List[Dict[str, Any]]:
        """All buffered spans belonging to any of the given trace ids,
        oldest first: the incident bundle's pin of the traces that the
        offending latency buckets name through their exemplars."""
        wanted = set(trace_ids)
        if not wanted:
            return []
        with self._lock:
            snap = list(self._buf)
        got = [d for d in snap if d.get("traceId") in wanted]
        got.sort(key=lambda d: d.get("startUs", 0))
        return got


class JSONLExporter:
    """Append-one-JSON-line-per-span file exporter with size-based
    rotation. Rotation follows the :mod:`atomic_write` discipline:
    ``os.replace`` to ``<path>.1`` then directory fsync, so ``pio
    trace`` never reads a half-moved file. Thread-safe; opens lazily so
    configuring a path costs nothing until the first sampled span."""

    def __init__(self, path: str, max_bytes: int = 32 * 1024 * 1024) -> None:
        self.path = path
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._f: Optional[Any] = None
        self._size = 0

    def _open(self) -> None:
        """Caller holds the lock."""
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(self.path, "ab")
        self._size = self._f.tell()

    def _rotate(self) -> None:
        """Caller holds the lock."""
        assert self._f is not None
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        self._f = None
        os.replace(self.path, self.path + ".1")
        d = os.path.dirname(self.path)
        fsync_dir(d if d else ".")
        self._open()

    def export(self, span_dict: Dict[str, Any]) -> None:
        data = (json.dumps(span_dict, separators=(",", ":"),
                           default=str) + "\n").encode("utf-8")
        with self._lock:
            if self._f is None:
                self._open()
            assert self._f is not None
            if self._size and self._size + len(data) > self.max_bytes:
                self._rotate()
            self._f.write(data)
            self._f.flush()
            self._size += len(data)

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


# -- tracer --------------------------------------------------------------------


class Tracer:
    """Process-wide tracing state: the enabled flag, the sampling
    policy, the ring buffer, and any extra exporters. There is one
    instance, :data:`TRACER`; :meth:`configure` is how the CLI flags
    reach it."""

    def __init__(self) -> None:
        self.enabled = False
        #: probability a NEW trace is file-exported (errors and slow
        #: spans always are — tail sampling)
        self.sample_rate = 1.0
        #: spans at/over this duration export regardless of sampling
        self.slow_span_ms = 250.0
        #: root spans at/over this get their full tree logged (0 = off)
        self.slow_query_ms = 0.0
        self.ring = RingBufferExporter()
        self.exporters: List[Any] = []
        self._rng = random.Random()

    def configure(self, enabled: bool = True,
                  sample_rate: Optional[float] = None,
                  slow_span_ms: Optional[float] = None,
                  slow_query_ms: Optional[float] = None,
                  jsonl_path: Optional[str] = None,
                  ring_capacity: Optional[int] = None,
                  exporters: Optional[List[Any]] = None) -> "Tracer":
        if sample_rate is not None:
            if not (0.0 <= sample_rate <= 1.0):
                raise ValueError(
                    f"sample_rate must be in [0, 1], got {sample_rate}")
            self.sample_rate = sample_rate
        if slow_span_ms is not None:
            self.slow_span_ms = slow_span_ms
        if slow_query_ms is not None:
            self.slow_query_ms = slow_query_ms
        if ring_capacity is not None:
            self.ring = RingBufferExporter(ring_capacity)
        if exporters is not None:
            self.exporters = list(exporters)
        if jsonl_path is not None:
            self.exporters = [e for e in self.exporters
                              if not isinstance(e, JSONLExporter)]
            self.exporters.append(JSONLExporter(jsonl_path))
        self.enabled = enabled
        return self

    def reset(self) -> None:
        """Back to the disabled defaults (tests)."""
        for e in self.exporters:
            close = getattr(e, "close", None)
            if close:
                try:
                    close()
                except Exception:
                    pass
        self.__init__()  # type: ignore[misc]

    # -- span lifecycle --------------------------------------------------------

    def _decide_sampled(self) -> bool:
        r = self.sample_rate
        return r >= 1.0 or (r > 0.0 and self._rng.random() < r)

    def finish(self, span: Span, exc_type=None, exc=None) -> None:
        """Close the books on a span: stamp duration, fold in any
        in-flight exception, export (fail-open), maybe log slowness."""
        if exc is not None and span.status != "error":
            span.set_error(f"{getattr(exc_type, '__name__', 'Exception')}: {exc}")
        span.duration_us = (time.perf_counter_ns() - span._t0) // 1000
        _M_SPANS.inc((span.status,))
        d = span.to_dict()
        try:
            faults.inject("trace.export")
            self.ring.export(d)
        except Exception:
            _M_EXPORT_FAILURES.inc()
        if span.sampled or span.status == "error" or \
                span.duration_us >= self.slow_span_ms * 1000.0:
            for exp in self.exporters:
                try:
                    faults.inject("trace.export")
                    exp.export(d)
                except Exception:
                    _M_EXPORT_FAILURES.inc()
        if span.parent_id is None and self.slow_query_ms > 0 and \
                span.duration_us >= self.slow_query_ms * 1000.0:
            try:
                self._log_slow(span)
            except Exception:  # the log is best-effort like the export
                _M_EXPORT_FAILURES.inc()

    def _log_slow(self, root: Span) -> None:
        tree = self.ring.trace(root.trace_id)
        logger.warning(
            "slow request trace=%s %s took %.1fms (threshold %.0fms)\n%s",
            root.trace_id, root.name, root.duration_us / 1000.0,
            self.slow_query_ms, render_trace_tree(tree))


TRACER = Tracer()


# -- span entry points ---------------------------------------------------------


def span(name: str, **attrs: Any):
    """Open a child span of the context's current span (or a new root
    if there is none). Usable as ``with`` and ``async with``. On the
    disabled path this returns the shared no-op handle."""
    tr = TRACER
    if not tr.enabled:
        return NOOP_SPAN
    parent = _CURRENT.get()
    if parent is not None:
        s = Span(name, parent.trace_id, parent.span_id, parent.sampled, attrs)
    else:
        s = Span(name, new_trace_id(), None, tr._decide_sampled(), attrs)
    return _SpanHandle(tr, s)


def root_span(name: str, trace_id: Optional[str] = None,
              parent_span_id: Optional[str] = None,
              sampled: Optional[bool] = None, **attrs: Any):
    """Open a trace root, honouring inbound propagation headers: an
    inbound trace id continues that trace; an inbound sampled flag
    overrides the local sampling decision. Ignores any span already in
    context (this IS the context boundary)."""
    tr = TRACER
    if not tr.enabled:
        return NOOP_SPAN
    if sampled is None:
        sampled = tr._decide_sampled()
    s = Span(name, trace_id or new_trace_id(), parent_span_id, sampled, attrs)
    return _SpanHandle(tr, s)


def detached_span(name: str, **attrs: Any):
    """A new root regardless of context — for background work (e.g. the
    coalescer's group commit) that serves MANY requests' traces and
    links to them via attributes instead of parentage."""
    tr = TRACER
    if not tr.enabled:
        return NOOP_SPAN
    s = Span(name, new_trace_id(), None, tr._decide_sampled(), attrs)
    return _SpanHandle(tr, s)


# -- context helpers -----------------------------------------------------------


def current_span() -> Optional[Span]:
    return _CURRENT.get()


def current_trace_id() -> Optional[str]:
    s = _CURRENT.get()
    return s.trace_id if s is not None else None


def exemplar() -> Optional[str]:
    """Trace id for histogram exemplars — None when tracing is off or
    no span is active, so ``observe(..., exemplar=tracing.exemplar())``
    is safe on every path."""
    if not TRACER.enabled:
        return None
    s = _CURRENT.get()
    return s.trace_id if s is not None else None


def add_attrs(**attrs: Any) -> None:
    """Attach attributes to the current span, if any — lets deep code
    (e.g. a storage backend) annotate the span its caller opened."""
    s = _CURRENT.get()
    if s is not None:
        s.attrs.update(attrs)


def bind_current(fn: Callable) -> Callable:
    """Carry the caller's context (current span included) into a plain
    ``ThreadPoolExecutor``; ``asyncio.to_thread`` does this natively, a
    raw ``submit`` does not (the engine server's feedback executor)."""
    ctx = contextvars.copy_context()

    def _bound(*args, **kwargs):
        return ctx.run(fn, *args, **kwargs)

    return _bound


# -- propagation headers -------------------------------------------------------


def parse_traceparent(value: str) -> Optional[Tuple[str, str, bool]]:
    """``(trace_id, parent_span_id, sampled)`` or None if malformed.
    Per W3C: all-zero ids are invalid; unknown versions are accepted on
    the 00 field layout."""
    m = _TRACEPARENT_RE.match(value.strip().lower())
    if m is None:
        return None
    version, trace_id, span_id, flags = m.groups()
    if version == "ff" or trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id, bool(int(flags, 16) & 1)


def extract_headers(
        headers: Dict[str, str]) -> Tuple[Optional[str], Optional[str],
                                          Optional[bool]]:
    """Inbound propagation from lowercase-keyed headers: prefer W3C
    ``traceparent``, fall back to ``x-pio-trace-id`` (id only, local
    sampling decision)."""
    tp = headers.get("traceparent")
    if tp:
        parsed = parse_traceparent(tp)
        if parsed is not None:
            return parsed
    tid = headers.get("x-pio-trace-id")
    if tid and _TRACE_ID_RE.match(tid):
        return tid.lower(), None, None
    return None, None, None


# -- presentation --------------------------------------------------------------


def render_trace_tree(spans: List[Dict[str, Any]]) -> str:
    """Indented one-line-per-span tree of a trace's span dicts (the
    slow-query log and ``pio trace --tree`` share this)."""
    by_id = {d["spanId"]: d for d in spans if d.get("spanId")}
    children: Dict[Optional[str], List[Dict[str, Any]]] = {}
    for d in spans:
        pid = d.get("parentId")
        key = pid if pid in by_id else None
        children.setdefault(key, []).append(d)
    for kids in children.values():
        kids.sort(key=lambda d: d.get("startUs", 0))
    lines: List[str] = []

    def emit(d: Dict[str, Any], depth: int) -> None:
        dur = d.get("durationUs", 0) / 1000.0
        status = d.get("status", "ok")
        attrs = d.get("attrs") or {}
        extra = " ".join(f"{k}={v}" for k, v in attrs.items())
        err = f" error={d['error']!r}" if d.get("error") else ""
        lines.append(f"{'  ' * depth}{d.get('name', '?')} {dur:.2f}ms "
                     f"[{status}]{err}{' ' + extra if extra else ''}")
        for kid in children.get(d.get("spanId"), []):
            emit(kid, depth + 1)

    for root in children.get(None, []):
        emit(root, 0)
    return "\n".join(lines)


def traces_payload(trace_id: Optional[str] = None,
                   min_ms: Optional[float] = None,
                   errors_only: bool = False,
                   limit: int = 100) -> Dict[str, Any]:
    """The ``/traces`` endpoint body (shared by both servers)."""
    spans = TRACER.ring.spans(trace_id=trace_id, min_duration_ms=min_ms,
                              errors_only=errors_only, limit=limit)
    return {"enabled": TRACER.enabled, "count": len(spans), "spans": spans}


def default_trace_path(home: str) -> str:
    """Where servers write (and ``pio trace`` reads) the JSONL export
    when ``--trace-file`` is not given."""
    return os.path.join(home, "traces", "spans.jsonl")
