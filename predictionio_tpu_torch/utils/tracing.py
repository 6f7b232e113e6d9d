"""Request-scoped tracing: the subset on the serving path.

Spans are linked by ``(trace_id, span_id, parent_id)``, timed with the
monotonic clock and kept in a bounded in-memory ring. Tracing is
disabled by default, and then :func:`span` costs one attribute read and
returns a shared no-op handle. Context propagates through
:mod:`contextvars`, so nested ``with span(...)`` blocks parent
correctly across ``await`` points and through ``asyncio.to_thread``.
Inbound W3C ``traceparent`` and ``X-PIO-Trace-Id`` headers are honoured
at the root.
"""

from __future__ import annotations

import contextvars
import os
import random
import re
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")
_TRACE_ID_RE = re.compile(r"^[0-9a-fA-F]{16,64}$")

_CURRENT: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "pio_torch_current_span", default=None)

_ID_RNG = random.Random(os.urandom(16))


def new_trace_id() -> str:
    return f"{_ID_RNG.getrandbits(128) | 1:032x}"


def new_span_id() -> str:
    return f"{_ID_RNG.getrandbits(64) | 1:016x}"


class Span:
    """One timed operation, finished when its ``with`` block exits."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "attrs",
                 "duration_us", "status", "error", "_t0")

    def __init__(self, name: str, trace_id: str, parent_id: Optional[str],
                 attrs: Optional[Dict[str, Any]] = None) -> None:
        self.name = name
        self.trace_id = trace_id
        self.span_id = new_span_id()
        self.parent_id = parent_id
        self.attrs: Dict[str, Any] = dict(attrs) if attrs else {}
        self.status = "ok"
        self.error: Optional[str] = None
        self.duration_us = 0
        self._t0 = time.perf_counter_ns()

    def set_attr(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def set_error(self, message: str) -> None:
        self.status = "error"
        self.error = message

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "traceId": self.trace_id, "spanId": self.span_id,
            "parentId": self.parent_id, "name": self.name,
            "durationUs": self.duration_us, "status": self.status,
        }
        if self.error is not None:
            d["error"] = self.error
        if self.attrs:
            d["attrs"] = self.attrs
        return d


class _SpanHandle:
    """Sync and async context manager: activates the span on enter,
    finishes it on exit; an exception marks it ``error`` and propagates."""

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
    """Shared do-nothing handle returned while tracing is disabled."""

    __slots__ = ()
    trace_id = ""

    def set_attr(self, key: str, value: Any) -> None:
        pass

    def set_error(self, message: str) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    async def __aenter__(self) -> "_NoopSpan":
        return self

    async def __aexit__(self, exc_type, exc, tb) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


class Tracer:
    """Process-wide tracing state: the enabled flag and the ring of
    finished spans."""

    def __init__(self, ring_capacity: int = 2048) -> None:
        self.enabled = False
        self._ring: deque = deque(maxlen=ring_capacity)
        self._lock = threading.Lock()

    def configure(self, enabled: bool = True) -> "Tracer":
        self.enabled = enabled
        return self

    def finish(self, span: Span, exc_type=None, exc=None) -> None:
        if exc is not None and span.status != "error":
            span.set_error(f"{getattr(exc_type, '__name__', 'Exception')}: {exc}")
        span.duration_us = (time.perf_counter_ns() - span._t0) // 1000
        with self._lock:
            self._ring.append(span.to_dict())

    def spans(self, trace_id: Optional[str] = None) -> List[Dict[str, Any]]:
        """Finished spans, oldest first, optionally of one trace."""
        with self._lock:
            snap = list(self._ring)
        return [d for d in snap if trace_id is None or d["traceId"] == trace_id]


TRACER = Tracer()


def span(name: str, **attrs: Any):
    """Open a child span of the context's current span (or a new root if
    there is none). Usable as ``with`` and ``async with``."""
    if not TRACER.enabled:
        return NOOP_SPAN
    parent = _CURRENT.get()
    if parent is not None:
        return _SpanHandle(TRACER, Span(name, parent.trace_id,
                                        parent.span_id, attrs))
    return _SpanHandle(TRACER, Span(name, new_trace_id(), None, attrs))


def root_span(name: str, trace_id: Optional[str] = None,
              parent_span_id: Optional[str] = None, **attrs: Any):
    """Open a trace root, continuing an inbound trace id when given."""
    if not TRACER.enabled:
        return NOOP_SPAN
    return _SpanHandle(TRACER, Span(name, trace_id or new_trace_id(),
                                    parent_span_id, attrs))


def exemplar() -> Optional[str]:
    """Trace id for histogram exemplars — None when tracing is off or no
    span is active."""
    if not TRACER.enabled:
        return None
    s = _CURRENT.get()
    return s.trace_id if s is not None else None


def extract_headers(
        headers: Dict[str, str]) -> Tuple[Optional[str], Optional[str]]:
    """Inbound (trace id, parent span id) from lowercase-keyed headers:
    W3C ``traceparent`` first, then ``x-pio-trace-id``."""
    tp = headers.get("traceparent")
    if tp:
        m = _TRACEPARENT_RE.match(tp.strip().lower())
        if m is not None:
            version, trace_id, span_id, _flags = m.groups()
            if version != "ff" and trace_id != "0" * 32 and span_id != "0" * 16:
                return trace_id, span_id
    tid = headers.get("x-pio-trace-id")
    if tid and _TRACE_ID_RE.match(tid):
        return tid.lower(), None
    return None, None
