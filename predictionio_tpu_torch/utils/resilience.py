"""Resilience primitives: the port's copy of the JAX package's
``utils/resilience.py`` — deadlines, retry with exponential backoff and
full jitter, and a closed/open/half-open circuit breaker.

``retry_with_backoff`` wraps sync and coroutine functions alike, and the
breaker's state machine never blocks, so ``allow``/``admit``/
``record_*`` are safe on the event loop. The group-commit coalescer
(``server/ingest.py``) uses the breaker's decoupled shape (``admit`` at
enqueue, ``record_*`` at commit); the engine server's feedback goes
through its ``feedback_sink`` breaker, which ``/health`` reports and
whose ``on_open`` observer triggers an incident bundle.

Breaker state lands on the metrics registry as
``pio_circuit_breaker_state{breaker}`` (0 closed, 1 half-open, 2 open)
plus a transition counter, under the JAX package's names.
"""

from __future__ import annotations

import asyncio
import functools
import inspect
import random
import threading
import time
from typing import Any, Callable, Iterator, Optional, Sequence, Tuple, Type


class DeadlineExceeded(TimeoutError):
    """A Deadline ran out (subclasses TimeoutError so generic timeout
    handling — e.g. ``except TimeoutError`` around ``wait_for`` — sees
    both kinds with one clause)."""


class Deadline:
    """A monotonic point in time that work must finish by.

    Cheap value object: pass it down a call chain so every layer
    (retry loops, storage calls, probe queries) shares ONE budget
    instead of stacking per-layer timeouts that can add up to minutes.
    """

    __slots__ = ("_at",)

    def __init__(self, timeout_s: float, *,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self._at = clock() + float(timeout_s)

    @classmethod
    def after(cls, timeout_s: float) -> "Deadline":
        return cls(timeout_s)

    def remaining(self) -> float:
        """Seconds left; never negative (0.0 means expired)."""
        return max(0.0, self._at - time.monotonic())

    def expired(self) -> bool:
        return time.monotonic() >= self._at

    def check(self, what: str = "deadline") -> None:
        """Raise :class:`DeadlineExceeded` if the budget is gone."""
        if self.expired():
            raise DeadlineExceeded(f"{what} exceeded")

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Deadline(remaining={self.remaining():.3f}s)"


def backoff_delays(base: float, cap: float, *, jitter: str = "full",
                   rng: Optional[random.Random] = None) -> Iterator[float]:
    """Infinite exponential-backoff delay sequence.

    Attempt ``n`` targets ``min(cap, base * 2**n)``; ``jitter`` then
    spreads callers out (AWS Architecture blog terminology):

    - ``"full"``  — uniform in [0, target]: best herd dispersion, the
      retry default;
    - ``"equal"`` — target/2 + uniform in [0, target/2]: keeps a floor
      (used by the process supervisor, where a near-zero restart delay
      defeats the point);
    - ``"none"``  — deterministic target (tests).
    """
    if jitter not in ("full", "equal", "none"):
        raise ValueError(f"unknown jitter mode {jitter!r}")
    rng = rng or random
    n = 0
    while True:
        target = min(cap, base * (2 ** n))
        if jitter == "full":
            yield rng.uniform(0.0, target)
        elif jitter == "equal":
            yield target / 2 + rng.uniform(0.0, target / 2)
        else:
            yield target
        if target < cap:
            n += 1


def parse_retry_after(value: Optional[str]) -> Optional[float]:
    """Parse an HTTP ``Retry-After`` header value (delta-seconds form)
    into a positive float, or None. The HTTP-date form is not parsed —
    every server in this tree emits delta-seconds."""
    if not value:
        return None
    try:
        secs = float(str(value).strip())
    except (TypeError, ValueError):
        return None
    return secs if secs > 0 else None


def retry_after_hint(e: BaseException) -> Optional[float]:
    """Server-provided backoff hint riding on an exception: HTTP layers
    set a ``retry_after`` attribute (seconds) from a 429/503
    ``Retry-After`` header before re-raising. Positive float or None."""
    hint = getattr(e, "retry_after", None)
    if hint is None:
        return None
    try:
        hint = float(hint)
    except (TypeError, ValueError):
        return None
    return hint if hint > 0 else None


def retry_with_backoff(
    retries: int = 3,
    *,
    base: float = 0.05,
    cap: float = 2.0,
    jitter: str = "full",
    retry_on: Tuple[Type[BaseException], ...] = (Exception,),
    deadline: Optional[float] = None,
    rng: Optional[random.Random] = None,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
):
    """Decorator factory: retry the wrapped callable up to ``retries``
    extra times with exponential backoff + jitter.

    Works on sync functions (sleeps with ``time.sleep``) and coroutine
    functions (awaits ``asyncio.sleep``) — the event loop is never
    blocked. ``deadline`` (seconds, per invocation) bounds the WHOLE
    retry run: once the budget is gone the last error is raised rather
    than starting another attempt or sleep.

    A failure carrying a server-provided ``retry_after`` hint (see
    :func:`retry_after_hint` — set from a 429/503 ``Retry-After``
    header) overrides the jittered delay for that pause: the server
    knows its own recovery window better than our exponential guess.
    The hint is still bounded by ``deadline``.

    :class:`CircuitOpenError` is never retried, regardless of
    ``retry_on`` — an open breaker means the dependency is known-down
    and hammering it is exactly what the breaker exists to prevent.
    """

    def should_retry(e: BaseException) -> bool:
        return isinstance(e, retry_on) and not isinstance(e, CircuitOpenError)

    def next_pause(delays: Iterator[float], e: BaseException,
                   dl: Optional[Deadline]) -> float:
        pause = next(delays)
        hint = retry_after_hint(e)
        if hint is not None:
            pause = hint
        if dl is not None:
            pause = min(pause, dl.remaining())
        return pause

    def deco(fn: Callable) -> Callable:
        if inspect.iscoroutinefunction(fn):
            @functools.wraps(fn)
            async def awrapper(*args, **kwargs):
                dl = Deadline(deadline) if deadline is not None else None
                delays = backoff_delays(base, cap, jitter=jitter, rng=rng)
                for attempt in range(retries + 1):
                    try:
                        return await fn(*args, **kwargs)
                    except BaseException as e:
                        if (attempt >= retries or not should_retry(e)
                                or (dl is not None and dl.expired())):
                            raise
                        if on_retry is not None:
                            on_retry(attempt, e)
                        await asyncio.sleep(next_pause(delays, e, dl))
            return awrapper

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            dl = Deadline(deadline) if deadline is not None else None
            delays = backoff_delays(base, cap, jitter=jitter, rng=rng)
            for attempt in range(retries + 1):
                try:
                    return fn(*args, **kwargs)
                except BaseException as e:
                    if (attempt >= retries or not should_retry(e)
                            or (dl is not None and dl.expired())):
                        raise
                    if on_retry is not None:
                        on_retry(attempt, e)
                    time.sleep(next_pause(delays, e, dl))
        return wrapper

    return deco


def retry_call(fn: Callable, *args, retries: int = 3, **retry_kwargs) -> Any:
    """One-shot convenience: ``retry_call(fn, a, b, retries=2, ...)``.
    Keyword arguments other than the retry options go to the retry
    policy, not ``fn`` — wrap ``fn`` in a lambda/partial for kwargs."""
    return retry_with_backoff(retries, **retry_kwargs)(fn)(*args)


class CircuitOpenError(RuntimeError):
    """The breaker is open: the dependency is known-down, fail fast."""

    def __init__(self, breaker: str, retry_after: float) -> None:
        super().__init__(
            f"circuit breaker {breaker!r} is open "
            f"(retry after {retry_after:.1f}s)")
        self.breaker = breaker
        self.retry_after = retry_after


CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"
_STATE_VALUE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    """Closed → open → half-open circuit breaker.

    Closed: calls flow; ``failure_threshold`` CONSECUTIVE failures trip
    it open. Open: calls fail fast with :class:`CircuitOpenError` until
    ``reset_timeout`` seconds pass. Half-open: up to ``half_open_max``
    trial calls are admitted; one success closes the breaker, one
    failure re-opens it (and restarts the reset clock).

    Two usage shapes:

    - **per-call** — ``breaker.call(fn, *a)`` / ``await
      breaker.acall(coro_fn, *a)`` wrap one operation with
      admit/record;
    - **decoupled** — queue-fronted layers (the ingest coalescer) call
      ``admit()`` at enqueue time and ``record_success()`` /
      ``record_failure()`` at commit time. ``admit`` does not reserve a
      half-open slot (submission and trial happen at different times),
      so in half-open a burst may run several trials; the first
      recorded outcome decides the state.

    All state transitions are under one lock and never block, so the
    breaker is shared freely between worker threads and the event loop.
    """

    def __init__(self, name: str, *, failure_threshold: int = 5,
                 reset_timeout: float = 30.0, half_open_max: int = 1,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.name = name
        self.failure_threshold = failure_threshold
        self.reset_timeout = reset_timeout
        self.half_open_max = half_open_max
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._half_open_inflight = 0
        #: optional observer fired (OUTSIDE the lock) with the breaker
        #: name each time the state transitions to OPEN — the incident
        #: capture plane hangs its "breaker opened" trigger here. Must
        #: never raise into the recording caller; exceptions are eaten.
        self.on_open: Optional[Callable[[str], None]] = None
        from predictionio_tpu_torch.utils.metrics import REGISTRY

        self._m_state = REGISTRY.gauge(
            "pio_circuit_breaker_state",
            "Breaker state (0 closed, 1 half-open, 2 open)", ("breaker",))
        self._m_trans = REGISTRY.counter(
            "pio_circuit_breaker_transitions_total",
            "Breaker state transitions", ("breaker", "to"))
        self._m_state.set(0, (name,))

    # -- state machine (lock held) --------------------------------------------

    def _set_state(self, state: str) -> None:
        if state != self._state:
            self._state = state
            self._m_state.set(_STATE_VALUE[state], (self.name,))
            self._m_trans.inc((self.name, state))

    def _tick(self) -> None:
        """Open → half-open once the reset timeout has elapsed.
        Caller holds the lock."""
        if (self._state == OPEN
                and self._clock() - self._opened_at >= self.reset_timeout):
            self._set_state(HALF_OPEN)
            self._half_open_inflight = 0

    # -- public API ------------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            self._tick()
            return self._state

    def retry_after(self) -> float:
        """Seconds until the next trial call would be admitted."""
        with self._lock:
            self._tick()
            if self._state != OPEN:
                return 0.0
            return max(0.0, self.reset_timeout
                       - (self._clock() - self._opened_at))

    def admit(self) -> bool:
        """Non-reserving admission check: False only while OPEN."""
        with self._lock:
            self._tick()
            return self._state != OPEN

    def allow(self) -> bool:
        """Reserving admission: in half-open, takes one of the
        ``half_open_max`` trial slots (released by ``record_*``)."""
        with self._lock:
            self._tick()
            if self._state == CLOSED:
                return True
            if (self._state == HALF_OPEN
                    and self._half_open_inflight < self.half_open_max):
                self._half_open_inflight += 1
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            if self._half_open_inflight > 0:
                self._half_open_inflight -= 1
            if self._state in (HALF_OPEN, OPEN):
                # OPEN too: a decoupled trial that was admitted during
                # half-open may report after a sibling re-opened it —
                # the dependency demonstrably works, close it
                self._set_state(CLOSED)

    def record_failure(self) -> None:
        opened = False
        with self._lock:
            self._tick()
            if self._half_open_inflight > 0:
                self._half_open_inflight -= 1
            if self._state == HALF_OPEN:
                self._set_state(OPEN)
                self._opened_at = self._clock()
                self._failures = self.failure_threshold
                opened = True
            else:
                self._failures += 1
                if (self._state == CLOSED
                        and self._failures >= self.failure_threshold):
                    self._set_state(OPEN)
                    self._opened_at = self._clock()
                    opened = True
        if opened and self.on_open is not None:
            try:
                self.on_open(self.name)
            except Exception:
                pass  # an observer must never fail the recording caller

    def reset(self) -> None:
        """Force-close (admin/test hook)."""
        with self._lock:
            self._failures = 0
            self._half_open_inflight = 0
            self._set_state(CLOSED)

    # -- call wrappers ---------------------------------------------------------

    def call(self, fn: Callable, *args, **kwargs) -> Any:
        if not self.allow():
            raise CircuitOpenError(self.name, self.retry_after())
        try:
            out = fn(*args, **kwargs)
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return out

    async def acall(self, fn: Callable, *args, **kwargs) -> Any:
        if not self.allow():
            raise CircuitOpenError(self.name, self.retry_after())
        try:
            out = fn(*args, **kwargs)
            if inspect.isawaitable(out):
                out = await out
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return out
