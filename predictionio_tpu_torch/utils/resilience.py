"""Resilience primitives: the circuit breaker of the ingest path.

The port's copy of the JAX package's ``utils/resilience.py``, limited to
:class:`CircuitBreaker` in the decoupled shape the group-commit
coalescer (``server/ingest.py``) uses: ``admit()`` when an event is
queued, ``record_success()`` / ``record_failure()`` when its commit
returns. The per-call wrappers (``call``, ``acall`` and
``CircuitOpenError``), the half-open trial slots they reserve,
deadlines and retry with backoff come with the engine server's
operations surface.

Breaker state lands on the metrics registry as
``pio_circuit_breaker_state{breaker=...}`` (0 closed, 1 half-open,
2 open) plus a transition counter, under the JAX package's names.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

from predictionio_tpu_torch.utils.metrics import REGISTRY

CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"
_STATE_VALUE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    """Closed → open → half-open circuit breaker.

    Closed: ``failure_threshold`` CONSECUTIVE failures trip it open.
    Open: ``admit()`` is False until ``reset_timeout`` seconds pass.
    Half-open: admission resumes; the first recorded success closes the
    breaker, a failure re-opens it and restarts the reset clock.

    ``admit`` reserves nothing (submission and commit happen at
    different times), so in half-open a burst may run several trials;
    the first recorded outcome decides the state. All transitions are
    under one lock and never block, so the breaker is shared freely
    between worker threads and the event loop.
    """

    def __init__(self, name: str, *, failure_threshold: int = 5,
                 reset_timeout: float = 30.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.name = name
        self.failure_threshold = failure_threshold
        self.reset_timeout = reset_timeout
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
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
        """Open → half-open once the reset timeout has elapsed."""
        if (self._state == OPEN
                and self._clock() - self._opened_at >= self.reset_timeout):
            self._set_state(HALF_OPEN)

    # -- public API ------------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            self._tick()
            return self._state

    def retry_after(self) -> float:
        """Seconds until the next trial would be admitted."""
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

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            if self._state in (HALF_OPEN, OPEN):
                # OPEN too: a trial admitted during half-open may report
                # after a sibling re-opened it — the dependency
                # demonstrably works, close it
                self._set_state(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._tick()
            if self._state == HALF_OPEN:
                self._set_state(OPEN)
                self._opened_at = self._clock()
                self._failures = self.failure_threshold
            else:
                self._failures += 1
                if (self._state == CLOSED
                        and self._failures >= self.failure_threshold):
                    self._set_state(OPEN)
                    self._opened_at = self._clock()

