"""Feedback event sinks: how the Engine Server reports served
predictions back as events (the port's copy of the JAX package's
``server/eventsink.py``).

The reference's engine server posts feedback through the Event Server's
authenticated HTTP API (reference: [U] core/.../workflow/CreateServer
feedback with ``eventServerIp``/``eventServerPort`` + ``accessKey`` —
unverified, SURVEY.md §3.2) — NOT by writing the event store directly,
because event storage is generally remote to the serving host and the
access key enforces the app's write contract. The sink is injectable:

- :class:`HTTPEventSink` — the reference-faithful path: ``POST
  {url}/events.json?accessKey=…[&channel=…]``. Default when a feedback
  URL is configured.
- :class:`DirectEventSink` — in-process write into the local storage
  (single-box deployments with no Event Server running).

Sinks run off the serving hot path (fire-and-forget worker thread) and
must never raise into the caller; failures are counted, not fatal.
``send_batch`` delivers a backlog at once: the HTTP sink posts several
events to ``/batch/events.json`` (one event alone still goes to
``/events.json``), the direct sink makes one ``insert_batch``. The
engine server's feedback workers use it, so that feedback keeps pace
with serving (the JAX package's sinks have ``send`` only).

Resilience: :class:`HTTPEventSink` retries transient failures with
exponential backoff + full jitter, and accepts an optional
:class:`~predictionio_tpu_torch.utils.resilience.CircuitBreaker` for
standalone use — a down Event Server then fails fast with
``CircuitOpenError`` instead of paying the connect timeout per event.
(The engine server wraps whatever sink it is given in its own
``engine_feedback_sink`` breaker, reported on ``/health``, so it does
not pass one here.) The ``eventsink.send`` fault-injection site covers
both sinks.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.parse
import urllib.request
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional

from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.utils import faults, tracing
from predictionio_tpu_torch.utils.metrics import REGISTRY
from predictionio_tpu_torch.utils.resilience import (
    CircuitBreaker,
    parse_retry_after,
    retry_with_backoff,
)

#: leader-redirect traffic: result="followed" per 307/308 hop taken,
#: "exhausted" when the hop budget runs out mid-chain. A rising
#: followed-rate means writers are pointed at a follower (update the
#: sink URL); any exhausted means two nodes redirect at each other —
#: a split-brain symptom worth a page.
_M_REDIRECTS = REGISTRY.counter(
    "pio_eventsink_redirects_total",
    "Event-plane leader redirects (307/308) seen by the feedback sink",
    ("result",))


class RedirectExhausted(RuntimeError):
    """The redirect chain outlived ``REDIRECT_HOPS`` — distinct from a
    generic send failure so dashboards and tests can tell "the leader
    moved" from "the event server is down". Still a
    :class:`RuntimeError`, so the send retry (which re-enters at the
    original URL, picking up the post-failover redirect) applies."""

    def __init__(self, message: str, retry_after: Optional[float] = None
                 ) -> None:
        super().__init__(message)
        self.retry_after = retry_after


class EventSink(ABC):
    """Delivers one feedback event; raises on failure (the caller
    counts and swallows — feedback must never break serving). Returns
    the server-assigned event id when the backend reports one."""

    @abstractmethod
    def send(self, event: Event) -> Optional[str]:
        ...


class HTTPEventSink(EventSink):
    """Authenticated POST to an Event Server's ``/events.json``.

    Understands the replicated event plane: a follower answers writes
    with ``307`` + ``Location`` pointing at the current leader, so the
    sink re-POSTs there (bounded hops — a redirect loop between two
    confused nodes must not spin forever; any ``Retry-After`` on the
    redirect is honored first). A redirect onto a node that just died
    surfaces as a retryable error, and the backoff retry re-enters at
    the ORIGINAL url — whose redirect points at the NEW leader once
    promotion lands. Writers therefore never hard-fail across a
    failover."""

    #: additional hops followed after the initial POST
    REDIRECT_HOPS = 4

    def __init__(self, url: str, access_key: str,
                 channel: Optional[str] = None,
                 timeout: float = 5.0,
                 retries: int = 2,
                 breaker: Optional[CircuitBreaker] = None) -> None:
        self.url = url.rstrip("/")
        self.access_key = access_key
        self.channel = channel
        self.timeout = timeout
        self.retries = retries
        self.breaker = breaker

    def _post_json(self, path: str, payload: Any) -> Any:
        """POST ``payload`` as JSON to ``path`` (following redirects) and
        return the decoded answer, None when it is not JSON."""
        faults.inject("eventsink.send")
        qs: Dict[str, str] = {"accessKey": self.access_key}
        if self.channel:
            qs["channel"] = self.channel
        target = f"{self.url}{path}?{urllib.parse.urlencode(qs)}"
        body = json.dumps(payload).encode("utf-8")
        for hop in range(self.REDIRECT_HOPS + 1):
            req = urllib.request.Request(
                target, data=body,
                headers={"Content-Type": "application/json"},
                method="POST")
            try:
                with urllib.request.urlopen(req,
                                            timeout=self.timeout) as resp:
                    if resp.status not in (200, 201):
                        raise RuntimeError(
                            f"event server returned {resp.status}")
                    try:
                        return json.loads(resp.read())
                    except ValueError:
                        return None
            except urllib.error.HTTPError as e:
                hint = parse_retry_after(e.headers.get("Retry-After"))
                if e.code in (307, 308):
                    # follower → leader redirect (urllib refuses to
                    # auto-resend a POST body, so we follow by hand)
                    loc = e.headers.get("Location")
                    if loc and hop < self.REDIRECT_HOPS:
                        _M_REDIRECTS.inc(("followed",))
                        target = urllib.parse.urljoin(target, loc)
                        if hint:
                            time.sleep(min(hint, 1.0))
                        continue
                    _M_REDIRECTS.inc(("exhausted",))
                    raise RedirectExhausted(
                        f"event server redirect not followable after "
                        f"{hop} hop(s): {e.code}", hint) from e
                if e.code == 429:
                    # backpressure, not rejection: retryable, and the
                    # server's Retry-After hint overrides our backoff
                    # guess
                    err = RuntimeError(
                        "event server throttled feedback: 429")
                    err.retry_after = hint
                    raise err from e
                if e.code < 500:
                    # deterministic rejection (bad key, bad event):
                    # raise a type outside retry_on so it is NOT
                    # retried
                    raise ValueError(
                        f"event server rejected feedback: {e.code}") from e
                err = RuntimeError(f"event server returned {e.code}")
                err.retry_after = hint
                raise err from e
        raise RuntimeError("unreachable: redirect loop guard")

    def _post(self, event: Event) -> Optional[str]:
        return (self._post_json("/events.json", event.to_json())
                or {}).get("eventId")

    def _post_batch(self, events: List[Event]) -> List[Optional[str]]:
        doc = self._post_json("/batch/events.json",
                              [e.to_json() for e in events])
        if not isinstance(doc, list) or len(doc) != len(events):
            raise RuntimeError(f"event server answered a batch of "
                               f"{len(events)} with {doc!r:.200}")
        return [d.get("eventId") if d.get("status") == 201 else None
                for d in doc]

    def _retried(self, fn, arg):
        # retry transient delivery failures (short, jittered — feedback
        # is best-effort and must not occupy its worker for long), but
        # NOT client errors: a 4xx (bad key, bad event) is deterministic
        # and retrying it just hammers the Event Server
        attempt = retry_with_backoff(
            self.retries, base=0.05, cap=0.5,
            retry_on=(OSError, RuntimeError),
        )(fn)
        if self.breaker is not None:
            return self.breaker.call(attempt, arg)
        return attempt(arg)

    def send(self, event: Event) -> Optional[str]:
        with tracing.span("sink.send", sink="http", url=self.url):
            return self._retried(self._post, event)

    def send_batch(self, events: List[Event]) -> List[Optional[str]]:
        """Deliver up to 50 events (the Event Server's batch limit): one
        alone goes to ``/events.json`` as :meth:`send`, several to
        ``/batch/events.json`` in one POST. Each event's id, or None for
        one the server refused; a refusal of the whole POST raises."""
        if len(events) == 1:
            return [self.send(events[0])]
        with tracing.span("sink.send", sink="http", url=self.url,
                          records=len(events)):
            return self._retried(self._post_batch, events)


class DirectEventSink(EventSink):
    """In-process write (no Event Server between serving and storage)."""

    def __init__(self, storage: Any, app_name: str) -> None:
        self.storage = storage
        self.app_name = app_name

    def send(self, event: Event) -> Optional[str]:
        with tracing.span("sink.send", sink="direct", app=self.app_name):
            faults.inject("eventsink.send")
            app = self.storage.meta.get_app_by_name(self.app_name)
            if app is None:
                raise ValueError(f"no app named {self.app_name!r}")
            return self.storage.events.insert(event, app.id)

    def send_batch(self, events: List[Event]) -> List[Optional[str]]:
        with tracing.span("sink.send", sink="direct", app=self.app_name,
                          records=len(events)):
            faults.inject("eventsink.send")
            app = self.storage.meta.get_app_by_name(self.app_name)
            if app is None:
                raise ValueError(f"no app named {self.app_name!r}")
            return self.storage.events.insert_batch(events, app.id)
