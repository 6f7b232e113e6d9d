"""Fleet router: health-aware reverse proxy over N engine-server replicas
(the port's copy of the JAX package's ``server/router.py``; its replicas
are the port's ``deploy`` processes, each serving through the card).

One engine server is one SIGKILL away from a dark app. This router puts
a replica SET behind a single endpoint: clients talk
to the router; the router spreads queries over healthy replicas and
absorbs single-replica failures, reloads, and latency outliers.

Architecture (all asyncio, single loop, dependency-free — the HTTP
client is built on ``asyncio.open_connection`` because the environment
bakes no aiohttp):

- **Replica state machine** — each replica is ``ok | degraded |
  not-ready | down``, driven by two signals: ACTIVE ``/health`` polling
  every ``health_interval`` (picks up the AOT warm-up's not-ready, open
  dependency breakers, and replica identity), and PASSIVE outlier
  ejection through a per-replica :class:`CircuitBreaker` fed by live
  request outcomes — a replica that fails requests stops receiving them
  before the next poll notices.
- **Replica identity** — ``/health`` carries ``instance`` (process
  uid), ``startedAt``, and ``reloadGeneration``. An identity change
  means a RESTARTED replica, not a flapping one: the router resets its
  breaker and EWMA instead of keeping the fresh process ejected for the
  old process's sins.
- **Load balancing** — power-of-two-choices: sample two available
  replicas, route to the lower ``(inflight + 1) x EWMA-latency`` score.
  Near-optimal load spread at O(1) per request, no global sort.
- **Deadline + trace propagation** — the client's remaining budget
  travels down in ``X-PIO-Deadline-Ms`` and SHRINKS per hop; W3C
  ``traceparent`` flows through (router span when tracing is on,
  passthrough otherwise) so one trace id explains a request across the
  fleet.
- **Retry budget** — retries are token-bucket capped at
  ``retry_budget_ratio`` of live traffic, so a brown-out cannot be
  amplified into a retry storm. Non-idempotent POSTs (feedback,
  events) are NEVER retried; ``/queries.json`` POSTs are read-only by
  contract and are.
- **Per-tenant budgets** — requests carrying ``X-PIO-App`` (forwarded
  downstream unchanged) additionally spend from THAT app's retry/hedge
  bucket, refilled only by that app's live traffic and scaled by its
  quota weight. A retrying tenant draws down its own budget before the
  fleet's, so one tenant's brown-out cannot eat the shared retry
  allowance. Per-app ``deadline_ms`` quota overrides cap the deadline
  budget the router grants that tenant.
- **Hedging** — a ``/queries.json`` attempt still running after the
  rolling p95 of recent latencies gets a second attempt on a different
  replica; first answer wins, the loser is cancelled. Hedges draw from
  the same retry budget.
- **Retry-After honoring** — a replica answering 429/503 with
  ``Retry-After`` is backed off for exactly that window (the engine
  server's hint: breaker reset or AOT re-warm ETA).
- **Rolling reload** — ``router reload --rolling`` (or ``POST
  /router/reload?rolling=1``): one replica at a time is drained
  (out of rotation, in-flight allowed to finish), told to ``/reload``
  (probe-then-swap + AOT pre-warm happen replica-side), polled back to
  ready, and re-admitted. A full-fleet model swap serves zero errors.

- **Observability plane** — the router keeps an in-process
  time-series store (``utils/timeseries.py``) fed by its own registry
  AND by federating every replica's ``/metrics`` (summed, re-exposed
  as ``pio_fleet_*``), evaluates declarative SLOs from
  ``conf/slo.json`` into multi-window burn-rate gauges, and runs a
  low-QPS synthetic prober whose canary queries (tagged
  ``X-PIO-Probe``) keep the SLO series alive at zero real traffic.
  ``GET /metrics/history``, ``/slo/status`` and ``/top`` serve the
  history; a fast burn degrades ``/health``.

Fault sites (``utils/faults.py``): ``router.replica.down`` and
``router.replica.slow`` on the forward path, ``router.health.flap`` on
the active probe, ``slo.probe.fail`` on the synthetic prober.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import os
import random
import time
import urllib.parse
import uuid
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Set, Tuple

from predictionio_tpu_torch.server.http import (
    HTTPServer,
    Request,
    Response,
    Router,
    traces_handler,
)
from predictionio_tpu_torch.server.slo import SloEngine
from predictionio_tpu_torch.server.tenancy import TenantQuotas
from predictionio_tpu_torch.utils import tracing
from predictionio_tpu_torch.utils.faults import FAULTS
from predictionio_tpu_torch.utils.metrics import REGISTRY, _num, build_info
from predictionio_tpu_torch.utils.resilience import CircuitBreaker, parse_retry_after
from predictionio_tpu_torch.utils.timeseries import (
    LabelSet,
    TimeSeriesStore,
    history_payload,
    parse_duration,
    parse_prom_text,
    parse_selector,
    render_key,
    scaled_tiers,
    scrape_loop,
)

# replica states (the router's view; /health's "ok"/"degraded"/
# "not-ready" map onto the first three, "down" is the router's own
# verdict after failed probes)
OK, DEGRADED, NOT_READY, DOWN = "ok", "degraded", "not-ready", "down"

#: pio_router_replica_state gauge encoding
_STATE_CODE = {OK: 0, DEGRADED: 1, NOT_READY: 2, DOWN: 3}
_DRAINING_CODE = 4

#: POST paths that are safe to retry/hedge: /queries.json is read-only
#: by contract (a prediction, not a write). Feedback/event POSTs are
#: not — a retried POST /events.json is a duplicate event.
_IDEMPOTENT_POSTS = frozenset({"/queries.json"})

#: consecutive probe failures before a replica is marked down (one
#: blip must not eject a replica the passive path still likes)
_DOWN_AFTER = 2

#: paths that get their own per-path latency series; anything else is
#: folded into "other" — the path is client-controlled and a metric
#: label must never be an unbounded attacker-chosen string
_TOP_PATHS = frozenset({"/queries.json", "/feedback.json", "/events.json"})

#: fallback SLO config consulted when the ctor gets no explicit path
_DEFAULT_SLO_CONFIG = os.path.join("conf", "slo.json")


class ReplicaError(RuntimeError):
    """Transport-level failure talking to a replica."""


class Replica:
    """One engine-server backend and everything the router knows
    about it."""

    @staticmethod
    def parse_hostport(url: str) -> Tuple[str, int]:
        u = url.strip()
        if "//" not in u:
            u = "http://" + u
        parts = urllib.parse.urlsplit(u)
        if not parts.hostname or not parts.port:
            raise ValueError(f"replica url needs host:port, got {url!r}")
        return parts.hostname, parts.port

    def __init__(self, url: str, *,
                 breaker_threshold: int = 3,
                 breaker_reset: float = 5.0) -> None:
        self.host, self.port = self.parse_hostport(url)
        self.name = f"{self.host}:{self.port}"
        self.state = NOT_READY  # unknown until the first probe
        self.draining = False
        self.inflight = 0
        self.ewma_sec = 0.0
        #: loop-time before which this replica takes no traffic
        #: (replica-sent Retry-After on 429/503)
        self.backoff_until = 0.0
        #: the backoff came from a not-ready /health answer: it ends as
        #: soon as /health reports the replica serving again
        self.health_backoff = False
        self.health_failures = 0
        #: identity from /health; a change == restarted process
        self.instance: Optional[str] = None
        self.started_at: Optional[float] = None
        self.reload_generation: int = -1
        self.last_health: Dict[str, Any] = {}
        self.breaker = CircuitBreaker(
            f"router_replica_{self.name}",
            failure_threshold=breaker_threshold,
            reset_timeout=breaker_reset)
        #: pooled keep-alive connections (reader, writer)
        self.pool: List[Tuple[asyncio.StreamReader, asyncio.StreamWriter]] = []

    def available(self, now: float) -> bool:
        """In rotation right now? Active state says serving, not
        draining, not inside a Retry-After window, and the passive
        breaker admits traffic (half-open probes flow — the breaker's
        ``admit`` is non-reserving, the real gate is recorded
        outcomes)."""
        return (not self.draining
                and self.state in (OK, DEGRADED)
                and now >= self.backoff_until
                and self.breaker.admit())

    def score(self) -> float:
        """P2C score: lower is better. In-flight count weighted by the
        replica's EWMA latency, floored so a fresh replica (no samples)
        still competes."""
        return (self.inflight + 1) * max(self.ewma_sec, 1e-4)

    def observe(self, dt: float) -> None:
        self.ewma_sec = dt if self.ewma_sec == 0 else (
            0.8 * self.ewma_sec + 0.2 * dt)

    def reset_runtime(self) -> None:
        """A restarted process inherits none of its predecessor's
        penalties."""
        self.breaker.reset()
        self.ewma_sec = 0.0
        self.backoff_until = 0.0
        self.health_backoff = False
        self.health_failures = 0

    def close_pool(self) -> None:
        for _, w in self.pool:
            with contextlib.suppress(Exception):
                w.close()
        self.pool.clear()

    def snapshot(self) -> Dict[str, Any]:
        return {
            "url": f"http://{self.name}",
            "state": self.state,
            "draining": self.draining,
            "inflight": self.inflight,
            "ewmaMs": round(self.ewma_sec * 1e3, 3),
            "breaker": self.breaker.state,
            "instance": self.instance,
            "startedAt": self.started_at,
            "reloadGeneration": self.reload_generation,
        }


class _Attempt:
    """Outcome of one proxied try against one replica. ``status == 0``
    means the request never got an HTTP answer (transport error, fault,
    down replica)."""

    __slots__ = ("replica", "status", "headers", "body", "error")

    def __init__(self, replica: Replica, status: int,
                 headers: Dict[str, str], body: bytes,
                 error: Optional[str] = None) -> None:
        self.replica = replica
        self.status = status
        self.headers = headers
        self.body = body
        self.error = error

    @property
    def retryable(self) -> bool:
        # 5xx and 429/503 are replica-local problems another replica
        # may not have; 4xx (bar 429) is the CLIENT's problem and
        # retrying it elsewhere just repeats the rejection
        return self.status == 0 or self.status >= 500 or self.status == 429


class FleetRouter:
    """The reverse proxy. One instance == one listening endpoint over
    one replica set."""

    def __init__(
        self,
        replicas: Optional[List[str]] = None,
        manifest: Optional[str] = None,
        host: str = "0.0.0.0",
        port: int = 8100,
        *,
        health_interval: float = 1.0,
        retry_budget_ratio: float = 0.1,
        retry_budget_burst: float = 10.0,
        hedge: bool = True,
        hedge_min_ms: float = 20.0,
        default_deadline_ms: float = 10000.0,
        per_try_timeout_ms: float = 0.0,
        connect_timeout_ms: float = 1000.0,
        drain_timeout: float = 30.0,
        ready_timeout: float = 120.0,
        breaker_threshold: int = 3,
        breaker_reset: float = 5.0,
        access_log: bool = False,
        tenant_quotas: Optional[Any] = None,
        slo_config: Optional[str] = None,
        observers: Optional[List[str]] = None,
        scrape_interval: float = 10.0,
        probe_interval: float = 0.0,
        probe_path: str = "/queries.json",
        probe_body: str = '{"user": "pio-probe", "num": 1}',
        incident_dir: Optional[str] = None,
        incident_debounce: float = 300.0,
        incident_retain: int = 20,
        pool: Optional[Any] = None,
        autoscale: Optional[Any] = None,
        remediations: Optional[str] = None,
    ) -> None:
        if not replicas and not manifest:
            raise ValueError("need a replica list or a manifest file")
        self.manifest = manifest
        self._manifest_mtime = 0.0
        self._breaker_threshold = breaker_threshold
        self._breaker_reset = breaker_reset
        #: per-replica variant-weight pins from the manifest
        #: (``URL variants=champion:9,challenger:1`` lines), keyed by
        #: replica name; pushed to the replica's POST /variants/weights
        #: by the health loop (probe-then-apply happens replica-side)
        self._variant_pins: Dict[str, Dict[str, float]] = {}
        self._pins_pushed: Dict[str, Dict[str, float]] = {}
        #: observe-only members (``observe=1`` manifest lines, e.g. the
        #: continuous trainer's metrics listener): health-polled and
        #: federated into the fleet series, never routed or probed
        self._manifest_observers: List[str] = []
        urls = list(replicas or [])
        if manifest:
            urls = self._manifest_urls() or urls
        self.replicas: List[Replica] = [self._make_replica(u) for u in urls]
        self.observers: List[Replica] = [
            self._make_replica(u) for u in (observers or [])
            + self._manifest_observers]
        self.health_interval = max(0.05, health_interval)
        self.default_deadline = max(0.001, default_deadline_ms / 1e3)
        self.per_try_timeout = max(0.0, per_try_timeout_ms / 1e3)
        self.connect_timeout = max(0.05, connect_timeout_ms / 1e3)
        self.drain_timeout = drain_timeout
        self.ready_timeout = ready_timeout
        self.hedge_enabled = hedge
        self.hedge_min = max(0.001, hedge_min_ms / 1e3)
        #: rolling window of successful /queries.json latencies; the
        #: hedge fires at its p95 — hedging the median would double
        #: traffic, hedging only the true tail costs ~5%
        self._lat_window: Deque[float] = deque(maxlen=512)
        self._hedge_delay_cached = self.hedge_min
        self._lat_seen = 0
        #: retry token bucket: each live request deposits
        #: ``retry_budget_ratio`` tokens (capped at burst); a retry or
        #: hedge withdraws 1.0. Loop-thread-only — no lock.
        self.retry_budget_ratio = max(0.0, retry_budget_ratio)
        self.retry_budget_burst = max(1.0, retry_budget_burst)
        self._budget_tokens = self.retry_budget_burst
        #: per-tenant sub-buckets under the global one, keyed by the
        #: ``X-PIO-App`` header ("-" when absent). Refilled only by
        #: that tenant's live traffic; a retry/hedge must clear BOTH
        #: its own bucket and the global one. Loop-thread-only.
        if isinstance(tenant_quotas, str):
            self.quotas = TenantQuotas(tenant_quotas)
        elif tenant_quotas is not None:
            self.quotas = tenant_quotas
        else:
            self.quotas = TenantQuotas.for_home(
                os.environ.get("PIO_HOME")
                or os.path.join(os.path.expanduser("~"), ".pio_store"))
        self._app_tokens: Dict[str, float] = {}
        self._reload_lock: Optional[asyncio.Lock] = None
        self._rng = random.Random(0x9107)

        # -- observability plane: TSDB + federation + SLOs + prober
        self.instance_uid = uuid.uuid4().hex[:12]
        build_info(self.instance_uid)
        self.scrape_interval = max(0.05, scrape_interval)
        self.probe_interval = max(0.0, probe_interval)
        self.probe_path = probe_path
        self.probe_body = probe_body.encode("utf-8")
        self.tsdb = TimeSeriesStore(
            REGISTRY, tiers=scaled_tiers(self.scrape_interval))
        if slo_config:
            self.slo = SloEngine.from_file(slo_config, self.tsdb)
        elif os.path.exists(_DEFAULT_SLO_CONFIG):
            self.slo = SloEngine.from_file(_DEFAULT_SLO_CONFIG, self.tsdb)
        else:
            self.slo = SloEngine(self.tsdb)
        #: last federated snapshot, appended verbatim to /metrics so
        #: one scrape of the router sees the whole fleet
        self._fleet_snapshot: Dict[Tuple[str, LabelSet], float] = {}

        # -- incident flight recorder: postmortem bundles on fast burn,
        # replica death, breaker open, SIGQUIT/crash (utils/incidents)
        self.incidents = None
        if incident_dir:
            from predictionio_tpu_torch.utils.incidents import (
                IncidentCapturer,
                IncidentStore,
                default_incident_dir,
            )

            if incident_dir == "auto":
                incident_dir = default_incident_dir(
                    os.environ.get("PIO_HOME")
                    or os.path.join(os.path.expanduser("~"), ".pio_store"))
            self.incidents = IncidentCapturer(
                IncidentStore(incident_dir, retain=incident_retain),
                process="router", debounce=incident_debounce)
            self.incidents.add_source("slo_status", self.slo.to_json)
            self.incidents.add_source("replicas", self._replica_doc)
            self.incidents.add_source(
                "tenants", lambda: {"appRetryTokens": dict(self._app_tokens)})
            self.incidents.set_history(self.tsdb, self._incident_selectors)
            for rep in self.replicas:   # built before the capturer was
                rep.breaker.on_open = lambda name: self.incidents.trigger(
                    "breaker-open", {"breaker": name})

        # -- self-healing plane: replica pool + autoscaler + remediator
        # (server/autoscale, server/remediate). The pool rewrites the
        # manifest; the mtime watcher above is how scaling reaches the
        # routing table — no extra discovery plumbing.
        self.pool = pool
        self.autoscaler = None
        self.remediator = None
        #: monotonic deadline until which the synthetic prober stays
        #: quiet (the probe-exclusion playbook / POST /probe?pause=N)
        self._probe_paused_until = 0.0
        if pool is not None or autoscale is not None:
            from predictionio_tpu_torch.server.autoscale import Autoscaler
            from predictionio_tpu_torch.server.remediate import (
                RemediationEngine,
                RouterActuator,
                load_playbooks,
            )

            self.remediator = RemediationEngine(
                RouterActuator(self, pool),
                load_playbooks(remediations),
                on_action=self._on_remediation)
            if autoscale is not None and pool is not None:
                self.autoscaler = Autoscaler(
                    self, pool, autoscale, remediator=self.remediator,
                    log=lambda *a: print(*a, flush=True))
            if self.incidents is not None:
                if self.autoscaler is not None:
                    self.incidents.add_source(
                        "autoscale", self.autoscaler.status_doc)
                self.incidents.add_source(
                    "remediations",
                    lambda: {"log": list(self.remediator.log)})

        self._m_state = REGISTRY.gauge(
            "pio_router_replica_state",
            "Replica state (0 ok, 1 degraded, 2 not-ready, 3 down, "
            "4 draining)", ("replica",))
        self._m_requests = REGISTRY.counter(
            "pio_router_requests_total", "Client requests answered",
            ("status",))
        self._m_attempts = REGISTRY.counter(
            "pio_router_attempts_total", "Proxied attempts per replica",
            ("replica", "outcome"))
        self._m_retries = REGISTRY.counter(
            "pio_router_retries_total", "Retried attempts",
            ("reason", "app"))
        self._m_retry_denied = REGISTRY.counter(
            "pio_router_retry_denied_total",
            "Retries NOT taken", ("reason", "app"))
        self._m_hedges = REGISTRY.counter(
            "pio_router_hedges_total", "Hedged /queries.json attempts",
            ("outcome", "app"))
        self._m_budget = REGISTRY.gauge(
            "pio_router_retry_budget_remaining",
            "Retry/hedge tokens currently in the bucket")
        self._m_budget.set(self._budget_tokens)
        self._m_app_budget = REGISTRY.gauge(
            "pio_router_app_retry_tokens",
            "Per-app retry/hedge tokens remaining", ("app",))
        self._m_replica_s = REGISTRY.histogram(
            "pio_router_replica_seconds",
            "Per-replica attempt latency (seconds)",
            labelnames=("replica",))
        self._m_rolling = REGISTRY.counter(
            "pio_router_rolling_reloads_total",
            "Rolling fleet reloads", ("result",))
        self._m_path_s = REGISTRY.histogram(
            "pio_router_path_seconds",
            "End-to-end routed request latency per path (seconds)",
            labelnames=("path",))
        self._m_probe = REGISTRY.counter(
            "pio_probe_requests_total",
            "Synthetic canary probes by path and outcome",
            ("path", "outcome"))
        self._m_probe_s = REGISTRY.histogram(
            "pio_probe_seconds",
            "Synthetic canary probe latency (seconds)",
            labelnames=("path",))
        self._m_federate = REGISTRY.counter(
            "pio_fleet_scrapes_total",
            "Replica /metrics federation scrapes", ("replica", "result"))

        router = Router()
        router.route("GET", "/", self._root)
        router.route("GET", "/health", self._own_health)
        router.route("GET", "/metrics", self._metrics)
        router.route("GET", "/metrics/history", self._metrics_history)
        router.route("GET", "/slo/status", self._slo_status)
        router.route("GET", "/top", self._top)
        router.route("GET", "/traces", traces_handler)
        router.route("GET", "/router/status", self._router_status)
        router.route("POST", "/router/reload", self._router_reload)
        router.route("GET", "/pool/status", self._pool_status)
        router.route("POST", "/pool/add", self._pool_add)
        router.route("POST", "/pool/remove", self._pool_remove)
        router.route("POST", "/pool/restart", self._pool_restart)
        router.route("GET", "/autoscale/status", self._autoscale_status)
        router.route("POST", "/probe", self._probe_ctl)
        router.route("GET", "/{path+}", self._proxy)
        router.route("POST", "/{path+}", self._proxy)
        self.http = HTTPServer(router, host, port, access_log=access_log,
                               server_name="router")

    # -- replica set -------------------------------------------------------

    def _make_replica(self, url: str) -> Replica:
        rep = Replica(url, breaker_threshold=self._breaker_threshold,
                      breaker_reset=self._breaker_reset)
        if getattr(self, "incidents", None) is not None:
            rep.breaker.on_open = lambda name: self.incidents.trigger(
                "breaker-open", {"breaker": name})
        return rep

    # -- self-healing plane ------------------------------------------------

    def _on_remediation(self, entry: Dict[str, Any]) -> None:
        """Every executed (or refused) remediation becomes an incident
        timeline entry — the bundle answers "what did the machine do
        about it" next to "what went wrong"."""
        if self.incidents is not None:
            self.incidents.trigger("remediation", {
                "playbook": entry.get("playbook"),
                "action": entry.get("action"),
                "target": entry.get("target"),
                "result": entry.get("result")})

    def pause_probe(self, seconds: float) -> None:
        """Silence the synthetic prober for ``seconds`` (auto-resumes;
        the probe-exclusion playbook's verb). Probing a known-broken
        canary target burns SLO budget without information."""
        self._probe_paused_until = time.monotonic() + max(0.0, seconds)

    def resume_probe(self) -> None:
        self._probe_paused_until = 0.0

    # -- incident capture sources ------------------------------------------

    def _replica_doc(self) -> Dict[str, Any]:
        """Sync replica-state snapshot for incident bundles (the async
        /router/status answer, minus anything needing the loop)."""
        return {"instance": self.instance_uid,
                "manifest": self.manifest,
                "replicas": [dict(r.snapshot(), name=r.name)
                             for r in self.replicas],
                "observers": [dict(r.snapshot(), name=r.name)
                              for r in self.observers]}

    def _incident_selectors(self) -> List[str]:
        """The history series a bundle pins: the SLO objectives' own
        series plus the router/fleet series a postmortem aligns
        against (replica states, shed and quota counters, burn
        rates)."""
        sels = {
            "pio_router_requests_total", "pio_router_replica_state",
            "pio_router_attempts_total", "pio_slo_burn_rate",
            "pio_circuit_breaker_state",
            "pio_fleet_engine_shed_total",
            "pio_fleet_tenant_quota_rejected_total",
            "pio_autoscale_decisions_total",
            "pio_autoscale_replicas",
            "pio_remediate_actions_total",
        }
        for spec in self.slo.specs:
            if spec.series:
                sels.add(spec.series)
            if spec.histogram:
                sels.update({f"{spec.histogram}_bucket",
                             f"{spec.histogram}_count"})
        return sorted(sels)

    def _read_manifest(self) -> List[str]:
        """One replica URL per line; blank lines and ``#`` comments
        skipped. A line may pin that replica's variant split with a
        trailing ``variants=name:weight,...`` annotation. Returns []
        when unreadable (keep the current set)."""
        if not self.manifest:
            return []
        try:
            self._manifest_mtime = os.stat(self.manifest).st_mtime
            with open(self.manifest, "r", encoding="utf-8") as f:
                return [ln.strip() for ln in f
                        if ln.strip() and not ln.strip().startswith("#")]
        except OSError:
            return []

    def _manifest_urls(self) -> List[str]:
        """Manifest lines → replica URLs, recording ``variants=`` pins
        (and dropping the pin of any replica that left the manifest)."""
        urls: List[str] = []
        pins: Dict[str, Dict[str, float]] = {}
        observers: List[str] = []
        for line in self._read_manifest():
            parts = line.split()
            url = parts[0]
            if any(tok == "observe=1" for tok in parts[1:]):
                # observe-only member: federated, never routed
                observers.append(url)
                continue
            urls.append(url)
            for tok in parts[1:]:
                if tok.startswith("variants="):
                    try:
                        from predictionio_tpu_torch.server.variants import (
                            parse_weights,
                        )

                        name = "%s:%d" % Replica.parse_hostport(url)
                        pins[name] = {s.name: s.weight for s in
                                      parse_weights(tok[len("variants="):])}
                    except Exception:
                        pass  # a bad pin never takes the manifest down
        if urls:
            self._variant_pins = pins
            for name in list(self._pins_pushed):
                if self._pins_pushed.get(name) != pins.get(name):
                    self._pins_pushed.pop(name, None)
        self._manifest_observers = observers
        return urls

    def _refresh_manifest(self) -> None:
        if not self.manifest:
            return
        try:
            mtime = os.stat(self.manifest).st_mtime
        except OSError:
            return
        if mtime == self._manifest_mtime:
            return
        urls = self._manifest_urls()
        if not urls:
            return
        want = {"%s:%d" % Replica.parse_hostport(u): u for u in urls}
        have = {r.name: r for r in self.replicas}
        for name, url in want.items():
            if name not in have:
                self.replicas.append(self._make_replica(url))
        for name, rep in list(have.items()):
            if name not in want:
                rep.close_pool()
                self.replicas.remove(rep)
                self._m_state.set(_STATE_CODE[DOWN], (name,))
        want_obs = {"%s:%d" % Replica.parse_hostport(u): u
                    for u in self._manifest_observers}
        have_obs = {r.name: r for r in self.observers}
        for name, url in want_obs.items():
            if name not in have_obs:
                self.observers.append(self._make_replica(url))
        for name, rep in list(have_obs.items()):
            if name not in want_obs:
                rep.close_pool()
                self.observers.remove(rep)

    # -- retry budget ------------------------------------------------------

    def _app_burst(self, app: str) -> float:
        """This tenant's bucket depth: the global burst scaled by its
        quota weight (floor 1.0 so every tenant can afford at least
        one retry)."""
        try:
            w = self.quotas.weight(app)
        except Exception:  # noqa: BLE001 — policy lookup must not 500
            w = 1.0
        return max(1.0, self.retry_budget_burst * w)

    def _budget_refill(self, app: str = "-") -> None:
        self._budget_tokens = min(
            self.retry_budget_burst,
            self._budget_tokens + self.retry_budget_ratio)
        self._m_budget.set(self._budget_tokens)
        tokens = self._app_tokens.get(app)
        if tokens is None:
            if len(self._app_tokens) >= 1024:
                # header values are attacker-controlled: drop full
                # (i.e. inert) buckets rather than grow without bound
                self._app_tokens = {
                    a: t for a, t in self._app_tokens.items()
                    if t < self._app_burst(a)}
            tokens = self._app_burst(app)
        self._app_tokens[app] = min(self._app_burst(app),
                                    tokens + self.retry_budget_ratio)
        self._m_app_budget.set(self._app_tokens[app], (app,))

    def _budget_take(self, app: str = "-") -> bool:
        """Spend one retry/hedge token: the tenant's own bucket AND
        the global one must both clear, atomically (loop-thread-only,
        no award between the two checks)."""
        tokens = self._app_tokens.get(app, self._app_burst(app))
        if tokens < 1.0 or self._budget_tokens < 1.0:
            return False
        self._app_tokens[app] = tokens - 1.0
        self._m_app_budget.set(self._app_tokens[app], (app,))
        self._budget_tokens -= 1.0
        self._m_budget.set(self._budget_tokens)
        return True

    # -- hedge delay -------------------------------------------------------

    def _note_query_latency(self, dt: float) -> None:
        self._lat_window.append(dt)
        self._lat_seen += 1
        # recompute the cached p95 every 32 samples — sorting 512
        # floats per request would be silly
        if self._lat_seen % 32 == 0 and len(self._lat_window) >= 32:
            ordered = sorted(self._lat_window)
            p95 = ordered[max(0, int(len(ordered) * 0.95) - 1)]
            self._hedge_delay_cached = max(self.hedge_min, p95)

    def _hedge_delay(self) -> float:
        if len(self._lat_window) < 32:
            return self.hedge_min
        return self._hedge_delay_cached

    # -- picking -----------------------------------------------------------

    def _pick(self, exclude: Set[str]) -> Optional[Replica]:
        """Power-of-two-choices over available replicas not in
        ``exclude``; falls back to the full available set when
        exclusion empties it (retrying the same replica beats 502)."""
        now = asyncio.get_running_loop().time()
        avail = [r for r in self.replicas
                 if r.available(now) and r.name not in exclude]
        if not avail:
            avail = [r for r in self.replicas if r.available(now)]
        if not avail:
            return None
        if len(avail) == 1:
            return avail[0]
        a, b = self._rng.sample(avail, 2)
        return a if a.score() <= b.score() else b

    # -- the HTTP client ---------------------------------------------------

    async def _connect(self, replica: Replica) -> Tuple[
            asyncio.StreamReader, asyncio.StreamWriter]:
        try:
            return await asyncio.wait_for(
                asyncio.open_connection(replica.host, replica.port),
                self.connect_timeout)
        except asyncio.TimeoutError:
            raise ReplicaError(f"connect to {replica.name} timed out")
        except OSError as e:
            raise ReplicaError(f"connect to {replica.name} failed: {e}")

    async def _roundtrip(self, replica: Replica,
                         conn: Tuple[asyncio.StreamReader,
                                     asyncio.StreamWriter],
                         payload: bytes, timeout: float
                         ) -> Tuple[int, Dict[str, str], bytes, bool]:
        """Write one request, read one response. Returns (status,
        headers, body, keep_alive)."""
        reader, writer = conn

        async def io() -> Tuple[int, Dict[str, str], bytes, bool]:
            writer.write(payload)
            await writer.drain()
            head = await reader.readuntil(b"\r\n\r\n")
            lines = head.decode("latin-1").split("\r\n")
            try:
                status = int(lines[0].split(" ", 2)[1])
            except (IndexError, ValueError):
                raise ReplicaError(
                    f"bad status line from {replica.name}: {lines[0]!r}")
            headers: Dict[str, str] = {}
            for ln in lines[1:]:
                if ":" in ln:
                    k, v = ln.split(":", 1)
                    headers[k.strip().lower()] = v.strip()
            length = int(headers.get("content-length", "0") or "0")
            body = await reader.readexactly(length) if length else b""
            keep = headers.get("connection", "keep-alive").lower() != "close"
            return status, headers, body, keep

        try:
            return await asyncio.wait_for(io(), timeout)
        except asyncio.TimeoutError:
            raise
        except ReplicaError:
            raise
        except (OSError, asyncio.IncompleteReadError,
                asyncio.LimitOverrunError) as e:
            raise ReplicaError(
                f"{replica.name}: {type(e).__name__}: {e}")

    async def _fetch(self, replica: Replica, method: str, target: str,
                     headers: Dict[str, str], body: bytes,
                     timeout: float) -> Tuple[int, Dict[str, str], bytes]:
        """One HTTP exchange with keep-alive pooling. A pooled
        connection that fails before the deadline is retried ONCE on a
        fresh one (the replica may have closed it between requests);
        a timeout is never retried here — that would silently double
        the per-try budget."""
        head = [f"{method} {target} HTTP/1.1",
                f"Host: {replica.name}",
                f"Content-Length: {len(body)}"]
        for k, v in headers.items():
            head.append(f"{k}: {v}")
        payload = ("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + body

        pooled = bool(replica.pool)
        conn = replica.pool.pop() if pooled else await self._connect(replica)
        try:
            status, rhead, rbody, keep = await self._roundtrip(
                replica, conn, payload, timeout)
        except asyncio.TimeoutError:
            self._close_conn(conn)
            raise ReplicaError(f"{replica.name}: per-try timeout "
                               f"({timeout * 1e3:.0f} ms)")
        except ReplicaError:
            self._close_conn(conn)
            if not pooled:
                raise
            # stale pooled socket — one fresh retry
            conn = await self._connect(replica)
            try:
                status, rhead, rbody, keep = await self._roundtrip(
                    replica, conn, payload, timeout)
            except (ReplicaError, asyncio.TimeoutError):
                self._close_conn(conn)
                raise
        except asyncio.CancelledError:
            self._close_conn(conn)
            raise
        if keep and len(replica.pool) < 8:
            replica.pool.append(conn)
        else:
            self._close_conn(conn)
        return status, rhead, rbody

    @staticmethod
    def _close_conn(conn: Tuple[asyncio.StreamReader,
                                asyncio.StreamWriter]) -> None:
        with contextlib.suppress(Exception):
            conn[1].close()

    # -- proxying ----------------------------------------------------------

    def _forward_headers(self, req: Request, remaining: float
                         ) -> Dict[str, str]:
        out: Dict[str, str] = {}
        ct = req.headers.get("content-type")
        if ct:
            out["Content-Type"] = ct
        # the budget SHRINKS per hop: what we forward is what is left
        out["X-PIO-Deadline-Ms"] = str(max(1, int(remaining * 1e3)))
        if tracing.TRACER.enabled:
            sp = tracing.current_span()
            tp = sp.traceparent() if sp is not None else ""
            if tp:
                out["traceparent"] = tp
        if "traceparent" not in out and "traceparent" in req.headers:
            out["traceparent"] = req.headers["traceparent"]
        if "x-pio-trace-id" in req.headers:
            out["X-PIO-Trace-Id"] = req.headers["x-pio-trace-id"]
        # tenant identity rides down with the request so the replica's
        # fair-admission gate sheds the right app under saturation
        if "x-pio-app" in req.headers:
            out["X-PIO-App"] = req.headers["x-pio-app"]
        return out

    async def _attempt(self, replica: Replica, req: Request, target: str,
                       deadline: float) -> _Attempt:
        """One try against one replica: fault sites, per-try timeout,
        latency observation, breaker + Retry-After bookkeeping. A
        cancelled attempt (lost hedge) records neither success nor
        failure — it proves nothing about the replica."""
        loop = asyncio.get_running_loop()
        remaining = deadline - loop.time()
        if remaining <= 0:
            return _Attempt(replica, 0, {}, b"", error="deadline exhausted")
        timeout = remaining
        if self.per_try_timeout > 0:
            timeout = min(timeout, self.per_try_timeout)
        headers = self._forward_headers(req, remaining)
        async def io() -> Tuple[int, Dict[str, str], bytes]:
            await FAULTS.ahit("router.replica.slow")
            await FAULTS.ahit("router.replica.down")
            return await self._fetch(
                replica, req.method, target, headers, req.body, timeout)

        replica.inflight += 1
        t0 = loop.time()
        try:
            # the outer wait_for also bounds injected fault latency —
            # a router.replica.slow sleep cannot outlive the deadline
            status, rhead, rbody = await asyncio.wait_for(io(), timeout)
        except asyncio.CancelledError:
            raise
        except Exception as e:  # ReplicaError, FaultError
            replica.breaker.record_failure()
            self._m_attempts.inc((replica.name, "error"))
            return _Attempt(replica, 0, {}, b"",
                            error=f"{type(e).__name__}: {e}")
        finally:
            replica.inflight -= 1
        dt = loop.time() - t0
        replica.observe(dt)
        self._m_replica_s.observe(dt, (replica.name,),
                                  exemplar=tracing.exemplar())
        if status >= 500 or status == 429:
            replica.breaker.record_failure()
            self._m_attempts.inc((replica.name, str(status)))
            if status in (429, 503):
                hint = parse_retry_after(rhead.get("retry-after"))
                if hint is not None:
                    replica.backoff_until = loop.time() + hint
                    replica.health_backoff = False
        else:
            replica.breaker.record_success()
            self._m_attempts.inc((replica.name, "ok"))
            if status == 200 and req.path == "/queries.json":
                self._note_query_latency(dt)
        return _Attempt(replica, status, rhead, rbody)

    async def _attempt_hedged(self, replica: Replica, req: Request,
                              target: str, deadline: float,
                              app: str = "-") -> _Attempt:
        """Primary attempt + (after the p95 delay) one hedge on a
        different replica. First non-retryable answer wins; the other
        task is cancelled. Falls back to plain behavior when no second
        replica or no budget (the hedge spends from the requesting
        tenant's bucket as well as the global one)."""
        primary = asyncio.create_task(
            self._attempt(replica, req, target, deadline))
        done, _ = await asyncio.wait({primary}, timeout=self._hedge_delay())
        tasks: List[asyncio.Task] = [primary]
        if not done:
            second = self._pick({replica.name})
            if second is not None and second is not replica \
                    and self._budget_take(app):
                self._m_hedges.inc(("launched", app))
                tasks.append(asyncio.create_task(
                    self._attempt(second, req, target, deadline)))
            elif second is not None and second is not replica:
                self._m_hedges.inc(("denied", app))
        hedged = len(tasks) > 1
        winner: Optional[_Attempt] = None
        fallback: Optional[_Attempt] = None
        pending = set(tasks)
        while pending and winner is None:
            done, pending = await asyncio.wait(
                pending, return_when=asyncio.FIRST_COMPLETED)
            for t in done:
                try:
                    att = t.result()
                except asyncio.CancelledError:
                    continue
                if not att.retryable:
                    winner = att
                    if hedged:
                        self._m_hedges.inc(
                            ("won", app) if t is not primary
                            else ("lost", app))
                    break
                fallback = fallback or att
        for t in pending:
            t.cancel()
        if pending:
            await asyncio.gather(*pending, return_exceptions=True)
        return winner or fallback or _Attempt(
            replica, 0, {}, b"", error="all attempts failed")

    def _is_idempotent(self, req: Request) -> bool:
        return req.method == "GET" or req.path in _IDEMPOTENT_POSTS

    async def _proxy(self, req: Request) -> Response:
        app = req.headers.get("x-pio-app", "") or "-"
        self._budget_refill(app)
        loop = asyncio.get_running_loop()
        budget = self.default_deadline
        if app != "-":
            try:
                cap = self.quotas.deadline_ms(app) / 1e3
            except Exception:  # noqa: BLE001 — policy lookup must not 500
                cap = 0.0
            if cap > 0:
                budget = min(budget, cap)
        hop = req.headers.get("x-pio-deadline-ms")
        if hop:
            try:
                v = float(hop) / 1e3
                if v > 0:
                    budget = min(budget, v)
            except ValueError:
                pass
        t_start = loop.time()
        deadline = t_start + budget
        path_label = req.path if req.path in _TOP_PATHS else "other"
        target = req.path
        if req.query:
            target += "?" + urllib.parse.urlencode(req.query, doseq=True)
        hedge = (self.hedge_enabled and req.method == "POST"
                 and req.path == "/queries.json")
        idempotent = self._is_idempotent(req)

        tried: Set[str] = set()
        att: Optional[_Attempt] = None
        while True:
            replica = self._pick(tried)
            if replica is None:
                break
            tried.add(replica.name)
            if hedge:
                att = await self._attempt_hedged(replica, req, target,
                                                 deadline, app)
            else:
                att = await self._attempt(replica, req, target, deadline)
            if not att.retryable:
                break
            # retry gates, in order of what they protect: correctness
            # (idempotency), the tenant + fleet (budgets), the client
            # (deadline)
            if not idempotent:
                self._m_retry_denied.inc(("non_idempotent", app))
                break
            if not self._budget_take(app):
                self._m_retry_denied.inc(("budget", app))
                break
            if deadline - loop.time() <= 0:
                self._m_retry_denied.inc(("deadline", app))
                break
            self._m_retries.inc(
                ("transport", app) if att.status == 0
                else (str(att.status), app))

        self._m_path_s.observe(loop.time() - t_start, (path_label,))
        if att is None:
            self._m_requests.inc(("503",))
            resp = Response.json(
                {"message": "no replica available"}, status=503)
            resp.headers["Retry-After"] = str(
                max(1, round(self.health_interval)))
            return resp
        if att.status == 0:
            self._m_requests.inc(("502",))
            return Response.json(
                {"message": f"all replicas failed: {att.error}"},
                status=502)
        self._m_requests.inc((str(att.status),))
        resp = Response(
            status=att.status, body=att.body,
            content_type=att.headers.get(
                "content-type", "application/json; charset=utf-8"))
        ra = att.headers.get("retry-after")
        if ra:
            resp.headers["Retry-After"] = ra
        return resp

    # -- health polling ----------------------------------------------------

    async def _poll_replica(self, replica: Replica) -> None:
        loop = asyncio.get_running_loop()
        try:
            await FAULTS.ahit("router.health.flap")
            status, _, body = await self._fetch(
                replica, "GET", "/health", {},
                b"", max(0.5, self.health_interval * 2))
        except Exception as e:  # noqa: BLE001 — any probe failure counts
            replica.health_failures += 1
            if replica.health_failures >= _DOWN_AFTER:
                if replica.state != DOWN and self.incidents is not None:
                    # trigger (b): the down TRANSITION, not the steady
                    # state — a replica that stays dead fires once
                    self.incidents.trigger(
                        "replica-down",
                        {"replica": replica.name, "error": str(e)})
                replica.state = DOWN
            replica.last_health = {"error": str(e)}
            return
        replica.health_failures = 0
        try:
            doc = json.loads(body) if body else {}
        except json.JSONDecodeError:
            doc = {}
        replica.last_health = doc
        ident = doc.get("instance")
        if ident and replica.instance and ident != replica.instance:
            # restarted replica: forget the old process's record
            replica.reset_runtime()
        if ident:
            replica.instance = ident
        if doc.get("startedAt") is not None:
            replica.started_at = doc.get("startedAt")
        if doc.get("reloadGeneration") is not None:
            replica.reload_generation = int(doc["reloadGeneration"])
        state = doc.get("status")
        if state in (OK, DEGRADED, NOT_READY):
            replica.state = state
        elif status == 200:
            replica.state = OK
        else:
            replica.state = NOT_READY
        if replica.state == NOT_READY and status == 503:
            hint = parse_retry_after(doc.get("retryAfterSec"))
            if hint is not None:
                replica.backoff_until = loop.time() + hint
                replica.health_backoff = True
        elif replica.health_backoff and replica.state in (OK, DEGRADED):
            # the hint estimated a warm-up that is over: a stale window
            # would keep a ready replica out of rotation, and a rolling
            # reload that re-admits it and drains the next would leave
            # no replica at all (the JAX package keeps the window)
            replica.backoff_until = 0.0
            replica.health_backoff = False

    def _publish_states(self) -> None:
        for r in self.replicas:
            code = _DRAINING_CODE if r.draining else _STATE_CODE[r.state]
            self._m_state.set(code, (r.name,))

    async def _poll_all(self) -> None:
        self._refresh_manifest()
        if self.replicas or self.observers:
            await asyncio.gather(
                *(self._poll_replica(r)
                  for r in self.replicas + self.observers))
        self._publish_states()
        await self._push_variant_pins()

    async def _push_variant_pins(self) -> None:
        """Apply manifest-pinned variant splits to serving replicas
        (POST /variants/weights — the replica itself enforces
        probe-then-apply). Idempotent per pin: pushed once, re-pushed
        only when the pin changes or the push failed (retried on the
        next health tick, so a replica that comes up late still
        converges to its pinned split)."""
        if not self._variant_pins:
            return
        for rep in self.replicas:
            pin = self._variant_pins.get(rep.name)
            if (pin is None or rep.state not in (OK, DEGRADED)
                    or self._pins_pushed.get(rep.name) == pin):
                continue
            try:
                await asyncio.to_thread(
                    self._post_weights, f"http://{rep.name}", pin)
                self._pins_pushed[rep.name] = dict(pin)
            except Exception:  # noqa: BLE001 — retried next tick
                pass

    @staticmethod
    def _post_weights(url: str, weights: Dict[str, float]) -> None:
        import urllib.request

        req = urllib.request.Request(
            url.rstrip("/") + "/variants/weights",
            data=json.dumps({"weights": weights}).encode("utf-8"),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=5.0):
            pass

    async def _health_loop(self) -> None:
        while True:
            await asyncio.sleep(self.health_interval)
            try:
                await self._poll_all()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — the loop must survive
                pass

    # -- observability plane -----------------------------------------------

    async def _federate(self) -> None:
        """Scrape every serving replica's ``/metrics``, SUM the
        ``pio_*`` samples across the fleet per (name, labels), and
        record them into the router's TSDB under the ``pio_fleet_``
        prefix. Counters sum to a fleet counter (per-series reset
        handling still works: one replica restart only dents its own
        contribution), histogram ``_bucket``/``_sum``/``_count`` lines
        sum into mergeable fleet buckets. A failed replica scrape costs
        that replica's samples this tick, nothing else."""
        ts = self.tsdb.clock()
        merged: Dict[Tuple[str, LabelSet], float] = {}
        for rep in list(self.replicas) + list(self.observers):
            if rep.state not in (OK, DEGRADED):
                continue
            try:
                status, _, body = await self._fetch(
                    rep, "GET", "/metrics", {}, b"",
                    max(1.0, self.scrape_interval))
            except Exception:  # noqa: BLE001 — fail-soft per replica
                self._m_federate.inc((rep.name, "error"))
                continue
            if status != 200:
                self._m_federate.inc((rep.name, "error"))
                continue
            self._m_federate.inc((rep.name, "ok"))
            for name, labels, value in parse_prom_text(
                    body.decode("utf-8", "replace")):
                if not name.startswith("pio_"):
                    continue
                key = ("pio_fleet_" + name[len("pio_"):],
                       tuple(sorted(labels.items())))
                merged[key] = merged.get(key, 0.0) + value
        for (name, labels), value in merged.items():
            self.tsdb.record(name, dict(labels), value, ts)
        self._fleet_snapshot = merged

    async def _observe_tick(self) -> None:
        """Runs on every TSDB scrape tick, after the local registry
        scrape: federate the fleet, then re-judge every SLO against the
        fresh history."""
        await self._federate()
        self.slo.evaluate()
        newly = self.slo.newly_fast_burning
        if newly and self.incidents is not None:
            # trigger (a): an SLO ENTERED fast burn this tick — the
            # capture runs off-loop in its own thread, so the scrape
            # cadence (and serving) never waits on bundle I/O
            self.incidents.trigger("slo-fast-burn", {"slos": newly})

    def _render_fleet(self) -> str:
        if not self._fleet_snapshot:
            return ""
        lines = ["# fleet-federated series (summed across replicas)"]
        for (name, labels), v in sorted(self._fleet_snapshot.items()):
            lines.append(f"{render_key(name, labels)} {_num(v)}")
        return "\n".join(lines) + "\n"

    async def _probe_once(self) -> None:
        """One synthetic canary: pick a replica, send the probe query
        tagged ``X-PIO-Probe`` (replicas exclude it from tenant quota
        charges and variant scoreboards; going through ``_fetch``
        rather than ``_proxy`` keeps it out of the router's own request
        accounting and retry budgets). Outcome lands in the
        ``pio_probe_*`` series the default SLOs watch — the prober's
        whole job is making "no traffic" impossible."""
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        outcome = "ok"
        try:
            await FAULTS.ahit("slo.probe.fail")
            replica = self._pick(set())
            if replica is None:
                raise ReplicaError("no replica available to probe")
            await FAULTS.ahit("router.replica.down")
            status, _, _ = await self._fetch(
                replica, "POST", self.probe_path,
                {"Content-Type": "application/json", "X-PIO-Probe": "1"},
                self.probe_body, min(5.0, self.default_deadline))
            if status >= 500:
                outcome = "error"
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — a failed probe IS the signal
            outcome = "error"
        self._m_probe.inc((self.probe_path, outcome))
        self._m_probe_s.observe(loop.time() - t0, (self.probe_path,))

    async def _probe_loop(self) -> None:
        while True:
            await asyncio.sleep(self.probe_interval)
            if time.monotonic() < self._probe_paused_until:
                continue
            try:
                await self._probe_once()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — the loop must survive
                pass

    # -- rolling reload ----------------------------------------------------

    async def rolling_reload(self) -> Dict[str, Any]:
        """Drain → /reload → wait-ready → re-admit, one replica at a
        time. At most one replica is ever out of rotation, so fleet
        capacity never drops below N-1 and a reload that wedges one
        replica leaves the rest serving."""
        if self._reload_lock is None:
            self._reload_lock = asyncio.Lock()
        async with self._reload_lock:
            loop = asyncio.get_running_loop()
            entries: List[Dict[str, Any]] = []
            ok = True
            for replica in list(self.replicas):
                entry: Dict[str, Any] = {"replica": replica.name}
                entries.append(entry)
                replica.draining = True
                self._publish_states()
                try:
                    t0 = loop.time()
                    while (replica.inflight > 0
                           and loop.time() - t0 < self.drain_timeout):
                        await asyncio.sleep(0.01)
                    entry["drainedMs"] = round(
                        (loop.time() - t0) * 1e3, 1)
                    try:
                        status, _, body = await self._fetch(
                            replica, "GET", "/reload", {}, b"",
                            max(self.ready_timeout, 1.0))
                    except (ReplicaError, asyncio.TimeoutError) as e:
                        entry["result"] = f"reload failed: {e}"
                        ok = False
                        continue
                    if status != 200:
                        entry["result"] = f"reload answered {status}"
                        ok = False
                        continue
                    with contextlib.suppress(Exception):
                        entry["reloadGeneration"] = json.loads(
                            body).get("reloadGeneration")
                    # wait for readiness (AOT re-warm shows up here as
                    # /health not-ready until the ladder is compiled)
                    t0 = loop.time()
                    ready = False
                    while loop.time() - t0 < self.ready_timeout:
                        await self._poll_replica(replica)
                        if (replica.state in (OK, DEGRADED)
                                and replica.health_failures == 0):
                            ready = True
                            break
                        await asyncio.sleep(
                            min(0.05, self.health_interval))
                    if not ready:
                        entry["result"] = "not ready after reload"
                        ok = False
                        continue
                    entry["result"] = "ok"
                finally:
                    replica.draining = False
                    self._publish_states()
            ok = ok and all(e.get("result") == "ok" for e in entries)
            self._m_rolling.inc(("ok",) if ok else ("failed",))
            return {"rolling": True, "ok": ok, "replicas": entries}

    async def reload_all(self) -> Dict[str, Any]:
        """Non-rolling: fire /reload at every replica concurrently.
        Fast, but the fleet may serve stale+fresh models side by side
        and briefly lose capacity to simultaneous AOT re-warms."""
        async def one(r: Replica) -> Dict[str, Any]:
            try:
                status, _, body = await self._fetch(
                    r, "GET", "/reload", {}, b"",
                    max(self.ready_timeout, 1.0))
            except (ReplicaError, asyncio.TimeoutError) as e:
                return {"replica": r.name, "result": f"reload failed: {e}"}
            if status != 200:
                return {"replica": r.name,
                        "result": f"reload answered {status}"}
            out = {"replica": r.name, "result": "ok"}
            with contextlib.suppress(Exception):
                out["reloadGeneration"] = json.loads(
                    body).get("reloadGeneration")
            return out

        entries = await asyncio.gather(*(one(r) for r in self.replicas))
        ok = all(e.get("result") == "ok" for e in entries)
        return {"rolling": False, "ok": ok, "replicas": list(entries)}

    # -- own endpoints -----------------------------------------------------

    async def _root(self, req: Request) -> Response:
        now = asyncio.get_running_loop().time()
        return Response.json({
            "status": "router",
            "replicas": len(self.replicas),
            "available": sum(1 for r in self.replicas if r.available(now)),
        })

    async def _own_health(self, req: Request) -> Response:
        now = asyncio.get_running_loop().time()
        avail = sum(1 for r in self.replicas if r.available(now))
        burning = self.slo.fast_burning()
        body = {
            "status": ("ok" if avail and not burning
                       else "degraded" if avail else "not-ready"),
            "available": avail,
            "replicas": {r.name: r.state for r in self.replicas},
            "instance": self.instance_uid,
        }
        if burning:
            # an SLO fast burn means the fleet is eating its error
            # budget NOW — still serving (200), but degraded so
            # supervisors and dashboards see it without scraping
            body["sloFastBurn"] = burning
        if avail:
            return Response.json(body)
        resp = Response.json(body, status=503)
        resp.headers["Retry-After"] = str(
            max(1, round(self.health_interval)))
        return resp

    async def _router_status(self, req: Request) -> Response:
        return Response.json({
            "replicas": [r.snapshot() for r in self.replicas],
            "observers": [r.snapshot() for r in self.observers],
            "retryBudgetTokens": round(self._budget_tokens, 3),
            "appRetryTokens": {a: round(t, 3)
                               for a, t in sorted(self._app_tokens.items())},
            "hedgeDelayMs": round(self._hedge_delay() * 1e3, 3),
            "hedging": self.hedge_enabled,
            "manifest": self.manifest,
        })

    async def _router_reload(self, req: Request) -> Response:
        rolling = (req.param("rolling") or "") in ("1", "true", "yes")
        out = await (self.rolling_reload() if rolling
                     else self.reload_all())
        return Response.json(out, status=200 if out["ok"] else 500)

    async def _pool_status(self, req: Request) -> Response:
        if self.pool is None:
            return Response.json(
                {"message": "no replica pool attached "
                            "(start with --pool-spawn)"}, status=409)
        snap = await asyncio.to_thread(self.pool.snapshot)
        return Response.json({"pool": snap, "size": len(snap)})

    async def _pool_add(self, req: Request) -> Response:
        if self.pool is None:
            return Response.json(
                {"message": "no replica pool attached"}, status=409)
        try:
            name = await asyncio.to_thread(self.pool.add_replica)
        except Exception as e:  # noqa: BLE001 — surface, don't 500-trace
            return Response.json({"ok": False, "message": str(e)},
                                 status=500)
        return Response.json({"ok": True, "added": name})

    async def _pool_remove(self, req: Request) -> Response:
        if self.pool is None:
            return Response.json(
                {"message": "no replica pool attached"}, status=409)
        try:
            name = await asyncio.to_thread(
                self.pool.remove_replica, req.param("replica") or None)
        except Exception as e:  # noqa: BLE001
            return Response.json({"ok": False, "message": str(e)},
                                 status=409)
        return Response.json({"ok": True, "removed": name})

    async def _pool_restart(self, req: Request) -> Response:
        if self.pool is None:
            return Response.json(
                {"message": "no replica pool attached"}, status=409)
        name = req.param("replica")
        if not name:
            return Response.json({"message": "need ?replica=host:port"},
                                 status=400)
        try:
            await asyncio.to_thread(self.pool.restart_replica, name)
        except Exception as e:  # noqa: BLE001
            return Response.json({"ok": False, "message": str(e)},
                                 status=404)
        return Response.json({"ok": True, "restarting": name})

    async def _autoscale_status(self, req: Request) -> Response:
        if self.autoscaler is None:
            return Response.json(
                {"message": "autoscaler not running "
                            "(needs --pool-spawn without --no-autoscale)"},
                status=409)
        return Response.json(self.autoscaler.status_doc())

    async def _probe_ctl(self, req: Request) -> Response:
        """``POST /probe?pause=SECONDS`` / ``POST /probe?resume=1`` —
        the probe-exclusion playbook's HTTP surface."""
        if req.param("resume"):
            self.resume_probe()
            return Response.json({"ok": True, "probe": "running"})
        pause = req.param("pause")
        if pause is None:
            return Response.json(
                {"message": "need ?pause=SECONDS or ?resume=1"},
                status=400)
        try:
            seconds = float(pause)
        except ValueError:
            return Response.json({"message": f"bad pause {pause!r}"},
                                 status=400)
        self.pause_probe(seconds)
        return Response.json({"ok": True, "probe": "paused",
                              "resumeAfterSec": seconds})

    async def _metrics(self, req: Request) -> Response:
        # own registry first, then the federated fleet snapshot: one
        # scrape of the router is one scrape point for the whole pod
        return Response.text(REGISTRY.render() + self._render_fleet(),
                             content_type="text/plain; version=0.0.4")

    async def _metrics_history(self, req: Request) -> Response:
        status, payload = history_payload(
            self.tsdb, req.param("series") or "", req.param("window") or "")
        return Response.json(payload, status=status)

    async def _slo_status(self, req: Request) -> Response:
        self.slo.evaluate()
        return Response.json(self.slo.to_json())

    async def _top(self, req: Request) -> Response:
        """Everything ``top`` renders, computed server-side over
        the federated history so the CLI stays a dumb refresh loop."""
        try:
            window = parse_duration(req.param("window") or "1m")
        except ValueError as e:
            return Response.json({"message": str(e)}, status=400)

        by_status: Dict[str, float] = {}
        for key in self.tsdb.query("pio_router_requests_total", window):
            _, labels = parse_selector(key)
            by_status[labels.get("status", "?")] = round(
                self.tsdb.rate(key, window), 3)

        def _ms(v: Optional[float]) -> Optional[float]:
            return None if v is None else round(v * 1e3, 3)

        paths: Dict[str, Dict[str, Any]] = {}
        for p in sorted(_TOP_PATHS | {"other"}):
            count_key = render_key("pio_router_path_seconds_count",
                                   (("path", p),))
            if not any(self.tsdb.query(count_key, window).values()):
                continue
            paths[p] = {
                "qps": round(self.tsdb.rate(count_key, window), 3),
                "p50Ms": _ms(self.tsdb.quantile(
                    "pio_router_path_seconds", 0.5, window, {"path": p})),
                "p99Ms": _ms(self.tsdb.quantile(
                    "pio_router_path_seconds", 0.99, window, {"path": p})),
            }

        variant_rates: Dict[str, float] = {}
        for key in self.tsdb.query(
                "pio_fleet_variant_requests_total", window):
            _, labels = parse_selector(key)
            v = labels.get("variant", "?")
            variant_rates[v] = (variant_rates.get(v, 0.0)
                                + self.tsdb.rate(key, window))
        vtotal = sum(variant_rates.values())
        variants = {v: {"qps": round(r, 3),
                        "share": round(r / vtotal, 4) if vtotal else 0.0}
                    for v, r in sorted(variant_rates.items())}

        sheds: Dict[str, float] = {}
        for key in self.tsdb.query("pio_fleet_engine_shed_total", window):
            _, labels = parse_selector(key)
            r = self.tsdb.rate(key, window)
            if r > 0:
                sheds[labels.get("app", "-")] = round(r, 3)

        probe: Dict[str, float] = {}
        for key in self.tsdb.query("pio_probe_requests_total", window):
            _, labels = parse_selector(key)
            probe[labels.get("outcome", "?")] = round(
                self.tsdb.rate(key, window), 4)

        # continuous-trainer section, present once a trainer listener
        # joined federation (observe=1 manifest line / --observer)
        trainer: Dict[str, Any] = {}
        cycles: Dict[str, float] = {}
        for key in self.tsdb.query("pio_fleet_trainer_cycles_total",
                                   window):
            _, labels = parse_selector(key)
            samples = self.tsdb.query(key, window).get(key) or []
            if samples:
                cycles[labels.get("outcome", "?")] = samples[-1][1]
        if cycles:
            trainer["cycles"] = cycles
        for name, out_key in (("pio_fleet_trainer_lease_held", "leaseHeld"),
                              ("pio_fleet_trainer_generation",
                               "generation")):
            for key, samples in self.tsdb.query(name, window).items():
                if samples:
                    trainer[out_key] = samples[-1][1]

        self.slo.evaluate()
        return Response.json({
            "windowSeconds": window,
            "qps": {"total": round(sum(by_status.values()), 3),
                    "byStatus": by_status},
            "paths": paths,
            "variants": variants,
            "tenantSheds": sheds,
            "probe": probe,
            "trainer": trainer,
            "replicas": [dict(r.snapshot(),
                              modelGeneration=r.last_health.get(
                                  "modelGeneration"))
                         for r in self.replicas],
            "observers": [r.snapshot() for r in self.observers],
            "slo": self.slo.to_json(),
        })

    # -- lifecycle ---------------------------------------------------------

    async def serve_forever(self) -> None:
        if self.incidents is not None:
            from predictionio_tpu_torch.utils.incidents import (
                install_crash_handlers,
            )

            install_crash_handlers(self.incidents)
        # probe the fleet once BEFORE accepting traffic, so the first
        # client request has states to route on
        await self._poll_all()
        tasks = [
            asyncio.create_task(self._health_loop(),
                                name="pio-router-health"),
            asyncio.create_task(
                scrape_loop(self.tsdb, self.scrape_interval,
                            extra=self._observe_tick),
                name="pio-router-observe"),
        ]
        if self.probe_interval > 0:
            tasks.append(asyncio.create_task(self._probe_loop(),
                                             name="pio-router-probe"))
        if self.autoscaler is not None:
            tasks.append(asyncio.create_task(self.autoscaler.loop(),
                                             name="pio-router-autoscale"))
        try:
            await self.http.serve_forever()
        finally:
            for t in tasks:
                t.cancel()
            for t in tasks:
                with contextlib.suppress(asyncio.CancelledError):
                    await t
            for r in self.replicas + self.observers:
                r.close_pool()

    def run(self) -> None:
        asyncio.run(self.serve_forever())
