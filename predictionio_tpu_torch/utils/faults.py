"""Deterministic fault injection: the port's copy of the JAX package's
``utils/faults.py`` (the same registry, plans and ``PIO_FAULTS`` syntax).

Named **injection sites**, one-line ``faults.inject("serving.query")``
calls placed where the code talks to something that can fail, and
**plans** armed against them:

- ``latency``: sleep N seconds per hit (a hung or slow dependency);
- ``error``: raise :class:`FaultError` (a down dependency);
- ``rate``: fire with probability p per hit, from a seeded per-plan
  RNG, so that a flaky run is reproducible;
- ``count``: fire at most N times, then fall dormant.

The ``data.corrupt.*`` sites flip a byte in data passing through
:meth:`FaultRegistry.corrupt` instead of sleeping or raising.

Arming is programmatic (tests, ``chip_smoke.py``) or through the
``PIO_FAULTS`` environment variable, read once at import::

    PIO_FAULTS="serving.reload:error=down;serving.query:latency=0.2,rate=0.5"

Sites are separated by ``;``; each takes comma-separated ``key=value``
directives (``latency`` seconds, ``error`` message, ``rate``
probability, ``count`` max fires, ``seed`` RNG seed). ``inject()`` is
one attribute read and one branch until the first ``arm()``.

Sites the port wires so far:

======================  ===================================================
``serving.query``       engine-server query worker and micro-batch worker
``serving.reload``      the ``/reload`` candidate's probe query
``trace.export``        span export (ring and JSONL); fail-open
``tsdb.scrape.stall``   the metrics-history scrape tick of each server
``tenant.quota.exhausted``  the per-app token bucket reads empty
``eventsink.send``      feedback sink delivery (Event Server down)
``ingest.commit``       coalescer group commit (event storage down)
``models.s3``           S3 model-store operations (put, get, delete, list)
``models.hdfs``         HDFS model-store operations (put, get, delete,
                        list)
``variant.assign.skew``  variant-split assignment — the weighted hash
                        is bypassed and every query lands on the
                        default arm (a skewed split the per-variant
                        request series must make visible)
``variant.reload.partial``  variant swap mid-``/reload`` — the
                        candidate died after loading but before
                        publishing; the champion must keep serving and
                        the split must fall back to 100/0
``incident.capture.stall``  incident-bundle capture task (every
                        server) — a wedged/failing capture costs the
                        postmortem bundle, never the serving path;
                        watch ``pio_incident_captures_total{result}``
``ann.index.corrupt``   byte-flip on ANN retrieval-index load
                        (``PQIndex.from_bytes`` — covers the
                        ``ann_index.bin`` file and blob-embedded
                        indexes; the load raises ``IntegrityError``)
``segments.cold``       cold-tier segment store operations (put, get,
                        delete), shared by the local, S3 and HDFS tiers
``segments.shard.hot``  writer sharding of the event log — the entity
                        hash is bypassed and every append lands on
                        writer shard 0
``data.corrupt.eventlog``  byte-flip on ``pio fsck`` event-log reads
``data.corrupt.snapshot``  byte-flip on snapshot npz load
``data.corrupt.model``     byte-flip on ``pio fsck`` model-blob reads and
                        on S3 and HDFS model-blob downloads
``data.corrupt.segment``   byte-flip on cold-tier segment fetch and on
                        ``pio fsck`` segment and sidecar reads
``train.crash``         continuous trainer, after the wake decision and
                        before any publish — the process dies; the
                        supervisor restarts it and ``run_train(resume=
                        True)`` picks up the port's checkpoints
``train.lease.lost``    continuous trainer heartbeat renewal — the
                        single-writer lease was stolen; the trainer
                        must abandon the cycle and never publish
``promote.regression``  the trainer's promotion gate — the candidate
                        scores as regressed, so the gate must refuse it
``replication.follower.lag``  follower WAL apply — a slow or down
                        follower; the leader marks the link unhealthy
                        and keeps acking; watch ``pio_repl_lag_bytes``
``replication.wal.torn``  byte-flip on a replicated WAL batch (and on a
                        fetched sealed segment) before its check — the
                        follower refuses it (422) and keeps its cursor
``replication.leader.partition``  event-plane leader heartbeat — the
                        lease renewal fails as if partitioned; the
                        leader fences itself (writes 503)
``router.replica.down``  fleet-router forward path — the replica refuses
                        or drops the proxied request
``router.replica.slow``  fleet-router forward path — added latency on the
                        proxied request (drives hedging)
``router.health.flap``  fleet-router active ``/health`` probe (a flapping
                        or partitioned replica)
``slo.probe.fail``      router synthetic prober, before the canary is
                        sent — the probe fails, so the SLO burn-rate
                        series spike and ``/health`` degrades
``autoscale.flap``      autoscaler decision tick — the raw desire is
                        inverted every tick; the cooldown and flap
                        damping, not the thresholds, bound the churn
``remediate.wrong_target``  remediation target selection — a healthy
                        replica is picked; pre-action verification must
                        refuse it
``remediate.storm``     auto-remediation dedup — the same finding
                        re-fires every tick as new; the per-playbook
                        rate limit alone bounds the blast radius
======================  ===================================================

The S3 and HDFS model stores (``storage/remote.py``) build their
``models.{kind}`` site in ``_ResilientCalls._init_resilience``.
"""

from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional


class FaultError(RuntimeError):
    """The error an ``error`` plan raises at its site."""


@dataclass
class FaultPlan:
    site: str
    latency: float = 0.0
    error: Optional[str] = None
    rate: float = 1.0
    count: Optional[int] = None
    seed: int = 0
    fired: int = 0
    _rng: random.Random = field(init=False, repr=False)

    def __post_init__(self) -> None:
        self._rng = random.Random(self.seed)


class FaultRegistry:
    """Process-wide registry of armed fault plans, keyed by site."""

    def __init__(self, env: Optional[Dict[str, str]] = None) -> None:
        self._lock = threading.Lock()
        self._plans: Dict[str, FaultPlan] = {}
        self._hits: Dict[str, int] = {}
        #: fast-path flag: read without the lock by inject(); only ever
        #: True while at least one plan is armed
        self.armed = False
        spec = (os.environ if env is None else env).get("PIO_FAULTS", "")
        if spec:
            self.arm_spec(spec)

    # -- arming ----------------------------------------------------------------

    def arm(self, site: str, *, latency: float = 0.0,
            error: Optional[str] = None, rate: float = 1.0,
            count: Optional[int] = None, seed: int = 0) -> FaultPlan:
        """Arm one plan at ``site`` (replacing any previous plan there).
        A plan with neither latency nor error still counts hits — a
        pure probe for "did this code path run"."""
        if not (0.0 <= rate <= 1.0):
            raise ValueError(f"rate must be in [0, 1], got {rate}")
        plan = FaultPlan(site=site, latency=latency, error=error,
                         rate=rate, count=count, seed=seed)
        with self._lock:
            self._plans[site] = plan
            self.armed = True
        return plan

    def arm_spec(self, spec: str) -> None:
        """Arm from a ``PIO_FAULTS``-format string (see module doc)."""
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            site, _, directives = part.partition(":")
            site = site.strip()
            if not site or not directives:
                raise ValueError(
                    f"bad PIO_FAULTS entry {part!r}: want site:key=value[,...]")
            kwargs: Dict[str, object] = {}
            for d in directives.split(","):
                key, eq, value = d.strip().partition("=")
                if key == "latency":
                    kwargs["latency"] = float(value)
                elif key == "error":
                    kwargs["error"] = value if eq else "injected fault"
                elif key == "rate":
                    kwargs["rate"] = float(value)
                elif key == "count":
                    kwargs["count"] = int(value)
                elif key == "seed":
                    kwargs["seed"] = int(value)
                else:
                    raise ValueError(
                        f"unknown PIO_FAULTS directive {key!r} in {part!r}")
            self.arm(site, **kwargs)  # type: ignore[arg-type]

    def disarm(self, site: Optional[str] = None) -> None:
        """Disarm one site, or everything (and reset hit counters)."""
        with self._lock:
            if site is None:
                self._plans.clear()
                self._hits.clear()
            else:
                self._plans.pop(site, None)
            self.armed = bool(self._plans)

    # -- introspection ---------------------------------------------------------

    def plans(self) -> Dict[str, FaultPlan]:
        with self._lock:
            return dict(self._plans)

    def hits(self, site: str) -> int:
        """Times ``inject(site)`` ran while the registry was armed."""
        with self._lock:
            return self._hits.get(site, 0)

    def fired(self, site: str) -> int:
        """Times the plan at ``site`` actually injected its fault."""
        with self._lock:
            plan = self._plans.get(site)
            return plan.fired if plan is not None else 0

    # -- injection -------------------------------------------------------------

    def _evaluate(self, site: str) -> Optional[FaultPlan]:
        """Count the hit and decide whether the plan fires (lock held
        briefly; the latency sleep happens OUTSIDE the lock)."""
        with self._lock:
            self._hits[site] = self._hits.get(site, 0) + 1
            plan = self._plans.get(site)
            if plan is None:
                return None
            if plan.count is not None and plan.fired >= plan.count:
                return None
            if plan.rate < 1.0 and plan._rng.random() >= plan.rate:
                return None
            plan.fired += 1
            return plan

    def hit(self, site: str) -> None:
        """Sync injection point (worker threads, storage backends)."""
        if not self.armed:
            return
        plan = self._evaluate(site)
        if plan is None:
            return
        if plan.latency > 0:
            time.sleep(plan.latency)
        if plan.error is not None:
            raise FaultError(f"[{site}] {plan.error}")

    def corrupt(self, site: str, data: bytes) -> bytes:
        """Byte-flip injection for the ``data.corrupt.*`` sites: when
        the armed plan fires, return a copy of ``data`` with the
        middle byte inverted (deterministic position, so a test can
        predict exactly which artifact region is damaged); otherwise
        return ``data`` unchanged. Disarmed cost: one attribute read."""
        if not self.armed or not data:
            return data
        plan = self._evaluate(site)
        if plan is None:
            return data
        flipped = bytearray(data)
        flipped[len(flipped) // 2] ^= 0xFF
        return bytes(flipped)

    async def ahit(self, site: str) -> None:
        """Async injection point — latency sleeps on the event loop
        without blocking it."""
        if not self.armed:
            return
        plan = self._evaluate(site)
        if plan is None:
            return
        if plan.latency > 0:
            import asyncio

            await asyncio.sleep(plan.latency)
        if plan.error is not None:
            raise FaultError(f"[{site}] {plan.error}")


#: the process-wide registry (armed from PIO_FAULTS at import)
FAULTS = FaultRegistry()


def inject(site: str) -> None:
    """Module-level shorthand for ``FAULTS.hit(site)`` — the one-liner
    placed at injection sites."""
    if FAULTS.armed:
        FAULTS.hit(site)


def corrupt_bytes(site: str, data: bytes) -> bytes:
    """Module-level shorthand for ``FAULTS.corrupt(site, data)`` — the
    one-liner placed on read paths that feed checksum verification."""
    if FAULTS.armed:
        return FAULTS.corrupt(site, data)
    return data
