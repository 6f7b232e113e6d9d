"""SLO-driven autoscaler: the router's control loop over its own fleet
(the port's copy of the JAX package's ``server/autoscale.py``).

The router holds the sensors (the federated ``pio_fleet_*`` TSDB,
multi-window burn rates, the synthetic prober) and the actuators (the
supervised replica lifecycle, rolling reload). This module is the
controller between them: every ``interval`` seconds it reads the
router's TSDB and SLO engine, decides ``up | down | hold``, and drives
a :class:`~predictionio_tpu_torch.tools.supervise.ReplicaPool` — which
rewrites the manifest the router's mtime watcher already follows, so
scaling needs no new discovery plumbing at all.

The decision rules, in the order they apply:

- **pressure** (scale up) when ANY of per-replica QPS, fleet p99, or
  per-replica inflight exceeds its ``up_*`` threshold — or the SLO
  engine reports a fast burn — for ``sustain_ticks`` consecutive
  ticks;
- **quiet** (scale down) only when ALL signals sit below the (much
  lower) ``down_*`` thresholds AND nothing burns, for ``quiet_ticks``
  consecutive ticks — hysteresis: the up and down thresholds never
  meet, so the controller cannot chatter around a single line;
- **cooldowns** after every action (a long one after scale-down: a
  removal that turns out wrong costs latency, an addition only money);
- **flap damping**: at most ``flap_max_actions`` membership changes
  per ``flap_window`` — a metrics storm gets a frozen fleet, not an
  oscillating one;
- hard floors: scale-down NEVER removes the last healthy replica, and
  never goes below ``min_replicas``; scale-up never exceeds
  ``max_replicas``.

Every tick emits ``pio_autoscale_decisions_total{action,reason}``
(reasons are a bounded vocabulary — grep the ``_REASONS`` tuple) and a
decision-log entry; the log rides into incident bundles, so a
postmortem answers "why did the fleet shrink at 03:12" from the bundle
alone. The ``autoscale.flap`` fault site flips the raw desire before
the guardrails run — the drill that proves damping, not thresholds,
bounds the blast radius.

Wedged replicas the autoscaler cannot fix by adding capacity (down /
breaker-open members) are handed to the
:class:`~predictionio_tpu_torch.server.remediate.RemediationEngine`.
"""

from __future__ import annotations

import asyncio
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, List, Optional

from predictionio_tpu_torch.utils import faults
from predictionio_tpu_torch.utils.metrics import REGISTRY

#: the bounded decision-reason vocabulary (label cardinality stays
#: finite; free-text reasons live in the decision log)
_REASONS = ("qps", "p99", "inflight", "slo-burn", "quiet",
            "steady", "between-thresholds", "sustaining",
            "at-max", "at-min", "last-healthy", "cooldown",
            "flap-damped", "fault:autoscale.flap")


@dataclass
class AutoscaleConfig:
    """Thresholds and guardrails; all tunable from ``router serve``
    flags. The defaults suit the profile harness's stub replicas —
    production fleets tune ``up_qps_per_replica`` to measured
    single-replica capacity."""

    min_replicas: int = 1
    max_replicas: int = 4
    interval: float = 5.0
    window: float = 60.0
    up_qps_per_replica: float = 50.0
    up_p99_ms: float = 500.0
    up_inflight_per_replica: float = 8.0
    down_qps_per_replica: float = 10.0
    down_p99_ms: float = 200.0
    sustain_ticks: int = 3
    quiet_ticks: int = 6
    cooldown_up: float = 30.0
    cooldown_down: float = 120.0
    flap_window: float = 600.0
    flap_max_actions: int = 4


class Autoscaler:
    """Pure decisions in :meth:`tick` (sync, clock-injected, fully
    unit-testable), side effects in :meth:`act`, and an async
    :meth:`loop` that ties them together under the router's event
    loop."""

    def __init__(self, router: Any, pool: Any,
                 config: Optional[AutoscaleConfig] = None,
                 remediator: Any = None,
                 clock: Callable[[], float] = time.monotonic,
                 log: Callable[..., None] = lambda *a: None) -> None:
        self.router = router
        self.pool = pool
        self.config = config or AutoscaleConfig()
        self.remediator = remediator
        self.clock = clock
        self.log = log
        self._pressure_ticks = 0
        self._quiet_ticks = 0
        self._last_action_at: Optional[float] = None
        self._last_action: Optional[str] = None
        #: monotonic times of executed membership changes (flap damping)
        self._actions: Deque[float] = deque()
        self.decisions: Deque[Dict[str, Any]] = deque(maxlen=512)
        self._m_decisions = REGISTRY.counter(
            "pio_autoscale_decisions_total",
            "Autoscaler tick outcomes by action taken (up/down/hold) "
            "and the dominant reason", ("action", "reason"))
        self._m_replicas = REGISTRY.gauge(
            "pio_autoscale_replicas",
            "Fleet size as the autoscaler sees it", ("state",))

    # -- signals ---------------------------------------------------------------

    def _signals(self) -> Dict[str, Any]:
        """One consistent read of everything the decision needs.
        Healthy = serving-capable right now (not draining, state
        ok/degraded); replicas counts POOL members — what scale-down
        may remove — which on a pool-managed fleet equals the router's
        rotation."""
        cfg = self.config
        reps = list(self.router.replicas)
        healthy = [r for r in reps
                   if not r.draining and r.state in ("ok", "degraded")]
        qps = sum(self.router.tsdb.rate(key, cfg.window)
                  for key in self.router.tsdb.query(
                      "pio_router_requests_total", cfg.window))
        p99 = self.router.tsdb.quantile(
            "pio_router_path_seconds", 0.99, cfg.window,
            {"path": "/queries.json"})
        return {
            "replicas": self.pool.size() if self.pool is not None
                        else len(reps),
            "healthy": len(healthy),
            "qps": qps,
            "p99_ms": None if p99 is None else p99 * 1e3,
            "inflight": sum(r.inflight for r in reps),
            "fast_burning": list(self.router.slo.fast_burning()),
            "wedged": [r.name for r in reps
                       if r.state == "down" or r.breaker.state == "open"],
        }

    # -- the decision ----------------------------------------------------------

    def tick(self) -> Dict[str, Any]:
        """Evaluate one control tick. Returns the decision doc
        (``action`` is what the guardrails let through, ``desire`` what
        the signals asked for) — :meth:`act` applies it."""
        cfg = self.config
        sig = self._signals()
        n = max(1, sig["replicas"])

        pressure = []
        if sig["qps"] / n > cfg.up_qps_per_replica:
            pressure.append("qps")
        if sig["p99_ms"] is not None and sig["p99_ms"] > cfg.up_p99_ms:
            pressure.append("p99")
        if sig["inflight"] / n > cfg.up_inflight_per_replica:
            pressure.append("inflight")
        if sig["fast_burning"]:
            pressure.append("slo-burn")
        quiet = (not pressure
                 and sig["qps"] / n < cfg.down_qps_per_replica
                 and (sig["p99_ms"] is None
                      or sig["p99_ms"] < cfg.down_p99_ms)
                 and not sig["fast_burning"])

        self._pressure_ticks = self._pressure_ticks + 1 if pressure else 0
        self._quiet_ticks = self._quiet_ticks + 1 if quiet else 0

        desire, reason = "hold", "steady"
        if pressure:
            if self._pressure_ticks >= cfg.sustain_ticks:
                desire, reason = "up", pressure[0]
            else:
                reason = "sustaining"
        elif quiet:
            if self._quiet_ticks >= cfg.quiet_ticks:
                desire, reason = "down", "quiet"
            else:
                reason = "sustaining"
        else:
            reason = "between-thresholds"

        try:
            faults.inject("autoscale.flap")
        except faults.FaultError:
            # the drill: a poisoned signal inverts the desire every
            # tick; only the guardrails below stand between this and
            # an oscillating fleet
            desire = "down" if desire == "up" else "up"
            reason = "fault:autoscale.flap"

        action = desire
        now = self.clock()
        if desire != "hold":
            cooldown = (cfg.cooldown_up if desire == "up"
                        else cfg.cooldown_down)
            while self._actions and now - self._actions[0] > cfg.flap_window:
                self._actions.popleft()
            if desire == "up" and sig["replicas"] >= cfg.max_replicas:
                action, reason = "hold", "at-max"
            elif desire == "down" and sig["healthy"] <= 1:
                # the hard rule: never remove the last replica still
                # able to serve, whatever the metrics claim
                action, reason = "hold", "last-healthy"
            elif desire == "down" and sig["replicas"] <= cfg.min_replicas:
                action, reason = "hold", "at-min"
            elif (self._last_action_at is not None
                  and now - self._last_action_at < cooldown):
                action, reason = "hold", "cooldown"
            elif len(self._actions) >= cfg.flap_max_actions:
                action, reason = "hold", "flap-damped"

        decision = {
            "at": time.time(),
            "action": action,
            "desire": desire,
            "reason": reason,
            "signals": {k: (round(v, 3) if isinstance(v, float) else v)
                        for k, v in sig.items()},
        }
        self._m_decisions.inc((action, reason))
        self._m_replicas.set(float(sig["replicas"]), ("total",))
        self._m_replicas.set(float(sig["healthy"]), ("healthy",))
        self.decisions.append(decision)
        if action != "hold":
            self.log(f"[autoscale] {action}: {reason} "
                     f"(replicas={sig['replicas']} "
                     f"qps={sig['qps']:.1f} p99={sig['p99_ms']}ms)")
        return decision

    def act(self, decision: Dict[str, Any]) -> None:
        """Apply a non-hold decision through the pool (blocking —
        ``add_replica`` waits for /health; run via ``to_thread`` from
        the loop). Resets the sustain counters and charges the
        cooldown/flap budgets only when the pool call succeeded."""
        if self.pool is None or decision["action"] == "hold":
            return
        if decision["action"] == "up":
            self.pool.add_replica()
        else:
            self.pool.remove_replica()
        now = self.clock()
        self._last_action_at = now
        self._last_action = decision["action"]
        self._actions.append(now)
        self._pressure_ticks = 0
        self._quiet_ticks = 0

    # -- the loop --------------------------------------------------------------

    async def run_once(self) -> Dict[str, Any]:
        """One full control cycle: decide, act, then hand wedged
        replicas to the remediator. Pool/remediation failures are
        recorded on the decision, never raised — a broken actuator
        must not kill the control loop."""
        decision = self.tick()
        if decision["action"] != "hold":
            try:
                await asyncio.to_thread(self.act, decision)
            except Exception as e:  # noqa: BLE001 — loop survives actuator
                decision["error"] = f"{type(e).__name__}: {e}"
                self.log(f"[autoscale] {decision['action']} failed: {e}")
        wedged = decision["signals"].get("wedged") or []
        if wedged and self.remediator is not None:
            findings = [{"severity": 2, "kind": "breaker-open",
                         "title": f"replica {name} wedged "
                                  "(down or breaker open)",
                         "replica": f"http://{name}"}
                        for name in wedged]
            try:
                acted = await asyncio.to_thread(
                    self.remediator.auto_remediate, findings)
                if acted:
                    decision["remediations"] = [
                        {"playbook": a["playbook"], "target": a["target"],
                         "result": a["result"]} for a in acted]
            except Exception as e:  # noqa: BLE001
                decision["error"] = f"remediate: {type(e).__name__}: {e}"
        return decision

    async def loop(self) -> None:
        """Run forever on the router's event loop (mirrors the prober's
        ``_probe_loop`` lifecycle: cancelled on shutdown)."""
        while True:
            try:
                await self.run_once()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — never die
                self.log(f"[autoscale] tick crashed: {e}")
            await asyncio.sleep(self.config.interval)

    # -- introspection ---------------------------------------------------------

    def status_doc(self) -> Dict[str, Any]:
        """``GET /autoscale/status`` and the incident-bundle source:
        config, counters, and the recent decision log (newest last)."""
        cfg = self.config
        return {
            "config": {
                "minReplicas": cfg.min_replicas,
                "maxReplicas": cfg.max_replicas,
                "intervalSec": cfg.interval,
                "windowSec": cfg.window,
            },
            "pressureTicks": self._pressure_ticks,
            "quietTicks": self._quiet_ticks,
            "lastAction": self._last_action,
            "recentActions": len(self._actions),
            "decisions": list(self.decisions)[-50:],
        }
