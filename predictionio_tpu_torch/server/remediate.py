"""Playbook-driven auto-remediation: ``doctor --act`` and the
router-resident loop behind the autoscaler (the port's copy of the JAX
package's ``server/remediate.py``: the same playbooks, lock file and
fault sites).

``doctor`` ranks findings; this module closes the loop by mapping each
finding *kind* onto a **playbook**, the machine-readable form of a
runbook:

- ``restart_replica``  — bounce a wedged replica through the
  :class:`~predictionio_tpu_torch.tools.supervise.ReplicaPool` (or the
  router's ``POST /pool/restart`` from an ops box);
- ``rollback_model``   — ``ModelRegistry.rollback`` + rolling fleet
  reload, for a fast burn that follows a model promotion;
- ``clamp_tenant``     — rewrite quotas.json to clamp a hot tenant's
  ingest rate (hot-reloaded fleet-wide within ~1s);
- ``exclude_probe``    — pause the router's synthetic prober for a
  window (and auto-resume), when the canary itself is the burn.

Playbooks are declared in ``conf/remediations.json``. The engine
is **dry-run by default**: :meth:`RemediationEngine.plan` always
prints what it WOULD do; only ``--yes`` (or the autoscaler's
``auto_remediate``) executes.

Guardrails, each drilled by a fault site:

- every action re-verifies its target against live state immediately
  before acting — ``remediate.wrong_target`` corrupts the selected
  target and the verification must refuse (never restart a healthy
  replica because a finding went stale);
- per-playbook rate limits bound actions per window —
  ``remediate.storm`` floods the engine with repeat findings and the
  limiter, not luck, must hold;
- a fenced one-remediation-in-flight file lock serializes concurrent
  actors (two ``doctor --act --yes`` runs, or doctor racing the
  autoscaler's remediator).

Everything here imports neither torch nor numpy: ``doctor`` runs on
an ops box.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from predictionio_tpu_torch.utils import faults
from predictionio_tpu_torch.utils.metrics import REGISTRY

DEFAULT_PLAYBOOKS_PATH = os.path.join("conf", "remediations.json")

#: built-in contract, mirrored by conf/remediations.json — the file
#: wins when present, so operators tune windows without code changes
DEFAULT_PLAYBOOKS_DOC: Dict[str, Any] = {
    "playbooks": [
        {"name": "restart-wedged-replica",
         "match": {"kinds": ["replica-down", "replica-not-ready",
                             "breaker-open"], "minSeverity": 1},
         "action": "restart_replica",
         "rateLimit": {"max": 2, "windowSec": 600}},
        {"name": "rollback-model-generation",
         "match": {"kinds": ["model-regression"], "minSeverity": 1},
         "action": "rollback_model",
         "rateLimit": {"max": 1, "windowSec": 3600}},
        {"name": "clamp-hot-tenant",
         "match": {"kinds": ["tenant-pressure"], "minSeverity": 1},
         "action": "clamp_tenant",
         "params": {"rateFactor": 0.5, "shedRate": 100},
         "rateLimit": {"max": 2, "windowSec": 1800}},
        {"name": "probe-exclusion",
         "match": {"kinds": ["probe-failing"], "minSeverity": 1},
         "action": "exclude_probe",
         "params": {"resumeAfterSec": 600},
         "rateLimit": {"max": 2, "windowSec": 3600}},
    ],
}

_ACTIONS = ("restart_replica", "rollback_model", "clamp_tenant",
            "exclude_probe")


@dataclass
class Playbook:
    """One finding-kind → action mapping with its own rate limit."""

    name: str
    action: str
    kinds: Tuple[str, ...]
    min_severity: int = 1
    params: Dict[str, Any] = field(default_factory=dict)
    rate_max: int = 2
    rate_window: float = 600.0

    @classmethod
    def from_doc(cls, doc: Dict[str, Any]) -> "Playbook":
        match = doc.get("match") or {}
        rl = doc.get("rateLimit") or {}
        action = doc.get("action")
        if action not in _ACTIONS:
            raise ValueError(
                f"playbook {doc.get('name')!r}: unknown action {action!r} "
                f"(expected one of {_ACTIONS})")
        return cls(
            name=str(doc.get("name") or action),
            action=action,
            kinds=tuple(match.get("kinds") or ()),
            min_severity=int(match.get("minSeverity", 1)),
            params=dict(doc.get("params") or {}),
            rate_max=int(rl.get("max", 2)),
            rate_window=float(rl.get("windowSec", 600)),
        )

    def matches(self, finding: Dict[str, Any]) -> bool:
        return (finding.get("kind") in self.kinds
                and int(finding.get("severity", 0)) >= self.min_severity)


def load_playbooks(path: Optional[str] = None) -> List[Playbook]:
    """``conf/remediations.json`` when readable, else the built-in
    contract. A torn/garbled file is a loud error for an explicit
    ``--remediations PATH``, a silent fallback for the default path —
    remediation config must never take the doctor down."""
    doc = DEFAULT_PLAYBOOKS_DOC
    explicit = path is not None
    path = path or DEFAULT_PLAYBOOKS_PATH
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        if explicit:
            raise
    return [Playbook.from_doc(p) for p in doc.get("playbooks") or []]


def finding_target(finding: Dict[str, Any], action: str) -> Optional[str]:
    """The entity an action operates on, from the finding's structured
    fields (see ``utils/incidents.diagnose``)."""
    if action == "restart_replica":
        url = finding.get("replica") or ""
        # findings carry http:// URLs; the pool and router speak
        # host:port names
        return url.split("://", 1)[-1].rstrip("/") or None
    if action == "clamp_tenant":
        return finding.get("app")
    if action == "rollback_model":
        return "champion"
    if action == "exclude_probe":
        return "probe"
    return None


class RemediationEngine:
    """Plan and (with explicit consent) execute playbook actions.

    ``actuator`` supplies the verbs: an object with ``verify(action,
    target) -> (ok, why)`` plus one method per action name. Two ship
    with the tree: :class:`RouterActuator` (in-process, used by the
    autoscaler's remediator) and :class:`OpsActuator` (HTTP + storage
    home, used by ``doctor --act``).
    """

    def __init__(self, actuator: Any,
                 playbooks: Optional[List[Playbook]] = None,
                 *, lock_path: Optional[str] = None,
                 lock_stale: float = 120.0,
                 clock: Callable[[], float] = time.monotonic,
                 on_action: Optional[Callable[[Dict[str, Any]], Any]] = None,
                 log_size: int = 256) -> None:
        self.actuator = actuator
        self.playbooks = (playbooks if playbooks is not None
                          else load_playbooks())
        self.lock_path = lock_path
        self.lock_stale = lock_stale
        self.clock = clock
        self.on_action = on_action
        #: playbook name → monotonic times of executed actions
        self._rate: Dict[str, Deque[float]] = {}
        #: (playbook, target) → last attempt time (transition dedup for
        #: the auto loop: a finding that persists must not re-fire)
        self._attempted: Dict[Tuple[str, str], float] = {}
        self.log: Deque[Dict[str, Any]] = deque(maxlen=log_size)
        self._m_actions = REGISTRY.counter(
            "pio_remediate_actions_total",
            "Remediation playbook outcomes",
            ("playbook", "result"))

    # -- planning --------------------------------------------------------------

    def match(self, finding: Dict[str, Any]) -> Optional[Playbook]:
        for pb in self.playbooks:
            if pb.matches(finding):
                return pb
        return None

    def _rate_limited(self, pb: Playbook, charge: bool = False) -> bool:
        times = self._rate.setdefault(pb.name, deque())
        now = self.clock()
        while times and now - times[0] > pb.rate_window:
            times.popleft()
        if len(times) >= pb.rate_max:
            return True
        if charge:
            times.append(now)
        return False

    def plan(self, findings: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        """Map findings onto playbook entries — pure, no side effects,
        safe to print. One entry per (playbook, target), first finding
        wins."""
        entries: List[Dict[str, Any]] = []
        seen: set = set()
        for f in findings:
            pb = self.match(f)
            if pb is None:
                continue
            target = finding_target(f, pb.action)
            if target is None or (pb.name, target) in seen:
                continue
            seen.add((pb.name, target))
            entries.append({
                "playbook": pb.name,
                "action": pb.action,
                "target": target,
                "params": dict(pb.params),
                "finding": {"kind": f.get("kind"),
                            "severity": f.get("severity"),
                            "title": f.get("title")},
                "rateLimited": self._rate_limited(pb),
            })
        return entries

    # -- execution -------------------------------------------------------------

    def _acquire_lock(self) -> bool:
        if not self.lock_path:
            return True
        for _ in range(2):
            try:
                fd = os.open(self.lock_path,
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.write(fd, str(os.getpid()).encode("ascii"))
                os.close(fd)
                return True
            except FileExistsError:
                try:
                    age = time.time() - os.stat(self.lock_path).st_mtime
                    if age > self.lock_stale:
                        os.unlink(self.lock_path)  # orphan: break + retry
                        continue
                except OSError:
                    continue
                return False
        return False

    def _release_lock(self) -> None:
        if self.lock_path:
            try:
                os.unlink(self.lock_path)
            except OSError:
                pass

    def _finish(self, entry: Dict[str, Any], result: str) -> Dict[str, Any]:
        out = dict(entry, result=result, at=time.time())
        family = result.split(":", 1)[0].split(" ", 1)[0]
        self._m_actions.inc((entry["playbook"], family))
        self.log.append(out)
        if self.on_action is not None:
            try:
                self.on_action(out)
            except Exception:  # noqa: BLE001 — timeline is best-effort
                pass
        return out

    def execute(self, entries: List[Dict[str, Any]],
                yes: bool = False) -> List[Dict[str, Any]]:
        """Run a plan. ``yes=False`` is the dry run: every entry comes
        back ``result="dry-run"`` and NOTHING is touched. With
        ``yes=True``, each entry passes (in order) the one-in-flight
        lock, the per-playbook rate limit, and target verification —
        then the actuator verb runs."""
        if not yes:
            return [dict(e, result="dry-run") for e in entries]
        if not self._acquire_lock():
            return [self._finish(e, "locked") for e in entries]
        by_name = {pb.name: pb for pb in self.playbooks}
        results = []
        try:
            for entry in entries:
                pb = by_name.get(entry["playbook"])
                if pb is None:
                    results.append(self._finish(entry, "error: unknown "
                                                       "playbook"))
                    continue
                if self._rate_limited(pb):
                    results.append(self._finish(entry, "rate-limited"))
                    continue
                target = entry["target"]
                try:
                    faults.inject("remediate.wrong_target")
                except faults.FaultError:
                    # the drill: target selection went wrong —
                    # verification below must catch it
                    wrong = getattr(self.actuator, "wrong_target", None)
                    target = (wrong(entry["action"], target) if wrong
                              else f"{target}:wrong")
                ok, why = self.actuator.verify(entry["action"], target)
                if not ok:
                    results.append(self._finish(
                        dict(entry, target=target), f"refused: {why}"))
                    continue
                try:
                    verb = getattr(self.actuator, entry["action"])
                    detail = verb(target, **entry.get("params") or {})
                except Exception as e:  # noqa: BLE001 — per-entry isolation
                    results.append(self._finish(
                        entry, f"error: {type(e).__name__}: {e}"))
                    continue
                self._rate_limited(pb, charge=True)
                done = dict(entry)
                if detail:
                    done["detail"] = detail
                results.append(self._finish(done, "executed"))
        finally:
            self._release_lock()
        return results

    # -- the autoscaler's loop -------------------------------------------------

    def auto_remediate(self,
                       findings: List[Dict[str, Any]]
                       ) -> List[Dict[str, Any]]:
        """Unattended remediation for the router-resident loop: plan,
        dedup persistent findings (a replica that STAYS broken fires
        once per rate window, not once per tick), execute. The
        ``remediate.storm`` drill bypasses the dedup so the rate
        limiter alone must bound the blast radius."""
        storm = False
        try:
            faults.inject("remediate.storm")
        except faults.FaultError:
            storm = True
        by_name = {pb.name: pb for pb in self.playbooks}
        now = self.clock()
        entries = []
        for entry in self.plan(findings):
            pb = by_name[entry["playbook"]]
            key = (entry["playbook"], entry["target"])
            last = self._attempted.get(key)
            if not storm and last is not None and now - last < pb.rate_window:
                continue
            self._attempted[key] = now
            entries.append(entry)
        if not entries:
            return []
        return self.execute(entries, yes=True)


class RouterActuator:
    """In-process verbs for the router-resident remediator: restart
    through the attached :class:`ReplicaPool`, verify against live
    ``Replica`` state, pause the prober, clamp via the router's own
    quota store. ``rollback_model`` is NOT available here — the router
    has no storage home; rollbacks run via ``doctor --act`` on a
    box that does."""

    def __init__(self, router: Any, pool: Any = None) -> None:
        self.router = router
        self.pool = pool

    def _replica(self, target: str) -> Any:
        for rep in self.router.replicas:
            if rep.name == target:
                return rep
        return None

    def verify(self, action: str, target: str) -> Tuple[bool, str]:
        if action == "restart_replica":
            rep = self._replica(target)
            if rep is None:
                return False, f"unknown replica {target!r}"
            if (rep.state in ("down", "not-ready")
                    or rep.breaker.state == "open"
                    or rep.health_failures > 0):
                return True, ""
            return False, (f"replica {target} is {rep.state} with breaker "
                           f"{rep.breaker.state} — not wedged")
        if action == "restart_replica" or target is None:
            return False, "no target"
        return True, ""

    def wrong_target(self, action: str, target: str) -> str:
        """The ``remediate.wrong_target`` drill's corruption: the most
        plausible WRONG answer — a healthy replica — so verification
        is what must save us, not an unresolvable name."""
        if action == "restart_replica":
            for rep in self.router.replicas:
                if (rep.name != target and rep.state == "ok"
                        and rep.breaker.state == "closed"):
                    return rep.name
        return f"{target}:wrong"

    def restart_replica(self, target: str) -> str:
        if self.pool is None:
            raise RuntimeError("no replica pool attached to this router")
        self.pool.restart_replica(target)
        return f"pool restart requested for {target}"

    def exclude_probe(self, target: str, resumeAfterSec: float = 600,
                      **_: Any) -> str:
        self.router.pause_probe(float(resumeAfterSec))
        return f"prober paused for {resumeAfterSec:g}s"

    def clamp_tenant(self, app: str, rateFactor: float = 0.5,
                     shedRate: float = 100, **_: Any) -> str:
        return _clamp_tenant(self.router.quotas, app, rateFactor, shedRate)

    def rollback_model(self, target: str, **_: Any) -> str:
        raise RuntimeError(
            "rollback_model needs a storage home — run "
            "`doctor --act` where PIO_HOME points at the models")


class OpsActuator:
    """The verbs of ``doctor --act`` on an ops box: replica
    and probe actions go over HTTP to the router; model rollback and
    tenant clamps act on the storage home directly."""

    def __init__(self, url: Optional[str] = None,
                 home: Optional[str] = None,
                 timeout: float = 30.0) -> None:
        self.url = url.rstrip("/") if url else None
        self.home = home
        self.timeout = timeout

    def _http(self, method: str, path: str) -> Dict[str, Any]:
        import urllib.request

        if not self.url:
            raise RuntimeError("this action needs --url (a live router)")
        req = urllib.request.Request(self.url + path, data=b"",
                                     method=method)
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            body = r.read()
        try:
            return json.loads(body) if body else {}
        except ValueError:
            return {}

    def verify(self, action: str, target: str) -> Tuple[bool, str]:
        if action == "restart_replica":
            try:
                doc = self._http("GET", "/router/status")
            except Exception as e:  # noqa: BLE001 — verification must not 500
                return False, f"router status unreachable: {e}"
            for rep in doc.get("replicas") or []:
                name = (rep.get("url") or "").split("://", 1)[-1]
                if name != target:
                    continue
                if (rep.get("state") in ("down", "not-ready")
                        or rep.get("breaker") == "open"):
                    return True, ""
                return False, (f"replica {target} is {rep.get('state')} "
                               f"with breaker {rep.get('breaker')} — "
                               "not wedged")
            return False, f"unknown replica {target!r}"
        if not target:
            return False, "no target"
        return True, ""

    def restart_replica(self, target: str) -> str:
        out = self._http("POST", f"/pool/restart?replica={target}")
        if not out.get("ok"):
            raise RuntimeError(f"router refused restart: {out}")
        return f"router restarted {target}"

    def exclude_probe(self, target: str, resumeAfterSec: float = 600,
                      **_: Any) -> str:
        self._http("POST", f"/probe?pause={float(resumeAfterSec):g}")
        return f"prober paused for {resumeAfterSec:g}s"

    def clamp_tenant(self, app: str, rateFactor: float = 0.5,
                     shedRate: float = 100, **_: Any) -> str:
        from predictionio_tpu_torch.server.tenancy import TenantQuotas

        if not self.home:
            raise RuntimeError("clamp_tenant needs a storage home "
                               "(PIO_HOME) for quotas.json")
        return _clamp_tenant(TenantQuotas.for_home(self.home), app,
                             rateFactor, shedRate)

    def rollback_model(self, target: str, **_: Any) -> str:
        from predictionio_tpu_torch.storage.models import model_registry
        from predictionio_tpu_torch.storage.registry import (Storage,
                                                       StorageConfig)

        cfg = (StorageConfig(home=self.home) if self.home
               else StorageConfig.from_env())
        storage = Storage(cfg)
        registry = model_registry(storage)
        entry = registry.rollback()
        registry.sync_meta(storage.meta)
        detail = f"rolled back to generation {entry.get('gen')}"
        if self.url:
            out = self._http("POST", "/router/reload?rolling=1")
            detail += (" + rolling reload ok" if out.get("ok")
                       else f" + rolling reload FAILED: {out}")
        return detail


def _clamp_tenant(quotas: Any, app: str, rate_factor: float,
                  shed_rate: float) -> str:
    """Shared clamp: halve (``rateFactor``) a limited tenant, or pin an
    unlimited one to ``shedRate`` — quotas.json is hot-reloaded by
    every ingest gate within ~1s, so the clamp lands fleet-wide without
    restarts."""
    current = float(quotas.describe(app).get("rate") or 0.0)
    new_rate = (max(1.0, current * rate_factor) if current > 0
                else float(shed_rate))
    quotas.set_quota(app, rate=new_rate, burst=new_rate)
    return (f"app {app} ingest clamped "
            f"{current:g} -> {new_rate:g} events/s")
