"""Incident flight recorder: automatic postmortem capture (the port's
copy of the JAX package's ``utils/incidents.py``).

The evidence behind a page lives in ring buffers (the fine-tier metrics
history, the trace ring, breaker state) that age out while the operator
is still getting paged. When something trips, the process writes itself
a bounded on-disk **incident bundle** pinning what a postmortem needs,
before the rings forget.

A bundle is one directory ``<home>/incidents/<ts>-<trigger>/``:

- ``manifest.json``   — trigger(s), process, firing SLOs, armed fault
  sites, bucket exemplars, build identity, the file list (written
  LAST, atomically: a manifest's presence means the bundle is whole);
- ``metrics_history.json`` — fine-tier history windows (default 15 m)
  for the firing series;
- ``traces.json``     — the trace ring filtered to the exemplar trace
  ids named by the offending latency buckets;
- one ``<source>.json`` per registered source — health, variants:
  whatever the host process already serves on its endpoints.

The port's engine and event servers wire two triggers: a circuit
breaker opens, and the process receives SIGQUIT or dies by an unhandled
exception (:func:`install_crash_handlers`). The JAX package's router and
continuous trainer add SLO burns and replicas going down. Capture is
one fail-open background thread — it carries the
``incident.capture.stall`` fault site and the
``pio_incident_captures_total{trigger,result}`` counter, is debounced
per trigger so a flapping breaker cannot fill the disk, and
near-in-time triggers coalesce into the SAME bundle (one page, one
bundle). The store prunes itself to ``retain`` bundles after every
capture.

``pio incidents list/show/prune`` browses the store and :func:`diagnose`
correlates a bundle into a ranked findings report (the JAX package's
``pio doctor`` reads it; :func:`diagnose_live` reads a router's live
answers). Steady-state cost is zero: no trigger, no thread, no I/O.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

from predictionio_tpu_torch.utils.atomic_write import atomic_write_text
from predictionio_tpu_torch.utils.faults import FAULTS
from predictionio_tpu_torch.utils.metrics import REGISTRY, Histogram

_m_captures = REGISTRY.counter(
    "pio_incident_captures_total",
    "Incident-bundle capture attempts by trigger and result "
    "(debounced = suppressed by the per-trigger debounce window)",
    ("trigger", "result"))
_m_resident = REGISTRY.gauge(
    "pio_incident_resident",
    "Incident bundles currently resident in the on-disk store")


def default_incident_dir(home: str) -> str:
    """The conventional store location under a storage home."""
    return os.path.join(home, "incidents")


class IncidentStore:
    """Bounded on-disk incident store: one directory per bundle under
    ``root``, pruned oldest-first to ``retain`` bundles. Clock-
    injectable so retention tests run on a fake clock."""

    def __init__(self, root: str, retain: int = 20,
                 clock: Callable[[], float] = time.time) -> None:
        self.root = root
        self.retain = max(1, retain)
        self.clock = clock

    # -- layout ----------------------------------------------------------------

    def new_id(self, ts: float, trigger: str) -> str:
        """``<utc-compact-ts>-<trigger>``, uniquified if two captures
        land inside the same second."""
        stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime(ts))
        base = f"{stamp}-{trigger}"
        iid, n = base, 1
        while os.path.isdir(os.path.join(self.root, iid)):
            n += 1
            iid = f"{base}-{n}"
        return iid

    def path(self, incident_id: str) -> str:
        return os.path.join(self.root, incident_id)

    # -- writing ---------------------------------------------------------------

    def write_bundle(self, incident_id: str, files: Dict[str, Any],
                     manifest: Dict[str, Any]) -> str:
        """Write every bundle file, then the manifest LAST — a bundle
        with a manifest is complete by construction. ``str`` values
        are written raw; everything else as JSON."""
        d = self.path(incident_id)
        os.makedirs(d, exist_ok=True)
        for name, content in files.items():
            if isinstance(content, str):
                atomic_write_text(os.path.join(d, name), content)
            else:
                atomic_write_text(
                    os.path.join(d, name),
                    json.dumps(content, indent=2, sort_keys=True,
                               default=str))
        manifest = dict(manifest)
        manifest["files"] = sorted(set(files) | {"manifest.json"})
        atomic_write_text(os.path.join(d, "manifest.json"),
                          json.dumps(manifest, indent=2, sort_keys=True,
                                     default=str))
        return d

    # -- reading ---------------------------------------------------------------

    def ids(self) -> List[str]:
        """Resident bundle ids, newest first (lexicographic on the
        timestamped name, which sorts chronologically)."""
        try:
            entries = [e for e in os.listdir(self.root)
                       if os.path.isdir(os.path.join(self.root, e))]
        except OSError:
            return []
        return sorted(entries, reverse=True)

    def load_manifest(self, incident_id: str) -> Optional[Dict[str, Any]]:
        try:
            with open(os.path.join(self.path(incident_id), "manifest.json"),
                      "r", encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def read_json(self, incident_id: str, name: str) -> Optional[Any]:
        try:
            with open(os.path.join(self.path(incident_id), name),
                      "r", encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def load_bundle(self, incident_id: str) -> Optional[Dict[str, Any]]:
        """``{"id", "manifest", "files": {name: parsed}}`` for one
        bundle, or None when it has no manifest (incomplete)."""
        manifest = self.load_manifest(incident_id)
        if manifest is None:
            return None
        files: Dict[str, Any] = {}
        for name in manifest.get("files", []):
            if name == "manifest.json" or not name.endswith(".json"):
                continue
            doc = self.read_json(incident_id, name)
            if doc is not None:
                files[name] = doc
        return {"id": incident_id, "manifest": manifest, "files": files}

    def list_bundles(self) -> List[Dict[str, Any]]:
        """Summary rows, newest first: id + the manifest highlights
        (manifest-less directories show as ``incomplete``)."""
        out = []
        for iid in self.ids():
            m = self.load_manifest(iid)
            if m is None:
                out.append({"id": iid, "incomplete": True})
                continue
            out.append({
                "id": iid,
                "trigger": m.get("trigger"),
                "process": m.get("process"),
                "capturedAt": m.get("capturedAt"),
                "triggers": [t.get("trigger") for t in
                             m.get("triggers", [])],
                "sloFastBurning": m.get("sloFastBurning", []),
                "faults": sorted(m.get("faults", {})),
            })
        return out

    # -- retention -------------------------------------------------------------

    def prune(self, retain: Optional[int] = None) -> List[str]:
        """Drop the oldest bundles beyond the retention bound; returns
        the removed ids. Updates ``pio_incident_resident``."""
        keep = self.retain if retain is None else max(0, retain)
        ids = self.ids()           # newest first
        removed = []
        for iid in ids[keep:]:
            shutil.rmtree(self.path(iid), ignore_errors=True)
            removed.append(iid)
        _m_resident.set(min(len(ids), keep))
        return removed


# -- capture helpers -----------------------------------------------------------


def collect_exemplars(registry=None, limit: int = 64) -> List[Dict[str, Any]]:
    """Walk every histogram's retained bucket exemplars: the concrete
    trace ids the offending latency buckets name. Highest-valued
    observations first so slow outliers survive the cap."""
    registry = REGISTRY if registry is None else registry
    out: List[Dict[str, Any]] = []
    for metric in registry.metrics():
        if not isinstance(metric, Histogram):
            continue
        for key, le, trace_id, value in metric.exemplars():
            out.append({
                "series": metric.name,
                "labels": dict(zip(metric.labelnames, key)),
                "le": le,
                "traceId": trace_id,
                "valueMs": round(value * 1e3, 3),
            })
    out.sort(key=lambda e: e["valueMs"], reverse=True)
    return out[:limit]


def build_info_snapshot(registry=None) -> Dict[str, str]:
    """The ``pio_build_info`` identity labels of this process."""
    registry = REGISTRY if registry is None else registry
    for metric in registry.metrics():
        if getattr(metric, "name", "") == "pio_build_info":
            for key, _ in metric.items():       # type: ignore[attr-defined]
                return dict(zip(metric.labelnames, key))
    return {}


def fault_snapshot() -> Dict[str, Dict[str, Any]]:
    """The armed fault plans, JSON-shaped — a bundle that records an
    injected era says so in its own manifest."""
    out = {}
    for site, plan in FAULTS.plans().items():
        out[site] = {"latency": plan.latency, "error": plan.error,
                     "rate": plan.rate, "count": plan.count,
                     "fired": plan.fired}
    return out


def thread_dump() -> str:
    """Stack of every live thread (the SIGQUIT payload), built from
    ``sys._current_frames`` so it works from a signal handler."""
    names = {t.ident: t.name for t in threading.enumerate()}
    lines = []
    for tid, frame in sys._current_frames().items():
        lines.append(f"--- thread {names.get(tid, '?')} (id {tid}) ---")
        lines.extend(ln.rstrip("\n")
                     for ln in traceback.format_stack(frame))
    return "\n".join(lines) + "\n"


# -- the capturer --------------------------------------------------------------


class IncidentCapturer:
    """The per-process capture plane: named content sources (the logic
    behind the host's own endpoints), an optional TSDB + selector set
    for the history pin, per-trigger debounce, and near-in-time
    coalescing into one bundle. ``trigger()`` costs a lock and a dict
    lookup when debounced; an admitted trigger spawns one daemon
    thread and returns — never the caller's latency."""

    def __init__(self, store: IncidentStore, process: str,
                 debounce: float = 300.0, coalesce: float = 60.0,
                 clock: Callable[[], float] = time.time) -> None:
        self.store = store
        self.process = process
        self.debounce = debounce
        self.coalesce = coalesce
        self.clock = clock
        self.sources: Dict[str, Callable[[], Any]] = {}
        self.tsdb = None
        self.history_selectors: Optional[Callable[[], List[str]]] = None
        self.history_window = 900.0
        self._lock = threading.Lock()
        self._last_by_trigger: Dict[str, float] = {}
        self._last_capture: Optional[Tuple[float, str]] = None
        self._threads: List[threading.Thread] = []

    def add_source(self, name: str, fn: Callable[[], Any]) -> None:
        self.sources[name] = fn

    def set_history(self, tsdb, selectors: Callable[[], List[str]],
                    window: float = 900.0) -> None:
        self.tsdb = tsdb
        self.history_selectors = selectors
        self.history_window = window

    # -- triggering ------------------------------------------------------------

    def trigger(self, trigger: str, detail: Optional[Dict[str, Any]] = None,
                sync: bool = False,
                extra_files: Optional[Dict[str, Any]] = None
                ) -> Optional[str]:
        """Fire one capture trigger. Returns the incident id it will
        write into, or None when the per-trigger debounce suppressed
        it. ``sync=True`` captures inline (crash handlers — the
        process is dying and a thread would not get scheduled)."""
        now = self.clock()
        with self._lock:
            last = self._last_by_trigger.get(trigger)
            if last is not None and now - last < self.debounce:
                _m_captures.inc((trigger, "debounced"))
                return None
            self._last_by_trigger[trigger] = now
            if (self._last_capture is not None
                    and now - self._last_capture[0] < self.coalesce):
                iid = self._last_capture[1]     # coalesce: same bundle
            else:
                iid = self.store.new_id(now, trigger)
            self._last_capture = (now, iid)
        if sync:
            self._capture(iid, trigger, detail, now, extra_files)
        else:
            t = threading.Thread(
                target=self._capture, args=(iid, trigger, detail, now,
                                            extra_files),
                name="pio-incident-capture", daemon=True)
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)
            t.start()
        return iid

    def join(self, timeout: float = 5.0) -> None:
        """Wait for in-flight captures (atexit / tests)."""
        for t in list(self._threads):
            t.join(timeout)

    # -- the capture body ------------------------------------------------------

    def _capture(self, incident_id: str, trigger: str,
                 detail: Optional[Dict[str, Any]], ts: float,
                 extra_files: Optional[Dict[str, Any]]) -> None:
        try:
            FAULTS.hit("incident.capture.stall")
            files: Dict[str, Any] = {}
            for name, fn in list(self.sources.items()):
                try:
                    files[f"{name}.json"] = fn()
                except Exception as e:  # noqa: BLE001 — partial > none
                    files[f"{name}.json"] = {
                        "error": f"{type(e).__name__}: {e}"}
            exemplars = collect_exemplars()
            trace_ids = sorted({e["traceId"] for e in exemplars})
            spans: List[Dict[str, Any]] = []
            try:
                from predictionio_tpu_torch.utils.tracing import TRACER
                spans = TRACER.ring.export_by_trace_ids(trace_ids)
            except Exception:
                pass
            files["traces.json"] = {"exemplarTraceIds": trace_ids,
                                    "spans": spans}
            if self.tsdb is not None and self.history_selectors is not None:
                try:
                    files["metrics_history.json"] = self.tsdb.snapshot_window(
                        self.history_selectors(), self.history_window)
                except Exception as e:  # noqa: BLE001
                    files["metrics_history.json"] = {
                        "error": f"{type(e).__name__}: {e}"}
            files["faults.json"] = fault_snapshot()
            if extra_files:
                files.update(extra_files)
            record = {"trigger": trigger, "at": round(ts, 3),
                      "detail": detail or {}}
            slo_doc = files.get("slo_status.json") or {}
            firing = list(slo_doc.get("fastBurning") or [])
            if detail and detail.get("slos"):
                firing = sorted(set(firing) | set(detail["slos"]))
            prior = self.store.load_manifest(incident_id)
            if prior is not None:            # coalesced re-capture
                triggers = prior.get("triggers", []) + [record]
                firing = sorted(set(prior.get("sloFastBurning", []))
                                | set(firing))
                first = prior.get("trigger", trigger)
            else:
                triggers, first = [record], trigger
            manifest = {
                "id": incident_id,
                "process": self.process,
                "trigger": first,
                "triggers": triggers,
                "capturedAt": time.strftime(
                    "%Y-%m-%dT%H:%M:%SZ", time.gmtime(ts)),
                "capturedAtEpoch": round(ts, 3),
                "sloFastBurning": firing,
                "faults": files["faults.json"],
                "exemplars": exemplars,
                "metricsWindowSeconds": (
                    self.history_window if self.tsdb is not None else 0),
                "buildInfo": build_info_snapshot(),
            }
            self.store.write_bundle(incident_id, files, manifest)
            _m_captures.inc((trigger, "ok"))
        except Exception:  # noqa: BLE001 — fail-open: never the host
            _m_captures.inc((trigger, "error"))
        finally:
            try:
                self.store.prune()
            except Exception:  # noqa: BLE001
                pass


# -- crash-dump plumbing -------------------------------------------------------


def install_crash_handlers(capturer: IncidentCapturer,
                           install_signals: bool = True) -> None:
    """Wire trigger (d) into a process: ``faulthandler`` for hard
    faults, SIGQUIT → thread-dump-to-incident (the process keeps
    running, the JVM convention), ``sys.excepthook`` → synchronous
    ``crash`` capture before the interpreter dies (not for the
    ``KeyboardInterrupt`` of a SIGINT stop), and an atexit join
    so an in-flight capture gets to finish. Signal installation is
    skipped off the main thread (embedded servers in tests)."""
    import atexit
    import faulthandler
    import signal

    try:
        faulthandler.enable()
    except Exception:  # noqa: BLE001 — no usable stderr fd
        pass

    if install_signals and hasattr(signal, "SIGQUIT"):
        def _on_sigquit(signum, frame):  # noqa: ARG001
            capturer.trigger(
                "sigquit", extra_files={"thread_dump.txt": thread_dump()})

        try:
            signal.signal(signal.SIGQUIT, _on_sigquit)
        except ValueError:
            pass  # not the main thread

    prev_hook = sys.excepthook

    def _on_crash(exc_type, exc, tb):
        if issubclass(exc_type, KeyboardInterrupt):
            # SIGINT is how an operator stops a server: a stop, not a
            # crash (the JAX package's hook writes a bundle for it)
            prev_hook(exc_type, exc, tb)
            return
        try:
            capturer.trigger(
                "crash",
                detail={"exception": f"{exc_type.__name__}: {exc}"},
                sync=True,
                extra_files={"crash_traceback.txt": "".join(
                    traceback.format_exception(exc_type, exc, tb))})
        except Exception:  # noqa: BLE001
            pass
        prev_hook(exc_type, exc, tb)

    sys.excepthook = _on_crash
    atexit.register(capturer.join, 2.0)


# -- doctor: bundle correlation ------------------------------------------------


def _series_entity(key: str) -> str:
    """A human handle for one history series key: the most specific
    label value (replica/app/variant/...) or the bare name."""
    if "{" not in key:
        return key
    name, _, labels = key.partition("{")
    pairs = [p for p in labels.rstrip("}").split(",") if "=" in p]
    for want in ("replica", "app", "variant", "path", "outcome"):
        for p in pairs:
            k, _, v = p.partition("=")
            if k == want:
                return f"{name}[{k}={v.strip(chr(34))}]"
    return key


def _series_label(key: str, want: str) -> Optional[str]:
    """One label value out of a rendered series key, or None."""
    if "{" not in key:
        return None
    _, _, labels = key.partition("{")
    for p in labels.rstrip("}").split(","):
        k, _, v = p.partition("=")
        if k == want:
            return v.strip('"')
    return None


def _first_movers(history: Dict[str, Any], limit: int = 3
                  ) -> List[Tuple[float, str]]:
    """Timeline alignment: for every captured series, the earliest
    sample time its value moved off its first-sample baseline —
    sorted, so "which replica/tenant/variant moved first" is the head
    of the list."""
    movers: List[Tuple[float, str]] = []
    for key, samples in (history.get("series") or {}).items():
        if len(samples) < 2:
            continue
        baseline = samples[0][1]
        for t, v in samples[1:]:
            if v != baseline:
                movers.append((t, _series_entity(key)))
                break
    movers.sort()
    return movers[:limit]


def diagnose(bundle: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Correlate one bundle into ranked findings
    ``{"severity": 0|1|2, "kind", "title", "evidence"}`` — severity
    2 = firing (page-worthy), 1 = warn, 0 = informational. ``kind`` is
    the machine handle ``conf/remediations.json`` playbooks match on;
    kinds with a target also carry the structured field the actuator
    needs (``replica``, ``app``, ``site``, ``slo``). Sorted most
    severe first; :func:`exit_code` maps the ranking onto the
    ``pio doctor`` exit contract."""
    manifest = bundle.get("manifest") or {}
    files = bundle.get("files") or {}
    findings: List[Dict[str, Any]] = []

    for name in manifest.get("sloFastBurning") or []:
        findings.append({
            "severity": 2,
            "kind": "slo-fast-burn",
            "slo": name,
            "title": f"SLO {name} fast-burning at capture",
            "evidence": "manifest.sloFastBurning; burn rates in "
                        "slo_status.json",
        })
    faults = manifest.get("faults") or {}
    for site, plan in sorted(faults.items()):
        findings.append({
            "severity": 2,
            "kind": "fault-armed",
            "site": site,
            "title": f"fault site {site} armed during the incident era",
            "evidence": f"injected plan {plan} — this window is a "
                        "drill/chaos era, not organic failure",
        })
    for rep in (files.get("replicas.json") or {}).get("replicas", []):
        state = rep.get("state")
        if state in ("down", "not-ready"):
            findings.append({
                "severity": 2 if state == "down" else 1,
                "kind": ("replica-down" if state == "down"
                         else "replica-not-ready"),
                "replica": rep.get("url"),
                "title": f"replica {rep.get('url')} was {state}",
                "evidence": f"breaker={rep.get('breaker')} "
                            f"ewmaMs={rep.get('ewmaMs')}",
            })
        elif rep.get("breaker") == "open":
            findings.append({
                "severity": 2,
                "kind": "breaker-open",
                "replica": rep.get("url"),
                "title": f"replica {rep.get('url')} breaker open",
                "evidence": "passive breaker ejected the replica; "
                            "Retry-After windows applied",
            })
    history = files.get("metrics_history.json") or {}
    movers = _first_movers(history)
    if movers:
        t0, who = movers[0]
        rest = ", ".join(w for _, w in movers[1:])
        findings.append({
            "severity": 1,
            "kind": "first-mover",
            "title": f"{who} moved first (t={t0:.1f})",
            "evidence": ("followed by " + rest if rest else
                         "no other series moved in the window"),
        })
    shed = {k: v for k, v in (history.get("series") or {}).items()
            if k.startswith(("pio_engine_shed_total",
                             "pio_fleet_engine_shed_total",
                             "pio_tenant_quota_rejected_total",
                             "pio_fleet_tenant_quota_rejected_total"))}
    for key, samples in sorted(shed.items()):
        if len(samples) >= 2 and samples[-1][1] > samples[0][1]:
            findings.append({
                "severity": 1,
                "kind": "tenant-pressure",
                "app": _series_label(key, "app"),
                "title": f"tenant pressure: {_series_entity(key)} "
                         f"rose {samples[0][1]:g} → {samples[-1][1]:g}",
                "evidence": "shed/quota 429s carried Retry-After "
                            "backpressure during the window",
            })
    exemplars = manifest.get("exemplars") or []
    if exemplars:
        worst = exemplars[0]
        findings.append({
            "severity": 0,
            "kind": "exemplar",
            "title": f"worst pinned exemplar {worst.get('valueMs')}ms "
                     f"in {worst.get('series')}",
            "evidence": f"trace {worst.get('traceId')} resolvable in "
                        "traces.json",
        })
    triggers = manifest.get("triggers") or []
    if len(triggers) > 1:
        findings.append({
            "severity": 0,
            "kind": "coalesced",
            "title": f"{len(triggers)} triggers coalesced into this "
                     "bundle",
            "evidence": ", ".join(t.get("trigger", "?") for t in triggers),
        })
    findings.sort(key=lambda f: -f["severity"])
    return findings


def diagnose_live(slo_doc: Dict[str, Any], health_doc: Dict[str, Any],
                  top_doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    """The live-fleet variant of :func:`diagnose`, over the router's
    ``/slo/status`` + ``/health`` + ``/top`` answers. Same
    ``kind``/target contract as :func:`diagnose` — this is what
    ``pio doctor --act --url`` feeds the remediation engine."""
    findings: List[Dict[str, Any]] = []
    fast = slo_doc.get("fastBurning") or []
    for name in fast:
        findings.append({
            "severity": 2,
            "kind": "slo-fast-burn",
            "slo": name,
            "title": f"SLO {name} fast-burning NOW",
            "evidence": "live /slo/status",
        })
    if fast:
        # a fast burn while a model generation is serving is the
        # rollback playbook's trigger — the most common cause of a
        # sudden fleet-wide burn is the generation just promoted
        gens = sorted({rep.get("modelGeneration")
                       for rep in top_doc.get("replicas") or []
                       if rep.get("modelGeneration") is not None})
        if gens:
            findings.append({
                "severity": 1,
                "kind": "model-regression",
                "generation": gens[-1],
                "title": f"fast burn while model generation {gens[-1]} "
                         "serves — suspect the last promotion",
                "evidence": "fastBurning + replica modelGeneration on "
                            "live /top; rollback restores the previous "
                            "champion",
            })
    for s in slo_doc.get("slos") or []:
        if s.get("slowBurn") and not s.get("fastBurn"):
            findings.append({
                "severity": 1,
                "kind": "slo-slow-burn",
                "slo": s.get("name"),
                "title": f"SLO {s.get('name')} slow-burning",
                "evidence": "ticket-grade budget spend on live "
                            "/slo/status",
            })
    if health_doc.get("status") == "degraded":
        findings.append({
            "severity": 1,
            "kind": "router-degraded",
            "title": "router /health degraded",
            "evidence": str(health_doc.get("reason", "")),
        })
    for rep in top_doc.get("replicas") or []:
        if rep.get("state") == "down" or rep.get("breaker") == "open":
            findings.append({
                "severity": 2,
                "kind": ("replica-down" if rep.get("state") == "down"
                         else "breaker-open"),
                "replica": rep.get("url"),
                "title": f"replica {rep.get('url')} "
                         f"state={rep.get('state')} "
                         f"breaker={rep.get('breaker')}",
                "evidence": "live /top replica table",
            })
    for app, rate in sorted((top_doc.get("tenantSheds") or {}).items()):
        if rate > 0:
            findings.append({
                "severity": 1,
                "kind": "tenant-pressure",
                "app": app,
                "title": f"tenant {app} being shed at {rate:g}/s",
                "evidence": "live /top tenantSheds; clamp playbook "
                            "rewrites quotas.json",
            })
    probe = top_doc.get("probe") or {}
    err = sum(v for k, v in probe.items() if k != "ok")
    if err > 0 and err >= probe.get("ok", 0.0):
        findings.append({
            "severity": 2,
            "kind": "probe-failing",
            "title": f"synthetic probe failing at {err:g}/s "
                     f"(ok {probe.get('ok', 0.0):g}/s)",
            "evidence": "live /top probe outcomes; exclusion playbook "
                        "pauses the prober while the canary target is "
                        "repaired",
        })
    findings.sort(key=lambda f: -f["severity"])
    return findings


def exit_code(findings: List[Dict[str, Any]]) -> int:
    """``pio doctor`` contract: 0 clean, 1 warn, 2 firing."""
    return max((f["severity"] for f in findings), default=0)
