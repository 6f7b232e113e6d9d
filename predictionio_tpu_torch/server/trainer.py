"""Continuous-training loop: the port's copy of the JAX package's
``server/trainer.py`` (crash-safe delta trainer with lease fencing,
guardrail-gated promotion and automatic rollback).

The loop connects pieces the port already has (feedback events through
the event server, the snapshot cache's creation-time watermark,
``/reload``'s probe-then-swap):

1. **Single-writer lease with fencing** (:class:`TrainerLease`): a
   file-backed lease under the storage home, renewed by heartbeat.
   Every acquisition bumps a monotonically increasing fencing token;
   the model registry remembers the highest token it has seen and
   refuses writes carrying an older one, so a wedged trainer that
   loses its lease mid-train can never publish a late blob. The lease
   file is the JAX package's: either package's trainer (or event-plane
   node, ``server/repl_server.py``) acquires, renews and fences the
   other's.
2. **Watermark wake**: the trainer polls ``events.creation_stats`` and
   trains only when at least ``min_delta_events`` new events arrived
   since the last completed cycle (state in ``trainer.state.json``).
3. **Crash-safe delta train** on ``cfg.device`` (CUDA unless the
   config says ``"cpu"``): ``run_train(resume=True,
   batch="continuous")``, so a ``kill -9`` mid-train leaves the port's
   checkpoint directory (``<home>/train_ckpt_torch/``) in place and the
   restarted trainer resumes from its newest checkpoint.
4. **Generation registry**: the candidate lands in
   :class:`~predictionio_tpu_torch.storage.models.ModelRegistry` as a
   new generation (sha256 sidecar, fence-checked with the lease's
   token) and its meta status is SHELVED until judged.
5. **Gates**: ``offline`` (champion against candidate RMSE on the newest
   held-out feedback, through each instance's query path: the instance is
   loaded on ``cfg.device``, and a rating query is a dot product of two
   factor rows on the host, as in the JAX package; a candidate whose
   every query raises is refused), ``online`` (the
   challenger arm's accrued ``pio_variant_online_rmse``), ``eval`` (the
   latest ``pio eval`` leaderboard) or ``both``.
6. **Probe-then-swap push**: survivors are promoted and every replica,
   or the fleet router, gets a plain ``/reload``.
7. **Bake window with automatic rollback** on the scraped error rate
   and p95.

Fault sites (``utils/faults.py``): ``train.crash`` (mid-delta-train,
after the wake decision and before any publish), ``train.lease.lost``
(the heartbeat finds the lease stolen) and ``promote.regression`` (the
candidate scores as regressed).

Run it supervised::

    python -m predictionio_tpu_torch.tools.cli daemon -- train --continuous \\
        --engine-dir predictionio_tpu_torch/templates/recommendation

On SIGTERM the trainer releases the lease (expiry zeroed, token kept)
before exiting 0, so a graceful restart re-acquires at once and the
supervisor treats the clean exit as a finished job, not a crash.

With ``cfg.verbose`` the loop prints one ``[trainer]`` line a cycle:
its outcome, the walls of its train (the training read included; the
workflow's own ``train phases:`` line splits it), gate, promote and
reload, and the process's kernel launches so far; and the gate's verdict
(its RMSEs and reason) on a ``[trainer] gate:`` line.
"""

from __future__ import annotations

import errno
import json
import math
import os
import pickle
import re
import signal
import threading
import time
import urllib.request
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from predictionio_tpu_torch.storage.models import (
    FencedWriteError,
    ModelRegistry,
    model_registry,
)
from predictionio_tpu_torch.storage.registry import Storage, get_storage
from predictionio_tpu_torch.utils import faults
from predictionio_tpu_torch.utils.atomic_write import atomic_write_bytes
from predictionio_tpu_torch.utils.integrity import IntegrityError
from predictionio_tpu_torch.utils.metrics import REGISTRY

# Trainer observability: these land in the process registry so the
# optional metrics listener (cfg.metrics_port) can expose them and the
# fleet router can federate them as pio_fleet_trainer_* (manifest
# ``observe=1`` line → health-polled + scraped, never routed).
_m_cycles = REGISTRY.counter(
    "pio_trainer_cycles_total",
    "Continuous-trainer wake cycles by outcome",
    ("outcome",))
_m_lease_held = REGISTRY.gauge(
    "pio_trainer_lease_held",
    "1 while this trainer holds the single-writer lease")
_m_generation = REGISTRY.gauge(
    "pio_trainer_generation",
    "Newest model generation this trainer registered")
_m_bake_active = REGISTRY.gauge(
    "pio_trainer_bake_active",
    "1 while a bake window is judging a freshly promoted generation")


class LeaseLost(RuntimeError):
    """The trainer's single-writer lease was stolen (or vanished): the
    current cycle must be abandoned without publishing anything."""


# -- the single-writer lease ---------------------------------------------------


class TrainerLease:
    """File-backed single-writer lease with fencing tokens.

    The lease file (``<home>/trainer.lease``) holds one JSON document::

        {"owner": "host:pid", "token": 7, "expires": 1722870000.0}

    Mutations are serialized by a sibling ``.lock`` file created with
    ``O_CREAT|O_EXCL`` (the portable atomic primitive on a local or NFS
    filesystem); a lock older than a few seconds is presumed orphaned by
    a dead process and broken. The lease itself expires by wall clock:
    a holder that stops heartbeating is supersedable after ``ttl``.

    **Wall-clock jumps**: the expiry in the file must stay wall-clock
    (it is compared across hosts), but a contender double-checks it
    against its OWN monotonic observations of the lease document —
    every renewal bumps a ``beat`` counter, so a live holder's document
    visibly changes each heartbeat:

    - a forward jump makes a live lease LOOK expired; the contender
      refuses to steal while it has watched the document change within
      the last ``ttl`` of monotonic time (heartbeats are landing, the
      wall is lying);
    - a backward jump makes a dead lease LOOK live forever; the
      contender steals anyway once the document has been byte-identical
      for ``ttl`` of monotonic time (nobody is heartbeating, whatever
      the wall says).

    A contender with no observation history trusts the wall clock — so
    a genuinely expired lease is still stolen on first sighting.

    **Fencing**: every successful :meth:`acquire` bumps ``token`` past
    the previous holder's, whether or not that holder is alive. The
    token rides along on every registry write, and the registry refuses
    tokens older than the highest it has seen — so even a holder that
    is superseded *mid-write* cannot land a late blob. :meth:`release`
    zeroes ``expires`` but **keeps the token**, so a graceful handoff
    still forces the next holder onto a fresh token.
    """

    def __init__(self, path: str, owner: str, ttl: float = 30.0,
                 clock: Callable[[], float] = time.time,
                 sleep: Callable[[float], None] = time.sleep,
                 mono: Callable[[], float] = time.monotonic) -> None:
        self.path = path
        self.owner = owner
        self.ttl = float(ttl)
        self.token: Optional[int] = None
        self._clock = clock
        self._sleep = sleep
        self._mono = mono
        #: observation fingerprint: the lease document's bytes as last
        #: seen, when THIS fingerprint was first seen (monotonic), and
        #: when we last watched the document CHANGE (monotonic)
        self._seen_fp: Optional[str] = None
        self._seen_at = 0.0
        self._changed_at: Optional[float] = None

    # -- the .lock mutex -------------------------------------------------------

    def _lock_path(self) -> str:
        return self.path + ".lock"

    def _locked(self):
        lease = self

        class _Ctx:
            def __enter__(self):
                deadline = lease._clock() + 0.5
                lp = lease._lock_path()
                while True:
                    try:
                        fd = os.open(lp, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                        os.close(fd)
                        return self
                    except OSError as e:
                        if e.errno != errno.EEXIST:
                            raise
                        # break a lock left by a process that died between
                        # creating it and removing it
                        try:
                            if lease._clock() - os.path.getmtime(lp) > 5.0:
                                os.unlink(lp)
                                continue
                        except OSError:
                            continue
                        if lease._clock() >= deadline:
                            raise TimeoutError(
                                f"could not take {lp} within 0.5s")
                        lease._sleep(0.02)

            def __exit__(self, *exc):
                try:
                    os.unlink(lease._lock_path())
                except OSError:
                    pass
                return False

        return _Ctx()

    # -- lease document --------------------------------------------------------

    def _read(self) -> Optional[Dict[str, Any]]:
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                return json.load(f)
        except (FileNotFoundError, ValueError):
            return None

    def _write(self, doc: Dict[str, Any]) -> None:
        atomic_write_bytes(
            self.path, json.dumps(doc, sort_keys=True).encode("utf-8"))

    # -- protocol --------------------------------------------------------------

    def _observe(self, doc: Optional[Dict[str, Any]]) -> float:
        """Update the observation fingerprint; returns monotonic now."""
        mono_now = self._mono()
        fp = (None if doc is None
              else json.dumps(doc, sort_keys=True))
        if fp != self._seen_fp:
            if self._seen_fp is not None:
                self._changed_at = mono_now
            self._seen_fp = fp
            self._seen_at = mono_now
        return mono_now

    def acquire(self) -> bool:
        """Try to take the lease. True on success (``self.token`` is the
        new fencing token); False when another live holder has it.
        Wall expiry decides, cross-checked against this contender's
        monotonic observations (see class doc) so a clock jump neither
        self-expires a live lease nor immortalizes a dead one."""
        with self._locked():
            doc = self._read()
            now = self._clock()
            mono_now = self._observe(doc)
            if doc is not None and doc.get("owner") != self.owner:
                wall_live = float(doc.get("expires", 0)) > now
                # dead to monotonic eyes: byte-identical for >= ttl
                stale_mono = mono_now - self._seen_at >= self.ttl
                # alive to monotonic eyes: we watched it change < ttl ago
                fresh_mono = (self._changed_at is not None
                              and mono_now - self._changed_at < self.ttl)
                if wall_live and not stale_mono:
                    return False
                if not wall_live and fresh_mono:
                    # forward wall jump: heartbeats are visibly landing
                    return False
            prev = int(doc.get("token", 0)) if doc else 0
            self.token = prev + 1
            self._write({"owner": self.owner, "token": self.token,
                         "expires": now + self.ttl})
            return True

    def renew(self) -> None:
        """Heartbeat: extend the expiry — but first verify we still hold
        the lease. Raises :class:`LeaseLost` when the file shows another
        owner or a different token (we were superseded while wedged)."""
        try:
            faults.inject("train.lease.lost")
        except faults.FaultError as e:
            raise LeaseLost(str(e)) from e
        if self.token is None:
            raise LeaseLost("renew() before acquire()")
        with self._locked():
            doc = self._read()
            if (doc is None or doc.get("owner") != self.owner
                    or int(doc.get("token", -1)) != self.token):
                raise LeaseLost(
                    f"lease superseded (file shows "
                    f"{doc.get('owner') if doc else None!r} "
                    f"token {doc.get('token') if doc else None})")
            # the beat makes every renewal change the document bytes,
            # so contenders' monotonic fingerprints see a live holder
            # even when a backward wall jump leaves ``expires`` equal
            doc["expires"] = self._clock() + self.ttl
            doc["beat"] = int(doc.get("beat", 0)) + 1
            self._write(doc)

    def release(self) -> None:
        """Graceful handoff: zero the expiry so a successor acquires
        instantly, but KEEP the token so the successor still fences us
        out. A no-op if we no longer hold the lease."""
        if self.token is None:
            return
        try:
            with self._locked():
                doc = self._read()
                if (doc is not None and doc.get("owner") == self.owner
                        and int(doc.get("token", -1)) == self.token):
                    doc["expires"] = 0
                    self._write(doc)
        finally:
            self.token = None


# -- serving-metrics parsing (bake window) -------------------------------------

_PROM_LINE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+([0-9.eE+-]+|NaN|[+-]?Inf)\s*$")


def _parse_prom(text: str) -> Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float]:
    """Prometheus text format → {(name, sorted label tuple): value}."""
    out: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _PROM_LINE.match(line)
        if not m:
            continue
        name, labels_raw, value = m.group(1), m.group(2), m.group(3)
        labels: List[Tuple[str, str]] = []
        if labels_raw:
            for part in re.findall(r'(\w+)="((?:[^"\\]|\\.)*)"', labels_raw):
                labels.append((part[0], part[1]))
        try:
            out[(name, tuple(sorted(labels)))] = float(value)
        except ValueError:
            continue
    return out


def _query_stats(snap: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float],
                 ) -> Tuple[float, float, Dict[float, float]]:
    """(total queries, 5xx queries, {le: cumulative bucket count}) from
    one scrape of an engine server's ``/metrics``."""
    total = err = 0.0
    buckets: Dict[float, float] = {}
    for (name, labels), value in snap.items():
        ld = dict(labels)
        if name == "pio_engine_queries_total":
            total += value
            if ld.get("status", "").startswith("5"):
                err += value
        elif name == "pio_engine_query_seconds_bucket":
            le = ld.get("le", "")
            bound = math.inf if le in ("+Inf", "Inf") else float(le)
            buckets[bound] = buckets.get(bound, 0.0) + value
    return total, err, buckets


def _p95_from_delta(before: Dict[float, float],
                    after: Dict[float, float]) -> Optional[float]:
    """p95 latency over the window, from cumulative-histogram deltas."""
    deltas = sorted((le, max(0.0, after.get(le, 0.0) - before.get(le, 0.0)))
                    for le in after)
    if not deltas:
        return None
    total = deltas[-1][1]  # +Inf bucket is cumulative over all
    if total <= 0:
        return None
    want = 0.95 * total
    for le, cum in deltas:
        if cum >= want:
            return le if le != math.inf else deltas[-2][0] if len(deltas) > 1 else None
    return None


# -- trainer configuration -----------------------------------------------------


@dataclass
class TrainerConfig:
    """Everything the continuous trainer needs to run one loop."""

    engine_factory: str
    app_name: str
    variant: Dict[str, Any] = field(default_factory=dict)
    variant_id: str = ""
    channel: Optional[str] = None
    #: wake threshold: train only when this many new events arrived
    min_delta_events: int = 1
    #: seconds between watermark polls when idle
    poll_interval: float = 5.0
    #: lease TTL; heartbeats renew at ttl/3
    lease_ttl: float = 30.0
    lease_path: Optional[str] = None
    #: generations kept by the registry beyond the champion
    retain: int = 5
    #: guardrail: newest-N held-out feedback events to score against
    guardrail_holdout: int = 200
    #: guardrail: refuse candidates whose RMSE is worse than champion
    #: by more than this fraction
    guardrail_max_regress: float = 0.10
    #: guardrail: below this many scoreable pairs, pass trivially
    guardrail_min_events: int = 10
    #: promotion gate mode: ``offline`` (held-out RMSE, the default),
    #: ``online`` (the challenger's accrued LIVE metrics scraped from
    #: the fleet's ``pio_variant_online_rmse`` series), ``both``, or
    #: ``eval`` (consult the latest persisted `pio eval` sweep
    #: leaderboard and refuse candidates it ranked below the champion)
    gate: str = "offline"
    #: eval gate: leaderboards older than this many seconds are stale
    #: and the gate passes trivially (0 = never stale)
    eval_leaderboard_max_age: float = 0.0
    #: online gate: the variant names of the incumbent and the arm
    #: whose accrued live RMSE is being judged
    online_champion: str = "champion"
    online_challenger: str = "challenger"
    #: online gate: below this many rated pairs accrued fleet-wide,
    #: pass trivially (not enough live evidence to refuse on)
    online_min_pairs: int = 20
    #: online gate: refuse when the challenger's accrued online RMSE is
    #: worse than the champion's by more than this fraction
    #: (None = reuse guardrail_max_regress)
    online_max_regress: Optional[float] = None
    #: bake window length; 0 disables live-metrics bake
    bake_seconds: float = 0.0
    #: bake: roll back when the 5xx fraction over the window exceeds this
    bake_error_rate: float = 0.01
    #: bake: roll back when window p95 exceeds baseline p95 by this factor
    bake_p95_ratio: float = 2.0
    #: engine-server base URLs to /reload and scrape (direct mode)
    reload_urls: List[str] = field(default_factory=list)
    #: fleet-router base URL: reload goes through POST /router/reload?rolling=1
    router_url: Optional[str] = None
    #: fleet manifest path: replica URLs parsed for reload + bake scraping
    fleet_manifest: Optional[str] = None
    #: train over the device mesh of the variant's meshConf (train
    #: --continuous without --no-mesh), as run_train's use_mesh
    use_mesh: bool = False
    #: the torch device the delta train and the guardrail's scoring run
    #: on: CUDA unless ``"cpu"``; raises when that is CUDA and no card
    device: Optional[str] = None
    #: print the workflow's phases and one ``[trainer]`` line a cycle
    verbose: int = 0
    http_timeout: float = 10.0
    #: observability listener: None disables; an int (0 = ephemeral)
    #: serves /metrics, /metrics/history and /health in a daemon thread
    #: so the router can federate the trainer like a replica
    metrics_port: Optional[int] = None
    #: incident flight recorder: None disables, ``"auto"`` derives
    #: ``<home>/incidents``, anything else is an explicit directory
    incident_dir: Optional[str] = None


# -- the trainer ---------------------------------------------------------------


class ContinuousTrainer:
    """The supervised delta-train → gate → promote → bake loop.

    All effectful dependencies are injectable (``clock``, ``sleep``,
    ``train_fn``, ``http`` fetcher) so that a test can drive one
    full wake cycle with a fake clock, a stub trainer, and no sockets.
    """

    def __init__(self, cfg: TrainerConfig,
                 storage: Optional[Storage] = None,
                 clock: Callable[[], float] = time.time,
                 sleep: Callable[[float], None] = time.sleep,
                 train_fn: Optional[Callable[..., str]] = None,
                 http: Optional[Callable[[str, str], str]] = None) -> None:
        self.cfg = cfg
        self.storage = storage or get_storage()
        self.clock = clock
        self.sleep = sleep
        self._train_fn = train_fn
        self._http = http or self._urllib_http
        self._stopping = False
        home = self.storage.config.home
        self.registry: ModelRegistry = model_registry(
            self.storage, retain=cfg.retain)
        # the uuid suffix makes the owner unique per trainer OBJECT, not
        # just per process: a successor on the same host/pid (or a second
        # trainer constructed in-process) must go through the normal
        # expiry + fencing path, never silently reclaim
        owner = f"{os.uname().nodename}:{os.getpid()}:{uuid.uuid4().hex[:8]}"
        self.lease = TrainerLease(
            cfg.lease_path or os.path.join(home, "trainer.lease"),
            owner=owner, ttl=cfg.lease_ttl, clock=clock, sleep=sleep)
        self.state_path = os.path.join(home, "trainer.state.json")
        #: walls of the last cycle's steps (``run_once``)
        self.timings: Dict[str, float] = {}
        self._app_id: Optional[int] = None
        self._channel_id: Optional[int] = None
        self.tsdb = None
        self._listener = None
        self._listener_loop = None
        self._listener_thread: Optional[threading.Thread] = None
        if cfg.metrics_port is not None:
            from predictionio_tpu_torch.utils.timeseries import (
                TimeSeriesStore,
                scaled_tiers,
            )
            self.tsdb = TimeSeriesStore(
                REGISTRY, tiers=scaled_tiers(10.0), clock=clock)
        self.incidents = None
        if cfg.incident_dir:
            from predictionio_tpu_torch.utils.incidents import (
                IncidentCapturer,
                IncidentStore,
                default_incident_dir,
            )
            root = (default_incident_dir(home)
                    if cfg.incident_dir == "auto" else cfg.incident_dir)
            self.incidents = IncidentCapturer(
                IncidentStore(root, clock=clock), process="trainer",
                clock=clock)
            self.incidents.add_source("trainer", self._status_doc)
            if self.tsdb is not None:
                self.incidents.set_history(
                    self.tsdb, lambda: ["pio_trainer_cycles_total",
                                        "pio_trainer_lease_held",
                                        "pio_trainer_generation",
                                        "pio_trainer_bake_active"])

    # -- plumbing --------------------------------------------------------------

    def _urllib_http(self, method: str, url: str) -> str:
        req = urllib.request.Request(url, method=method)
        with urllib.request.urlopen(req, timeout=self.cfg.http_timeout) as r:
            return r.read().decode("utf-8", "replace")

    def _resolve_app(self) -> Tuple[int, Optional[int]]:
        if self._app_id is None:
            app = self.storage.meta.get_app_by_name(self.cfg.app_name)
            if app is None:
                raise ValueError(f"no app named {self.cfg.app_name!r}")
            self._app_id = app.id
            if self.cfg.channel:
                ch = self.storage.meta.get_channel_by_name(
                    app.id, self.cfg.channel)
                if ch is None:
                    raise ValueError(
                        f"no channel {self.cfg.channel!r} in app "
                        f"{self.cfg.app_name!r}")
                self._channel_id = ch.id
        return self._app_id, self._channel_id

    def _load_state(self) -> Dict[str, Any]:
        try:
            with open(self.state_path, "r", encoding="utf-8") as f:
                return json.load(f)
        except (FileNotFoundError, ValueError):
            return {"watermark_us": None, "count": 0}

    def _save_state(self, state: Dict[str, Any]) -> None:
        atomic_write_bytes(
            self.state_path,
            json.dumps(state, sort_keys=True).encode("utf-8"))

    def _delta(self) -> Tuple[int, Dict[str, Any]]:
        """(new events since the last completed cycle, current stats).
        A store that reads a log another process writes (``LogView``)
        is refreshed first, so each wake sees the appends since the last."""
        refresh = getattr(self.storage.events, "refresh", None)
        if refresh is not None:
            refresh()
        app_id, channel_id = self._resolve_app()
        state = self._load_state()
        stats = self.storage.events.creation_stats(app_id, channel_id)
        if stats is None:
            # backend can't answer cheaply (memory store): count via find
            count = sum(1 for _ in self.storage.events.find(app_id, channel_id))
            cur = {"watermark_us": None, "count": count}
            return max(0, count - int(state.get("count") or 0)), cur
        count, max_us = stats
        cur = {"watermark_us": max_us, "count": count}
        return max(0, count - int(state.get("count") or 0)), cur

    # -- training --------------------------------------------------------------

    def _train(self) -> str:
        """One delta train through the resumable checkpoint machinery."""
        if self._train_fn is not None:
            return self._train_fn(storage=self.storage)
        from predictionio_tpu_torch.core.workflow import run_train

        return run_train(
            self.cfg.engine_factory,
            variant=self.cfg.variant,
            storage=self.storage,
            verbose=self.cfg.verbose,
            device=self.cfg.device,
            resume=True,
            batch="continuous",
            use_mesh=self.cfg.use_mesh,
        )

    # -- guardrail -------------------------------------------------------------

    def _holdout(self) -> List[Tuple[str, str, float]]:
        """Newest held-out feedback as (user, item, rating) triplets."""
        app_id, channel_id = self._resolve_app()
        names = (self.cfg.variant.get("datasource", {})
                 .get("params", {}).get("event_names")) or ["rate", "buy"]
        buy_rating = float(self.cfg.variant.get("datasource", {})
                           .get("params", {}).get("buy_rating", 4.0))
        out: List[Tuple[str, str, float]] = []
        for ev in self.storage.events.find(
                app_id, channel_id, event_names=list(names),
                limit=self.cfg.guardrail_holdout, reversed=True):
            if ev.target_entity_id is None:
                continue
            if ev.event == "buy":
                rating = buy_rating
            else:
                try:
                    rating = float(ev.properties.get("rating", math.nan))
                except (TypeError, ValueError):
                    continue
            if math.isnan(rating):
                continue
            out.append((ev.entity_id, ev.target_entity_id, rating))
        return out

    def _rmse(self, instance_id: str, pairs: List[Tuple[str, str, float]],
              ) -> Tuple[Optional[float], int]:
        """Rating-prediction RMSE of one instance on the holdout, via the
        same query path serving uses (None = nothing scoreable), and the
        number of queries that raised. The instance is materialised on
        ``cfg.device``; a rating query is the template's
        ``predict_rating``, a dot product of two factor rows on the host."""
        from predictionio_tpu_torch.core.workflow import prepare_deploy
        from predictionio_tpu_torch.utils.device import resolve_device

        # a missing card raises here, before the try: it is no instance
        # this process cannot materialize
        device = resolve_device(self.cfg.device)
        try:
            deployed = prepare_deploy(instance_id=instance_id,
                                      storage=self.storage, device=device)
        except (ValueError, LookupError, ImportError, AttributeError,
                pickle.UnpicklingError, IntegrityError):
            # an instance this process cannot materialize (unresolvable
            # factory, missing or damaged blob) is unscoreable, not a hard
            # error — the guardrail treats None as "pass" and the bake
            # window remains the online line of defense
            return None, 0
        se = n = failed = 0
        for user, item, rating in pairs:
            try:
                res = deployed.query({"user": user, "item": item})
                scores = res.get("itemScores") or []
                if not scores:
                    continue
                se += (float(scores[0]["score"]) - rating) ** 2
                n += 1
            except Exception:
                failed += 1
                continue
        return (math.sqrt(se / n) if n else None), failed

    def _guardrail(self, candidate_id: str) -> Tuple[bool, Dict[str, Any]]:
        """Champion-vs-candidate offline gate. True = promote."""
        detail: Dict[str, Any] = {"champion_rmse": None,
                                  "candidate_rmse": None, "pairs": 0}
        regressed = False
        try:
            faults.inject("promote.regression")
        except faults.FaultError:
            regressed = True
        champ = self.registry.champion()
        pairs = self._holdout()
        detail["pairs"] = len(pairs)
        if regressed:
            detail["candidate_rmse"] = math.inf
            detail["reason"] = "injected regression"
            # an injected regression must be caught even on the first
            # generation / an empty holdout
            return False, detail
        if champ is None:
            detail["reason"] = "no champion: first generation promotes"
            return True, detail
        if len(pairs) < self.cfg.guardrail_min_events:
            detail["reason"] = (f"only {len(pairs)} holdout pairs "
                                f"(< {self.cfg.guardrail_min_events}): pass")
            return True, detail
        champ_rmse, _ = self._rmse(champ["instance_id"], pairs)
        cand_rmse, failed = self._rmse(candidate_id, pairs)
        detail["champion_rmse"] = champ_rmse
        detail["candidate_rmse"] = cand_rmse
        if cand_rmse is None and failed:
            # a candidate that materialises but fails every query it is
            # asked is no unscoreable pass (the JAX package promotes it)
            detail["reason"] = (f"all {failed} scoring queries of the "
                                "candidate failed")
            return False, detail
        if champ_rmse is None or cand_rmse is None:
            detail["reason"] = "unscoreable: pass"
            return True, detail
        limit = champ_rmse * (1.0 + self.cfg.guardrail_max_regress) + 1e-9
        if cand_rmse <= limit:
            detail["reason"] = f"rmse {cand_rmse:.4f} <= limit {limit:.4f}"
            return True, detail
        detail["reason"] = f"rmse {cand_rmse:.4f} > limit {limit:.4f}"
        return False, detail

    def _online_stats(self) -> Dict[str, Tuple[float, float]]:
        """Per-variant accrued ONLINE rating scores scraped from the
        fleet: {variant: (combined rmse, rated pairs)}. Replicas are
        combined pairs-weighted (sum of squared errors recomposed from
        each replica's rmse × pair count), so a replica that served
        10× the traffic counts 10× in the verdict."""
        per_replica: Dict[str, List[Tuple[float, float]]] = {}
        for u in self._replica_urls():
            try:
                snap = _parse_prom(self._http("GET", u + "/metrics"))
            except Exception:
                continue
            rmse: Dict[str, float] = {}
            pairs: Dict[str, float] = {}
            for (name, labels), value in snap.items():
                ld = dict(labels)
                v = ld.get("variant")
                if not v:
                    continue
                if name == "pio_variant_online_rmse":
                    rmse[v] = value
                elif (name == "pio_variant_feedback_total"
                      and ld.get("kind") == "rating"):
                    pairs[v] = pairs.get(v, 0.0) + value
            for v, r in rmse.items():
                per_replica.setdefault(v, []).append(
                    (r, pairs.get(v, 0.0)))
        out: Dict[str, Tuple[float, float]] = {}
        for v, obs in per_replica.items():
            n = sum(p for _, p in obs)
            if n <= 0:
                continue
            sq = sum(p * r * r for r, p in obs)
            out[v] = (math.sqrt(sq / n), n)
        return out

    def _guardrail_online(self, candidate_id: str,
                          ) -> Tuple[bool, Dict[str, Any]]:
        """Online champion-vs-challenger gate (``--gate online``): the
        verdict comes from the CHALLENGER arm's accrued live RMSE
        (``pio_variant_online_rmse``, fed by real feedback against real
        traffic — server/variant_metrics.py) instead of an offline
        held-out replay. Trivial pass when the fleet has not accrued
        enough rated pairs, or when no champion baseline exists —
        exactly mirroring the offline gate's unscoreable semantics."""
        detail: Dict[str, Any] = {
            "mode": "online", "candidate": candidate_id,
            "champion_rmse": None, "challenger_rmse": None, "pairs": 0}
        regressed = False
        try:
            faults.inject("promote.regression")
        except faults.FaultError:
            regressed = True
        if regressed:
            detail["challenger_rmse"] = math.inf
            detail["reason"] = "injected regression"
            return False, detail
        stats = self._online_stats()
        chal = stats.get(self.cfg.online_challenger)
        champ = stats.get(self.cfg.online_champion)
        if champ is not None:
            detail["champion_rmse"] = champ[0]
        if chal is not None:
            detail["challenger_rmse"] = chal[0]
            detail["pairs"] = chal[1]
        if chal is None or chal[1] < self.cfg.online_min_pairs:
            detail["reason"] = (
                f"only {chal[1] if chal else 0:.0f} online rated pairs "
                f"(< {self.cfg.online_min_pairs}): pass")
            return True, detail
        if champ is None:
            detail["reason"] = "no champion online baseline: pass"
            return True, detail
        regress = (self.cfg.online_max_regress
                   if self.cfg.online_max_regress is not None
                   else self.cfg.guardrail_max_regress)
        limit = champ[0] * (1.0 + regress) + 1e-9
        if chal[0] <= limit:
            detail["reason"] = (f"online rmse {chal[0]:.4f} <= "
                                f"limit {limit:.4f}")
            return True, detail
        detail["reason"] = (f"online rmse {chal[0]:.4f} > "
                            f"limit {limit:.4f}")
        return False, detail

    def _algo_params_of(self, instance_id: str) -> Optional[Any]:
        ei = self.storage.meta.get_engine_instance(instance_id)
        if ei is None or not ei.algorithms_params:
            return None
        try:
            return json.loads(ei.algorithms_params)
        except (TypeError, ValueError):
            return None

    def _guardrail_eval(self, candidate_id: str) -> Tuple[bool, Dict[str, Any]]:
        """Sweep-leaderboard gate (``--gate eval``): the verdict comes
        from the latest persisted `pio eval` leaderboard
        (storage/leaderboard.py) instead of a fresh replay — the sweep
        already scored the whole grid, so promotion just looks the
        candidate's hyperparameters up. Refuses when the fresh sweep
        ranked the candidate's params below the current champion's.
        Trivial pass mirrors the other gates' unscoreable semantics:
        no leaderboard, a stale one (``eval_leaderboard_max_age``), or
        params the grid never swept."""
        from predictionio_tpu_torch.storage import leaderboard as lb

        detail: Dict[str, Any] = {
            "mode": "eval", "candidate": candidate_id,
            "candidate_rank": None, "champion_rank": None,
            "leaderboard": None}
        regressed = False
        try:
            faults.inject("promote.regression")
        except faults.FaultError:
            regressed = True
        if regressed:
            detail["reason"] = "injected regression"
            return False, detail
        doc = lb.latest(self.storage.config.home)
        if doc is None:
            detail["reason"] = "no sweep leaderboard: pass"
            return True, detail
        detail["leaderboard"] = {
            "instanceId": doc.get("instanceId"),
            "metric": doc.get("metric"),
            "digest": lb.digest(doc),
        }
        max_age = self.cfg.eval_leaderboard_max_age
        if max_age > 0:
            age = self.clock() - float(doc.get("createdAt") or 0.0)
            detail["leaderboard"]["age"] = age
            if age > max_age:
                detail["reason"] = (f"leaderboard {age:.0f}s old "
                                    f"(> {max_age:.0f}s): stale, pass")
                return True, detail
        cand_params = self._algo_params_of(candidate_id)
        if cand_params is None:
            detail["reason"] = "candidate params unavailable: pass"
            return True, detail
        cand_rank = lb.candidate_rank_for(doc, cand_params)
        detail["candidate_rank"] = cand_rank
        if cand_rank is None:
            detail["reason"] = "candidate params not in swept grid: pass"
            return True, detail
        champ = self.registry.champion()
        if champ is None:
            detail["reason"] = "no champion: first generation promotes"
            return True, detail
        champ_params = self._algo_params_of(champ["instance_id"])
        champ_rank = (lb.candidate_rank_for(doc, champ_params)
                      if champ_params is not None else None)
        detail["champion_rank"] = champ_rank
        if champ_rank is None:
            detail["reason"] = "champion params not in swept grid: pass"
            return True, detail
        if cand_rank <= champ_rank:
            detail["reason"] = (f"sweep rank {cand_rank} <= champion "
                                f"rank {champ_rank}")
            return True, detail
        detail["reason"] = (f"sweep rank {cand_rank} > champion "
                            f"rank {champ_rank}")
        return False, detail

    def _gate(self, candidate_id: str) -> Tuple[bool, Dict[str, Any]]:
        """The promotion gate: offline held-out guardrail (default),
        the online live-metrics gate, the sweep-leaderboard gate
        (``eval``), or both offline+online (both must pass)."""
        mode = (self.cfg.gate or "offline").lower()
        if mode == "eval":
            return self._guardrail_eval(candidate_id)
        if mode == "online":
            return self._guardrail_online(candidate_id)
        if mode == "both":
            ok_off, off = self._guardrail(candidate_id)
            ok_on, on = self._guardrail_online(candidate_id)
            return ok_off and ok_on, {"mode": "both",
                                      "offline": off, "online": on}
        return self._guardrail(candidate_id)

    # -- reload push + bake ----------------------------------------------------

    def _replica_urls(self) -> List[str]:
        urls = list(self.cfg.reload_urls)
        if self.cfg.fleet_manifest:
            try:
                with open(self.cfg.fleet_manifest, "r", encoding="utf-8") as f:
                    doc = json.load(f)
                for rep in doc.get("replicas", []):
                    u = rep.get("url") if isinstance(rep, dict) else rep
                    if u:
                        urls.append(str(u).rstrip("/"))
            except (OSError, ValueError):
                pass
        return list(dict.fromkeys(u.rstrip("/") for u in urls))

    def _push_reload(self) -> bool:
        """Tell the fleet to swap onto the current champion. Rolling via
        the router when configured; direct ``/reload`` otherwise. True
        when every push succeeded."""
        ok = True
        if self.cfg.router_url:
            try:
                self._http("POST", self.cfg.router_url.rstrip("/")
                           + "/router/reload?rolling=1")
            except Exception:
                ok = False
        else:
            for u in self._replica_urls():
                try:
                    self._http("GET", u + "/reload")
                except Exception:
                    ok = False
        return ok

    def _scrape(self) -> Tuple[float, float, Dict[float, float]]:
        """Aggregate (queries, 5xx, latency buckets) across the fleet."""
        total = err = 0.0
        buckets: Dict[float, float] = {}
        for u in self._replica_urls():
            try:
                t, e, b = _query_stats(_parse_prom(
                    self._http("GET", u + "/metrics")))
            except Exception:
                continue
            total += t
            err += e
            for le, c in b.items():
                buckets[le] = buckets.get(le, 0.0) + c
        return total, err, buckets

    def _bake(self, baseline: Tuple[float, float, Dict[float, float]],
              ) -> Tuple[bool, Dict[str, Any]]:
        """Watch live metrics for the bake window. True = keep."""
        detail: Dict[str, Any] = {"window_queries": 0.0,
                                  "error_rate": 0.0, "p95": None}
        if self.cfg.bake_seconds <= 0 or not self._replica_urls():
            detail["reason"] = "bake disabled"
            return True, detail
        t0, e0, b0 = baseline
        # pre-bake p95 over the metrics' whole history, as the reference
        pre_p95 = _p95_from_delta({}, b0)
        deadline = self.clock() + self.cfg.bake_seconds
        step = max(0.2, min(2.0, self.cfg.bake_seconds / 5.0))
        while self.clock() < deadline and not self._stopping:
            self.sleep(step)
        t1, e1, b1 = self._scrape()
        dq = max(0.0, t1 - t0)
        de = max(0.0, e1 - e0)
        detail["window_queries"] = dq
        if dq > 0:
            rate = de / dq
            detail["error_rate"] = rate
            if rate > self.cfg.bake_error_rate:
                detail["reason"] = (f"error rate {rate:.4f} > "
                                    f"{self.cfg.bake_error_rate}")
                return False, detail
        p95 = _p95_from_delta(b0, b1)
        detail["p95"] = p95
        detail["baseline_p95"] = pre_p95
        if (p95 is not None and pre_p95 is not None and pre_p95 > 0
                and p95 > pre_p95 * self.cfg.bake_p95_ratio):
            detail["reason"] = (f"p95 {p95} > {self.cfg.bake_p95_ratio}x "
                                f"baseline {pre_p95}")
            return False, detail
        detail["reason"] = "healthy"
        return True, detail

    # -- one cycle -------------------------------------------------------------

    def run_once(self) -> Dict[str, Any]:
        """One wake cycle. Returns an outcome record::

            {"outcome": "idle" | "lease-held" | "promoted" | "refused"
                        | "rolled_back" | "reload-failed",
             "generation": int | None, "detail": {...}}

        Raises :class:`LeaseLost` when superseded mid-cycle (the caller
        — ``run`` or the supervisor — decides whether to re-acquire) and
        propagates training errors (the supervisor restarts us; the
        checkpoint directory carries the resume point).
        The walls of its steps land in ``self.timings`` (seconds on the
        host clock: ``train``, ``gate``, ``promote`` for every registry
        write, ``reload`` for the pushes).
        """
        self.timings = {}
        if self.lease.token is None:
            if not self.lease.acquire():
                return {"outcome": "lease-held", "generation": None,
                        "detail": {"path": self.lease.path}}
        else:
            self.lease.renew()

        delta, cur = self._delta()
        if delta < self.cfg.min_delta_events:
            return {"outcome": "idle", "generation": None,
                    "detail": {"delta": delta,
                               "need": self.cfg.min_delta_events}}

        # mid-delta-train crash site: an armed error here kills the
        # process the way kill -9 would — AFTER the wake decision,
        # BEFORE the model publishes. The supervisor restarts us and
        # run_train(resume=True) picks up the checkpoint.
        faults.inject("train.crash")

        t0 = time.perf_counter()
        instance_id = self._train()
        self.timings["train"] = time.perf_counter() - t0

        # the fence, part 1: prove we still hold the lease before any
        # registry write — a wedged trainer whose lease expired during
        # the (long) train must not publish
        self.lease.renew()

        t0 = time.perf_counter()
        blob = self.storage.models.get(instance_id)
        if blob is None:
            raise RuntimeError(f"trained instance {instance_id} has no blob")
        # the fence, part 2: the registry refuses stale tokens even if
        # the renew above raced a successor
        gen = self.registry.register(
            instance_id, blob, token=self.lease.token,
            created_us=int(self.clock() * 1_000_000))
        _m_generation.set(float(gen))
        # candidate is SHELVED in meta until judged: a concurrent
        # /reload keeps serving the champion
        self.registry.sync_meta(self.storage.meta)
        self.timings["promote"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        promote, gate = self._gate(instance_id)
        self.timings["gate"] = time.perf_counter() - t0
        if not promote:
            self.registry.mark(gen, "refused", token=self.lease.token)
            self.registry.sync_meta(self.storage.meta)
            self._save_state(cur)
            return {"outcome": "refused", "generation": gen, "detail": gate}

        baseline = (self._scrape() if self.cfg.bake_seconds > 0
                    else (0.0, 0.0, {}))
        t0 = time.perf_counter()
        self.lease.renew()
        self.registry.promote(gen, token=self.lease.token,
                              now_us=int(self.clock() * 1_000_000))
        self.registry.sync_meta(self.storage.meta)
        self.timings["promote"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        pushed = self._push_reload()
        self.timings["reload"] = time.perf_counter() - t0
        self._save_state(cur)

        _m_bake_active.set(1.0)
        try:
            keep, bake = self._bake(baseline)
        finally:
            _m_bake_active.set(0.0)
        if not keep:
            self.lease.renew()
            restored = self.registry.rollback(token=self.lease.token)
            self.registry.sync_meta(self.storage.meta)
            self._push_reload()
            return {"outcome": "rolled_back", "generation": gen,
                    "detail": {"gate": gate, "bake": bake,
                               "restored": restored["gen"]}}
        if not pushed:
            return {"outcome": "reload-failed", "generation": gen,
                    "detail": {"gate": gate}}
        return {"outcome": "promoted", "generation": gen,
                "detail": {"gate": gate, "bake": bake}}

    def _log_cycle(self, n: int, rec: Dict[str, Any]) -> None:
        """The ``[trainer]`` line of one cycle, and its gate's verdict
        when it has one (``cfg.verbose``)."""
        from predictionio_tpu_torch import ops

        walls = " ".join(f"{k}={v:.3f}s" for k, v in self.timings.items())
        launches = ", ".join(f"{c.__name__}={c.launches}"
                             for c in ops.LAUNCH_COUNTERS)
        print(f"[trainer] cycle {n}: {rec['outcome']} "
              f"gen={rec['generation']} {walls} "
              f"(kernel launches: {launches})", flush=True)
        detail = rec.get("detail") or {}
        gate = detail.get("gate", detail if rec["outcome"] == "refused" else None)
        if gate:
            print(f"[trainer] gate: {json.dumps(gate, sort_keys=True, default=str)}",
                  flush=True)

    # -- observability listener ------------------------------------------------

    def _status_doc(self) -> Dict[str, Any]:
        """Sync snapshot for incident bundles (runs off-loop)."""
        return {
            "instance": self.lease.owner,
            "app": self.cfg.app_name,
            "engineFactory": self.cfg.engine_factory,
            "leaseHeld": self.lease.token is not None,
            "leaseToken": self.lease.token,
            "bakeSeconds": self.cfg.bake_seconds,
            "state": self._load_state(),
        }

    @property
    def metrics_bound_port(self) -> Optional[int]:
        """Actual listener port (use with ``metrics_port=0`` in tests)."""
        if self._listener is None:
            return None
        return self._listener.bound_port

    def _start_listener(self) -> None:
        """The tiny /metrics + /metrics/history + /health listener, in a
        daemon thread with its own event loop: the trainer is a sync
        process, but federation speaks HTTP. Routes only observability —
        there is nothing to proxy to a trainer."""
        import asyncio

        from predictionio_tpu_torch.server.http import HTTPServer, Response, Router
        from predictionio_tpu_torch.utils.timeseries import (
            history_payload,
            scrape_loop,
        )

        tsdb = self.tsdb
        assert tsdb is not None

        async def metrics(req):
            return Response.text(
                REGISTRY.render(),
                content_type="text/plain; version=0.0.4; charset=utf-8")

        async def history(req):
            status, payload = history_payload(
                tsdb, req.param("series", ""), req.param("window", ""))
            return Response.json(payload, status=status)

        async def health(req):
            return Response.json({"status": "ok", "role": "trainer",
                                  "instance": self.lease.owner,
                                  "leaseHeld": self.lease.token is not None})

        router = Router()
        router.route("GET", "/metrics", metrics)
        router.route("GET", "/metrics/history", history)
        router.route("GET", "/health", health)
        srv = HTTPServer(router, host="0.0.0.0",
                         port=int(self.cfg.metrics_port or 0),
                         server_name="trainer-metrics")
        started = threading.Event()

        def _serve() -> None:
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            self._listener_loop = loop

            async def main() -> None:
                await srv.start()
                started.set()
                scraper = asyncio.get_running_loop().create_task(
                    scrape_loop(tsdb, 10.0))
                try:
                    await srv._shutdown.wait()
                finally:
                    scraper.cancel()
                    await srv.stop()

            try:
                loop.run_until_complete(main())
            finally:
                loop.close()

        self._listener = srv
        t = threading.Thread(target=_serve, name="trainer-metrics",
                             daemon=True)
        t.start()
        self._listener_thread = t
        if not started.wait(5.0):
            raise RuntimeError("trainer metrics listener failed to start")

    def _stop_listener(self) -> None:
        srv, loop = self._listener, self._listener_loop
        if srv is None or loop is None:
            return
        try:
            loop.call_soon_threadsafe(srv.request_shutdown)
        except RuntimeError:
            pass  # loop already closed
        if self._listener_thread is not None:
            self._listener_thread.join(timeout=5.0)
        self._listener = None
        self._listener_loop = None
        self._listener_thread = None

    # -- the loop --------------------------------------------------------------

    def stop(self, *_args: Any) -> None:
        self._stopping = True

    def run(self, max_cycles: Optional[int] = None,
            install_signals: bool = True) -> List[Dict[str, Any]]:
        """The supervised loop: wake → cycle → heartbeat-paced sleep.

        SIGTERM/SIGINT set the stop flag; the loop finishes the current
        cycle, releases the lease (token kept — see
        :meth:`TrainerLease.release`) and returns, exiting 0 so the
        supervisor treats it as a finished job. Crashes propagate
        WITHOUT releasing: the lease expires (or is superseded) and the
        fencing token does the rest.
        """
        if install_signals:
            signal.signal(signal.SIGTERM, self.stop)
            signal.signal(signal.SIGINT, self.stop)
        if self.incidents is not None:
            from predictionio_tpu_torch.utils.incidents import install_crash_handlers
            install_crash_handlers(self.incidents,
                                   install_signals=install_signals)
        if self.tsdb is not None and self._listener is None:
            self._start_listener()
        outcomes: List[Dict[str, Any]] = []
        cycles = 0
        while not self._stopping:
            try:
                rec = self.run_once()
            except LeaseLost:
                # drop our claim; next iteration re-acquires (and is
                # fenced out if a successor is live)
                self.lease.token = None
                rec = {"outcome": "lease-lost", "generation": None,
                       "detail": {}}
            _m_cycles.inc((rec["outcome"],))
            if self.cfg.verbose:
                self._log_cycle(cycles + 1, rec)
            _m_lease_held.set(1.0 if self.lease.token is not None else 0.0)
            if rec["outcome"] == "rolled_back" and self.incidents is not None:
                self.incidents.trigger(
                    "bake-rollback", {"generation": rec.get("generation"),
                                      "detail": rec.get("detail")})
            outcomes.append(rec)
            cycles += 1
            if max_cycles is not None and cycles >= max_cycles:
                break
            pause = (self.cfg.poll_interval
                     if rec["outcome"] in ("idle", "lease-held",
                                           "lease-lost")
                     else 0.0)
            # heartbeat-paced: never sleep past a renewal deadline
            pause = min(pause, self.cfg.lease_ttl / 3.0) if pause else 0.0
            deadline = self.clock() + pause
            while not self._stopping and self.clock() < deadline:
                self.sleep(min(0.2, self.cfg.poll_interval))
            if self.lease.token is not None and not self._stopping:
                try:
                    self.lease.renew()
                except LeaseLost:
                    self.lease.token = None
        # graceful exit only (stop flag or max_cycles): release zeroes
        # the expiry so the next trainer starts instantly — no TTL dead
        # window. A crash skips this on purpose: the lease expires (or
        # is superseded) and the fencing token refuses any late write.
        self.lease.release()
        _m_lease_held.set(0.0)
        self._stop_listener()
        if self.incidents is not None:
            self.incidents.join(2.0)
        return outcomes
