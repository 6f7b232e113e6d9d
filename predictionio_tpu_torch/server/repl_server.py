"""Event-plane replication server: the port's copy of the JAX package's
``server/repl_server.py`` (election, wire protocol, failover).

It is the HTTP and process half of
:mod:`predictionio_tpu_torch.data.replication`, which holds the
byte-level WAL shipping and fencing:

- :class:`ReplNode`: the per-process coordinator an
  :class:`~predictionio_tpu_torch.server.event_server.EventServer`
  carries when started with ``--lease-home``. Roles are emergent: every
  node races :meth:`~predictionio_tpu_torch.server.trainer.TrainerLease.acquire`
  over the shared lease file (``<lease-home>/eventplane.lease``); the
  winner leads at epoch = its fencing token and pushes WAL batches to
  its ``--replicate-to`` peers, and everyone else follows and
  307-redirects client traffic to the lease's ``owner`` URL. A leader
  that loses the lease (the renew thread fails, the lease is
  superseded, or the armed ``replication.leader.partition`` fault)
  demotes to **fenced**: its storage hooks raise ``FencedWriteError``
  before any byte lands, and its HTTP surface sheds with 503.

- The ``/repl/*`` wire, the JAX package's: ``POST /repl/apply`` (one
  WAL batch; raw bytes and offset/crc/epoch headers), ``POST
  /repl/roll`` (active segment sealed; a digest-carrying manifest row),
  ``GET /repl/manifest`` and ``GET /repl/segment/{ns}/{file}``
  (sealed-segment catch-up, digest-verified by the follower), ``POST
  /repl/promote`` (operator-forced takeover), ``GET /repl/status``.
  Gap responses (409) carry the follower's true cursor so the leader
  resends from it; stale epochs are 412, torn batches 422. When
  ``PIO_REPL_SECRET`` is set, both sides require it in ``X-Repl-Token``
  (403 without it).

- :func:`run_failover_drill`, behind ``failover --drill``: two event
  servers of the port's CLI over temporary homes, serial acked ingest
  through the follower's redirect, ``kill -9`` of the leader mid-ingest,
  then the proofs: **zero** acked events missing on the promoted node,
  promotion under a second, a forged stale-epoch write refused,
  ``fsck`` clean on both homes, and exactly one incident bundle naming
  the failover.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Callable, Dict, List, Optional

from predictionio_tpu_torch.data.replication import (
    REPL_EPOCH,
    REPL_PROMOTIONS,
    REPL_STATE,
    STATE_FENCED,
    STATE_FOLLOWING,
    STATE_IDLE,
    STATE_LEADER,
    STATE_PROMOTING,
    FollowerLink,
    ReplicaHome,
    ReplicationError,
    Replicator,
    StaleEpochError,
    WalBatch,
    WalGapError,
    WalTornError,
)
from predictionio_tpu_torch.server.http import Request, Response
from predictionio_tpu_torch.server.trainer import LeaseLost, TrainerLease
from predictionio_tpu_torch.utils import faults

LEASE_NAME = "eventplane.lease"


def _repl_secret() -> Optional[str]:
    return os.environ.get("PIO_REPL_SECRET") or None


# -- wire client (leader → follower, and drill → anyone) -----------------------


class FollowerClient:
    """Leader-side HTTP client for one follower's ``/repl/*`` surface.

    Maps the wire's refusal statuses back onto the protocol exceptions
    :class:`~predictionio_tpu_torch.data.replication.Replicator` understands:
    409+cursor → :class:`WalGapError` (resend from the follower's true
    offset), 412 → :class:`StaleEpochError` (we are fenced), 422 →
    :class:`WalTornError` (resend the batch)."""

    def __init__(self, base_url: str, timeout: float = 5.0) -> None:
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def _request(self, method: str, path: str, body: bytes = b"",
                 headers: Optional[Dict[str, str]] = None) -> bytes:
        req = urllib.request.Request(
            self.base_url + path, data=body if method == "POST" else None,
            method=method)
        req.add_header("Content-Type", "application/octet-stream")
        secret = _repl_secret()
        if secret:
            req.add_header("X-Repl-Token", secret)
        for k, v in (headers or {}).items():
            req.add_header(k, v)
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return resp.read()

    def apply(self, batch: WalBatch) -> int:
        headers = {
            "X-Repl-Ns": batch.ns_tag,
            "X-Repl-Seg": str(batch.seg_id),
            "X-Repl-Offset": str(batch.offset),
            "X-Repl-Crc": str(batch.crc),
            "X-Repl-Epoch": str(batch.epoch),
            "X-Repl-Records": str(batch.records),
        }
        try:
            out = self._request("POST", "/repl/apply", batch.payload,
                                headers)
        except urllib.error.HTTPError as e:
            doc = self._error_doc(e)
            if e.code == 409 and doc.get("error") == "gap":
                raise WalGapError(doc.get("message", "gap"),
                                  int(doc.get("seg", 0)),
                                  int(doc.get("offset", 0))) from e
            if e.code == 412:
                raise StaleEpochError(doc.get("message", "stale epoch")) \
                    from e
            if e.code == 422:
                raise WalTornError(doc.get("message", "torn batch")) from e
            raise ReplicationError(
                f"follower {self.base_url} refused apply: HTTP {e.code} "
                f"{doc.get('message', '')}") from e
        return int(json.loads(out)["offset"])

    def seal(self, ns_tag: str, meta: Dict[str, Any], epoch: int) -> None:
        body = json.dumps({"ns": ns_tag, "meta": meta,
                           "epoch": epoch}).encode()
        try:
            self._request("POST", "/repl/roll", body)
        except urllib.error.HTTPError as e:
            doc = self._error_doc(e)
            if e.code == 412:
                raise StaleEpochError(doc.get("message", "stale epoch")) \
                    from e
            raise ReplicationError(
                f"follower {self.base_url} refused seal: HTTP {e.code} "
                f"{doc.get('message', '')}") from e

    def status(self) -> Dict[str, Any]:
        return json.loads(self._request("GET", "/repl/status"))

    def manifest(self) -> Dict[str, Any]:
        return json.loads(self._request("GET", "/repl/manifest"))

    def fetch_segment(self, ns_tag: str, file: str) -> Optional[bytes]:
        try:
            return self._request(
                "GET", f"/repl/segment/{urllib.parse.quote(ns_tag)}/"
                       f"{urllib.parse.quote(file)}")
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise

    def promote(self) -> Dict[str, Any]:
        return json.loads(self._request("POST", "/repl/promote", b"{}"))

    @staticmethod
    def _error_doc(e: urllib.error.HTTPError) -> Dict[str, Any]:
        try:
            return json.loads(e.read())
        except Exception:  # noqa: BLE001
            return {}


def link_for(url: str, timeout: float = 5.0) -> FollowerLink:
    c = FollowerClient(url, timeout=timeout)
    return FollowerLink(url, apply_fn=c.apply, seal_fn=c.seal,
                        status_fn=lambda: c.status().get("replica", {}))


# -- the per-process coordinator -----------------------------------------------


class ReplNode:
    """Election + role state machine one event server carries.

    Lifecycle: :meth:`attach` (mount routes, storage hooks) at server
    construction, :meth:`start` when serving begins (one election
    attempt decides leader vs follower; background threads keep the
    role honest), :meth:`stop` on shutdown (a graceful leader releases
    the lease so a follower takes over without waiting out the TTL).
    """

    def __init__(self, lease_home: str, advertise_url: str,
                 home: str, replicate_to: Optional[List[str]] = None,
                 lease_ttl: float = 2.0,
                 push_timeout: float = 5.0,
                 catchup_interval: float = 1.0) -> None:
        os.makedirs(lease_home, exist_ok=True)
        self.advertise_url = advertise_url.rstrip("/")
        self.home = home
        self.peers = [u.rstrip("/") for u in (replicate_to or [])
                      if u.rstrip("/") != self.advertise_url]
        self.lease_ttl = float(lease_ttl)
        self.push_timeout = push_timeout
        self.catchup_interval = catchup_interval
        self.lease = TrainerLease(os.path.join(lease_home, LEASE_NAME),
                                  owner=self.advertise_url, ttl=lease_ttl)
        self.replica = ReplicaHome(home)
        self.replicator: Optional[Replicator] = None
        self.role = "idle"
        self.epoch = 0
        self.promotion_ms: Optional[float] = None
        self.promoted_at: Optional[float] = None
        self._server = None         # EventServer, set by attach()
        self._store = None          # its events store
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._leader_url: Optional[str] = None

    # -- wiring ------------------------------------------------------------

    def attach(self, server: Any, router: Any) -> None:
        self._server = server
        self._store = server.storage.events
        router.route("POST", "/repl/apply", self._h_apply)
        router.route("POST", "/repl/roll", self._h_roll)
        router.route("GET", "/repl/manifest", self._h_manifest)
        router.route("GET", "/repl/segment/{ns}/{file}", self._h_segment)
        router.route("POST", "/repl/promote", self._h_promote)
        router.route("GET", "/repl/status", self._h_status)

    def start(self) -> None:
        """One election attempt decides the starting role; the losers
        follow. Runs the role's background thread."""
        if self.lease.acquire():
            self._become_leader(self.lease.token or 1)
        else:
            self._become_follower()

    def stop(self) -> None:
        self._stop.set()
        if self.role == "leader":
            # graceful handoff: zero the expiry so a follower promotes
            # immediately instead of waiting out the TTL
            try:
                self.lease.release()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=2.0)

    # -- role transitions --------------------------------------------------

    def _set_role(self, role: str, state: int) -> None:
        self.role = role
        REPL_STATE.set(state)

    def _become_leader(self, epoch: int) -> None:
        with self._lock:
            self.epoch = epoch
            self.replica.epoch = max(self.replica.epoch, epoch)
            REPL_EPOCH.set(epoch)
            links = [link_for(u, timeout=self.push_timeout)
                     for u in self.peers]
            self.replicator = Replicator(
                links, epoch=lambda: self.epoch,
                fenced=lambda: self.role == "fenced")
            if hasattr(self._store, "set_replicator"):
                self._store.set_replicator(self.replicator)
            self._set_role("leader", STATE_LEADER)
        t = threading.Thread(target=self._heartbeat_loop,
                             name="pio-repl-heartbeat", daemon=True)
        t.start()
        self._threads.append(t)

    def _become_follower(self) -> None:
        with self._lock:
            if hasattr(self._store, "set_replicator"):
                self._store.set_replicator(None)
            self.replicator = None
            self._set_role("follower", STATE_FOLLOWING)
        t = threading.Thread(target=self._watch_loop,
                             name="pio-repl-watch", daemon=True)
        t.start()
        self._threads.append(t)

    def demote(self, reason: str) -> None:
        """Leadership lost: fence THIS node's writes before anything
        else — a fenced leader can serve reads of what it has, but its
        append hooks refuse, so it can never corrupt the log it lost."""
        with self._lock:
            if self.role == "fenced":
                return
            self._set_role("fenced", STATE_FENCED)
        server = self._server
        if server is not None and getattr(server, "incidents", None):
            server.incidents.trigger("repl-demoted", {"reason": reason})

    def promote(self, reason: str) -> Dict[str, Any]:
        """Follower → leader: take the lease (bumping the fencing
        token), flip the role, and let the lazily-opening native store
        serve the replicated files — every applied batch ended on a
        frame boundary, so the engine opens them with nothing to
        repair. Captures the whole takeover as ONE incident bundle."""
        t0 = time.monotonic()
        with self._lock:
            if self.role == "leader":
                return self.status_doc()
            self._set_role("promoting", STATE_PROMOTING)
            if not self.lease.acquire():
                # current leader still heartbeating — an operator
                # promote must first partition/stop it
                self._set_role("follower", STATE_FOLLOWING)
                raise ReplicationError(
                    "cannot promote: the lease is still held by "
                    f"{self._leader_url or 'the current leader'}")
            epoch = self.lease.token or (self.replica.epoch + 1)
            self.epoch = epoch
            self.replica.epoch = max(self.replica.epoch, epoch)
            self.replica.leading = True
            self.replica._save_state()
            REPL_EPOCH.set(epoch)
            REPL_PROMOTIONS.inc()
            links = [link_for(u, timeout=self.push_timeout)
                     for u in self.peers]
            self.replicator = Replicator(
                links, epoch=lambda: self.epoch,
                fenced=lambda: self.role == "fenced")
            if hasattr(self._store, "set_replicator"):
                self._store.set_replicator(self.replicator)
            self._set_role("leader", STATE_LEADER)
            self.promotion_ms = (time.monotonic() - t0) * 1000.0
            self.promoted_at = time.time()
        t = threading.Thread(target=self._heartbeat_loop,
                             name="pio-repl-heartbeat", daemon=True)
        t.start()
        self._threads.append(t)
        server = self._server
        if server is not None and getattr(server, "incidents", None):
            server.incidents.trigger(
                "failover",
                {"reason": reason, "epoch": self.epoch,
                 "promotionMs": self.promotion_ms,
                 "replica": self.replica.status()},
                sync=True)
        return self.status_doc()

    # -- leader heartbeat --------------------------------------------------

    def _heartbeat_loop(self) -> None:
        interval = max(0.02, self.lease_ttl / 3.0)
        while not self._stop.wait(interval):
            if self.role != "leader":
                return
            try:
                # an armed replication.leader.partition plan simulates
                # losing the lease home: the renew never happens and
                # the node demotes exactly as if partitioned away
                faults.inject("replication.leader.partition")
                self.lease.renew()
            except (LeaseLost, faults.FaultError) as e:
                self.demote(f"lease lost: {e}")
                return
            except OSError as e:
                # lease home unreachable: keep trying until the TTL
                # would have expired, then assume we are partitioned
                doc = self.lease._read()
                if doc is None or float(doc.get("expires", 0)) < time.time():
                    self.demote(f"lease home unreachable: {e}")
                    return

    # -- follower watch + catch-up ----------------------------------------

    def _watch_loop(self) -> None:
        interval = max(0.02, self.lease_ttl / 5.0)
        last_catchup = 0.0
        while not self._stop.wait(interval):
            if self.role != "follower":
                return
            doc = self.lease._read()
            now = time.time()
            if doc is not None and float(doc.get("expires", 0)) > now:
                self._leader_url = str(doc.get("owner", "")) or None
                if now - last_catchup >= self.catchup_interval:
                    last_catchup = now
                    self._catch_up()
                continue
            # lease expired (or never existed): the leader is gone —
            # race to take over; a losing race just keeps following
            try:
                self.promote("lease expired" if doc is not None
                             else "no leader")
                return
            except ReplicationError:
                continue
            except OSError:
                continue

    def _catch_up(self) -> None:
        """Pull sealed segments the push stream missed (we joined
        late, or a tombstone re-seal changed a digest)."""
        url = self._leader_url
        if not url or url == self.advertise_url:
            return
        client = FollowerClient(url, timeout=self.push_timeout)
        try:
            doc = client.manifest()
        except Exception:  # noqa: BLE001 — leader may be mid-death
            return
        for tag, entry in doc.get("namespaces", {}).items():
            try:
                self.replica.sync_sealed(
                    tag, entry.get("manifest", {}),
                    client.fetch_segment, int(doc.get("epoch", 0)))
            except ReplicationError:
                continue
            except OSError:
                continue

    # -- the HTTP gate (called by every event-data handler) ----------------

    def gate(self, req: Request) -> Optional[Response]:
        """None when this node may serve event traffic; otherwise the
        shed/redirect response. Followers 307 to the lease owner so
        clients that follow redirects never hard-fail during a
        promotion window; fenced ex-leaders shed with 503."""
        role = self.role
        if role == "leader":
            return None
        if role == "fenced":
            resp = Response.json(
                {"message": "this node's event-plane leadership was "
                            "lost; retry against the current leader",
                 "retryAfterSec": 1.0}, status=503)
            resp.headers["Retry-After"] = "1"
            return resp
        leader = self._leader_url
        if leader and leader != self.advertise_url:
            target = leader + req.path
            if req.query:
                target += "?" + urllib.parse.urlencode(
                    req.query, doseq=True)
            resp = Response.json(
                {"message": f"this node is a follower; leader is "
                            f"{leader}"}, status=307)
            resp.headers["Location"] = target
            resp.headers["Retry-After"] = "1"
            return resp
        resp = Response.json(
            {"message": "no event-plane leader elected yet; retry",
             "retryAfterSec": 1.0}, status=503)
        resp.headers["Retry-After"] = "1"
        return resp

    # -- /repl/* handlers --------------------------------------------------

    def _check_token(self, req: Request) -> Optional[Response]:
        secret = _repl_secret()
        if secret and req.headers.get("x-repl-token") != secret:
            return Response.json({"message": "bad or missing "
                                             "X-Repl-Token"}, status=403)
        return None

    async def _h_apply(self, req: Request) -> Response:
        import asyncio

        deny = self._check_token(req)
        if deny:
            return deny
        try:
            batch = WalBatch(
                ns_tag=req.headers.get("x-repl-ns", ""),
                seg_id=int(req.headers.get("x-repl-seg", "0")),
                offset=int(req.headers.get("x-repl-offset", "0")),
                payload=req.body,
                crc=int(req.headers.get("x-repl-crc", "0")),
                epoch=int(req.headers.get("x-repl-epoch", "0")),
                records=int(req.headers.get("x-repl-records", "0")))
        except ValueError:
            return Response.json({"message": "bad X-Repl-* headers"},
                                 status=400)
        if not batch.ns_tag:
            return Response.json({"message": "missing X-Repl-Ns"},
                                 status=400)
        if self.role in ("leader", "promoting", "fenced"):
            # a leader still refuses stale epochs loudly (the drill's
            # forged-write probe lands here); equal/newer epochs get a
            # role refusal — two live leaders is an operator problem
            if batch.epoch < self.replica.epoch:
                return Response.json(
                    {"message": f"stale epoch {batch.epoch} < "
                                f"{self.replica.epoch}"}, status=412)
            return Response.json(
                {"message": f"not a follower (role {self.role})"},
                status=409)
        try:
            offset = await asyncio.to_thread(self.replica.apply_wal, batch)
        except StaleEpochError as e:
            return Response.json({"message": str(e)}, status=412)
        except WalTornError as e:
            return Response.json({"message": str(e)}, status=422)
        except WalGapError as e:
            return Response.json(
                {"error": "gap", "message": str(e), "seg": e.seg_id,
                 "offset": e.offset}, status=409)
        except ReplicationError as e:
            return Response.json({"message": str(e)}, status=409)
        return Response.json({"offset": offset})

    async def _h_roll(self, req: Request) -> Response:
        import asyncio

        deny = self._check_token(req)
        if deny:
            return deny
        if self.role != "follower":
            return Response.json(
                {"message": f"not a follower (role {self.role})"},
                status=409)
        doc = req.json() or {}
        try:
            await asyncio.to_thread(
                self.replica.apply_seal, str(doc.get("ns", "")),
                dict(doc.get("meta") or {}), int(doc.get("epoch", 0)))
        except StaleEpochError as e:
            return Response.json({"message": str(e)}, status=412)
        except (ReplicationError, KeyError, ValueError) as e:
            return Response.json({"message": str(e)}, status=409)
        return Response.json({"ok": True})

    async def _h_manifest(self, req: Request) -> Response:
        import asyncio

        deny = self._check_token(req)
        if deny:
            return deny
        return Response.json(await asyncio.to_thread(self._manifest_doc))

    def _manifest_doc(self) -> Dict[str, Any]:
        """Disk-truth manifest of every namespace under this node's
        home (served by leaders for follower catch-up)."""
        log_dir = os.path.join(self.home, "eventlog")
        out: Dict[str, Any] = {}
        try:
            names = sorted(os.listdir(log_dir))
        except OSError:
            names = []
        for name in names:
            if name.endswith(".peld"):
                tag = name[:-len(".peld")]
                try:
                    with open(os.path.join(log_dir, name,
                                           "segments.json"),
                              encoding="utf-8") as f:
                        manifest = json.load(f)
                except (OSError, ValueError):
                    continue
                out.setdefault(tag, {})["manifest"] = manifest
            elif name.endswith(".pel"):
                tag = name[:-len(".pel")]
                try:
                    size = os.path.getsize(os.path.join(log_dir, name))
                except OSError:
                    size = 0
                out.setdefault(tag, {})["active_bytes"] = size
        return {"epoch": self.epoch, "namespaces": out}

    async def _h_segment(self, req: Request) -> Response:
        import asyncio

        deny = self._check_token(req)
        if deny:
            return deny
        tag = req.path_params["ns"]
        file = req.path_params["file"]
        if "/" in tag or ".." in tag or "/" in file or ".." in file:
            return Response.json({"message": "bad path"}, status=400)
        path = os.path.join(self.home, "eventlog", tag + ".peld", file)

        def read() -> Optional[bytes]:
            try:
                with open(path, "rb") as f:
                    return f.read()
            except OSError:
                return None

        blob = await asyncio.to_thread(read)
        if blob is None:
            return Response.json({"message": "no such segment"},
                                 status=404)
        return Response(status=200, body=blob,
                        content_type="application/octet-stream")

    async def _h_promote(self, req: Request) -> Response:
        import asyncio

        deny = self._check_token(req)
        if deny:
            return deny
        try:
            doc = await asyncio.to_thread(self.promote, "operator promote")
        except ReplicationError as e:
            return Response.json({"message": str(e)}, status=409)
        return Response.json(doc)

    async def _h_status(self, req: Request) -> Response:
        return Response.json(self.status_doc())

    def status_doc(self) -> Dict[str, Any]:
        doc: Dict[str, Any] = {
            "role": self.role,
            "epoch": self.epoch,
            "advertiseUrl": self.advertise_url,
            "leaderUrl": (self.advertise_url if self.role == "leader"
                          else self._leader_url),
            "peers": list(self.peers),
            "replica": self.replica.status(),
        }
        if self.promotion_ms is not None:
            doc["promotionMs"] = round(self.promotion_ms, 3)
            doc["promotedAt"] = self.promoted_at
        if self.replicator is not None:
            doc["replication"] = self.replicator.status()
        return doc


# -- the kill -9 drill ---------------------------------------------------------


def run_failover_drill(
    base_dir: str,
    events: int = 120,
    kill_after: int = 40,
    lease_ttl: float = 0.35,
    startup_timeout: float = 30.0,
    promote_timeout: float = 10.0,
    log: Callable[[str], None] = lambda s: None,
) -> Dict[str, Any]:
    """Two real event-server processes, one ``kill -9``, five proofs.

    Returns the proof document (also printed as one JSON line by
    ``failover --drill``)::

        {"acked": N, "ackedLost": 0, "promotionMs": ..., "epoch": 2,
         "staleEpochRefused": true, "fsck": {"leader": 0, "follower": 0},
         "incidentBundles": 1, ...}

    The drill ingests SERIALLY and kills between acks, so the dead
    leader's log ends on a frame boundary — any acked-event loss or
    fsck finding is therefore a replication bug, not a race in the
    harness. Promotion is measured from the ``kill -9`` to the
    follower's ``/repl/status`` reporting ``role=leader`` (polled
    every 10 ms, so the figure includes the full lease-expiry wait).
    """
    import signal
    import socket
    import subprocess
    import sys

    from predictionio_tpu_torch.data.pel_integrity import fsck_home
    from predictionio_tpu_torch.storage.meta import MetaStore

    def free_port() -> int:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    os.makedirs(base_dir, exist_ok=True)
    homes = {n: os.path.join(base_dir, n) for n in ("leader", "follower")}
    lease_home = os.path.join(base_dir, "lease")
    ports = {n: free_port() for n in homes}
    urls = {n: f"http://127.0.0.1:{p}" for n, p in ports.items()}
    access_key = "drill-key"
    for name, home in homes.items():
        os.makedirs(home, exist_ok=True)
        # the meta store is config-plane state replicated out-of-band
        # (both nodes are provisioned with the same apps/keys — in
        # production this is a shared SQL meta source)
        meta = MetaStore(os.path.join(home, "meta.db"))
        app = meta.create_app("failover-drill")
        meta.create_access_key(app.id, key=access_key)

    def spawn(name: str, peer: str) -> subprocess.Popen:
        env = dict(os.environ)
        env.update({
            "PIO_HOME": homes[name],
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "EL",
            "PIO_STORAGE_SOURCES_EL_TYPE": "EVENTLOG",
        })
        return subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch.tools.cli",
             "eventserver", "--ip", "127.0.0.1",
             "--port", str(ports[name]),
             "--lease-home", lease_home,
             "--advertise-url", urls[name],
             "--replicate-to", urls[peer],
             "--lease-ttl", str(lease_ttl),
             "--durable-acks",
             "--incident-dir", os.path.join(homes[name], "incidents")],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)

    def wait_status(url: str, pred, timeout: float, step: float = 0.01
                    ) -> Dict[str, Any]:
        deadline = time.monotonic() + timeout
        last: Dict[str, Any] = {}
        client = FollowerClient(url, timeout=2.0)
        while time.monotonic() < deadline:
            try:
                last = client.status()
                if pred(last):
                    return last
            except Exception:  # noqa: BLE001 — still booting
                pass
            time.sleep(step)
        raise TimeoutError(f"{url} never reached the expected repl "
                           f"state (last: {last})")

    procs: Dict[str, subprocess.Popen] = {}
    try:
        procs["leader"] = spawn("leader", peer="follower")
        wait_status(urls["leader"], lambda d: d.get("role") == "leader",
                    startup_timeout)
        log(f"leader up at {urls['leader']}")
        procs["follower"] = spawn("follower", peer="leader")
        wait_status(urls["follower"],
                    lambda d: d.get("role") == "follower", startup_timeout)
        log(f"follower up at {urls['follower']}")
        epoch_before = int(FollowerClient(
            urls["leader"], timeout=2.0).status()["epoch"])

        # writers point at the FOLLOWER: its 307 redirect (and the
        # sink's bounded redirect-following) is exactly what keeps
        # them alive through the promotion window
        from predictionio_tpu_torch.server.eventsink import HTTPEventSink

        sink = HTTPEventSink(urls["follower"], access_key,
                             retries=60, timeout=5.0)
        from predictionio_tpu_torch.data.event import Event

        acked: List[str] = []
        killed_at: Optional[float] = None
        for i in range(events):
            eid = sink.send(Event(
                event="drill", entity_type="user", entity_id=f"u{i}",
                properties={"seq": i}))
            acked.append(eid)
            if len(acked) == kill_after:
                log(f"kill -9 leader after {len(acked)} acks")
                procs["leader"].send_signal(signal.SIGKILL)
                killed_at = time.time()
        assert killed_at is not None, "drill never reached kill_after"
        procs["leader"].wait(timeout=10)

        promoted = wait_status(urls["follower"],
                               lambda d: d.get("role") == "leader",
                               promote_timeout)
        # kill-to-leader latency from the promoted node's own wall
        # clock (same host): the serial ingest keeps running through
        # the failover window, so "when did we notice via /repl/
        # status" would charge promotion for ingest time
        promotion_ms = (float(promoted["promotedAt"]) - killed_at) * 1000.0
        epoch_after = int(promoted["epoch"])
        log(f"follower promoted at epoch {epoch_after} "
            f"({promotion_ms:.0f} ms after kill)")

        # proof 1: ZERO acked events lost — every acked id must be
        # readable on the promoted node
        new_leader = urls["follower"]
        lost = []
        for eid in acked:
            req = urllib.request.Request(
                f"{new_leader}/events/{urllib.parse.quote(eid)}.json"
                f"?accessKey={access_key}")
            try:
                with urllib.request.urlopen(req, timeout=5.0) as resp:
                    json.loads(resp.read())
            except urllib.error.HTTPError:
                lost.append(eid)

        # proof 2: the dead leader's epoch can no longer write — a
        # forged WAL batch at the old epoch must be refused
        stale_refused = False
        try:
            FollowerClient(new_leader, timeout=2.0).apply(WalBatch.build(
                "events_1", 0, 0, b"PELOGv2\n", epoch=epoch_before))
        except StaleEpochError:
            stale_refused = True
        except ReplicationError:
            stale_refused = False

        # proof 3: both logs fsck clean — the replica is byte-accurate
        # and the killed leader's log ends on a frame boundary
        fsck = {}
        for name, home in homes.items():
            rep = fsck_home(home, repair=False)
            fsck[name] = 2 if rep["corrupt"] else (
                3 if rep["repaired"] else 0)

        # proof 4: exactly one coalesced incident bundle names the
        # failover on the promoted node
        bundles = _failover_bundles(
            os.path.join(homes["follower"], "incidents"))

        return {
            "acked": len(acked),
            "ackedLost": len(lost),
            "lostIds": lost[:10],
            "promotionMs": round(promotion_ms, 1),
            "nodePromotionMs": promoted.get("promotionMs"),
            "epochBefore": epoch_before,
            "epoch": epoch_after,
            "staleEpochRefused": stale_refused,
            "fsck": fsck,
            "incidentBundles": len(bundles),
            "ok": (not lost and stale_refused
                   and epoch_after > epoch_before
                   and promotion_ms < 1000.0
                   and all(v == 0 for v in fsck.values())
                   and len(bundles) == 1),
        }
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.terminate()
                try:
                    p.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    p.kill()


def _failover_bundles(incident_root: str) -> List[str]:
    """Incident bundles whose manifest names a failover trigger."""
    out = []
    try:
        names = os.listdir(incident_root)
    except OSError:
        return out
    for name in sorted(names):
        mpath = os.path.join(incident_root, name, "manifest.json")
        try:
            with open(mpath, encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        triggers = {doc.get("trigger")} | {
            t.get("trigger") for t in doc.get("triggers", [])
            if isinstance(t, dict)}
        if "failover" in triggers:
            out.append(name)
    return out
