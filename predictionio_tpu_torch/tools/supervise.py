"""Process supervision for the long-lived servers: the port's copy of
the JAX package's ``tools/supervise.py``.

The reference's engine server runs under a ``MasterActor`` that
supervises bind failures and restarts, and ``pio-daemon`` daemonizes
the services. Here that is split the unix way:

- bind retry lives in the servers themselves
  (:class:`predictionio_tpu_torch.server.http.HTTPServer`
  ``bind_retries``);
- crash restart and liveness live in this :class:`Supervisor`, which the
  ``daemon`` verb wraps around any verb of the port's CLI:

  * restarts the child when it exits unexpectedly, with exponential
    backoff and equal jitter
    (:func:`~predictionio_tpu_torch.utils.resilience.backoff_delays`)
    that resets after a stable period; the backoff sleep is
    interruptible, so SIGTERM during a long backoff stops promptly;
  * optional HTTP health checks (``GET health_url`` expecting < 500):
    a wedged-but-alive server gets killed and restarted;
  * a restart budget within a rolling window, so a crash loop ends in
    a loud failure instead of a silent hot loop;
  * SIGTERM/SIGINT forwarding and a pidfile for stop scripts.

Supervising the continuous trainer (``daemon -- train --continuous …``)
composes with its lease protocol: the forwarded SIGTERM lets the
trainer finish its cycle and **release** the lease (expiry zeroed,
fencing token kept) before exiting 0, which the supervisor treats as a
finished job. Size ``term_grace`` so a cycle can complete; a child
killed at the grace deadline leaves the lease to expire (the fencing
token keeps late writes out either way).

Every restart is exported as ``pio_supervise_restarts_total{name,
reason}`` (reason ``crash`` / ``health`` / ``operator``) and the current
backoff delay as ``pio_supervise_backoff_seconds{name}``.

:class:`ReplicaPool` builds on the supervisor: N supervised engine-server
replicas on one host, with port allocation, health-gated add,
drain-then-stop remove, and an atomically rewritten router manifest. It
is the actuator of the JAX package's autoscaler and remediation
playbooks, which come to the port with the router.

A bare verb is run as ``python -m predictionio_tpu_torch.tools.cli
<verb>`` (:func:`normalize_command`), so everything supervised runs
the port.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

from predictionio_tpu_torch.utils.atomic_write import atomic_write_text
from predictionio_tpu_torch.utils.metrics import REGISTRY
from predictionio_tpu_torch.utils.resilience import backoff_delays

_M_RESTARTS = REGISTRY.counter(
    "pio_supervise_restarts_total",
    "Supervised child restarts by cause (crash = unexpected exit, "
    "health = failed health check, operator = requested restart)",
    ("name", "reason"))
_M_BACKOFF = REGISTRY.gauge(
    "pio_supervise_backoff_seconds",
    "Most recent restart-backoff delay; 0 once the child is stable",
    ("name",))


def _log(*args) -> None:
    # flush per line: under `pio-daemon`'s redirected stdout, plain print
    # is block-buffered and restart events would not reach the log until
    # the buffer fills
    print(*args, flush=True)


class Supervisor:
    def __init__(
        self,
        argv: Sequence[str],
        health_url: Optional[str] = None,
        health_interval: float = 5.0,
        health_timeout: float = 3.0,
        health_grace: float = 10.0,
        max_restarts: int = 10,
        restart_window: float = 600.0,
        backoff: float = 1.0,
        backoff_max: float = 30.0,
        term_grace: float = 10.0,
        pidfile: Optional[str] = None,
        name: str = "default",
        log=_log,
    ) -> None:
        self.argv = list(argv)
        #: metric label (the pool uses ``host:port``); NOT a uniqueness
        #: claim — two supervisors may share a name and their restart
        #: counters then sum, which is what a dashboard wants anyway
        self.name = name
        self.health_url = health_url
        self.health_interval = health_interval
        self.health_timeout = health_timeout
        self.health_grace = health_grace
        self.max_restarts = max_restarts
        self.restart_window = restart_window
        self.backoff = backoff
        self.backoff_max = backoff_max
        #: SIGTERM→SIGKILL window when stopping the child; the
        #: continuous trainer needs enough to release its lease cleanly
        self.term_grace = term_grace
        self.pidfile = pidfile
        self.log = log
        self._child: Optional[subprocess.Popen] = None
        self._stopping = False
        self._restart_requested = False
        self.restarts = 0
        self.last_backoff = 0.0  # most recent restart delay (for logs/tests)
        self._restart_times: List[float] = []
        _M_BACKOFF.set(0.0, (self.name,))

    # -- child lifecycle -------------------------------------------------------

    def _spawn(self) -> None:
        self._child = subprocess.Popen(self.argv)
        self.log(f"[supervise] started pid {self._child.pid}: "
                 f"{' '.join(self.argv)}")

    def _terminate_child(self, grace: Optional[float] = None) -> None:
        child = self._child
        if child is None or child.poll() is not None:
            return
        child.terminate()
        try:
            child.wait(timeout=self.term_grace if grace is None else grace)
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait()

    def _healthy(self) -> bool:
        assert self.health_url is not None
        try:
            with urllib.request.urlopen(self.health_url,
                                        timeout=self.health_timeout) as r:
                return r.status < 500
        except urllib.error.HTTPError as e:
            return e.code < 500
        except Exception:
            return False

    def _budget_exceeded(self, now: float) -> bool:
        self._restart_times = [t for t in self._restart_times
                               if now - t <= self.restart_window]
        return len(self._restart_times) >= self.max_restarts

    def _new_delays(self) -> Iterator[float]:
        """Fresh restart-backoff schedule: exponential from ``backoff``
        to ``backoff_max`` with equal jitter (half deterministic, half
        random) — late enough to matter, never below half the target."""
        return backoff_delays(self.backoff, self.backoff_max, jitter="equal")

    def _sleep(self, seconds: float) -> bool:
        """Interruptible sleep: returns False the moment ``stop()`` (or
        a signal) flips ``_stopping`` — a SIGTERM mid-backoff must not
        wait out the remaining delay."""
        deadline = time.monotonic() + seconds
        while not self._stopping:
            left = deadline - time.monotonic()
            if left <= 0:
                return True
            time.sleep(min(0.2, left))
        return False

    def _record_restart(self, reason: str) -> None:
        self.restarts += 1
        _M_RESTARTS.inc((self.name, reason))

    def child_pid(self) -> Optional[int]:
        """Pid of the live child, or None (chaos drills kill -9 it)."""
        child = self._child
        if child is None or child.poll() is not None:
            return None
        return child.pid

    def request_restart(self) -> None:
        """Ask the run loop to bounce the child: terminate + immediate
        respawn, no backoff and no restart-budget charge. This is the
        remediation path ("restart wedged replica") — an operator
        decision, not a crash, so it must neither burn the crash budget
        nor wait out a backoff schedule."""
        self._restart_requested = True

    # -- main loop -------------------------------------------------------------

    def run(self) -> int:
        """Supervise until stopped; returns the exit code to propagate
        (0 on clean stop, 1 when the restart budget is exhausted)."""
        if self.pidfile:
            os.makedirs(os.path.dirname(self.pidfile) or ".", exist_ok=True)
            with open(self.pidfile, "w") as f:
                f.write(str(os.getpid()))

        def on_signal(signum, frame):
            self._stopping = True
            self._terminate_child()

        old = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                old[sig] = signal.signal(sig, on_signal)
            except ValueError:
                pass  # not the main thread (tests drive stop() directly)

        try:
            self._spawn()
            started = time.monotonic()
            last_health = started
            delays: Optional[Iterator[float]] = None  # None = fresh schedule
            while not self._stopping:
                if self._restart_requested:
                    self._restart_requested = False
                    self.log("[supervise] operator restart requested")
                    self._terminate_child()
                    self._record_restart("operator")
                    self._spawn()
                    started = time.monotonic()
                    last_health = started
                    continue
                code = self._child.poll() if self._child else None
                now = time.monotonic()
                restart = False
                reason = "crash"
                if code is not None:
                    if self._stopping:
                        break
                    if code == 0:
                        # a clean exit is a finished job, not a crash —
                        # restarting it (e.g. `pio daemon -- train`) would
                        # re-run a successful run until the budget ran out
                        self.log("[supervise] child exited cleanly; done")
                        return 0
                    self.log(f"[supervise] child exited with {code}")
                    restart = True
                elif (self.health_url is not None
                      and now - started > self.health_grace
                      and now - last_health >= self.health_interval):
                    last_health = now
                    if not self._healthy():
                        self.log("[supervise] health check failed; "
                                 "restarting child")
                        self._terminate_child()
                        restart = True
                        reason = "health"
                if restart:
                    if self._budget_exceeded(now):
                        self.log(f"[supervise] {self.max_restarts} restarts "
                                 f"within {self.restart_window:.0f}s — "
                                 "giving up")
                        return 1
                    self._restart_times.append(now)
                    self._record_restart(reason)
                    if delays is None:
                        delays = self._new_delays()
                    self.last_backoff = next(delays)
                    _M_BACKOFF.set(self.last_backoff, (self.name,))
                    self.log(f"[supervise] restarting in "
                             f"{self.last_backoff:.2f}s")
                    if not self._sleep(self.last_backoff):
                        break  # stop requested mid-backoff
                    self._spawn()
                    started = time.monotonic()
                    last_health = started
                else:
                    if (self._child is not None
                            and now - started > 2 * max(self.backoff, 1.0)):
                        delays = None  # stable → reset backoff schedule
                        _M_BACKOFF.set(0.0, (self.name,))
                    time.sleep(0.2)
            self._terminate_child()
            return 0
        finally:
            # whatever ended the loop (clean stop, budget exhausted),
            # there is no pending backoff any more — a gauge stuck at
            # the last delay would read as a live crash loop
            _M_BACKOFF.set(0.0, (self.name,))
            for sig, handler in old.items():
                signal.signal(sig, handler)
            if self.pidfile:
                try:
                    os.remove(self.pidfile)
                except FileNotFoundError:
                    pass

    def stop(self) -> None:
        self._stopping = True
        self._terminate_child()


def free_port(host: str = "127.0.0.1") -> int:
    """One free TCP port on ``host`` (bind-0 probe). Racy by nature —
    the pool's health-gated add is what actually confirms the replica
    bound it; a lost race just fails the add loudly."""
    s = socket.socket()
    try:
        s.bind((host, 0))
        return s.getsockname()[1]
    finally:
        s.close()


class PoolError(RuntimeError):
    """A replica-pool operation refused or failed (add never became
    healthy, remove would empty the pool, unknown replica name)."""


class ReplicaPool:
    """N supervised engine-server replicas on one host, fronted by a
    fleet-router manifest this pool owns and rewrites atomically.

    ``spawn`` describes how to start one replica: either a callable
    ``port -> argv`` or an argv template whose ``{port}`` tokens are
    substituted. Each replica runs under its own :class:`Supervisor`
    in a daemon thread (crash restart with backoff, restart metrics),
    so a kill -9'd replica is backfilled without anyone paging.

    - **add** is health-gated: the replica joins the manifest only
      after its ``/health`` answers 200, so the router never routes to
      a replica that is still compiling/loading.
    - **remove** is drain-then-stop: the replica leaves the manifest
      first (the router's watcher stops picking it), waits
      ``drain_grace`` for in-flight requests to finish, then SIGTERMs.
    - **restart** is the remediation actuator: terminate + respawn via
      :meth:`Supervisor.request_restart` (no budget charge), then the
      health gate re-admits it.

    Mutating methods serialize on one op lock ("one membership change
    at a time" is exactly the serialization the autoscaler wants),
    while a second short-held lock guards the member dict so status
    snapshots never wait behind a minutes-long health-gated add.
    """

    def __init__(self, spawn: Any, manifest: str, *,
                 host: str = "127.0.0.1",
                 ready_timeout: float = 120.0,
                 drain_grace: float = 2.0,
                 health_interval: float = 2.0,
                 health_grace: float = 30.0,
                 max_restarts: int = 20,
                 backoff: float = 0.5,
                 backoff_max: float = 10.0,
                 log: Callable[..., None] = _log) -> None:
        self.spawn = spawn
        self.manifest = manifest
        self.host = host
        self.ready_timeout = ready_timeout
        self.drain_grace = drain_grace
        self.health_interval = health_interval
        self.health_grace = health_grace
        self.max_restarts = max_restarts
        self.backoff = backoff
        self.backoff_max = backoff_max
        self.log = log
        self._lock = threading.Lock()     # guards _members (short holds)
        self._op = threading.Lock()       # serializes membership changes
        #: name ("host:port") → {"port", "supervisor", "thread"}
        self._members: Dict[str, Dict[str, Any]] = {}

    # -- introspection ---------------------------------------------------------

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._members)

    def size(self) -> int:
        with self._lock:
            return len(self._members)

    def child_pid(self, name: str) -> Optional[int]:
        with self._lock:
            member = self._members.get(name)
        return member["supervisor"].child_pid() if member else None

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            members = dict(self._members)
        return [{"name": name,
                 "port": m["port"],
                 "pid": m["supervisor"].child_pid(),
                 "restarts": m["supervisor"].restarts,
                 "lastBackoffSec": m["supervisor"].last_backoff}
                for name, m in sorted(members.items())]

    # -- manifest --------------------------------------------------------------

    def _write_manifest_locked(self) -> None:
        lines = ["# written by ReplicaPool — do not edit by hand"]
        lines += [f"http://{name}" for name in sorted(self._members)]
        atomic_write_text(self.manifest, "\n".join(lines) + "\n")

    # -- replica helpers -------------------------------------------------------

    def _argv(self, port: int) -> List[str]:
        if callable(self.spawn):
            return [str(a) for a in self.spawn(port)]
        return [str(a).replace("{port}", str(port)) for a in self.spawn]

    def _ready(self, port: int) -> bool:
        try:
            url = f"http://{self.host}:{port}/health"
            with urllib.request.urlopen(url, timeout=2.0) as r:
                return r.status == 200
        except Exception:  # noqa: BLE001 — not up yet, whatever the cause
            return False

    # -- membership ------------------------------------------------------------

    def add_replica(self) -> str:
        """Spawn + health-gate + admit one replica; returns its name.
        Raises :class:`PoolError` when the replica never becomes
        healthy inside ``ready_timeout`` (the supervisor is stopped —
        a failed add must not leave an orphan crash-looping)."""
        with self._op:
            port = free_port(self.host)
            name = f"{self.host}:{port}"
            sup = Supervisor(
                self._argv(port),
                health_url=f"http://{self.host}:{port}/health",
                health_interval=self.health_interval,
                health_grace=self.health_grace,
                max_restarts=self.max_restarts,
                backoff=self.backoff, backoff_max=self.backoff_max,
                name=name, log=self.log)
            thread = threading.Thread(
                target=sup.run, name=f"pio-pool-{name}", daemon=True)
            thread.start()
            deadline = time.monotonic() + self.ready_timeout
            while time.monotonic() < deadline:
                if self._ready(port):
                    break
                if not thread.is_alive():
                    raise PoolError(
                        f"replica {name} supervisor died during startup")
                time.sleep(0.1)
            else:
                sup.stop()
                raise PoolError(
                    f"replica {name} not healthy after "
                    f"{self.ready_timeout:.0f}s")
            with self._lock:
                self._members[name] = {
                    "port": port, "supervisor": sup, "thread": thread}
                self._write_manifest_locked()
                n = len(self._members)
            self.log(f"[pool] admitted replica {name} ({n} in manifest)")
            return name

    def remove_replica(self, name: Optional[str] = None) -> str:
        """Drain-then-stop one replica (the named one, else the
        newest). Refuses to empty the pool — scale-down past one
        replica is an outage, not an optimization."""
        with self._op:
            with self._lock:
                if len(self._members) <= 1:
                    raise PoolError("refusing to remove the last replica")
                if name is None:
                    name = max(self._members,
                               key=lambda n: self._members[n]["port"])
                member = self._members.pop(name, None)
                if member is None:
                    raise PoolError(
                        f"no replica named {name!r} in the pool")
                # manifest first: the router stops routing to it, THEN
                # the process goes away — never the other way around
                self._write_manifest_locked()
                n = len(self._members)
            time.sleep(self.drain_grace)
            member["supervisor"].stop()
            member["thread"].join(timeout=30.0)
            self.log(f"[pool] removed replica {name} ({n} in manifest)")
            return name

    def restart_replica(self, name: str) -> None:
        """Bounce one replica (operator/remediation restart — no
        budget charge, no backoff). The supervisor's health gate and
        the router's own /health polling re-admit it."""
        with self._lock:
            member = self._members.get(name)
            if member is None:
                raise PoolError(f"no replica named {name!r} in the pool")
            member["supervisor"].request_restart()

    def stop_all(self) -> None:
        with self._lock:
            members = dict(self._members)
            self._members.clear()
            try:
                self._write_manifest_locked()
            except OSError:
                pass
        for member in members.values():
            member["supervisor"].stop()
        for member in members.values():
            member["thread"].join(timeout=30.0)


def normalize_command(command: Sequence[str]) -> List[str]:
    """Resolve the supervised command line: drop the one leading ``--``
    argparse leaves in REMAINDER, and route bare verbs through this
    interpreter's CLI of the port (``eventserver --port 7070`` →
    ``python -m predictionio_tpu_torch.tools.cli eventserver --port 7070``)."""
    cmd = list(command)
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        return cmd
    head = os.path.basename(cmd[0])
    if cmd[0] != sys.executable and not head.startswith("python"):
        cmd = [sys.executable, "-m", "predictionio_tpu_torch.tools.cli"] + cmd
    return cmd


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="daemon",
        description="supervise a verb of the port's CLI (crash "
                    "restart, health checks, pidfile)")
    ap.add_argument("--pidfile")
    ap.add_argument("--health-url",
                    help="GET this URL periodically; a non-responsive or "
                         ">=500 child is restarted")
    ap.add_argument("--health-interval", type=float, default=5.0)
    ap.add_argument("--health-grace", type=float, default=30.0,
                    help="seconds after (re)start before health checks "
                         "begin — must exceed the server's worst-case "
                         "startup (model load + first compile)")
    ap.add_argument("--max-restarts", type=int, default=10)
    ap.add_argument("--restart-window", type=float, default=600.0)
    ap.add_argument("--term-grace", type=float, default=10.0,
                    help="seconds between SIGTERM and SIGKILL when "
                         "stopping the child (the continuous trainer "
                         "uses this window to release its lease)")
    ap.add_argument("command", nargs=argparse.REMAINDER,
                    help="the pio verb to supervise, e.g. "
                         "eventserver --port 7070")
    args = ap.parse_args(argv)
    cmd = normalize_command(args.command)
    if not cmd:
        ap.error("no command given")
    # crash-dump plumbing: a wedged supervisor answers SIGQUIT with a
    # full thread dump on stderr (→ the daemon log); the supervised
    # servers install their own SIGQUIT → incident-bundle handlers
    import faulthandler
    if not faulthandler.is_enabled():
        faulthandler.enable()
    try:
        faulthandler.register(signal.SIGQUIT, chain=True)
    except (AttributeError, ValueError):
        pass  # platform without SIGQUIT, or not the main thread
    sup = Supervisor(cmd, health_url=args.health_url,
                     health_interval=args.health_interval,
                     health_grace=args.health_grace,
                     max_restarts=args.max_restarts,
                     restart_window=args.restart_window,
                     term_grace=args.term_grace,
                     pidfile=args.pidfile)
    return sup.run()


if __name__ == "__main__":
    raise SystemExit(main())
