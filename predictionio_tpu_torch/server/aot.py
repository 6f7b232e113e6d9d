"""AOT-bucketed serving programs: the deploy-time warmup layer.

A serving program meets a NEW batch shape on first use; on the card
that first call builds the kernel library and allocates its buffers.
This module moves that cost to deploy time:

- :class:`BucketLadder` — a geometric ladder of padded batch buckets
  (default 1, 2, 4, … max_batch; ``--aot-buckets`` overrides). Every
  collected micro-batch is snapped UP to the nearest bucket and padded
  with masked rows, so the set of batch shapes that can reach the
  device is finite and known at deploy time.
- :class:`ExecutableCache` — a process-wide cache of warmed serving
  programs keyed by program geometry. Here an "executable" is a warmed
  callable per (B, k) with its device outputs preallocated; it holds no
  model values, so same-geometry models share it.
- :class:`AOTWarmup` — deploy-time orchestration: walks the deployed
  engine's algorithms, asks each (duck-typed ``aot_warm`` hook) to warm
  its serving program for every ladder bucket, and reports progress.
- ``PAD`` — the sentinel the micro-batcher pads collected batches with;
  padded rows are masked on device and sliced off the fan-out.

Per-bucket device-program latency lands in the
``pio_predict_device_seconds{bucket,path}`` histogram.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from predictionio_tpu_torch.utils.metrics import REGISTRY

# -- padding sentinel ---------------------------------------------------------


class _PadQuery:
    """Sentinel appended by the MicroBatcher to fill a batch up to its
    bucket. Engine layers never serve it: its result slot is sliced off
    before the fan-out. Singleton so ``q is PAD`` works across modules."""

    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return "<PAD>"


PAD = _PadQuery()


def is_pad(query: Any) -> bool:
    return query is PAD


def strip_pads(queries: Sequence[Any]) -> Tuple[List[Any], List[int]]:
    """Split a padded batch into (real queries, their original
    positions). The complement positions are PAD slots."""
    real, pos = [], []
    for i, q in enumerate(queries):
        if q is not PAD:
            real.append(q)
            pos.append(i)
    return real, pos


# -- the bucket ladder --------------------------------------------------------


class BucketLadder:
    """A sorted ladder of padded batch buckets.

    ``snap(n)`` returns the smallest bucket ≥ n — the batch shape the
    dispatch will actually run at. The largest bucket doubles as the
    serving ``max_batch``: the MicroBatcher never collects more.
    """

    def __init__(self, buckets: Sequence[int]) -> None:
        cleaned = sorted({int(b) for b in buckets if int(b) >= 1})
        if not cleaned:
            raise ValueError("bucket ladder needs at least one bucket >= 1")
        self.buckets: Tuple[int, ...] = tuple(cleaned)

    @classmethod
    def geometric(cls, max_batch: int, base: int = 2) -> "BucketLadder":
        """1, base, base², … up to (and always including) max_batch."""
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        buckets = []
        b = 1
        while b < max_batch:
            buckets.append(b)
            b *= base
        buckets.append(max_batch)
        return cls(buckets)

    @classmethod
    def parse(cls, spec: Optional[str], max_batch: int) -> "BucketLadder":
        """``--aot-buckets`` grammar: ``auto`` (or empty) → geometric
        ladder up to ``max_batch``; else a comma-separated explicit
        ladder, e.g. ``1,2,4,8,16,32,64``. An explicit ladder defines
        its own max batch (its largest bucket)."""
        if not spec or spec.strip().lower() == "auto":
            return cls.geometric(max_batch)
        try:
            buckets = [int(tok) for tok in spec.split(",") if tok.strip()]
        except ValueError as e:
            raise ValueError(f"bad --aot-buckets spec {spec!r}: {e}") from None
        return cls(buckets)

    @property
    def max_batch(self) -> int:
        return self.buckets[-1]

    def snap(self, n: int) -> int:
        """Smallest bucket ≥ n (n > max_batch snaps to max_batch —
        callers cap collection at max_batch, so this is defensive)."""
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def __iter__(self):
        return iter(self.buckets)

    def __len__(self) -> int:
        return len(self.buckets)

    def __repr__(self) -> str:
        return f"BucketLadder({list(self.buckets)})"


# -- process-wide executable cache -------------------------------------------


class ExecutableCache:
    """Warmed serving programs keyed by program geometry.

    The key captures everything that selects a distinct program (shapes,
    k, device); model values are passed at call time, so programs are
    shared across model instances with the same geometry.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._programs: Dict[Tuple, Any] = {}
        self._m_lookups = REGISTRY.counter(
            "pio_aot_cache_lookups_total",
            "AOT executable-cache lookups", ("result",))
        self._m_compile_s = REGISTRY.histogram(
            "pio_aot_compile_seconds",
            "Wall time of cold serving-program warmup",
            buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0, 60.0))

    def get(self, key: Tuple) -> Optional[Any]:
        with self._lock:
            return self._programs.get(key)

    def get_or_compile(self, key: Tuple, build: Callable[[], Any]) -> Any:
        """Return the cached program for ``key``, building (and recording
        the cold wall time) on first use. ``build`` runs outside the
        lock; a racing double build is benign (the first stored wins)."""
        with self._lock:
            prog = self._programs.get(key)
        if prog is not None:
            self._m_lookups.inc(("hit",))
            return prog
        t0 = time.perf_counter()
        prog = build()
        self._m_compile_s.observe(time.perf_counter() - t0)
        self._m_lookups.inc(("compile",))
        with self._lock:
            self._programs.setdefault(key, prog)
            return self._programs[key]

    def counts(self) -> Dict[str, int]:
        """{"hit": n, "compile": m}: what a warm pass found cached and
        what it built (a same-geometry ``/reload`` adds only hits)."""
        return {k[0]: int(v) for k, v in self._m_lookups.items()}

    def clear(self) -> None:
        with self._lock:
            self._programs.clear()


#: process-wide cache — all scorers share it so repeated deploys in one
#: process never re-warm a known geometry
EXECUTABLES = ExecutableCache()


# -- per-bucket device latency ------------------------------------------------

#: device-program latency per padded batch bucket. ``path`` = aot
#: (warmed program) | jit (an unwarmed shape — counts a warmup gap; the
#: JAX package's label, so one dashboard reads both packages).
DEVICE_LATENCY = REGISTRY.histogram(
    "pio_predict_device_seconds",
    "Serving device-program latency (ids upload, kernel, result fetch) "
    "per bucket",
    labelnames=("bucket", "path"))

_DISPATCHES = REGISTRY.counter(
    "pio_aot_dispatch_total",
    "Serving device dispatches", ("bucket", "path"))


def record_device_latency(bucket: int, seconds: float, path: str,
                          trace_exemplar: Optional[str] = None) -> None:
    labels = (str(bucket), path)
    DEVICE_LATENCY.observe(seconds, labels, exemplar=trace_exemplar)
    _DISPATCHES.inc(labels)


#: sharded-ANN serving layout, the JAX package's three families: shard
#: count of the serving mesh, padded item rows resident per device, and
#: the (k′ · shards) width of the distributed top-k merge. The port
#: serves ANN unsharded only (``ann/scorer``), so they stay 0; they are
#: registered so ``/metrics`` has the JAX server's families.
ANN_SHARDS = REGISTRY.gauge(
    "pio_ann_shard_count",
    "Item shards in the sharded ANN serving mesh (0 = unsharded)")
ANN_SHARD_ITEMS = REGISTRY.gauge(
    "pio_ann_shard_items_per_device",
    "Padded item rows resident per device under sharded ANN serving")
ANN_SHARD_MERGE = REGISTRY.gauge(
    "pio_ann_shard_merge_candidates",
    "Distributed shortlist-merge width (k' x shards) per query row")


# -- deploy-time warmup orchestration ----------------------------------------


class AOTWarmup:
    """Warms the deployed engine's serving programs for every ladder
    bucket, tracking progress.

    States: ``idle`` (never started) → ``warming`` → ``ready`` |
    ``failed``. Algorithms opt in by implementing
    ``aot_warm(model, ladder, ks)`` → dict with ``compiled``/``cached``
    counts (duck-typed). Engines whose algorithms serve host-side warm
    instantly.
    """

    def __init__(self, ladder: BucketLadder,
                 ks: Sequence[int] = (16,)) -> None:
        self.ladder = ladder
        self.ks = tuple(ks)
        self.state = "idle"
        self.error: Optional[str] = None
        self.compiled = 0
        self.cached = 0
        self.total_targets = 0
        self.wall_sec = 0.0
        self._started_at = 0.0
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._m_state = REGISTRY.gauge(
            "pio_aot_warmup_ready",
            "1 once the serving bucket ladder is fully warmed")
        self._m_state.set(0)
        self._m_warm_s = REGISTRY.gauge(
            "pio_aot_warmup_seconds", "Wall time of the last warmup pass")

    def warm_sync(self, deployed: Any) -> Dict[str, Any]:
        """Warm every algorithm of ``deployed`` across the ladder in the
        caller's thread. Raises on failure."""
        from predictionio_tpu_torch.utils import tracing

        t0 = time.perf_counter()
        with self._lock:
            self._started_at = t0
        compiled = cached = targets = 0
        with tracing.span("serving.aot_warmup",
                          buckets=len(self.ladder), ks=len(self.ks)):
            for (_, algo), model in zip(getattr(deployed, "algorithms", []),
                                        getattr(deployed, "models", [])):
                hook = getattr(algo, "aot_warm", None)
                if hook is None:
                    continue
                stats = hook(model, self.ladder, self.ks) or {}
                compiled += int(stats.get("compiled", 0))
                cached += int(stats.get("cached", 0))
                targets += int(stats.get("targets", 0))
        wall = time.perf_counter() - t0
        with self._lock:
            self.compiled, self.cached = compiled, cached
            self.total_targets = targets
            self.wall_sec = wall
        self._m_warm_s.set(wall)
        return {"compiled": compiled, "cached": cached,
                "targets": targets, "wall_sec": wall}

    def start(self, deployed: Any) -> None:
        """Kick off the deploy-time warmup in a daemon thread."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self.state = "warming"
            self.error = None
            self._m_state.set(0)
            self._thread = threading.Thread(
                target=self._run, args=(deployed,),
                name="pio-aot-warmup", daemon=True)
            self._thread.start()

    def _run(self, deployed: Any) -> None:
        try:
            self.warm_sync(deployed)
        except Exception as e:  # noqa: BLE001 — surfaced via progress()
            with self._lock:
                self.state = "failed"
                self.error = f"{type(e).__name__}: {e}"
            return
        with self._lock:
            self.state = "ready"
        self._m_state.set(1)

    def mark_ready(self) -> None:
        """Record a successful synchronous warm (the ``/reload`` path
        calls :meth:`warm_sync` on the candidate directly, with no
        background thread to flip the state)."""
        with self._lock:
            self.state = "ready"
        self._m_state.set(1)

    def wait(self, timeout: Optional[float] = None) -> bool:
        t = self._thread
        if t is not None:
            t.join(timeout)
        return self.state in ("ready", "failed")

    @property
    def ready(self) -> bool:
        return self.state == "ready"

    def retry_after(self) -> float:
        """Seconds a client turned away during warmup should wait: the
        last pass's wall time minus what has elapsed of the current one
        (floored at 0.5 s), or 5 s before any pass has finished."""
        with self._lock:
            if self.state in ("ready", "failed"):
                return 0.0
            est = self.wall_sec if self.wall_sec > 0 else 5.0
            if self.state == "warming" and self._started_at > 0:
                return max(0.5, est - (time.perf_counter() - self._started_at))
            return est

    def progress(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "state": self.state,
                "buckets": list(self.ladder.buckets),
                "ks": list(self.ks),
                "compiled": self.compiled,
                "cached": self.cached,
                "targets": self.total_targets,
                "wallSec": round(self.wall_sec, 3),
                **({"error": self.error} if self.error else {}),
            }

    def release(self) -> None:
        """Drop the warmup thread reference and return to ``idle``, for
        an owner that is done with this warm-up. ``serve_forever`` does
        not call it: a server that serves again after a stop keeps its
        ready ladder. The process-wide :data:`EXECUTABLES` cache
        survives, and no buffer is freed here: a program's buffers go
        only with the last scorer or in-flight dispatch that holds it."""
        with self._lock:
            self._thread = None
            self.state = "idle"
            self._m_state.set(0)
