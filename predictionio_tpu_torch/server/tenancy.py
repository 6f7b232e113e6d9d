"""Multi-tenant QoS primitives: the port's copy of the JAX package's
``server/tenancy.py``.

``TokenBucket``
    A rate+burst bucket with a computed ``retry_after``.

``TenantQuotas``
    The policy store: a ``quotas.json`` next to the event data with
    per-app overrides over fleet-wide defaults, hot-reloaded by mtime,
    in the JAX package's format (either package reads what the other
    wrote). Arms the ``tenant.quota.exhausted`` fault site.

``FairInflight``
    Weighted-fair admission under the engine server's ``max_inflight``:
    while the server has headroom every tenant is admitted, but at
    saturation a tenant is admitted only up to its weighted share, so
    the burster sheds first and quiet tenants keep their seats.

The engine server uses ``FairInflight`` with weights from
``TenantQuotas``; the event server's ingest quotas and the ``app quota``
verb come with the rest of tenancy.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Dict, Optional, Tuple

from predictionio_tpu_torch.utils import faults
from predictionio_tpu_torch.utils.atomic_write import atomic_write_text

QUOTAS_FILENAME = "quotas.json"

#: fleet-wide policy applied to any app without an explicit override.
#: rate=0 means "unlimited" (no bucket maintained), which keeps the
#: zero-config single-tenant deployment byte-identical to before.
DEFAULTS = {
    "rate": 0.0,           # ingest events/second sustained (0 = unlimited)
    "burst": 0.0,          # ingest bucket depth (0 = rate for 1s, min 1)
    "weight": 1.0,         # share of engine-server inflight at saturation
    "writer_shards": 1,    # ACTIVE-segment writer shards per namespace
    "deadline_ms": 0.0,    # router deadline cap for this app (0 = router default)
}


class TokenBucket:
    """Rate+burst token bucket with a computed backoff hint.

    ``take(n)`` is all-or-nothing; on refusal ``retry_after(n)`` says
    how long until ``n`` tokens will have accrued at the steady rate —
    the honest Retry-After for a 429, proportional to the deficit
    rather than a constant.
    """

    def __init__(self, rate: float, burst: float,
                 clock=time.monotonic) -> None:
        self.rate = float(rate)
        self.burst = max(float(burst), 1.0)
        self._clock = clock
        self._tokens = self.burst
        self._last = clock()
        self._lock = threading.Lock()

    def _refill_locked(self, now: float) -> None:
        # caller holds self._lock
        if now > self._last:
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last) * self.rate)
            self._last = now

    def take(self, n: float = 1.0) -> bool:
        with self._lock:
            self._refill_locked(self._clock())
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def retry_after(self, n: float = 1.0) -> float:
        """Seconds until ``n`` tokens will be available (>= 0.05)."""
        with self._lock:
            self._refill_locked(self._clock())
            deficit = n - self._tokens
        if deficit <= 0 or self.rate <= 0:
            return 0.05
        return max(0.05, deficit / self.rate)


class TenantQuotas:
    """Per-app QoS policy: quotas.json defaults + overrides, hot-reloaded.

    File shape (all fields optional; see ``DEFAULTS``)::

        {"defaults": {"rate": 500, "burst": 1000, "weight": 1,
                      "writer_shards": 1},
         "apps": {"7": {"rate": 50, "burst": 100, "weight": 0.5}}}

    ``admit(app_id, n)`` is the ingest gate: it charges ``n`` events
    against the app's bucket and, on refusal, returns the computed
    Retry-After.  Buckets are created lazily and survive reloads so a
    quota *edit* does not hand a burster a fresh burst allowance
    unless its rate/burst actually changed.
    """

    def __init__(self, path: Optional[str] = None,
                 defaults: Optional[Dict] = None,
                 clock=time.monotonic) -> None:
        self.path = path
        self._clock = clock
        self._lock = threading.Lock()
        self._defaults = dict(DEFAULTS)
        if defaults:
            self._defaults.update(defaults)
        self._apps: Dict[str, Dict] = {}
        self._buckets: Dict[str, TokenBucket] = {}
        self._mtime: float = -1.0
        self._next_check = 0.0
        self._reload_locked()

    # -- policy file ----------------------------------------------------

    @staticmethod
    def for_home(home: str, **kw) -> "TenantQuotas":
        return TenantQuotas(os.path.join(home, QUOTAS_FILENAME), **kw)

    def _reload_locked(self) -> None:
        if not self.path:
            return
        try:
            mtime = os.stat(self.path).st_mtime
        except OSError:
            mtime = -1.0
        if mtime == self._mtime:
            return
        self._mtime = mtime
        apps: Dict[str, Dict] = {}
        defaults = dict(DEFAULTS)
        if mtime >= 0:
            try:
                with open(self.path, "r", encoding="utf-8") as f:
                    doc = json.load(f)
                defaults.update(doc.get("defaults") or {})
                for app, over in (doc.get("apps") or {}).items():
                    apps[str(app)] = dict(over)
            except (OSError, ValueError):
                # a torn/garbled policy file must never take ingest
                # down; keep the previous policy until it parses again
                return
        self._defaults = defaults
        self._apps = apps
        # rebuild buckets only where the effective rate/burst changed
        for app in list(self._buckets):
            rate, burst = self._rate_burst_locked(app)
            b = self._buckets[app]
            if rate <= 0:
                del self._buckets[app]
            elif (b.rate, b.burst) != (rate, burst):
                self._buckets[app] = TokenBucket(rate, burst,
                                                 clock=self._clock)

    def _maybe_reload(self) -> None:
        # throttle the mtime probe: the gate sits on the per-event hot
        # path, so a policy edit lands within ~1s, not instantly
        now = self._clock()
        if now < self._next_check:
            return
        with self._lock:
            self._next_check = now + 1.0
            self._reload_locked()

    def set_quota(self, app_id: str, **fields) -> Dict:
        """Persist an override for ``app_id`` (the ``pio apps quota``
        verb).  Passing ``None`` for a field clears that override."""
        doc = {"defaults": {}, "apps": {}}
        if self.path and os.path.exists(self.path):
            try:
                with open(self.path, "r", encoding="utf-8") as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                pass
        doc.setdefault("apps", {})
        over = dict(doc["apps"].get(str(app_id)) or {})
        for k, v in fields.items():
            if k not in DEFAULTS:
                raise ValueError(f"unknown quota field {k!r} "
                                 f"(expected one of {sorted(DEFAULTS)})")
            if v is None:
                over.pop(k, None)
            else:
                over[k] = v
        if over:
            doc["apps"][str(app_id)] = over
        else:
            doc["apps"].pop(str(app_id), None)
        if self.path:
            atomic_write_text(self.path,
                              json.dumps(doc, indent=2, sort_keys=True))
        with self._lock:
            self._mtime = -2.0  # force re-read on next lookup
            self._reload_locked()
        return over

    # -- lookups --------------------------------------------------------

    def _field(self, app_id: str, key: str):
        over = self._apps.get(str(app_id))
        if over and key in over:
            return over[key]
        return self._defaults[key]

    def _rate_burst_locked(self, app_id: str) -> Tuple[float, float]:
        rate = float(self._field(app_id, "rate"))
        burst = float(self._field(app_id, "burst"))
        if burst <= 0:
            burst = max(rate, 1.0)
        return rate, burst

    def weight(self, app_id: str) -> float:
        self._maybe_reload()
        with self._lock:
            return max(float(self._field(app_id, "weight")), 0.0)

    def writer_shards(self, app_id: str) -> int:
        self._maybe_reload()
        with self._lock:
            return max(int(self._field(app_id, "writer_shards")), 1)

    def deadline_ms(self, app_id: str) -> float:
        """Router deadline cap for this app; 0 means "router default"."""
        self._maybe_reload()
        with self._lock:
            return max(float(self._field(app_id, "deadline_ms")), 0.0)

    def describe(self, app_id: str) -> Dict:
        """Effective policy for one app (CLI ``show`` output)."""
        self._maybe_reload()
        with self._lock:
            rate, burst = self._rate_burst_locked(app_id)
            return {"rate": rate, "burst": burst,
                    "weight": float(self._field(app_id, "weight")),
                    "writer_shards": int(self._field(app_id,
                                                     "writer_shards")),
                    "deadline_ms": float(self._field(app_id,
                                                     "deadline_ms"))}

    # -- the ingest gate ------------------------------------------------

    def admit(self, app_id: str, n: int = 1) -> Tuple[bool, float]:
        """Charge ``n`` events to ``app_id``; returns ``(ok,
        retry_after_seconds)``.  Unlimited apps (rate 0) always pass
        without a bucket."""
        self._maybe_reload()
        app = str(app_id)
        with self._lock:
            rate, burst = self._rate_burst_locked(app)
            bucket = self._buckets.get(app)
            if rate <= 0:
                bucket = None
            elif bucket is None:
                bucket = self._buckets[app] = TokenBucket(
                    rate, burst, clock=self._clock)
        try:
            # chaos drill: an armed error here empties the bucket —
            # the tenant sees its own 429 + Retry-After on demand
            faults.inject("tenant.quota.exhausted")
        except faults.FaultError:
            if bucket is None:
                return False, 1.0
            return False, bucket.retry_after(n)
        if bucket is None or bucket.take(n):
            return True, 0.0
        return False, bucket.retry_after(n)


class FairInflight:
    """Weighted-fair admission under a single global inflight cap.

    Two gates, both hard: the global ``limit`` (never exceeded, so the
    backend sees exactly the concurrency it was sized for) and a
    per-app cap at the app's weighted share of that limit, computed
    over the *currently active* tenant set.  With one tenant active
    its share IS the limit, so the single-tenant deployment behaves
    exactly as before; under contention the tenant over its share —
    the burster — is the one shed, and it can never monopolize the cap
    between other tenants' arrivals.  Ceiling rounding makes the
    shares sum to at least the limit, so the cap stays reachable under
    full contention.

    The active set is "apps seen in the last ``active_window``
    seconds": weights of long-idle tenants stop diluting the shares of
    the tenants actually present.

    Loop-thread-only by design (matches ``EngineServer._inflight``):
    acquire/release happen before any await on the server's event
    loop, so no lock is taken.
    """

    def __init__(self, limit: int,
                 weight_of=None,
                 active_window: float = 5.0,
                 clock=time.monotonic) -> None:
        self.limit = int(limit)
        self._weight_of = weight_of or (lambda app: 1.0)
        self.active_window = float(active_window)
        self._clock = clock
        self._inflight: Dict[str, int] = {}
        self._last_seen: Dict[str, float] = {}
        self.total = 0

    def share(self, app_id: str) -> int:
        """This app's current fair share of ``limit`` (>= 1)."""
        now = self._clock()
        horizon = now - self.active_window
        total_w = 0.0
        for app, seen in list(self._last_seen.items()):
            if seen < horizon and not self._inflight.get(app):
                del self._last_seen[app]
                continue
            total_w += max(self._weight_of(app), 0.0)
        w = max(self._weight_of(str(app_id)), 0.0)
        if str(app_id) not in self._last_seen:
            total_w += w
        if total_w <= 0 or w <= 0:
            return 1
        return max(1, int(math.ceil(self.limit * w / total_w)))

    def try_acquire(self, app_id: str) -> bool:
        app = str(app_id)
        self._last_seen[app] = self._clock()
        if self.limit:
            if self.total >= self.limit:
                return False
            if self._inflight.get(app, 0) >= self.share(app):
                return False
        self._inflight[app] = self._inflight.get(app, 0) + 1
        self.total += 1
        return True

    def release(self, app_id: str) -> None:
        app = str(app_id)
        n = self._inflight.get(app, 0)
        if n <= 1:
            self._inflight.pop(app, None)
        else:
            self._inflight[app] = n - 1
        self.total = max(0, self.total - 1)

    def inflight(self, app_id: Optional[str] = None) -> int:
        if app_id is None:
            return self.total
        return self._inflight.get(str(app_id), 0)

    def snapshot(self) -> Dict[str, int]:
        return dict(self._inflight)
