"""Embedded ring-buffer time-series store over the metrics Registry: the
port's copy of the JAX package's ``utils/timeseries.py``.

Every series on ``/metrics`` is a point-in-time snapshot; this module
keeps history in-process by scraping the local
:class:`~predictionio_tpu_torch.utils.metrics.Registry` on an interval
into fixed-size ring buffers:

- two downsampled **retention tiers** (default 10 s resolution for 1 h,
  2 min for 24 h; a query is served from the finest tier whose retention
  covers its window);
- **counter-reset handling**: :meth:`TimeSeriesStore.increase` treats a
  negative delta as a reset, the Prometheus ``rate()`` contract;
- **histogram quantiles over any window**: bucket series are stored
  cumulatively (one series per ``le``), so
  :meth:`TimeSeriesStore.quantile` merges buckets across label sets (and,
  via :meth:`record`, across replicas) and interpolates like
  ``histogram_quantile()``.

Exposed as ``GET /metrics/history?series=&window=`` on the event server
and the engine server. The scrape loop carries the ``tsdb.scrape.stall``
fault site: a wedged scraper degrades history, never serving
(``pio_tsdb_scrapes_total{result}`` counts outcomes). The store is
clock-injectable.
"""

from __future__ import annotations

import math
import re
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from predictionio_tpu_torch.utils.faults import FAULTS
from predictionio_tpu_torch.utils.metrics import (
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    Registry,
    _num,
)

#: (resolution seconds, slot count) per tier: 10 s × 360 = 1 h,
#: 120 s × 720 = 24 h
DEFAULT_TIERS: Tuple[Tuple[float, int], ...] = ((10.0, 360), (120.0, 720))


def scaled_tiers(interval: float) -> Tuple[Tuple[float, int], ...]:
    """Retention tiers matched to a scrape cadence: the fine tier's
    resolution follows the interval when it is faster than the default
    10 s (the ring downsamples by last-write-wins, so a finer scrape
    into a 10 s tier would keep one slot per 10 s and short burn-rate
    windows would never see two samples). Slot count stays 360, so a
    faster cadence trades retention for resolution."""
    return ((min(10.0, max(0.05, interval)), 360), (120.0, 720))

Sample = Tuple[float, float]
LabelSet = Tuple[Tuple[str, str], ...]

_SELECTOR_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>[^}]*)\})?$')
_LABEL_RE = re.compile(r'\s*([a-zA-Z_][a-zA-Z0-9_]*)\s*=\s*"([^"]*)"\s*')
_DURATION_RE = re.compile(r'^(\d+(?:\.\d+)?)(ms|s|m|h|d)?$')
_DURATION_UNITS = {"ms": 0.001, "s": 1.0, "m": 60.0, "h": 3600.0,
                   "d": 86400.0, None: 1.0}


def parse_duration(text: str) -> float:
    """``"300"``/``"5m"``/``"1h"`` → seconds (floats allowed)."""
    m = _DURATION_RE.match(text.strip())
    if not m:
        raise ValueError(f"bad duration {text!r} (want e.g. 300, 5m, 1h)")
    return float(m.group(1)) * _DURATION_UNITS[m.group(2)]


def parse_selector(selector: str) -> Tuple[str, Dict[str, str]]:
    """``name`` or ``name{k="v",…}`` → (name, label equality filter)."""
    m = _SELECTOR_RE.match(selector.strip())
    if not m:
        raise ValueError(f"bad series selector {selector!r}")
    labels: Dict[str, str] = {}
    body = m.group("labels")
    if body:
        for part in body.split(","):
            lm = _LABEL_RE.match(part)
            if not lm:
                raise ValueError(f"bad label matcher {part!r} in {selector!r}")
            labels[lm.group(1)] = lm.group(2)
    return m.group("name"), labels


def render_key(name: str, labels: LabelSet) -> str:
    if not labels:
        return name
    return name + "{" + ",".join(f'{k}="{v}"' for k, v in labels) + "}"


_EXPO_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$')


def parse_prom_text(text: str) -> List[Tuple[str, Dict[str, str], float]]:
    """Prometheus text exposition → ``(name, labels, value)`` triples.
    Comments and malformed lines are skipped, never raised — one bad
    line in a replica's scrape must not fail fleet federation
    wholesale."""
    out: List[Tuple[str, Dict[str, str], float]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _EXPO_RE.match(line)
        if not m:
            continue
        try:
            value = float(m.group(3))
        except ValueError:
            continue
        labels = {k: v for k, v in _LABEL_RE.findall(m.group(2) or "")}
        out.append((m.group(1), labels, value))
    return out


def history_payload(store: "TimeSeriesStore", selector: str,
                    window_text: str) -> Tuple[int, Dict]:
    """The shared ``GET /metrics/history?series=&window=`` contract:
    (HTTP status, JSON payload). Without a selector the answer is the
    resident series names — discoverability beats a bare 400."""
    if not selector:
        return 400, {"message": "series parameter required",
                     "names": store.names()}
    try:
        window = parse_duration(window_text or "5m")
        data = store.query(selector, window)
    except ValueError as e:
        return 400, {"message": str(e)}
    return 200, {
        "windowSeconds": window,
        "series": {key: [[round(t, 3), v] for t, v in samples]
                   for key, samples in data.items()},
    }


class _Ring:
    """One retention tier of one series: a deque of (ts, value) at a
    fixed resolution — samples landing inside the same resolution step
    overwrite (last-write-wins downsampling, correct for cumulative
    counters and point-in-time gauges alike)."""

    __slots__ = ("resolution", "samples")

    def __init__(self, resolution: float, slots: int) -> None:
        self.resolution = resolution
        self.samples: Deque[Sample] = deque(maxlen=slots)

    def append(self, ts: float, value: float) -> None:
        if self.samples and ts - self.samples[-1][0] < self.resolution:
            self.samples[-1] = (ts, value)
        else:
            self.samples.append((ts, value))

    def window(self, start: float) -> List[Sample]:
        return [s for s in self.samples if s[0] >= start]


class _Series:
    __slots__ = ("name", "labels", "rings")

    def __init__(self, name: str, labels: LabelSet,
                 tiers: Sequence[Tuple[float, int]]) -> None:
        self.name = name
        self.labels = labels
        self.rings = [_Ring(res, slots) for res, slots in tiers]


class TimeSeriesStore:
    """Ring-buffer TSDB fed by :meth:`scrape` (the local registry) and
    :meth:`record` (externally scraped samples — fleet federation)."""

    def __init__(self, registry: Optional[Registry] = None,
                 tiers: Sequence[Tuple[float, int]] = DEFAULT_TIERS,
                 clock: Callable[[], float] = time.time) -> None:
        if not tiers:
            raise ValueError("need at least one retention tier")
        self.registry = REGISTRY if registry is None else registry
        self.tiers = tuple(tiers)
        self.clock = clock
        self._series: Dict[Tuple[str, LabelSet], _Series] = {}
        self._lock = threading.Lock()

    # -- ingestion -------------------------------------------------------------

    def record(self, name: str, labels: Dict[str, str], value: float,
               ts: Optional[float] = None) -> None:
        """Record one sample into every tier."""
        if ts is None:
            ts = self.clock()
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = self._series[key] = _Series(name, key[1], self.tiers)
        for ring in series.rings:
            ring.append(ts, float(value))

    def scrape(self, ts: Optional[float] = None) -> int:
        """One scrape pass over the local registry: counters and gauges
        sample as-is; histograms sample as cumulative ``_bucket{le=}``
        series plus ``_sum``/``_count`` — the shape quantile evaluation
        and federation merging both consume. Returns samples written."""
        if ts is None:
            ts = self.clock()
        n = 0
        for metric in self.registry.metrics():
            if isinstance(metric, (Counter, Gauge)):
                names = metric.labelnames
                for key, value in metric.items():
                    self.record(metric.name, dict(zip(names, key)), value, ts)
                    n += 1
            elif isinstance(metric, Histogram):
                names = metric.labelnames
                for key, counts, total_sum in metric.items():
                    base = dict(zip(names, key))
                    cum = 0
                    for bound, c in zip(metric.buckets, counts):
                        cum += c
                        self.record(f"{metric.name}_bucket",
                                    {**base, "le": _num(bound)}, cum, ts)
                    cum += counts[-1]
                    self.record(f"{metric.name}_bucket",
                                {**base, "le": "+Inf"}, cum, ts)
                    self.record(f"{metric.name}_sum", base, total_sum, ts)
                    self.record(f"{metric.name}_count", base, cum, ts)
                    n += len(metric.buckets) + 3
        return n

    # -- querying --------------------------------------------------------------

    def _tier_for(self, window: float) -> int:
        for i, (res, slots) in enumerate(self.tiers):
            if window <= res * slots:
                return i
        return len(self.tiers) - 1

    def _matching(self, name: str,
                  label_filter: Dict[str, str]) -> List[_Series]:
        with self._lock:
            series = list(self._series.values())
        out = []
        for s in series:
            if s.name != name:
                continue
            have = dict(s.labels)
            if all(have.get(k) == v for k, v in label_filter.items()):
                out.append(s)
        return out

    def names(self) -> List[str]:
        with self._lock:
            return sorted({s.name for s in self._series.values()})

    def query(self, selector: str, window: float,
              ts: Optional[float] = None) -> Dict[str, List[Sample]]:
        """Raw samples per matching series key over the window, from
        the finest tier whose retention covers it."""
        if ts is None:
            ts = self.clock()
        name, label_filter = parse_selector(selector)
        tier = self._tier_for(window)
        start = ts - window
        return {render_key(s.name, s.labels): s.rings[tier].window(start)
                for s in self._matching(name, label_filter)}

    def increase(self, selector: str, window: float,
                 ts: Optional[float] = None) -> float:
        """Counter increase over the window, reset-aware, summed over
        matching series: a sample below its predecessor is a process
        restart, and the post-reset value is the true delta."""
        total = 0.0
        for samples in self.query(selector, window, ts).values():
            for (_, prev), (_, cur) in zip(samples, samples[1:]):
                total += cur if cur < prev else cur - prev
        return total

    def rate(self, selector: str, window: float,
             ts: Optional[float] = None) -> float:
        """Per-second rate of increase over the window (0.0 with fewer
        than two samples — no history, no claim)."""
        per_second = 0.0
        for samples in self.query(selector, window, ts).values():
            if len(samples) < 2:
                continue
            elapsed = samples[-1][0] - samples[0][0]
            if elapsed <= 0:
                continue
            inc = 0.0
            for (_, prev), (_, cur) in zip(samples, samples[1:]):
                inc += cur if cur < prev else cur - prev
            per_second += inc / elapsed
        return per_second

    def quantile(self, name: str, q: float, window: float,
                 label_filter: Optional[Dict[str, str]] = None,
                 ts: Optional[float] = None) -> Optional[float]:
        """``histogram_quantile(q, increase(name_bucket[window]))``:
        per-``le`` increases are merged (summed) across every matching
        label set — and therefore across replicas when the buckets were
        federated in via :meth:`record` — then linearly interpolated
        within the winning bucket. None when no observations landed in
        the window."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        selector = f"{name}_bucket"
        by_le: Dict[float, float] = {}
        filt = dict(label_filter or {})
        tsv = self.clock() if ts is None else ts
        for s in self._matching(selector, filt):
            le_str = dict(s.labels).get("le")
            if le_str is None:
                continue
            le = math.inf if le_str == "+Inf" else float(le_str)
            key = render_key(s.name, s.labels)
            inc = self.increase(key, window, tsv)
            by_le[le] = by_le.get(le, 0.0) + inc
        if not by_le or math.inf not in by_le:
            return None
        total = by_le[math.inf]
        if total <= 0:
            return None
        target = q * total
        bounds = sorted(by_le)
        cum = 0.0
        prev_bound = 0.0
        finite = [b for b in bounds if b != math.inf]
        for bound in bounds:
            cum = by_le[bound]
            if cum >= target:
                if bound == math.inf:
                    # quantile beyond the last finite bucket: report the
                    # highest finite bound (histogram_quantile contract)
                    return finite[-1] if finite else None
                prev_cum = 0.0
                i = bounds.index(bound)
                if i > 0:
                    prev_bound = bounds[i - 1]
                    prev_cum = by_le[prev_bound]
                else:
                    prev_bound = 0.0
                span = cum - prev_cum
                if span <= 0:
                    return bound
                return prev_bound + (bound - prev_bound) \
                    * (target - prev_cum) / span
        return finite[-1] if finite else None


# -- scrape loop ---------------------------------------------------------------

_m_scrapes = REGISTRY.counter(
    "pio_tsdb_scrapes_total",
    "TSDB scrape ticks by result (error = a tick failed or was "
    "fault-injected; history gets a gap, serving is untouched)",
    ("result",))
_m_series = REGISTRY.gauge(
    "pio_tsdb_series", "Distinct series resident in the TSDB ring buffers")


async def scrape_loop(store: TimeSeriesStore, interval: float) -> None:
    """The per-server background scraper task: tick, inject, scrape,
    count. Fail-open — an error (or an armed ``tsdb.scrape.stall`` plan)
    costs one tick of history, never the serving path."""
    import asyncio

    while True:
        await asyncio.sleep(interval)
        try:
            await FAULTS.ahit("tsdb.scrape.stall")
            store.scrape()
            with store._lock:
                _m_series.set(len(store._series))
            _m_scrapes.inc(("ok",))
        except asyncio.CancelledError:
            raise
        except Exception:
            _m_scrapes.inc(("error",))
