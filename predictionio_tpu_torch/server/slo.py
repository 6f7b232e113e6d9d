"""Declarative SLOs with Google-SRE multi-window burn-rate alerts: the
port's copy of the JAX package's ``server/slo.py`` (the same math,
series names and ``conf/slo.json`` schema).

An SLO here is an *objective over history*: "99% of queries succeed",
"95% answer under a second". The raw material is the
:class:`~predictionio_tpu_torch.utils.timeseries.TimeSeriesStore` the router
already keeps (its own series plus the federated ``pio_fleet_*``
replica series), so evaluation is a pure in-process computation — no
external alerting stack.

Burn rate is error-budget spend speed: ``1.0`` means the budget lasts
exactly the SLO period, ``14.4`` means a 30-day budget gone in 2 days.
Alerts use the multi-window form (SRE workbook ch. 5): the **fast**
page fires only when every fast window (default 5 m *and* 1 h) burns
above its threshold (default 14.4) — the short window makes the alert
reset quickly, the long one keeps a blip from paging; the **slow**
ticket fires on the slow windows (default 6 h above 6.0). Evaluation
publishes ``pio_slo_burn_rate{slo,window}`` and
``pio_slo_alerting{slo}`` (0 = quiet, 1 = slow burn, 2 = fast burn),
the router folds a fast burn into ``/health`` as ``degraded``, and
``slo status`` renders the same numbers over HTTP.

Configuration is ``conf/slo.json`` (schema below, shipped example in
the repo); objectives can target any counter or histogram series by
name + label equality — per path, per app, per variant::

    {
      "windows":    {"fast": ["5m", "1h"], "slow": ["6h"]},
      "thresholds": {"fast": 14.4, "slow": 6.0},
      "slos": [
        {"name": "queries-availability", "type": "availability",
         "objective": 0.99,
         "series": "pio_probe_requests_total",
         "labels": {"path": "/queries.json"},
         "bad": {"outcome": "error"}},
        {"name": "queries-latency", "type": "latency",
         "objective": 0.95,
         "histogram": "pio_probe_seconds",
         "labels": {"path": "/queries.json"},
         "threshold_ms": 1000}
      ]
    }

``availability``: bad-event ratio = increase(series + ``bad`` labels)
/ increase(series) over the window. ``latency``: the slow ratio is
read from the histogram's cumulative buckets, with ``threshold_ms``
snapped DOWN to the nearest bucket bound (a conservative snap: the SLO
can only get stricter). A window with no events burns at 0 — with the
synthetic prober on, "no events" itself becomes impossible, which is
the point of probing.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from predictionio_tpu_torch.utils.metrics import REGISTRY, Registry
from predictionio_tpu_torch.utils.timeseries import (
    TimeSeriesStore,
    parse_duration,
    render_key,
)

DEFAULT_WINDOWS = {"fast": ("5m", "1h"), "slow": ("6h",)}
DEFAULT_THRESHOLDS = {"fast": 14.4, "slow": 6.0}

#: built-in objectives used when no conf/slo.json is found: the
#: synthetic prober's canary path must stay available and fast.
DEFAULT_CONFIG = {
    "windows": {"fast": ["5m", "1h"], "slow": ["6h"]},
    "thresholds": {"fast": 14.4, "slow": 6.0},
    "slos": [
        {"name": "queries-availability", "type": "availability",
         "objective": 0.99,
         "series": "pio_probe_requests_total",
         "labels": {"path": "/queries.json"},
         "bad": {"outcome": "error"}},
        {"name": "queries-latency", "type": "latency",
         "objective": 0.95,
         "histogram": "pio_probe_seconds",
         "labels": {"path": "/queries.json"},
         "threshold_ms": 1000},
    ],
}


@dataclass
class SloSpec:
    name: str
    type: str                       # "availability" | "latency"
    objective: float                # e.g. 0.99
    series: str = ""                # availability: counter series name
    histogram: str = ""             # latency: histogram base name
    labels: Dict[str, str] = field(default_factory=dict)
    bad: Dict[str, str] = field(default_factory=dict)
    threshold_ms: float = 0.0

    @property
    def budget(self) -> float:
        return max(1.0 - self.objective, 1e-9)


@dataclass
class SloStatus:
    name: str
    objective: float
    burn: Dict[str, float]          # window label -> burn rate
    fast_burn: bool
    slow_burn: bool

    @property
    def alerting(self) -> int:
        return 2 if self.fast_burn else (1 if self.slow_burn else 0)

    def to_json(self) -> Dict:
        return {"name": self.name, "objective": self.objective,
                "burnRate": {w: round(b, 4) for w, b in self.burn.items()},
                "fastBurn": self.fast_burn, "slowBurn": self.slow_burn,
                "alerting": self.alerting}


def _parse_spec(doc: Dict) -> SloSpec:
    name = doc.get("name") or ""
    typ = doc.get("type") or ""
    if not name or typ not in ("availability", "latency"):
        raise ValueError(f"slo needs a name and type "
                         f"availability|latency: {doc!r}")
    objective = float(doc.get("objective", 0.0))
    if not 0.0 < objective < 1.0:
        raise ValueError(f"slo {name!r}: objective must be in (0, 1)")
    spec = SloSpec(
        name=name, type=typ, objective=objective,
        series=doc.get("series", ""), histogram=doc.get("histogram", ""),
        labels={k: str(v) for k, v in (doc.get("labels") or {}).items()},
        bad={k: str(v) for k, v in (doc.get("bad") or {}).items()},
        threshold_ms=float(doc.get("threshold_ms", 0.0)))
    if typ == "availability" and (not spec.series or not spec.bad):
        raise ValueError(f"availability slo {name!r} needs series + bad")
    if typ == "latency" and (not spec.histogram or spec.threshold_ms <= 0):
        raise ValueError(f"latency slo {name!r} needs histogram + "
                         "threshold_ms")
    return spec


class SloEngine:
    """Evaluates every configured SLO over a TimeSeriesStore and
    publishes the burn-rate / alerting gauges."""

    def __init__(self, store: TimeSeriesStore, config: Optional[Dict] = None,
                 registry: Optional[Registry] = None) -> None:
        self.store = store
        registry = REGISTRY if registry is None else registry
        config = DEFAULT_CONFIG if config is None else config
        windows = {**DEFAULT_WINDOWS, **(config.get("windows") or {})}
        self.fast_windows = [(w, parse_duration(w)) for w in windows["fast"]]
        self.slow_windows = [(w, parse_duration(w)) for w in windows["slow"]]
        thresholds = {**DEFAULT_THRESHOLDS,
                      **(config.get("thresholds") or {})}
        self.fast_threshold = float(thresholds["fast"])
        self.slow_threshold = float(thresholds["slow"])
        self.specs = [_parse_spec(d) for d in config.get("slos", [])]
        self._m_burn = registry.gauge(
            "pio_slo_burn_rate",
            "Error-budget burn rate per SLO and window (1.0 = budget "
            "lasts exactly the SLO period)", ("slo", "window"))
        self._m_alerting = registry.gauge(
            "pio_slo_alerting",
            "SLO alert state: 0 quiet, 1 slow burn, 2 fast burn",
            ("slo",))
        self.last: List[SloStatus] = []
        #: fast-burn rising edge: SLO names that entered fast burn on
        #: the most recent evaluate() tick (the incident-capture
        #: trigger — a page that STAYS firing must not retrigger)
        self.newly_fast_burning: List[str] = []
        self._prev_fast: set = set()

    @classmethod
    def from_file(cls, path: str, store: TimeSeriesStore,
                  registry: Optional[Registry] = None) -> "SloEngine":
        with open(path, "r", encoding="utf-8") as f:
            return cls(store, json.load(f), registry=registry)

    # -- ratio evaluation ------------------------------------------------------

    def _bad_ratio(self, spec: SloSpec, window: float,
                   ts: Optional[float]) -> float:
        if spec.type == "availability":
            total = self.store.increase(
                render_key(spec.series, tuple(sorted(spec.labels.items()))),
                window, ts)
            if total <= 0:
                return 0.0
            bad_labels = {**spec.labels, **spec.bad}
            bad = self.store.increase(
                render_key(spec.series, tuple(sorted(bad_labels.items()))),
                window, ts)
            return min(1.0, bad / total)
        # latency: slow ratio from cumulative buckets, threshold
        # snapped down to the nearest bucket bound
        threshold = spec.threshold_ms / 1000.0
        total = self.store.increase(
            render_key(f"{spec.histogram}_count",
                       tuple(sorted(spec.labels.items()))), window, ts)
        if total <= 0:
            return 0.0
        bounds = set()
        for s in self.store._matching(f"{spec.histogram}_bucket",
                                      spec.labels):
            le = dict(s.labels).get("le")
            if le and le != "+Inf":
                bounds.add(float(le))
        usable = sorted(b for b in bounds if b <= threshold + 1e-12)
        if not usable:
            return 0.0      # every bucket is above the threshold: blind
        le_bound = usable[-1]
        good = 0.0
        for s in self.store._matching(f"{spec.histogram}_bucket",
                                      {**spec.labels}):
            have = dict(s.labels)
            if have.get("le") is None:
                continue
            if have["le"] != "+Inf" and \
                    abs(float(have["le"]) - le_bound) < 1e-12:
                good += self.store.increase(
                    render_key(s.name, s.labels), window, ts)
        return min(1.0, max(0.0, 1.0 - good / total))

    # -- evaluation ------------------------------------------------------------

    def evaluate(self, ts: Optional[float] = None) -> List[SloStatus]:
        out: List[SloStatus] = []
        for spec in self.specs:
            burn: Dict[str, float] = {}
            for label, seconds in self.fast_windows + self.slow_windows:
                ratio = self._bad_ratio(spec, seconds, ts)
                burn[label] = ratio / spec.budget
            fast = all(burn[w] > self.fast_threshold
                       for w, _ in self.fast_windows)
            slow = all(burn[w] > self.slow_threshold
                       for w, _ in self.slow_windows)
            status = SloStatus(spec.name, spec.objective, burn, fast, slow)
            for w, b in burn.items():
                self._m_burn.set(min(b, 1e6), (spec.name, w))
            self._m_alerting.set(status.alerting, (spec.name,))
            out.append(status)
        self.last = out
        now_fast = {s.name for s in out if s.fast_burn}
        self.newly_fast_burning = sorted(now_fast - self._prev_fast)
        self._prev_fast = now_fast
        return out

    def fast_burning(self) -> List[str]:
        return [s.name for s in self.last if s.fast_burn]

    def to_json(self) -> Dict:
        return {
            "windows": {"fast": [w for w, _ in self.fast_windows],
                        "slow": [w for w, _ in self.slow_windows]},
            "thresholds": {"fast": self.fast_threshold,
                           "slow": self.slow_threshold},
            "slos": [s.to_json() for s in self.last],
            "fastBurning": self.fast_burning(),
        }
