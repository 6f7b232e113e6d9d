"""Prometheus-style metrics: the port's copy of the JAX package's
``utils/metrics.py``.

Dependency-free counters, gauges and histograms behind a get-or-create
:class:`Registry`, and the text exposition format served at ``/metrics``
on the event server and the engine server. The metric names are the JAX
package's, so one scrape layout reads both packages.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Sequence, Tuple

_DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                    0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class Counter:
    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = ()) -> None:
        self.name, self.help = name, help
        self.labelnames = tuple(labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}
        self._lock = threading.Lock()

    def inc(self, labels: Sequence[str] = (), n: float = 1.0) -> None:
        key = tuple(str(l) for l in labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + n

    def get(self, labels: Sequence[str] = ()) -> float:
        key = tuple(str(l) for l in labels)
        with self._lock:
            return self._values.get(key, 0.0)

    def items(self) -> List[Tuple[Tuple[str, ...], float]]:
        """Snapshot of every (label values, value) pair — the scrape
        path the TSDB uses instead of parsing text exposition."""
        with self._lock:
            return sorted(self._values.items())

    def render(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} counter"]
        with self._lock:
            items = sorted(self._values.items())
        for key, v in items:
            out.append(f"{self.name}{_labels(self.labelnames, key)} {_num(v)}")
        return out


class Gauge:
    """A value that goes up AND down (queue depths, in-flight counts).
    ``set`` is last-write-wins; ``inc``/``dec`` adjust atomically."""

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = ()) -> None:
        self.name, self.help = name, help
        self.labelnames = tuple(labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}
        self._lock = threading.Lock()

    def set(self, value: float, labels: Sequence[str] = ()) -> None:
        key = tuple(str(l) for l in labels)
        with self._lock:
            self._values[key] = float(value)

    def inc(self, labels: Sequence[str] = (), n: float = 1.0) -> None:
        key = tuple(str(l) for l in labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + n

    def dec(self, labels: Sequence[str] = (), n: float = 1.0) -> None:
        self.inc(labels, -n)

    def get(self, labels: Sequence[str] = ()) -> float:
        key = tuple(str(l) for l in labels)
        with self._lock:
            return self._values.get(key, 0.0)

    def items(self) -> List[Tuple[Tuple[str, ...], float]]:
        with self._lock:
            return sorted(self._values.items())

    def render(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} gauge"]
        with self._lock:
            items = sorted(self._values.items())
        for key, v in items:
            out.append(f"{self.name}{_labels(self.labelnames, key)} {_num(v)}")
        return out


class Histogram:
    """Labelled like Counter/Gauge: one bucket-counts series per label
    tuple. ``observe`` also takes an optional trace-id **exemplar**;
    the last exemplar per (labels, bucket) is kept so a latency bucket
    can name a concrete trace to pull up in ``/traces``. Exemplars stay
    out of the text exposition (plain-Prometheus parsers reject the
    OpenMetrics ``#`` syntax) — read them via :meth:`exemplar`."""

    def __init__(self, name: str, help: str,
                 buckets: Sequence[float] = _DEFAULT_BUCKETS,
                 labelnames: Sequence[str] = ()) -> None:
        self.name, self.help = name, help
        self.buckets = tuple(sorted(buckets))
        self.labelnames = tuple(labelnames)
        self._counts: Dict[Tuple[str, ...], List[int]] = {}
        self._sums: Dict[Tuple[str, ...], float] = {}
        # (labels key, bucket index) -> (trace id, observed value)
        self._exemplars: Dict[Tuple[Tuple[str, ...], int],
                              Tuple[str, float]] = {}
        self._lock = threading.Lock()
        if not self.labelnames:
            # an unlabelled histogram exposes zeroed buckets from birth
            # (pre-labels behaviour); labelled series appear on first use
            self._counts[()] = [0] * (len(self.buckets) + 1)
            self._sums[()] = 0.0

    def _bucket_index(self, value: float) -> int:
        # smallest i with value <= buckets[i]; past the end = +Inf tail
        return bisect.bisect_left(self.buckets, value)

    def observe(self, value: float, labels: Sequence[str] = (),
                exemplar: Optional[str] = None) -> None:
        key = tuple(str(l) for l in labels)
        i = self._bucket_index(value)
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                counts = self._counts[key] = [0] * (len(self.buckets) + 1)
                self._sums[key] = 0.0
            counts[i] += 1
            self._sums[key] += value
            if exemplar:
                self._exemplars[(key, i)] = (exemplar, value)

    def exemplar(self, le: float | str,
                 labels: Sequence[str] = ()) -> Optional[Tuple[str, float]]:
        """Last (trace id, value) observed in the bucket whose upper
        bound is ``le`` (``"+Inf"`` for the tail), or None."""
        key = tuple(str(l) for l in labels)
        if le == "+Inf":
            i = len(self.buckets)
        else:
            try:
                i = self.buckets.index(float(le))
            except ValueError:
                return None
        with self._lock:
            return self._exemplars.get((key, i))

    def exemplars(self) -> List[Tuple[Tuple[str, ...], str, str, float]]:
        """Every retained bucket exemplar as ``(label values, le text,
        trace id, observed value)``, for a reader that does not know
        the bucket geometry up front."""
        with self._lock:
            snap = sorted(self._exemplars.items())
        out: List[Tuple[Tuple[str, ...], str, str, float]] = []
        for (key, i), (trace_id, value) in snap:
            le = "+Inf" if i >= len(self.buckets) else _num(self.buckets[i])
            out.append((key, le, trace_id, value))
        return out

    def sum_count(self, labels: Sequence[str] = ()) -> Tuple[float, int]:
        """(sum of observations, observation count) for one label set —
        zeroes when the series does not exist yet."""
        key = tuple(str(l) for l in labels)
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                return 0.0, 0
            return self._sums[key], sum(counts)

    def items(self) -> List[Tuple[Tuple[str, ...], List[int], float]]:
        """Snapshot of (label values, per-bucket counts, sum) per
        series; counts are NON-cumulative, one slot per bucket plus the
        +Inf tail."""
        with self._lock:
            return sorted((k, list(c), self._sums[k])
                          for k, c in self._counts.items())

    def render(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} histogram"]
        with self._lock:
            items = sorted((k, list(c), self._sums[k])
                           for k, c in self._counts.items())
        for key, counts, total_sum in items:
            base = list(zip(self.labelnames, key))
            cum = 0
            for b, c in zip(self.buckets, counts):
                cum += c
                out.append(f"{self.name}_bucket"
                           f"{_label_str(base + [('le', _num(b))])} {cum}")
            cum += counts[-1]
            out.append(f"{self.name}_bucket"
                       f"{_label_str(base + [('le', '+Inf')])} {cum}")
            out.append(f"{self.name}_sum{_label_str(base)} {_num(total_sum)}")
            out.append(f"{self.name}_count{_label_str(base)} {cum}")
        return out


class Registry:
    """Get-or-create by name: re-instantiating a server must reuse the
    existing metric family — duplicate families are a Prometheus scrape
    error and would split counts between live and dead instances."""

    def __init__(self) -> None:
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help: str,
                labelnames: Sequence[str] = ()) -> Counter:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = Counter(name, help, labelnames)
            elif not isinstance(m, Counter):
                raise ValueError(f"metric {name!r} already a {type(m).__name__}")
            elif m.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} already registered with labels "
                    f"{m.labelnames}, requested {tuple(labelnames)}")
            return m

    def gauge(self, name: str, help: str,
              labelnames: Sequence[str] = ()) -> Gauge:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = Gauge(name, help, labelnames)
            elif not isinstance(m, Gauge):
                raise ValueError(f"metric {name!r} already a {type(m).__name__}")
            elif m.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} already registered with labels "
                    f"{m.labelnames}, requested {tuple(labelnames)}")
            return m

    def histogram(self, name: str, help: str,
                  buckets: Optional[Sequence[float]] = None,
                  labelnames: Sequence[str] = ()) -> Histogram:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = Histogram(
                    name, help, buckets or _DEFAULT_BUCKETS, labelnames)
            elif not isinstance(m, Histogram):
                raise ValueError(f"metric {name!r} already a {type(m).__name__}")
            elif buckets is not None and m.buckets != tuple(sorted(buckets)):
                raise ValueError(
                    f"metric {name!r} already registered with buckets "
                    f"{m.buckets}, requested {tuple(sorted(buckets))}")
            elif m.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} already registered with labels "
                    f"{m.labelnames}, requested {tuple(labelnames)}")
            return m

    def metrics(self) -> List[object]:
        """Snapshot of every registered metric object (scrape path)."""
        with self._lock:
            return list(self._metrics.values())

    def render(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        lines: List[str] = []
        for m in metrics:
            lines += m.render()  # type: ignore[attr-defined]
        return "\n".join(lines) + "\n"


def _labels(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    pairs = ",".join(f'{n}="{v}"' for n, v in zip(names, values))
    return "{" + pairs + "}"


def _label_str(pairs: Sequence[Tuple[str, str]]) -> str:
    if not pairs:
        return ""
    return "{" + ",".join(f'{n}="{v}"' for n, v in pairs) + "}"


def _num(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(float(v))


REGISTRY = Registry()


def build_info(instance: str) -> Gauge:
    """Emit the ``pio_build_info`` identity gauge for this process:
    always-1, with the running version and the server's instance uid as
    labels. Federation turns it into a per-version fleet census — a
    half-finished rollout is one ``sum by (version)`` away."""
    from predictionio_tpu_torch import __version__

    g = REGISTRY.gauge(
        "pio_build_info",
        "Build/identity info (value is always 1; the labels carry it)",
        ("version", "instance"))
    g.set(1, (__version__, instance))
    return g
