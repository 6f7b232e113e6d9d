"""Prometheus-style metrics: the subset the serving path records into.

Dependency-free counters, gauges and histograms behind a get-or-create
:class:`Registry`, with the JAX package's metric names, so one scrape
layout reads both packages.
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


class Gauge:
    """A value that goes up AND down. ``set`` is last-write-wins."""

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


class Histogram:
    """One bucket-counts series per label tuple. ``observe`` takes an
    optional trace-id exemplar; the last one per (labels, bucket) is
    kept so a latency bucket can name a concrete trace."""

    def __init__(self, name: str, help: str,
                 buckets: Sequence[float] = _DEFAULT_BUCKETS,
                 labelnames: Sequence[str] = ()) -> None:
        self.name, self.help = name, help
        self.buckets = tuple(sorted(buckets))
        self.labelnames = tuple(labelnames)
        self._counts: Dict[Tuple[str, ...], List[int]] = {}
        self._sums: Dict[Tuple[str, ...], float] = {}
        self._exemplars: Dict[Tuple[Tuple[str, ...], int],
                              Tuple[str, float]] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, labels: Sequence[str] = (),
                exemplar: Optional[str] = None) -> None:
        key = tuple(str(l) for l in labels)
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                counts = self._counts[key] = [0] * (len(self.buckets) + 1)
                self._sums[key] = 0.0
            counts[i] += 1
            self._sums[key] += value
            if exemplar:
                self._exemplars[(key, i)] = (exemplar, value)

    def sum_count(self, labels: Sequence[str] = ()) -> Tuple[float, int]:
        """(sum of observations, observation count) for one label set."""
        key = tuple(str(l) for l in labels)
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                return 0.0, 0
            return self._sums[key], sum(counts)


class Registry:
    """Get-or-create by name: re-instantiating a server reuses the
    existing metric family instead of splitting its counts."""

    def __init__(self) -> None:
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help: str, labelnames: Sequence[str],
             **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help,
                                              labelnames=labelnames, **kw)
            elif not isinstance(m, cls):
                raise ValueError(f"metric {name!r} already a {type(m).__name__}")
            elif m.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} already registered with labels "
                    f"{m.labelnames}, requested {tuple(labelnames)}")
            return m

    def counter(self, name: str, help: str,
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str,
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str,
                  buckets: Optional[Sequence[float]] = None,
                  labelnames: Sequence[str] = ()) -> Histogram:
        return self._get(Histogram, name, help, labelnames,
                         buckets=buckets or _DEFAULT_BUCKETS)


REGISTRY = Registry()
