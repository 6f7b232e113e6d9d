"""The traced run: torch.profiler over the measured window, read back
from its Chrome trace.

The benchmark's own spans (``span``) name what the host is doing; they
are ``record_function`` ranges, so they land in the trace as user
annotations and cost nothing when the profiler is off. From the trace
this module takes:

- ``busy_s``: the union of the device's kernel, copy and set intervals
  inside the window;
- ``window_s``: the length of the ``bench.window`` span;
- device seconds by kernel name (for the rooflines);
- idle gaps of the device inside the window, each named by the
  innermost benchmark span and the innermost host operation at its
  middle, summed by that name.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

WINDOW = "bench.window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset", "memcpy", "memset")
#: idle gaps shorter than this are counted in the idle share but not named
_NAMED_GAP_US = 5.0


@contextlib.contextmanager
def span(name: str):
    """A benchmark span: a ``record_function`` range named ``bench.<name>``."""
    from torch.profiler import record_function

    with record_function(f"bench.{name}"):
        yield


class Trace:
    """What the benchmark reads from one profiled window."""

    def __init__(self, events: list) -> None:
        self.window: Optional[Tuple[float, float]] = None
        dev: List[Tuple[float, float, str]] = []
        self.spans: List[Tuple[float, float, str]] = []
        self.ops: List[Tuple[float, float, str]] = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = str(e.get("cat", "")).lower()
            t0 = float(e["ts"])
            t1 = t0 + float(e["dur"])
            name = str(e.get("name", ""))
            if cat in _DEVICE_CATS:
                dev.append((t0, t1, name))
            elif cat == "user_annotation":
                if name == WINDOW:
                    self.window = (t0, t1)
                elif name.startswith("bench."):
                    self.spans.append((t0, t1, name[len("bench."):]))
            elif cat in ("cpu_op", "cuda_runtime", "cuda_driver"):
                self.ops.append((t0, t1, name))
        if self.window is None:
            lo = min((t for t, _, _ in dev), default=0.0)
            hi = max((t for _, t, _ in dev), default=0.0)
            self.window = (lo, hi)
        w0, w1 = self.window
        self.device = sorted((max(a, w0), min(b, w1), n) for a, b, n in dev
                             if b > w0 and a < w1)
        self.spans.sort()
        self.ops.sort()

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for a, b, _ in self.device:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def kernel_seconds(self, substrings) -> float:
        """Device seconds of every kernel whose name holds one of
        ``substrings``."""
        return sum(b - a for a, b, n in self.device
                   if any(s in n for s in substrings)) * 1e-6

    def device_ops(self, top: int = 10) -> List[list]:
        by: Dict[str, float] = defaultdict(float)
        for a, b, n in self.device:
            by[n[:160]] += (b - a) * 1e-6
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])[:top]]

    @staticmethod
    def _innermost(intervals, starts, t: float, look: int = 64) -> str:
        i = bisect.bisect_right(starts, t) - 1
        best = None
        for j in range(i, max(i - look, -1), -1):
            a, b, n = intervals[j]
            if a <= t <= b and (best is None or a > best[0]):
                best = (a, n)
        return best[1] if best else "-"

    def idle_gaps(self, top: int = 10) -> List[list]:
        """Idle seconds of the device in the window, summed by what the
        host was doing at each gap's middle: ``<benchmark span> / <host op>``."""
        w0, w1 = self.window
        busy = self.busy_intervals()
        edges = [w0] + [x for ab in busy for x in ab] + [w1]
        span_starts = [a for a, _, _ in self.spans]
        op_starts = [a for a, _, _ in self.ops]
        by: Dict[str, float] = defaultdict(float)
        for a, b in zip(edges[0::2], edges[1::2]):
            if b - a < _NAMED_GAP_US:
                continue
            mid = 0.5 * (a + b)
            name = (f"{self._innermost(self.spans, span_starts, mid)} / "
                    f"{self._innermost(self.ops, op_starts, mid)}")
            by[name[:160]] += (b - a) * 1e-6
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])[:top]]


class Profiler:
    """torch.profiler around the window when ``enabled``; ``trace`` holds
    the :class:`Trace` once it has stopped."""

    def __init__(self, enabled: bool, path: str) -> None:
        self.enabled, self.path = enabled, path
        self.trace: Optional[Trace] = None
        self._prof = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            import torch

            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
        return False

    def read(self) -> Optional[Trace]:
        """Export the trace, parse it, delete the file."""
        if self._prof is None:
            return None
        self._prof.export_chrome_trace(self.path)
        self._prof = None
        try:
            with open(self.path) as f:
                doc = json.load(f)
        finally:
            os.unlink(self.path)
        events = doc["traceEvents"] if isinstance(doc, dict) else doc
        self.trace = Trace(events)
        return self.trace
