"""Distributed ``pio eval``: the candidate grid as bucketed sweep programs.

The port's counterpart of the JAX package's ``core/sweep.py``. The
serial grid (``controller/evaluation.py``) trains every candidate and
scores the held-out fold one Python query at a time. Here candidates are
grouped by pipeline prefix exactly like ``Engine.eval_batch``; each
algorithm contributes train+score programs (``Algorithm.sweep_programs``)
bucketed by geometry; a bucket's hyperparameter rows are STACKED into one
``(k, H)`` float32 array snapped up ``GRID_LADDER`` (server/aot.py's
padding idiom: pad rows repeat row 0 and their results are sliced off),
and the bucket's program is built once per run (a "compile") and run
over the stacked rows on the device, scoring on the device too.

The JAX package vmaps a bucket into one XLA program; the port runs its
rows one after another over the one uploaded layout, each through the
same kernel launches as ``pio train``. With ``sweep_shards > 1`` the rows
are dealt out over the slots of a ``"shards"`` mesh
(``parallel/mesh.shards_mesh``): each slot's sub-grid runs on that slot's
device, and the stats come back in row order. A pool too small for the
mesh warns and runs unsharded, as the JAX package does. Scores come back
as per-candidate ``(stat_sum, stat_count)`` pairs that the metric folds with
``Metric.sweep_finalize`` — per fold and in total — so rankings equal the
serial path's (``controller.evaluation.ranking_key``: NaN ranks last).
Groups whose algorithm, serving or metric cannot run on this path fall
back to the serial ``eval_batch`` per group, counted in
``pio_eval_sweep_candidates_total{path="serial"}``.
"""

from __future__ import annotations

import threading
import time
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.controller.components import FirstServing
from predictionio_tpu_torch.controller.engine import (
    Engine,
    EngineParams,
    FastEvalCache,
)
from predictionio_tpu_torch.controller.evaluation import (
    Metric,
    MetricEvaluatorResult,
    ranking_key,
)
from predictionio_tpu_torch.parallel.mesh import shards_mesh
from predictionio_tpu_torch.server.aot import BucketLadder
from predictionio_tpu_torch.utils.device import resolve_device
from predictionio_tpu_torch.utils.metrics import REGISTRY

#: grid-width ladder: the stacked hyper axis snaps UP to one of these
#: widths so nearby grid sizes share a program (the server/aot.py
#: batch-bucket idiom applied to the hyperparameter axis)
GRID_LADDER = BucketLadder.geometric(4096)

_m_runs = REGISTRY.counter(
    "pio_eval_sweep_runs_total",
    "Distributed sweep runs (core/sweep.run_sweep calls)")
_m_candidates = REGISTRY.counter(
    "pio_eval_sweep_candidates_total",
    "Sweep candidates evaluated, by execution path",
    ("path",))  # vmapped | serial
_m_compiles = REGISTRY.counter(
    "pio_eval_sweep_compiles_total",
    "Sweep program-cache lookups by result",
    ("result",))  # compile | hit
_m_buckets = REGISTRY.gauge(
    "pio_eval_sweep_buckets",
    "Distinct geometry buckets in the most recent sweep")
_m_device_s = REGISTRY.histogram(
    "pio_eval_sweep_device_seconds",
    "Per-dispatch device wall time of stacked sweep programs",
    labelnames=("bucket",))
_m_wall_s = REGISTRY.histogram(
    "pio_eval_sweep_wall_seconds",
    "End-to-end run_sweep wall time")


@dataclass
class SweepProgram:
    """One geometry bucket's stacked train+score workload.

    ``build()`` returns the per-candidate program ``one(hyper_row, *data)
    -> (stat_sum, stat_count)``; the sweep runs it over the stacked
    ``hyper`` rows (``data`` is shared by every row) and builds it ONCE
    per distinct ``(geometry, padded width, shards, data shapes)`` key.
    ``indices`` are positions into the ``params_list`` the program
    covers, row-aligned with ``hyper``.
    """

    geometry: Tuple[Any, ...]
    build: Callable[[], Callable]
    hyper: np.ndarray            # (k, H) float32
    data: Tuple[Any, ...]        # shared operands (nested tuples allowed)
    indices: List[int]


@dataclass
class SweepResult:
    result: MetricEvaluatorResult
    fold_scores: List[List[float]]   # per candidate, per fold
    buckets: int                     # distinct program keys this run
    compiles: int                    # program builds this run
    dispatches: int
    vmapped: int                     # candidates on the device path
    serial: int                      # candidates on the fallback path
    shards: int
    wall_seconds: float = 0.0
    device_seconds: float = 0.0

    def stats(self) -> Dict[str, Any]:
        """The leaderboard's timing/compile block."""
        return {"buckets": self.buckets, "compiles": self.compiles,
                "dispatches": self.dispatches, "vmapped": self.vmapped,
                "serial": self.serial, "shards": self.shards,
                "wallSeconds": self.wall_seconds,
                "deviceSeconds": self.device_seconds}


class _SweepCache:
    """Per-run program cache with honest build counting: one build per
    distinct key, so ``compiles ≤ len(keys)`` (= buckets) holds by
    construction."""

    def __init__(self) -> None:
        self._fns: Dict[Any, Callable] = {}
        self._lock = threading.Lock()
        self.compiles = 0
        self.hits = 0

    def get_or_compile(self, key: Any, build: Callable[[], Callable]):
        with self._lock:
            fn = self._fns.get(key)
        if fn is not None:
            self.hits += 1
            _m_compiles.inc(("hit",))
            return fn
        fn = build()
        with self._lock:
            self._fns.setdefault(key, fn)
            self.compiles += 1
        _m_compiles.inc(("compile",))
        return fn

    @property
    def buckets(self) -> int:
        with self._lock:
            return len(self._fns)


def _leaves(data: Any) -> List[Any]:
    if isinstance(data, (tuple, list)):
        return [leaf for x in data for leaf in _leaves(x)]
    return [] if data is None else [data]


def _tree_shapes(data: Tuple[Any, ...]) -> Tuple:
    return tuple((tuple(getattr(x, "shape", ())),
                  str(getattr(x, "dtype", type(x).__name__)),
                  str(getattr(x, "device", "")))
                 for x in _leaves(data))


def _resolve_shards(sweep_shards: int, platform: str):
    """``(shards, mesh)``: a ``"shards"`` mesh over the slots of
    ``platform`` (``parallel/mesh.make_mesh``'s pool), or (0, None) when
    sharding is off or the pool is too small (degrade with a warning,
    don't fail — the unsharded sweep is always correct)."""
    if sweep_shards <= 1:
        return 0, None
    try:
        return int(sweep_shards), shards_mesh(int(sweep_shards), platform=platform)
    except ValueError as e:  # the pool is smaller than the mesh
        warnings.warn(f"sweep_shards={sweep_shards} unavailable ({e}); "
                      "running unsharded", RuntimeWarning)
        return 0, None


def _on_device(data: Any, device: torch.device) -> Any:
    """``data`` with every tensor on ``device`` (nested tuples kept)."""
    if isinstance(data, (tuple, list)):
        return type(data)(_on_device(x, device) for x in data)
    return data.to(device) if isinstance(data, torch.Tensor) else data


def _build_stacked(build: Callable[[], Callable], mesh=None) -> Callable:
    """The bucket's program over the stacked hyper axis: ``one`` for each
    row in turn, the results stacked; with a ``"shards"`` mesh the rows
    are dealt out in equal runs over its slots, each run on its slot's
    device."""
    one = build()

    def stacked(hyper: np.ndarray, *data):
        if mesh is None:
            outs = [one(row, *data) for row in hyper]
        else:
            per = len(hyper) // mesh.size
            outs = []
            for j, device in enumerate(mesh.slots):
                local = _on_device(data, device)
                outs += [one(row, *local) for row in hyper[j * per:(j + 1) * per]]
        return [s for s, _ in outs], [c for _, c in outs]

    return stacked


def _fetch(values: List[Any]) -> np.ndarray:
    """Per-row results as float64 on the host (one copy for tensors on one
    device; a sharded sweep's rows are copied device by device)."""
    if values and isinstance(values[0], torch.Tensor):
        if len({v.device for v in values}) == 1:
            return torch.stack(values).double().cpu().numpy()
        return torch.stack([v.to("cpu", torch.float64) for v in values]).numpy()
    return np.asarray([float(v) for v in values], np.float64)


def _dispatch(prog: SweepProgram, cache: _SweepCache, shards: int, mesh=None,
              ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Run one bucket's whole sub-grid; returns (stat_sums[k],
    stat_counts[k], device_seconds)."""
    hyper = np.asarray(prog.hyper, np.float32)
    if hyper.ndim != 2:
        raise ValueError("SweepProgram.hyper must be (k, H)")
    k = hyper.shape[0]
    kp = GRID_LADDER.snap(k)
    if shards > 1:
        kp = max(kp, shards)
        kp = ((kp + shards - 1) // shards) * shards
    if kp > k:
        # pad rows repeat row 0 — same geometry, results sliced off
        hyper = np.concatenate(
            [hyper, np.repeat(hyper[:1], kp - k, axis=0)], axis=0)
    key = (prog.geometry, kp, shards, _tree_shapes(prog.data))
    fn = cache.get_or_compile(key, lambda: _build_stacked(prog.build, mesh))
    devices = {x.device for x in _leaves(prog.data)
               if isinstance(x, torch.Tensor) and x.is_cuda}
    if mesh is not None:
        devices |= {d for d in mesh.slots if d.type == "cuda"}
    t0 = time.perf_counter()
    sums, counts = fn(hyper, *prog.data)
    for dev in devices:
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    sums, counts = _fetch(sums), _fetch(counts)
    _m_device_s.observe(dt, (str(kp),))
    return sums[:k], counts[:k], dt


def run_sweep(
    ctx: Any,
    engine: Engine,
    candidates: Sequence[EngineParams],
    metric: Metric,
    other_metrics: Sequence[Metric] = (),
    sweep_shards: int = 0,
    cache: Optional[FastEvalCache] = None,
) -> SweepResult:
    """Evaluate the full candidate grid, on the device where possible.

    Mirrors ``MetricEvaluator.evaluate`` + ``Engine.eval_batch``'s
    sharing (folds once per dataSourceParams, prepare once per (dsp, pp,
    fold)) but replaces the per-candidate train + per-query scoring loop
    with bucketed sweep dispatches. Groups that cannot run on this path
    (multi-algorithm engines, non-FirstServing, a metric without
    ``sweep_kind``, or an algorithm whose ``sweep_programs`` returns
    None) fall back to the serial ``eval_batch`` for that group — same
    scores, just not stacked. ``other_metrics`` are only computed on
    fallback groups (the device path never materializes per-query
    predictions); their slots are NaN elsewhere.

    ``sweep_shards > 1`` deals each bucket's rows out over a ``"shards"``
    mesh of the slots of the context's device type
    (``parallel/mesh.make_mesh``'s pool: every card, one CPU, or the
    slots given to ``parallel/distributed.initialize``, where one device
    may fill several).
    """
    if not candidates:
        raise ValueError("no candidate engine params to evaluate")
    t_run = time.perf_counter()
    _m_runs.inc()
    cache = cache if cache is not None else FastEvalCache()
    shards, mesh = _resolve_shards(sweep_shards, resolve_device(ctx.device).type)
    exe = _SweepCache()

    n = len(candidates)
    scores: List[float] = [float("nan")] * n
    others: List[List[float]] = [[] for _ in range(n)]
    fold_scores: List[List[float]] = [[] for _ in range(n)]
    dispatches = 0
    device_seconds = 0.0
    vmapped_count = 0
    serial_count = 0

    groups: Dict[Tuple[str, str, Tuple[str, ...]], List[int]] = {}
    for i, ep in enumerate(candidates):
        groups.setdefault(engine.group_key(cache, ep), []).append(i)

    for (ds_key, pp_key, names), idxs in groups.items():
        ep0 = candidates[idxs[0]]
        eligible = (len(names) == 1
                    and engine.serving_cls is FirstServing
                    and metric.sweep_kind is not None)
        group_done = False
        if eligible:
            cls = engine.algorithm_cls_map[names[0]]
            plist = [candidates[i].algorithms_params[0][1] for i in idxs]
            folds = cache.folds(
                ds_key,
                lambda: engine.data_source_cls(
                    ep0.data_source_params).read_eval(ctx))
            prep = engine.preparator_cls(ep0.preparator_params)
            # (sum, count) accumulated across folds, per group-local idx
            acc = np.zeros((len(idxs), 2), np.float64)
            per_fold: List[List[float]] = [[] for _ in idxs]
            ok = True
            for f, (td, _eval_info, qa) in enumerate(folds):
                pd = cache.prepared(ds_key, pp_key, f,
                                    lambda: prep.prepare(ctx, td))
                for p in plist:
                    cls(p).sanity_check(pd)
                progs = cls.sweep_programs(ctx, pd, plist, qa, metric)
                if progs is None:
                    ok = False
                    break
                covered: set = set()
                for prog in progs:
                    sums, counts, dt = _dispatch(prog, exe, shards, mesh)
                    dispatches += 1
                    device_seconds += dt
                    ctx.log(f"sweep dispatch: fold {f}, {len(prog.indices)} "
                            f"candidates, {dt:.3f} s device")
                    for row, j in enumerate(prog.indices):
                        acc[j, 0] += float(sums[row])
                        acc[j, 1] += float(counts[row])
                        per_fold[j].append(metric.sweep_finalize(
                            float(sums[row]), float(counts[row])))
                        covered.add(j)
                if covered != set(range(len(idxs))):
                    missing = sorted(set(range(len(idxs))) - covered)
                    raise RuntimeError(
                        f"{cls.__name__}.sweep_programs left candidates "
                        f"{missing} uncovered in fold {f}")
            if ok:
                for j, i in enumerate(idxs):
                    scores[i] = metric.sweep_finalize(acc[j, 0], acc[j, 1])
                    others[i] = [float("nan")] * len(other_metrics)
                    fold_scores[i] = per_fold[j]
                    ctx.log(f"candidate {i}: {metric.header}={scores[i]} "
                            "(vmapped)")
                vmapped_count += len(idxs)
                _m_candidates.inc(("vmapped",), n=len(idxs))
                group_done = True

        if not group_done:
            # serial fallback: the eval_batch path, per group
            eval_datas = engine.eval_batch(
                ctx, [candidates[i] for i in idxs], cache)
            for j, i in enumerate(idxs):
                ed = eval_datas[j]
                scores[i] = metric.calculate(ctx, ed)
                others[i] = [m.calculate(ctx, ed) for m in other_metrics]
                fold_scores[i] = [metric.calculate(ctx, [fold])
                                  for fold in ed]
                ctx.log(f"candidate {i}: {metric.header}={scores[i]} "
                        "(serial)")
            serial_count += len(idxs)
            _m_candidates.inc(("serial",), n=len(idxs))

    rows: List[Tuple[EngineParams, float, List[float]]] = [
        (candidates[i], scores[i], others[i]) for i in range(n)]
    best_i = max(range(n), key=lambda i: ranking_key(metric, scores[i]))
    result = MetricEvaluatorResult(
        best_score=rows[best_i][1], best_engine_params=rows[best_i][0],
        best_index=best_i, candidates=rows)
    wall = time.perf_counter() - t_run
    _m_buckets.set(exe.buckets)
    _m_wall_s.observe(wall)
    ctx.log(f"sweep: {vmapped_count} vmapped + {serial_count} serial "
            f"candidates, {exe.buckets} buckets, {exe.compiles} compiles, "
            f"{dispatches} dispatches, shards={shards}")
    return SweepResult(
        result=result, fold_scores=fold_scores, buckets=exe.buckets,
        compiles=exe.compiles, dispatches=dispatches,
        vmapped=vmapped_count, serial=serial_count, shards=shards,
        wall_seconds=wall, device_seconds=device_seconds)
