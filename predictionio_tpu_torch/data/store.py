"""App-facing event access: what training and serving read, by app name.

The port's copy of the JAX package's ``data/store.py``:
:func:`resolve_app_channel` (app and channel names → ids), :func:`find`
(the bulk scan), :func:`aggregate_properties` (an entity type's folded
property snapshots), :func:`find_by_entity` (one entity's events, newest
first) and the two training reads, :func:`read_training_interactions`
and :func:`read_training_event_groups`.

A store with a columnar scan (EVENTLOG's C++ scan, SQLite's
``scan_columnar``) is read through it (:func:`_native_scan`), and no
per-event Python object is built; the scan goes through the snapshot
cache (:func:`_cached_scan`, :mod:`predictionio_tpu_torch.data.snapshot`),
so a repeat train over an append-mostly log reads only the events
created since the last one. Each read records its outcome on the
``storage.scan`` span (``scan_cache``: ``miss:cold``, ``hit``,
``hit:delta``, ``miss:mutated``, ``miss:out_of_order``,
``miss:unsupported``, ``bypassed``, ...) and in the
``pio_snapshot_cache_*`` metrics. Other stores (MEMORY) go through the
generic two-pass readers of ``data/pipeline.py``; both paths give the
same arrays and vocabularies.
"""

from __future__ import annotations

import datetime as _dt
import math as _math
import os as _os
import re as _re
import time as _time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from predictionio_tpu_torch.data.event import Event, PropertyMap
from predictionio_tpu_torch.storage.registry import Storage, get_storage
from predictionio_tpu_torch.utils import tracing as _tracing
from predictionio_tpu_torch.utils.metrics import REGISTRY as _REGISTRY

_SNAP_HITS = _REGISTRY.counter(
    "pio_snapshot_cache_hits_total",
    "Training columnar scans served from the snapshot cache")
_SNAP_MISSES = _REGISTRY.counter(
    "pio_snapshot_cache_misses_total",
    "Training columnar scans that fell back to a full rescan",
    labelnames=("reason",))
_SNAP_DELTA_ROWS = _REGISTRY.counter(
    "pio_snapshot_delta_rows_total",
    "Rows appended to snapshots by incremental delta scans")
_SCAN_SECONDS = _REGISTRY.histogram(
    "pio_columnar_scan_seconds",
    "Wall time of columnar training reads (cached or not)",
    buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0,
             2.5, 5.0, 10.0, 30.0, 60.0, 120.0))

# The rating-value grammar shared with the native columnar scan
# (eventlog.cc decimal_number_shape): JSON-style decimal numbers —
# DELIBERATELY narrower than Python float() (no hex, no inf/nan
# words, no underscore literals, ASCII digits only — the C++ side is
# byte-oriented) so the native and generic training reads keep/drop
# exactly the same events on every backend.
_NUM_RE = _re.compile(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?", _re.ASCII)


def _native_scan(storage: Optional[Storage]):
    """(scan_columnar, storage) when the configured event store
    exposes the native columnar scan, else (None, None). Unconfigured
    storage is not an error — the generic find() path resolves (or is
    test-seamed) on its own."""
    try:
        st = storage or get_storage()
        scan = getattr(st.events, "scan_columnar", None)
    except Exception:
        return None, None
    return (scan, st) if scan is not None else (None, None)


# -- snapshot cache -----------------------------------------------------------
#
# Repeat `pio train` over a mostly-append-only log should cost O(new
# events), not O(event log). The policy layer lives here; the disk
# format in data/snapshot.py; the per-backend creationTime predicate
# pushdown in the stores' scan_columnar/creation_stats.

_scan_cache_override: Optional[bool] = None

# Rewriting the snapshot npz costs O(snapshot); a steady-state warm
# read must not pay it for a tiny delta. The snapshot is recompacted
# only once the delta reaches 1/_COMPACT_FACTOR of its size — below
# that the old snapshot (and watermark) stay put and the next train
# re-scans the same still-small delta.
_COMPACT_FACTOR = 8


def set_scan_cache(enabled: Optional[bool]) -> Optional[bool]:
    """Process-wide snapshot-cache toggle; returns the previous value
    so callers (run_train's --no-scan-cache plumbing) can restore it.
    None defers to the ``PIO_SCAN_CACHE`` env var (default on)."""
    global _scan_cache_override
    prev = _scan_cache_override
    _scan_cache_override = enabled
    return prev


def scan_cache_enabled() -> bool:
    if _scan_cache_override is not None:
        return _scan_cache_override
    return _os.environ.get("PIO_SCAN_CACHE", "1").strip().lower() not in (
        "0", "false", "no", "off")


def _cached_scan(
    scan,
    st: Storage,
    app_id: int,
    channel_id: Optional[int],
    entity_type: Optional[str],
    target_entity_type: Optional[str],
    event_names: Optional[Sequence[str]],
    value_key: Optional[str],
):
    """Snapshot-cached columnar scan: load the persisted ColumnarEvents
    for this (store, namespace, filter) key, scan only
    ``creationTime > watermark``, and concatenate. Any doubt — missing
    or corrupt snapshot, deleted events, creationTimes at/below the
    watermark, out-of-order eventTimes in the delta, a backend that
    cannot answer the watermark probe — falls back to a full rescan
    (and re-primes the cache). Returns whatever contract ``scan`` has:
    a ColumnarEvents, or None when the backend declines columnar.

    Concurrency: the watermark is taken BEFORE any scan starts and
    every scan is bounded ``creationTime <= watermark``, so events
    ingested DURING the scan are neither half-seen now nor skipped
    later — the result is a consistent point-in-time read at the
    watermark, and the next train's delta picks up the remainder.
    """
    from predictionio_tpu_torch.data import snapshot as _snap
    from predictionio_tpu_torch.data.pipeline import concat_columnar

    events = st.events
    identity = getattr(events, "cache_identity", None)
    stats_fn = getattr(events, "creation_stats", None)
    stats = stats_fn(app_id, channel_id) if stats_fn is not None else None
    if identity is None or stats is None:
        _SNAP_MISSES.inc(("unsupported",))
        _tracing.add_attrs(scan_cache="miss:unsupported")
        return scan(app_id, channel_id, entity_type=entity_type,
                    target_entity_type=target_entity_type,
                    event_names=event_names, value_key=value_key)

    count_now, max_c = stats
    watermark = max_c if count_now else _snap.EMPTY_WATERMARK
    directory = _snap.cache_dir(st)
    key = _snap.filter_fingerprint(
        identity, app_id, channel_id, entity_type, target_entity_type,
        event_names, value_key)

    loaded = _snap.load_snapshot(directory, key)
    if loaded is not None:
        cols0, man = loaded
        # count(creation ≤ old watermark) must still equal what the
        # snapshot saw: a lower count means deletions, a higher one
        # means events arrived bearing creationTimes inside the
        # already-covered window — either way the delta can't see them
        at_w = events.creation_stats(app_id, channel_id,
                                     until_us=man.watermark_us)
        if at_w is not None and at_w[0] == man.pre_count:
            delta = scan(app_id, channel_id, entity_type=entity_type,
                         target_entity_type=target_entity_type,
                         event_names=event_names, value_key=value_key,
                         created_after_us=man.watermark_us,
                         created_until_us=watermark)
            if delta is not None:
                if delta.n == 0:
                    _SNAP_HITS.inc()
                    _tracing.add_attrs(scan_cache="hit")
                    if watermark > man.watermark_us:
                        _snap.update_manifest(directory, key, watermark,
                                              count_now, cols0.n)
                    return cols0
                # scan order is (eventTime, creationTime, id): appending
                # is only order-preserving when every delta event sorts
                # strictly after the snapshot's last (strict, because
                # eventTime ties break by fields the two scans can't
                # compare across the boundary)
                if (cols0.n == 0
                        or int(delta.times_us.min())
                        > int(cols0.times_us.max())):
                    merged = concat_columnar(cols0, delta)
                    if merged is not None:
                        _SNAP_HITS.inc()
                        _tracing.add_attrs(scan_cache="hit:delta")
                        _SNAP_DELTA_ROWS.inc(n=delta.n)
                        if delta.n * _COMPACT_FACTOR >= cols0.n:
                            _snap.save_snapshot(directory, key, merged,
                                                watermark, count_now)
                        return merged
                    _SNAP_MISSES.inc(("overflow",))
                    _tracing.add_attrs(scan_cache="miss:overflow")
                else:
                    _SNAP_MISSES.inc(("out_of_order",))
                    _tracing.add_attrs(scan_cache="miss:out_of_order")
            else:
                _SNAP_MISSES.inc(("declined",))
                _tracing.add_attrs(scan_cache="miss:declined")
        else:
            _SNAP_MISSES.inc(("mutated",))
            _tracing.add_attrs(scan_cache="miss:mutated")
    else:
        _SNAP_MISSES.inc(("cold",))
        _tracing.add_attrs(scan_cache="miss:cold")

    cols = scan(app_id, channel_id, entity_type=entity_type,
                target_entity_type=target_entity_type,
                event_names=event_names, value_key=value_key,
                created_until_us=watermark)
    if cols is not None:
        _snap.save_snapshot(directory, key, cols, watermark, count_now)
    return cols


def _scan_with_cache(
    scan,
    st: Storage,
    app_id: int,
    channel_id: Optional[int],
    start_time: Optional[_dt.datetime],
    until_time: Optional[_dt.datetime],
    entity_type: Optional[str],
    target_entity_type: Optional[str],
    event_names: Optional[Sequence[str]],
    value_key: Optional[str],
):
    """Route one columnar scan through the snapshot cache when
    eligible; always record scan wall time. Time-windowed reads
    (start/until) bypass the cache entirely — a window is not the
    repeat-train shape, and a windowed snapshot would go stale as the
    window slides."""
    t0 = _time.perf_counter()
    try:
        with _tracing.span("storage.scan", app_id=app_id) as sp:
            if (start_time is not None or until_time is not None
                    or not scan_cache_enabled()):
                sp.set_attr("scan_cache", "bypassed")
                cols = scan(app_id, channel_id, start_time=start_time,
                            until_time=until_time, entity_type=entity_type,
                            target_entity_type=target_entity_type,
                            event_names=event_names, value_key=value_key)
            else:
                cols = _cached_scan(scan, st, app_id, channel_id,
                                    entity_type, target_entity_type,
                                    event_names, value_key)
            if cols is not None:
                sp.set_attr("records", int(cols.n))
            return cols
    finally:
        _SCAN_SECONDS.observe(_time.perf_counter() - t0,
                              exemplar=_tracing.exemplar())


def _parse_value(v) -> Optional[float]:
    """Per-event training value from a property: numbers and bools
    pass through; strings must match the decimal grammar; anything
    else (absent, lists, dicts, exotic literals) is None."""
    if isinstance(v, bool):
        return 1.0 if v else 0.0
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, str) and _NUM_RE.fullmatch(v.strip(" ")):
        # spaces only: the C++ scan sees control chars as their JSON
        # escapes (a real tab arrives as \t bytes) and drops them —
        # stripping them here would diverge
        return float(v)
    return None


def resolve_app_channel(
    app_name: str, channel_name: Optional[str] = None, storage: Optional[Storage] = None
) -> Tuple[int, Optional[int]]:
    st = storage or get_storage()
    app = st.meta.get_app_by_name(app_name)
    if app is None:
        raise ValueError(f"App {app_name!r} does not exist; create it with `pio app new`")
    channel_id: Optional[int] = None
    if channel_name:
        ch = st.meta.get_channel_by_name(app.id, channel_name)
        if ch is None:
            raise ValueError(f"Channel {channel_name!r} does not exist in app {app_name!r}")
        channel_id = ch.id
    return app.id, channel_id


def find(
    app_name: str,
    channel_name: Optional[str] = None,
    start_time: Optional[_dt.datetime] = None,
    until_time: Optional[_dt.datetime] = None,
    entity_type: Optional[str] = None,
    entity_id: Optional[str] = None,
    event_names: Optional[Sequence[str]] = None,
    target_entity_type: Optional[str] = None,
    target_entity_id: Optional[str] = None,
    limit: Optional[int] = None,
    reversed: bool = False,
    storage: Optional[Storage] = None,
) -> Iterator[Event]:
    st = storage or get_storage()
    app_id, channel_id = resolve_app_channel(app_name, channel_name, st)
    return st.events.find(
        app_id,
        channel_id,
        start_time=start_time,
        until_time=until_time,
        entity_type=entity_type,
        entity_id=entity_id,
        event_names=event_names,
        target_entity_type=target_entity_type,
        target_entity_id=target_entity_id,
        limit=limit,
        reversed=reversed,
    )


def aggregate_properties(
    app_name: str,
    entity_type: str,
    channel_name: Optional[str] = None,
    start_time: Optional[_dt.datetime] = None,
    until_time: Optional[_dt.datetime] = None,
    storage: Optional[Storage] = None,
) -> Dict[str, PropertyMap]:
    st = storage or get_storage()
    app_id, channel_id = resolve_app_channel(app_name, channel_name, st)
    return st.events.aggregate_properties(
        app_id, entity_type, channel_id, start_time=start_time, until_time=until_time
    )


def read_training_interactions(
    app_name: str,
    channel_name: Optional[str] = None,
    start_time: Optional[_dt.datetime] = None,
    until_time: Optional[_dt.datetime] = None,
    entity_type: Optional[str] = None,
    target_entity_type: Optional[str] = None,
    event_names: Optional[Sequence[str]] = None,
    value_key: Optional[str] = None,
    value_spec: Optional[Dict[str, object]] = None,
    default_spec: object = 1.0,
    chunk_size: int = 65536,
    prefer_streaming: bool = False,
    storage: Optional[Storage] = None,
):
    """Bulk (entity, target[, value]) read for training (the reference's
    ``PEventStore.find → RDD[Rating]``), returning
    :class:`~predictionio_tpu_torch.data.pipeline.InteractionData`.

    When the backing store exposes a columnar scan (the C++ EVENTLOG
    engine, SQLite's row accumulator), the scan/parse/vocabulary pass
    builds no per-event Python object; every other backend streams through
    the generic two-pass :func:`~predictionio_tpu_torch.data.pipeline.
    read_interactions` with identical results.

    ``value_spec`` maps event name → ``"prop"`` (read
    ``properties[value_key]`` under the shared decimal grammar
    (``_NUM_RE``): numbers, bools, and plain decimal strings parse;
    absent/malformed/non-finite drops the event — identically on the
    native and generic paths) or a float constant; unlisted names take
    ``default_spec``. E.g. the recommendation template:
    ``value_key="rating", value_spec={"rate": "prop"},
    default_spec=buy_rating``.
    """
    from predictionio_tpu_torch.data.pipeline import (interactions_from_columnar,
                                                read_interactions)

    # prefer_streaming: the caller wants O(chunk) memory end-to-end
    # (event log may exceed host RAM) — the columnar scan materializes
    # ~26 B/event host-side (50× less than Event objects, but not
    # O(chunk)), so honor the streaming contract over raw speed
    scan, st = (None, None) if prefer_streaming else _native_scan(storage)
    if scan is not None:
        app_id, channel_id = resolve_app_channel(app_name, channel_name, st)
        cols = _scan_with_cache(
            scan, st, app_id, channel_id, start_time, until_time,
            entity_type, target_entity_type, event_names, value_key)
        if cols is not None:
            return interactions_from_columnar(cols, value_spec,
                                              default_spec,
                                              chunk_size=chunk_size)

    def value_fn(e):
        spec = (value_spec or {}).get(e.event, default_spec)
        if spec == "prop":
            if value_key is None:
                return None
            v = _parse_value(e.properties.get(value_key))
            return v if (v is not None and _math.isfinite(v)) else None
        return float(spec)  # type: ignore[arg-type]

    # module-level find(): resolves the app itself, and stays the
    # monkeypatchable seam templates' streaming tests rely on
    return read_interactions(
        lambda: find(
            app_name, channel_name, start_time=start_time,
            until_time=until_time, entity_type=entity_type,
            event_names=event_names,
            target_entity_type=target_entity_type, storage=storage),
        chunk_size=chunk_size,
        value_fn=(value_fn
                  if (value_spec or value_key or default_spec != 1.0)
                  else None),
    )


def read_training_event_groups(
    app_name: str,
    names: Sequence[str],
    channel_name: Optional[str] = None,
    entity_type: Optional[str] = "user",
    target_entity_type: Optional[str] = "item",
    chunk_size: int = 65536,
    storage: Optional[Storage] = None,
):
    """Multi-event grouped read with one shared vocabulary pair (the
    Universal-Recommender shape) — native columnar scan on stores that
    expose it (demux by name is a numpy mask), the generic two-scan
    :func:`~predictionio_tpu_torch.data.pipeline.read_event_groups`
    elsewhere. Returns ``({name: (user_idx, item_idx)}, user_ids,
    item_ids)`` identically on both paths."""
    from predictionio_tpu_torch.data.pipeline import (event_groups_from_columnar,
                                                read_event_groups)

    scan, st = _native_scan(storage)
    if scan is not None:
        app_id, channel_id = resolve_app_channel(app_name, channel_name, st)
        cols = _scan_with_cache(
            scan, st, app_id, channel_id, None, None,
            entity_type, target_entity_type, list(names), None)
        if cols is not None:
            return event_groups_from_columnar(cols, names)
    return read_event_groups(
        lambda: find(
            app_name, channel_name, entity_type=entity_type,
            target_entity_type=target_entity_type,
            event_names=list(names), storage=storage),
        names, chunk_size=chunk_size)


def find_by_entity(
    app_name: str,
    entity_type: str,
    entity_id: str,
    channel_name: Optional[str] = None,
    event_names: Optional[Sequence[str]] = None,
    target_entity_type: Optional[str] = None,
    target_entity_id: Optional[str] = None,
    start_time: Optional[_dt.datetime] = None,
    until_time: Optional[_dt.datetime] = None,
    limit: Optional[int] = None,
    latest: bool = True,
    storage: Optional[Storage] = None,
) -> List[Event]:
    """Serving-time point lookup (reference: LEventStore.findByEntity;
    `latest` mirrors its newest-first default)."""
    st = storage or get_storage()
    app_id, channel_id = resolve_app_channel(app_name, channel_name, st)
    return list(
        st.events.find(
            app_id,
            channel_id,
            start_time=start_time,
            until_time=until_time,
            entity_type=entity_type,
            entity_id=entity_id,
            event_names=event_names,
            target_entity_type=target_entity_type,
            target_entity_id=target_entity_id,
            limit=limit,
            reversed=latest,
        )
    )
