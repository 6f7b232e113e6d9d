"""Self-cleaning data source: sliding event window with compaction.

The port's copy of the JAX package's ``data/cleaning.py`` (reference:
SelfCleaningDataSource + EventWindow):

- ``EventWindow(duration, remove_duplicates, compress_properties)`` on a
  data source's params;
- on training read, ``clean_persisted_events`` rewrites the app's event
  namespace: property events ($set/$unset/$delete) older than the window
  are folded into ONE ``$set`` snapshot per entity, non-property events
  older than the window are dropped, duplicate events optionally
  deduplicated, and the store is rewritten by ``wipe`` + batched insert.

The window is measured against the wall clock, as in the JAX package.
"""

from __future__ import annotations

import datetime as _dt
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from predictionio_tpu_torch.data.event import (
    RESERVED_EVENTS,
    Event,
    aggregate_properties,
    utcnow,
)
from predictionio_tpu_torch.data.store import resolve_app_channel
from predictionio_tpu_torch.storage.registry import Storage, get_storage

_DURATION_RE = re.compile(
    r"^\s*(\d+(?:\.\d+)?)\s*(seconds?|minutes?|hours?|days?|weeks?|s|m|h|d|w)\s*$",
    re.IGNORECASE,
)

_UNIT_SECONDS = {
    "s": 1.0, "second": 1.0, "seconds": 1.0,
    "m": 60.0, "minute": 60.0, "minutes": 60.0,
    "h": 3600.0, "hour": 3600.0, "hours": 3600.0,
    "d": 86400.0, "day": 86400.0, "days": 86400.0,
    "w": 604800.0, "week": 604800.0, "weeks": 604800.0,
}


def parse_duration(value) -> _dt.timedelta:
    """'3 days' / '12h' / timedelta / seconds-number → timedelta
    (reference: scala.concurrent.duration string syntax)."""
    if isinstance(value, _dt.timedelta):
        return value
    if isinstance(value, (int, float)):
        return _dt.timedelta(seconds=float(value))
    m = _DURATION_RE.match(str(value))
    if not m:
        raise ValueError(f"unparseable duration {value!r}")
    return _dt.timedelta(seconds=float(m.group(1)) * _UNIT_SECONDS[m.group(2).lower()])


@dataclass
class EventWindow:
    """Sliding window config (reference: EventWindow case class)."""

    duration: Optional[object] = None  # str | timedelta | seconds
    remove_duplicates: bool = False
    compress_properties: bool = False

    @classmethod
    def from_json(cls, obj: Optional[Dict]) -> Optional["EventWindow"]:
        if not obj:
            return None
        return cls(
            duration=obj.get("duration"),
            remove_duplicates=bool(obj.get("removeDuplicates", False)),
            compress_properties=bool(obj.get("compressProperties", False)),
        )


def _dedup_key(e: Event) -> Tuple:
    import json

    # event_time is part of the identity: a repeat interaction at a
    # different time is a legitimate new event, only true re-sends
    # (same payload AND same eventTime) collapse
    return (e.event, e.entity_type, e.entity_id, e.target_entity_type,
            e.target_entity_id, e.event_time,
            json.dumps(e.properties, sort_keys=True))


def clean_persisted_events(
    app_name: str,
    window: EventWindow,
    channel_name: Optional[str] = None,
    storage: Optional[Storage] = None,
    now: Optional[_dt.datetime] = None,
) -> Dict[str, int]:
    """Rewrite the (app, channel) namespace per the window. Returns
    counts {"kept", "dropped", "compacted"} for observability."""
    st = storage or get_storage()
    app_id, channel_id = resolve_app_channel(app_name, channel_name, st)
    now = now or utcnow()
    cutoff = (now - parse_duration(window.duration)) if window.duration else None

    events = sorted(
        st.events.find(app_id, channel_id),
        key=lambda e: (e.event_time, e.creation_time),
    )

    kept: List[Event] = []
    old_property_events: Dict[Tuple[str, str], List[Event]] = {}
    dropped = 0
    for e in events:
        is_old = cutoff is not None and e.event_time < cutoff
        if not is_old:
            kept.append(e)
        elif window.compress_properties and e.event in RESERVED_EVENTS:
            old_property_events.setdefault(
                (e.entity_type, e.entity_id), []).append(e)
        else:
            dropped += 1  # old non-property (or compaction off): discard

    compacted: List[Event] = []
    for (etype, eid), evs in sorted(old_property_events.items()):
        folded = aggregate_properties(evs).get(eid)
        if folded is None or not folded.properties:
            dropped += len(evs)
            continue  # entity fully $delete-d before the cutoff
        snapshot_time = max(e.event_time for e in evs)
        compacted.append(Event(
            event="$set", entity_type=etype, entity_id=eid,
            properties=dict(folded.properties),
            event_time=snapshot_time,
        ).with_id())
        dropped += len(evs) - 1

    result = compacted + kept
    if window.remove_duplicates:
        seen = set()
        deduped = []
        for e in result:
            k = _dedup_key(e)
            if k in seen:
                dropped += 1
                continue
            seen.add(k)
            deduped.append(e)
        result = deduped

    st.events.wipe(app_id, channel_id)
    if result:
        st.events.insert_batch(result, app_id, channel_id)
    return {"kept": len(result), "dropped": dropped, "compacted": len(compacted)}


class SelfCleaningDataSource:
    """Mixin for DataSource classes (reference: SelfCleaningDataSource
    trait). The template's params dict may carry an ``eventWindow``
    block; call :meth:`clean` at the top of ``read_training``."""

    def event_window(self) -> Optional[EventWindow]:
        params = getattr(self, "params", None) or {}
        if isinstance(params, dict):
            raw = params.get("eventWindow")
        else:
            raw = getattr(params, "event_window", None)
        if isinstance(raw, EventWindow) or raw is None:
            return raw
        return EventWindow.from_json(raw)

    def clean(self, ctx, app_name: str,
              channel_name: Optional[str] = None) -> Optional[Dict[str, int]]:
        window = self.event_window()
        if window is None:
            return None
        stats = clean_persisted_events(
            app_name, window, channel_name, storage=ctx.storage)
        ctx.log(f"self-cleaning {app_name}: {stats}")
        return stats
