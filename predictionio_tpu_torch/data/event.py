"""The event data model: the port's copy of the JAX package's
``data/event.py``.

- An :class:`Event` is an immutable record ``(eventId, event, entityType,
  entityId, targetEntityType?, targetEntityId?, properties, eventTime,
  tags, prId, creationTime)``, parsed from and written to the reference's
  wire format (camelCase JSON, ISO-8601 times with milliseconds).
- Reserved "special" events ``$set`` / ``$unset`` / ``$delete`` mutate an
  entity's property snapshot; :func:`aggregate_properties` folds a stream
  of them (ordered by ``eventTime``) into per-entity
  :class:`PropertyMap` snapshots.
- :func:`validate_event` enforces the reference's ``EventValidation``
  rules, exactly as the JAX package does, so both packages accept and
  store the same events.
"""

from __future__ import annotations

import datetime as _dt
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional

RESERVED_EVENTS = ("$set", "$unset", "$delete")

#: Property value types permitted on the wire (JSON scalars, lists, maps).
JsonValue = Any


class EventValidationError(ValueError):
    """Raised when an event violates the ingestion contract."""


def utcnow() -> _dt.datetime:
    return _dt.datetime.now(_dt.timezone.utc)


def parse_event_time(value: Any) -> _dt.datetime:
    """Parse an ISO-8601 timestamp (the reference accepts joda ISO8601)."""
    if isinstance(value, _dt.datetime):
        dt = value
    elif isinstance(value, str):
        s = value.strip()
        if s.endswith("Z"):
            s = s[:-1] + "+00:00"
        try:
            dt = _dt.datetime.fromisoformat(s)
        except ValueError as e:
            raise EventValidationError(f"Cannot parse eventTime {value!r}: {e}") from e
    else:
        raise EventValidationError(f"eventTime must be an ISO8601 string, got {type(value).__name__}")
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=_dt.timezone.utc)
    return dt


def format_event_time(dt: _dt.datetime) -> str:
    """ISO-8601 with milliseconds, e.g. ``2026-07-29T12:34:56.789+00:00``."""
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=_dt.timezone.utc)
    return dt.isoformat(timespec="milliseconds")


@dataclass(frozen=True)
class Event:
    """One immutable event record."""

    event: str
    entity_type: str
    entity_id: str
    target_entity_type: Optional[str] = None
    target_entity_id: Optional[str] = None
    properties: Dict[str, JsonValue] = field(default_factory=dict)
    event_time: _dt.datetime = field(default_factory=utcnow)
    tags: List[str] = field(default_factory=list)
    pr_id: Optional[str] = None
    event_id: Optional[str] = None
    creation_time: _dt.datetime = field(default_factory=utcnow)

    def with_id(self) -> "Event":
        if self.event_id is not None:
            return self
        # bare __new__ + __dict__ copy, not dataclasses.replace or
        # copy.copy: replace() re-runs __init__ over all 11 fields
        # (~20 µs) and copy.copy pays __reduce_ex__/_reconstruct
        # (~11 µs) per event — real costs on the bulk-ingest path.
        # os.urandom.hex is uuid4().hex minus the UUID-class parsing
        # (same 16 random bytes, ~7 µs → ~1 µs each).
        ev = object.__new__(type(self))
        ev.__dict__.update(self.__dict__)
        ev.__dict__["event_id"] = os.urandom(16).hex()
        return ev

    # -- wire (de)serialization ------------------------------------------------

    @classmethod
    def from_json(cls, obj: Dict[str, Any]) -> "Event":
        """Parse the reference wire format (camelCase keys)."""
        if not isinstance(obj, dict):
            raise EventValidationError("event payload must be a JSON object")
        unknown = set(obj) - {
            "event", "entityType", "entityId", "targetEntityType",
            "targetEntityId", "properties", "eventTime", "tags", "prId",
            "eventId", "creationTime",
        }
        if unknown:
            raise EventValidationError(f"unknown fields: {sorted(unknown)}")
        try:
            name = obj["event"]
            entity_type = obj["entityType"]
            entity_id = obj["entityId"]
        except KeyError as e:
            raise EventValidationError(f"missing required field {e.args[0]!r}") from e
        props = obj.get("properties") or {}
        if not isinstance(props, dict):
            raise EventValidationError("properties must be a JSON object")
        def opt_str(field: str):
            # empty string = absent: storage backends serialize None
            # and "" identically (the frame/doc formats have no
            # distinct null), so accepting "" stored backend-divergent
            # events — '{"targetEntityType":"item","targetEntityId":""}'
            # fails the one-sided-target validation uniformly.
            # Non-string values are a typed error, not a crash five
            # layers down in the serializer.
            v = obj.get(field)
            if v is None or v == "":
                return None
            if not isinstance(v, str):
                raise EventValidationError(f"{field} must be a string")
            return v

        ev = cls(
            event=str(name),
            entity_type=str(entity_type),
            entity_id=str(entity_id),
            target_entity_type=opt_str("targetEntityType"),
            target_entity_id=opt_str("targetEntityId"),
            properties=dict(props),
            event_time=parse_event_time(obj["eventTime"]) if "eventTime" in obj and obj["eventTime"] is not None else utcnow(),
            tags=list(obj.get("tags") or []),
            pr_id=opt_str("prId"),
            event_id=opt_str("eventId"),
            creation_time=parse_event_time(obj["creationTime"]) if obj.get("creationTime") else utcnow(),
        )
        validate_event(ev)
        return ev

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "eventId": self.event_id,
            "event": self.event,
            "entityType": self.entity_type,
            "entityId": self.entity_id,
        }
        if self.target_entity_type is not None:
            out["targetEntityType"] = self.target_entity_type
        if self.target_entity_id is not None:
            out["targetEntityId"] = self.target_entity_id
        out["properties"] = dict(self.properties)
        out["eventTime"] = format_event_time(self.event_time)
        if self.tags:
            out["tags"] = list(self.tags)
        if self.pr_id is not None:
            out["prId"] = self.pr_id
        out["creationTime"] = format_event_time(self.creation_time)
        return out

    def to_json_str(self) -> str:
        return json.dumps(self.to_json(), separators=(",", ":"), sort_keys=False)


def validate_event(ev: Event) -> None:
    """Enforce the reference's EventValidation rules."""
    if not ev.event:
        raise EventValidationError("event name must be non-empty")
    if not ev.entity_type:
        raise EventValidationError("entityType must be non-empty")
    if not ev.entity_id:
        raise EventValidationError("entityId must be non-empty")
    if ev.event.startswith("$") and ev.event not in RESERVED_EVENTS:
        raise EventValidationError(
            f"event name {ev.event!r} starting with '$' is reserved; "
            f"allowed special events: {', '.join(RESERVED_EVENTS)}"
        )
    if ev.event in ("$set", "$unset"):
        if ev.target_entity_type is not None or ev.target_entity_id is not None:
            raise EventValidationError(f"{ev.event} must not have a target entity")
    if ev.event == "$unset" and not ev.properties:
        raise EventValidationError("$unset requires non-empty properties")
    if ev.event == "$delete" and ev.properties:
        raise EventValidationError("$delete must not have properties")
    if (ev.target_entity_type is None) != (ev.target_entity_id is None):
        raise EventValidationError(
            "targetEntityType and targetEntityId must be both present or both absent"
        )
    if ev.target_entity_type == "" or ev.target_entity_id == "":
        # "" is indistinguishable from None in every storage format
        # (frames/docs have no distinct null) — programmatic inserts
        # must pass None for "no target", or the backends diverge
        raise EventValidationError(
            "target entity fields must be None when absent, not empty strings"
        )


@dataclass
class PropertyMap:
    """An entity's folded property snapshot with update lineage.

    Mirrors the reference's ``PropertyMap`` (DataMap + firstUpdated /
    lastUpdated timestamps).
    """

    properties: Dict[str, JsonValue]
    first_updated: _dt.datetime
    last_updated: _dt.datetime

    def get(self, key: str, default: Any = None) -> Any:
        return self.properties.get(key, default)

    def __getitem__(self, key: str) -> Any:
        return self.properties[key]

    def __contains__(self, key: str) -> bool:
        return key in self.properties


def aggregate_properties(events: Iterable[Event]) -> Dict[str, PropertyMap]:
    """Fold ``$set``/``$unset``/``$delete`` events into per-entity snapshots.

    Events are folded in ``eventTime`` order (ties broken by creation
    time then insertion order, matching the reference's sort-by-eventTime
    fold in ``PEventAggregator``). Non-special events are ignored.
    Returns ``{entityId: PropertyMap}`` for entities that currently exist
    (a trailing ``$delete`` removes the entity).
    """
    ordered = sorted(
        (e for e in events if e.event in RESERVED_EVENTS),
        key=lambda e: (e.event_time, e.creation_time),
    )
    state: Dict[str, PropertyMap] = {}
    for e in ordered:
        eid = e.entity_id
        if e.event == "$set":
            cur = state.get(eid)
            if cur is None:
                state[eid] = PropertyMap(dict(e.properties), e.event_time, e.event_time)
            else:
                cur.properties.update(e.properties)
                cur.last_updated = max(cur.last_updated, e.event_time)
        elif e.event == "$unset":
            cur = state.get(eid)
            if cur is not None:
                for k in e.properties:
                    cur.properties.pop(k, None)
                cur.last_updated = max(cur.last_updated, e.event_time)
        elif e.event == "$delete":
            state.pop(eid, None)
    return state
