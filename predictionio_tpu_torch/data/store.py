"""App-facing event access: what training reads, by app name.

The port's copy of the JAX package's ``data/store.py`` for the training
read: :func:`resolve_app_channel` (app and channel names → ids),
:func:`find` (the bulk scan), :func:`read_training_interactions` on
the generic two-pass path (``data/pipeline.read_interactions``) and
:func:`read_training_event_groups` (``data/pipeline.read_event_groups``),
and
for the serving-time business rules :func:`aggregate_properties` (an
entity type's folded property snapshots) and :func:`find_by_entity`
(one entity's events, newest first). The
port's stores have no native columnar scan yet, so there is no native
path and no snapshot cache; both give the same arrays and vocabularies
as this path in the JAX package.
"""

from __future__ import annotations

import datetime as _dt
import math as _math
import re as _re
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from predictionio_tpu_torch.data.event import Event, PropertyMap
from predictionio_tpu_torch.storage.registry import Storage, get_storage

# The rating-value grammar the JAX package shares with its native scan:
# JSON-style decimal numbers, deliberately narrower than float() (no
# hex, no inf/nan words, no underscores, ASCII digits only), so every
# read path keeps and drops exactly the same events.
_NUM_RE = _re.compile(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?", _re.ASCII)


def _parse_value(v) -> Optional[float]:
    """Per-event training value from a property: numbers and bools pass
    through; strings must match the decimal grammar; anything else
    (absent, lists, dicts, exotic literals) is None."""
    if isinstance(v, bool):
        return 1.0 if v else 0.0
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, str) and _NUM_RE.fullmatch(v.strip(" ")):
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
    storage: Optional[Storage] = None,
):
    """Bulk (entity, target[, value]) read for training, returning
    :class:`~predictionio_tpu_torch.data.pipeline.InteractionData`.

    ``value_spec`` maps event name → ``"prop"`` (read
    ``properties[value_key]`` under the shared decimal grammar; absent,
    malformed or non-finite drops the event) or a float constant;
    unlisted names take ``default_spec``. E.g. the recommendation
    template: ``value_key="rating", value_spec={"rate": "prop"},
    default_spec=buy_rating``.
    """
    from predictionio_tpu_torch.data.pipeline import read_interactions

    def value_fn(e):
        spec = (value_spec or {}).get(e.event, default_spec)
        if spec == "prop":
            if value_key is None:
                return None
            v = _parse_value(e.properties.get(value_key))
            return v if (v is not None and _math.isfinite(v)) else None
        return float(spec)  # type: ignore[arg-type]

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
    Universal-Recommender shape) through the generic two-scan
    :func:`~predictionio_tpu_torch.data.pipeline.read_event_groups`.
    Returns ``({name: (user_idx, item_idx)}, user_ids, item_ids)``."""
    from predictionio_tpu_torch.data.pipeline import read_event_groups

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
