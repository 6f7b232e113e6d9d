"""Batch views over the event stream (legacy helper layer).

The port's copy of the JAX package's ``data/view.py`` (the reference's
``LBatchView``/``PBatchView``). A view materializes one pass over an
app's events and offers the common folds: property aggregation per
entity type and event grouping by entity or name. Heavy per-event math
belongs on the device over the arrays a DataSource builds, not in this
host-side helper.
"""

from __future__ import annotations

import datetime as _dt
from typing import Dict, List, Optional, Tuple

from predictionio_tpu_torch.data.event import Event, PropertyMap, aggregate_properties
from predictionio_tpu_torch.data.store import resolve_app_channel
from predictionio_tpu_torch.storage.registry import Storage, get_storage


class BatchView:
    """One materialized scan of an (app, channel) namespace."""

    def __init__(
        self,
        app_name: str,
        channel_name: Optional[str] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        storage: Optional[Storage] = None,
    ) -> None:
        st = storage or get_storage()
        app_id, channel_id = resolve_app_channel(app_name, channel_name, st)
        self.events: List[Event] = list(st.events.find(
            app_id, channel_id, start_time=start_time, until_time=until_time))

    def aggregate_properties(self, entity_type: str) -> Dict[str, PropertyMap]:
        """Folded ``$set/$unset/$delete`` snapshot per entity of the type
        (reference: LBatchView.aggregateProperties)."""
        return aggregate_properties(
            e for e in self.events if e.entity_type == entity_type)

    def group_by_entity(
        self, entity_type: Optional[str] = None,
        event_names: Optional[List[str]] = None,
    ) -> Dict[str, List[Event]]:
        """Events per entity id, insertion order preserved
        (reference: events-by-entity grouping in LBatchView)."""
        out: Dict[str, List[Event]] = {}
        for e in self.events:
            if entity_type is not None and e.entity_type != entity_type:
                continue
            if event_names is not None and e.event not in event_names:
                continue
            out.setdefault(e.entity_id, []).append(e)
        return out

    def count_by_event(self) -> Dict[str, int]:
        """Event-name histogram (the /stats.json shape)."""
        out: Dict[str, int] = {}
        for e in self.events:
            out[e.event] = out.get(e.event, 0) + 1
        return out

    def pairs(
        self, event_names: Optional[List[str]] = None,
    ) -> List[Tuple[str, str]]:
        """(entityId, targetEntityId) interaction pairs — the shape every
        recommender DataSource wants."""
        return [
            (e.entity_id, e.target_entity_id)
            for e in self.events
            if e.target_entity_id is not None
            and (event_names is None or e.event in event_names)
        ]
