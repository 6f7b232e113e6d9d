"""PEventStore for notebooks: DataFrame-returning event reads."""

from __future__ import annotations

import datetime as _dt
from typing import Any, Dict, List, Optional, Sequence


class PEventStore:
    """DataFrame-returning event reads over the port's storage."""

    @staticmethod
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
    ):
        """Events as a pandas DataFrame (one row per event; ``properties``
        is a dict column)."""
        import pandas as pd

        from predictionio_tpu_torch.data import store
        from predictionio_tpu_torch.pypio.pypio import _st

        events = store.find(
            app_name, channel_name=channel_name, start_time=start_time,
            until_time=until_time, entity_type=entity_type,
            entity_id=entity_id, event_names=event_names,
            target_entity_type=target_entity_type,
            target_entity_id=target_entity_id, storage=_st())
        rows: List[Dict[str, Any]] = [{
            "eventId": e.event_id,
            "event": e.event,
            "entityType": e.entity_type,
            "entityId": e.entity_id,
            "targetEntityType": e.target_entity_type,
            "targetEntityId": e.target_entity_id,
            "properties": dict(e.properties or {}),
            "eventTime": e.event_time,
        } for e in events]
        return pd.DataFrame(rows, columns=[
            "eventId", "event", "entityType", "entityId",
            "targetEntityType", "targetEntityId", "properties", "eventTime"])

    @staticmethod
    def aggregate_properties(
        app_name: str,
        entity_type: str,
        channel_name: Optional[str] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
    ):
        """$set/$unset/$delete-folded latest properties per entity, as a
        DataFrame indexed by entityId."""
        import pandas as pd

        from predictionio_tpu_torch.data import store
        from predictionio_tpu_torch.pypio.pypio import _st

        snap = store.aggregate_properties(
            app_name, entity_type, channel_name=channel_name,
            start_time=start_time, until_time=until_time, storage=_st())
        df = pd.DataFrame.from_dict(
            {eid: dict(props.properties) for eid, props in snap.items()},
            orient="index")
        df.index.name = "entityId"
        return df
