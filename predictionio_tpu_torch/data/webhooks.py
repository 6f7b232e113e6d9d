"""Webhook connectors: translate 3rd-party payloads into events.

The port's copy, whole, of the JAX package's ``data/webhooks.py``.
Reference: [U] data/.../webhooks/{JsonConnector,FormConnector,
segmentio/SegmentIOConnector,mailchimp/MailChimpConnector}.scala
(unverified, SURVEY.md §2a). A connector maps one provider payload to
the event wire JSON; the event server inserts it through the normal
validated path. Register custom connectors with
:func:`register_connector`.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Dict, Optional


class Connector(ABC):
    #: "json" (JSON body) or "form" (urlencoded form body)
    kind: str = "json"

    @abstractmethod
    def to_event_json(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """Translate the provider payload into event wire JSON; raise
        ValueError on malformed payloads."""


class SegmentIOConnector(Connector):
    """Segment.com HTTP tracking payloads (track/identify/page/screen/
    group/alias), mirroring the reference's SegmentIOConnector."""

    kind = "json"
    SUPPORTED = ("track", "identify", "page", "screen", "group", "alias")

    def to_event_json(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        if not isinstance(payload, dict):
            raise ValueError("segmentio payload must be a JSON object")
        typ = payload.get("type")
        if typ not in self.SUPPORTED:
            raise ValueError(f"unsupported segmentio type {typ!r}")
        user = payload.get("userId") or payload.get("anonymousId")
        if not user:
            raise ValueError("segmentio payload needs userId or anonymousId")
        name = payload.get("event") if typ == "track" else typ
        if not name:
            raise ValueError("track payload needs an event name")
        props: Dict[str, Any] = {}
        for key in ("properties", "traits", "context"):
            val = payload.get(key)
            if isinstance(val, dict) and val:
                props[key] = val
        out: Dict[str, Any] = {
            "event": str(name),
            "entityType": "user",
            "entityId": str(user),
            "properties": props,
        }
        if payload.get("timestamp"):
            out["eventTime"] = payload["timestamp"]
        return out


class MailChimpConnector(Connector):
    """MailChimp webhook form payloads (subscribe/unsubscribe/profile/
    upemail/cleaned/campaign), mirroring the reference's
    MailChimpConnector (form-encoded ``data[...]`` keys)."""

    kind = "form"
    SUPPORTED = ("subscribe", "unsubscribe", "profile", "upemail", "cleaned",
                 "campaign")

    def to_event_json(self, form: Dict[str, str]) -> Dict[str, Any]:
        typ = form.get("type")
        if typ not in self.SUPPORTED:
            raise ValueError(f"unsupported mailchimp type {typ!r}")
        data = {
            k[len("data["):-1]: v
            for k, v in form.items()
            if k.startswith("data[") and k.endswith("]")
        }
        entity_id = data.get("email") or data.get("new_email") or data.get("id")
        if not entity_id:
            raise ValueError("mailchimp payload needs data[email] or data[id]")
        out: Dict[str, Any] = {
            "event": str(typ),
            "entityType": "user",
            "entityId": str(entity_id),
            "properties": data,
        }
        if form.get("fired_at"):
            # MailChimp fires "YYYY-MM-DD HH:MM:SS" (UTC)
            out["eventTime"] = form["fired_at"].replace(" ", "T") + "+00:00"
        return out


_CONNECTORS: Dict[str, Connector] = {
    "segmentio": SegmentIOConnector(),
    "mailchimp": MailChimpConnector(),
}


def register_connector(name: str, connector: Connector) -> None:
    _CONNECTORS[name] = connector


def get_connector(name: str) -> Optional[Connector]:
    return _CONNECTORS.get(name)
