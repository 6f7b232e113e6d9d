"""Type helpers kept for call-site compatibility with the reference's
py4j helpers (a list is the array; no JVM gateway)."""

from __future__ import annotations

import datetime as _dt
from typing import Iterable, List, Optional


def new_string_array(items: Iterable[str], gateway=None) -> List[str]:
    """py4j needed explicit JVM arrays; here a list IS the array. The
    ``gateway`` arg is accepted and ignored for call-site compatibility."""
    return [str(i) for i in items]


def to_datetime(value) -> Optional[_dt.datetime]:
    """ISO-8601 string / epoch seconds / datetime → aware datetime."""
    if value is None or isinstance(value, _dt.datetime):
        return value
    if isinstance(value, (int, float)):
        return _dt.datetime.fromtimestamp(float(value), tz=_dt.timezone.utc)
    s = str(value)
    if s.endswith("Z"):
        s = s[:-1] + "+00:00"
    dt = _dt.datetime.fromisoformat(s)
    return dt if dt.tzinfo else dt.replace(tzinfo=_dt.timezone.utc)
