"""Server plugin system: the port's copy of the JAX package's
``core/plugins.py``.

Reference: [U] core/.../workflow/EngineServerPlugin.scala +
data/.../api/EventServerPlugin.scala, discovered through Java's
ServiceLoader (unverified, SURVEY.md §2a). Here discovery is Pythonic:
plugins register programmatically or are loaded from the ``PIO_PLUGINS``
environment variable (comma-separated ``module:attr`` specs resolving to
plugin instances or classes; a bare ``module`` takes its ``plugin``).

Event-server plugins see every incoming event (``input_blocker`` may
reject it with a 403; ``input_sniffer`` observes it after the commit).
Engine-server plugins see every query and prediction pair
(``output_blocker`` may transform the response; ``output_sniffer``
observes) and may expose extra HTTP routes under ``/plugins/<name>/…``.
"""

from __future__ import annotations

import importlib
import os
from typing import Any, List, Optional


class EventServerPlugin:
    name = "event-plugin"

    def input_blocker(self, event, app_id: int, channel_id: Optional[int]) -> Optional[str]:
        """Return a rejection message to block the event, or None to allow."""
        return None

    def input_sniffer(self, event, app_id: int, channel_id: Optional[int]) -> None:
        pass


class EngineServerPlugin:
    name = "engine-plugin"

    def output_blocker(self, query: Any, prediction: Any) -> Any:
        """Return the (possibly transformed) prediction."""
        return prediction

    def output_sniffer(self, query: Any, prediction: Any) -> None:
        pass

    def handle_route(self, subpath: str, body: Any) -> Any:
        """Serve ``GET/POST /plugins/<name>/<subpath>``; return JSON-able."""
        return {"plugin": self.name, "path": subpath}


_event_plugins: List[EventServerPlugin] = []
_engine_plugins: List[EngineServerPlugin] = []
_env_loaded = False


def register_event_plugin(p: EventServerPlugin) -> None:
    _event_plugins.append(p)


def register_engine_plugin(p: EngineServerPlugin) -> None:
    _engine_plugins.append(p)


def _load_env_plugins() -> None:
    global _env_loaded
    if _env_loaded:
        return
    _env_loaded = True
    specs = os.environ.get("PIO_PLUGINS", "")
    for spec in filter(None, (s.strip() for s in specs.split(","))):
        mod_name, _, attr = spec.partition(":")
        obj = getattr(importlib.import_module(mod_name), attr or "plugin")
        plugin = obj() if isinstance(obj, type) else obj
        if isinstance(plugin, EventServerPlugin):
            register_event_plugin(plugin)
        elif isinstance(plugin, EngineServerPlugin):
            register_engine_plugin(plugin)
        else:
            raise TypeError(f"{spec} is not an Event/EngineServerPlugin")


def event_server_plugins() -> List[EventServerPlugin]:
    _load_env_plugins()
    return list(_event_plugins)


def engine_server_plugins() -> List[EngineServerPlugin]:
    _load_env_plugins()
    return list(_engine_plugins)


def reset_plugins() -> None:
    """Test hook."""
    global _env_loaded
    _event_plugins.clear()
    _engine_plugins.clear()
    _env_loaded = False
