"""Backend registry: env-driven selection of the meta, event and model stores.

The port's copy of the JAX package's ``storage/registry.py``: the
reference's ``Storage`` object, which reads
``PIO_STORAGE_REPOSITORIES_{METADATA,EVENTDATA,MODELDATA}_{NAME,SOURCE}``
and ``PIO_STORAGE_SOURCES_<S>_{TYPE,...}``. Backends register by TYPE
name (``register_event_backend`` and its two siblings):

- meta: SQLITE, MEMORY, PGSQL, MYSQL, ELASTICSEARCH;
- events: SQLITE, MEMORY, EVENTLOG, PGSQL, MYSQL, ELASTICSEARCH;
- models: LOCALFS, MEMORY, PGSQL, MYSQL, ELASTICSEARCH, S3, HDFS.

EVENTLOG is the native C++ log under ``<home>/eventlog``
(:mod:`predictionio_tpu_torch.data.filestore`), built with g++ when the
store is first opened; ELASTICSEARCH the embedded index under the
source's ``PATH`` (default ``<home>/es_index``,
:mod:`predictionio_tpu_torch.storage.indexed`); the network types bind
their client libraries when opened (:mod:`predictionio_tpu_torch.storage.remote`).
A type nobody registered, a missing client library and an unreachable
server all raise. The defaults are the JAX package's (everything under
``$PIO_HOME or ~/.pio_store``: SQLite meta and events, LOCALFS models),
so the two packages share one storage home.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from predictionio_tpu_torch.data.events import (
    EventStore,
    MemoryEventStore,
    SqliteEventStore,
)
from predictionio_tpu_torch.storage.meta import MetaStore
from predictionio_tpu_torch.storage.models import (
    LocalFSModelStore,
    MemoryModelStore,
    ModelStore,
)


def pio_home() -> str:
    return os.environ.get("PIO_HOME") or os.path.join(
        os.path.expanduser("~"), ".pio_store")


@dataclass
class StorageConfig:
    """Resolved storage configuration (one 'source' per repository).

    ``sources`` holds every configured source's settings
    (``PIO_STORAGE_SOURCES_<NAME>_<KEY>`` → ``sources[NAME][KEY]``) and
    ``*_source`` names the source behind each repository, so that a
    backend factory reads its own source's settings (two S3 sources
    must not shadow each other).
    """

    metadata_type: str = "SQLITE"
    eventdata_type: str = "SQLITE"
    modeldata_type: str = "LOCALFS"
    metadata_source: str = ""
    eventdata_source: str = ""
    modeldata_source: str = ""
    sources: Dict[str, Dict[str, str]] = field(default_factory=dict)
    home: str = field(default_factory=pio_home)

    def source_properties(self, repo: str) -> Dict[str, str]:
        """Settings of the source backing ``repo`` ('METADATA', …)."""
        name = getattr(self, f"{repo.lower()}_source", "")
        return self.sources.get(name, {})

    @classmethod
    def from_env(cls, env: Optional[Dict[str, str]] = None) -> "StorageConfig":
        e = dict(os.environ if env is None else env)

        def repo_source(repo: str) -> str:
            return e.get(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE", "")

        # Source names and setting keys may both contain underscores:
        # each env var binds to the LONGEST candidate source name
        # prefixing it.
        prefix = "PIO_STORAGE_SOURCES_"
        rests = [k[len(prefix):] for k in e if k.startswith(prefix)]
        names = {repo_source(r) for r in ("METADATA", "EVENTDATA", "MODELDATA")}
        names |= {r[: -len("_TYPE")] for r in rests if r.endswith("_TYPE")}
        names.discard("")
        sources: Dict[str, Dict[str, str]] = {}
        for rest in rests:
            owner = max((n for n in names if rest.startswith(n + "_")),
                        key=len, default="")
            if owner:
                sources.setdefault(owner, {})[rest[len(owner) + 1:]] = \
                    e[prefix + rest]

        def source_type(repo: str, default: str) -> str:
            src = repo_source(repo)
            if src:
                return sources.get(src, {}).get("TYPE", default).upper()
            return default

        return cls(
            metadata_type=source_type("METADATA", "SQLITE"),
            eventdata_type=source_type("EVENTDATA", "SQLITE"),
            modeldata_type=source_type("MODELDATA", "LOCALFS"),
            metadata_source=repo_source("METADATA"),
            eventdata_source=repo_source("EVENTDATA"),
            modeldata_source=repo_source("MODELDATA"),
            sources=sources,
            home=e.get("PIO_HOME", pio_home()),
        )


def _ensure(home: str) -> str:
    os.makedirs(home, exist_ok=True)
    return home


def _eventlog_factory(cfg: StorageConfig) -> EventStore:
    # lazy import: the C++ engine is built only when EVENTLOG is selected
    from predictionio_tpu_torch.data.filestore import NativeEventLogStore

    return NativeEventLogStore(os.path.join(_ensure(cfg.home), "eventlog"))


_EVENT_BACKENDS: Dict[str, Callable[[StorageConfig], EventStore]] = {
    "MEMORY": lambda cfg: MemoryEventStore(),
    "SQLITE": lambda cfg: SqliteEventStore(
        os.path.join(_ensure(cfg.home), "events.db")),
    "EVENTLOG": _eventlog_factory,
}
_MODEL_BACKENDS: Dict[str, Callable[[StorageConfig], ModelStore]] = {
    "MEMORY": lambda cfg: MemoryModelStore(),
    "LOCALFS": lambda cfg: LocalFSModelStore(
        os.path.join(_ensure(cfg.home), "models")),
}
_META_BACKENDS: Dict[str, Callable[[StorageConfig], MetaStore]] = {
    "MEMORY": lambda cfg: MetaStore(":memory:"),
    "SQLITE": lambda cfg: MetaStore(os.path.join(_ensure(cfg.home), "meta.db")),
}


def register_event_backend(name: str, factory: Callable[[StorageConfig], EventStore]) -> None:
    _EVENT_BACKENDS[name.upper()] = factory


def register_model_backend(name: str, factory: Callable[[StorageConfig], ModelStore]) -> None:
    _MODEL_BACKENDS[name.upper()] = factory


def register_meta_backend(name: str, factory: Callable[[StorageConfig], MetaStore]) -> None:
    _META_BACKENDS[name.upper()] = factory


# the network backends (S3 and HDFS model stores, the PGSQL and MYSQL
# servers) and the embedded index's ELASTICSEARCH register their TYPE
# names; their client libraries bind when a store is opened
from predictionio_tpu_torch.storage import indexed as _indexed  # noqa: E402
from predictionio_tpu_torch.storage import remote as _remote  # noqa: E402

_remote.register_all()
_indexed.register_all()


class Storage:
    """Handle on the meta, event and model repositories (lazy singletons)."""

    def __init__(self, config: Optional[StorageConfig] = None,
                 events: Optional[EventStore] = None) -> None:
        self.config = config or StorageConfig.from_env()
        self._lock = threading.Lock()
        self._meta: Optional[MetaStore] = None
        # an event store given here replaces the configured backend's
        # (``train`` reads a live EVENTLOG home through a LogView)
        self._events: Optional[EventStore] = events
        self._models: Optional[ModelStore] = None

    @property
    def meta(self) -> MetaStore:
        with self._lock:
            if self._meta is None:
                try:
                    factory = _META_BACKENDS[self.config.metadata_type]
                except KeyError:
                    raise KeyError(
                        f"unknown METADATA backend {self.config.metadata_type!r}; "
                        f"registered: {sorted(_META_BACKENDS)}") from None
                self._meta = factory(self.config)
            return self._meta

    @property
    def events(self) -> EventStore:
        with self._lock:
            if self._events is None:
                try:
                    factory = _EVENT_BACKENDS[self.config.eventdata_type]
                except KeyError:
                    raise KeyError(
                        f"unknown EVENTDATA backend {self.config.eventdata_type!r}; "
                        f"registered: {sorted(_EVENT_BACKENDS)}") from None
                self._events = factory(self.config)
            return self._events

    @property
    def models(self) -> ModelStore:
        with self._lock:
            if self._models is None:
                try:
                    factory = _MODEL_BACKENDS[self.config.modeldata_type]
                except KeyError:
                    raise KeyError(
                        f"unknown MODELDATA backend {self.config.modeldata_type!r}; "
                        f"registered: {sorted(_MODEL_BACKENDS)}") from None
                self._models = factory(self.config)
            return self._models

    def verify(self) -> Dict[str, str]:
        """Connectivity check for ``status``: it touches what the JAX
        package's ``verify`` touches (the app list, the namespace of app 0
        and the model ids), so both leave the same files behind."""
        out = {}
        self.meta.list_apps()
        out["metadata"] = self.config.metadata_type
        self.events.init_channel(0)
        out["eventdata"] = self.config.eventdata_type
        self.models.list_ids()
        out["modeldata"] = self.config.modeldata_type
        return out


_default: Optional[Storage] = None
_default_lock = threading.Lock()


def get_storage() -> Storage:
    global _default
    with _default_lock:
        if _default is None:
            _default = Storage()
        return _default


def set_storage(storage: Optional[Storage]) -> None:
    """Override the process-wide storage (tests, embedded use)."""
    global _default
    with _default_lock:
        _default = storage
