"""Event stores: the backend SPI, the in-memory store and the SQLite store.

The port's copy of the JAX package's ``data/events.py`` for the two
backends training reads here: ``MEMORY`` and ``SQLITE``. The SQLite store
keeps the reference's table per (app, channel) namespace
(``pio_event_<appId>[_<channelId>]``), its schema, its indexes and its
scan order, so events the JAX package wrote into a ``PIO_HOME`` are read
by the port and the other way round. The other backends (the native
event log, segments, replication, remote SQL engines), their bulk paths
(the native JSONL import and export) and the columnar scan are not
ported yet.
"""

from __future__ import annotations

import datetime as _dt
import json
import sqlite3
import threading
from abc import ABC, abstractmethod
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from predictionio_tpu_torch.data.event import (
    Event,
    PropertyMap,
    aggregate_properties,
    format_event_time,
    parse_event_time,
    validate_event,
)


class EventStore(ABC):
    """Backend SPI for event storage (one namespace per app/channel)."""

    def init_channel(self, app_id: int, channel_id: Optional[int] = None) -> None:
        """Prepare storage for a namespace (idempotent)."""

    def remove_channel(self, app_id: int, channel_id: Optional[int] = None) -> None:
        """Drop a namespace entirely."""

    def close(self) -> None:
        pass

    def set_durable(self, durable: bool = True) -> None:
        """Ask the backend to make each commit survive power loss (fsync
        on commit), not just process death. The event server's durable-
        ack mode turns this on so that a 201 means on disk; group commit
        amortizes the sync over the whole batch. Backends without a sync
        level (in-memory) ignore it."""

    @abstractmethod
    def insert(self, event: Event, app_id: int, channel_id: Optional[int] = None) -> str:
        """Insert one event; returns its (possibly generated) eventId."""

    def insert_batch(
        self, events: Sequence[Event], app_id: int, channel_id: Optional[int] = None
    ) -> List[str]:
        return [self.insert(e, app_id, channel_id) for e in events]

    @abstractmethod
    def delete(self, event_id: str, app_id: int, channel_id: Optional[int] = None) -> bool:
        """Delete by id; returns whether it existed."""

    def wipe(self, app_id: int, channel_id: Optional[int] = None) -> None:
        """Delete all events in the namespace, keeping it usable."""
        for e in list(self.find(app_id, channel_id)):
            assert e.event_id is not None
            self.delete(e.event_id, app_id, channel_id)

    @abstractmethod
    def get(self, event_id: str, app_id: int, channel_id: Optional[int] = None) -> Optional[Event]:
        ...

    @abstractmethod
    def find(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        entity_id: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Optional[str] = None,
        target_entity_id: Optional[str] = None,
        limit: Optional[int] = None,
        reversed: bool = False,
    ) -> Iterator[Event]:
        """Scan events ordered by eventTime asc (desc when ``reversed``).
        ``start_time`` inclusive, ``until_time`` exclusive; ``limit=None``
        (or negative) means no limit."""

    # -- derived ---------------------------------------------------------------

    def aggregate_properties(
        self,
        app_id: int,
        entity_type: str,
        channel_id: Optional[int] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
    ) -> Dict[str, PropertyMap]:
        """Fold $set/$unset/$delete into per-entity snapshots.

        Reference: [U] PEvents.aggregateProperties / PEventAggregator.
        """
        evs = self.find(
            app_id,
            channel_id,
            start_time=start_time,
            until_time=until_time,
            entity_type=entity_type,
            event_names=["$set", "$unset", "$delete"],
        )
        return aggregate_properties(evs)


def _match(
    e: Event,
    start_time: Optional[_dt.datetime],
    until_time: Optional[_dt.datetime],
    entity_type: Optional[str],
    entity_id: Optional[str],
    event_names: Optional[Sequence[str]],
    target_entity_type: Optional[str],
    target_entity_id: Optional[str],
) -> bool:
    if start_time is not None and e.event_time < start_time:
        return False
    if until_time is not None and e.event_time >= until_time:
        return False
    if entity_type is not None and e.entity_type != entity_type:
        return False
    if entity_id is not None and e.entity_id != entity_id:
        return False
    if event_names is not None and e.event not in event_names:
        return False
    if target_entity_type is not None and e.target_entity_type != target_entity_type:
        return False
    if target_entity_id is not None and e.target_entity_id != target_entity_id:
        return False
    return True


class MemoryEventStore(EventStore):
    """In-process event store (tests, quickstarts)."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        # id → Event per (app, channel); find() sorts a snapshot
        self._data: Dict[Tuple[int, Optional[int]], Dict[str, Event]] = {}

    def _ns(self, app_id: int, channel_id: Optional[int]) -> Dict[str, Event]:
        return self._data.setdefault((app_id, channel_id), {})

    def init_channel(self, app_id: int, channel_id: Optional[int] = None) -> None:
        with self._lock:
            self._ns(app_id, channel_id)

    def remove_channel(self, app_id: int, channel_id: Optional[int] = None) -> None:
        with self._lock:
            self._data.pop((app_id, channel_id), None)

    def insert(self, event: Event, app_id: int, channel_id: Optional[int] = None) -> str:
        return self.insert_batch([event], app_id, channel_id)[0]

    def insert_batch(
        self, events: Sequence[Event], app_id: int, channel_id: Optional[int] = None
    ) -> List[str]:
        # validate every event before writing any (no partial batch),
        # overwrite by id (the reference's put semantics)
        stamped = []
        for e in events:
            validate_event(e)
            stamped.append(e.with_id())
        with self._lock:
            ns = self._ns(app_id, channel_id)
            for e in stamped:
                ns[e.event_id] = e
        return [e.event_id for e in stamped]  # type: ignore[misc]

    def get(self, event_id: str, app_id: int, channel_id: Optional[int] = None) -> Optional[Event]:
        with self._lock:
            return self._ns(app_id, channel_id).get(event_id)

    def delete(self, event_id: str, app_id: int, channel_id: Optional[int] = None) -> bool:
        with self._lock:
            return self._ns(app_id, channel_id).pop(event_id, None) is not None

    def wipe(self, app_id: int, channel_id: Optional[int] = None) -> None:
        with self._lock:
            self._data[(app_id, channel_id)] = {}

    def find(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        entity_id: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Optional[str] = None,
        target_entity_id: Optional[str] = None,
        limit: Optional[int] = None,
        reversed: bool = False,
    ) -> Iterator[Event]:
        with self._lock:
            snapshot = list(self._ns(app_id, channel_id).values())
        snapshot.sort(key=lambda e: (e.event_time, e.creation_time), reverse=reversed)
        n = 0
        for e in snapshot:
            if _match(e, start_time, until_time, entity_type, entity_id,
                      event_names, target_entity_type, target_entity_id):
                yield e
                n += 1
                if limit is not None and limit >= 0 and n >= limit:
                    return


_EPOCH = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)


def _ts(dt: _dt.datetime) -> int:
    """Epoch microseconds, in integer arithmetic; naive times are UTC."""
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=_dt.timezone.utc)
    return (dt - _EPOCH) // _dt.timedelta(microseconds=1)


_EVENT_COLS = ("id", "event", "entityType", "entityId", "targetEntityType",
               "targetEntityId", "properties", "eventTime", "eventTimeIso",
               "tags", "prId", "creationTime", "creationTimeIso")


class SqliteEventStore(EventStore):
    """Durable event store on SQLite (the default backend): the SQLite
    dialect of the reference's ``SQLEventStore``. One table per (app,
    channel) namespace, indexed on eventTime, entity, event name and
    creationTime; one connection per thread in WAL mode (``':memory:'``
    shares one connection, since such a database exists per
    connection). Each connection commits at ``synchronous=NORMAL``, or
    at ``FULL`` (an fsync of the WAL per commit) after ``set_durable``."""

    def __init__(self, path: str) -> None:
        self._path = path
        self._lock = threading.RLock()
        self._local = threading.local()
        self._shared = self._connect() if path == ":memory:" else None
        self._known: set = set()  # (table, connection) whose DDL already ran
        self._sync = "NORMAL"

    def set_durable(self, durable: bool = True) -> None:
        # each thread's connection takes the level the next time it is used
        self._sync = "FULL" if durable else "NORMAL"

    def _connect(self) -> sqlite3.Connection:
        conn = sqlite3.connect(self._path, timeout=30.0,
                               check_same_thread=self._path != ":memory:")
        if self._path != ":memory:":
            conn.execute("PRAGMA journal_mode=WAL")
            conn.execute("PRAGMA synchronous=NORMAL")
        return conn

    def _conn(self) -> sqlite3.Connection:
        if self._shared is not None:
            return self._shared
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = self._local.conn = self._connect()
            self._local.sync = "NORMAL"
        if self._local.sync != self._sync:
            sync = self._sync
            conn.execute(f"PRAGMA synchronous={sync}")
            self._local.sync = sync
        return conn

    @staticmethod
    def _table(app_id: int, channel_id: Optional[int]) -> str:
        return f"pio_event_{app_id}" + (f"_{channel_id}" if channel_id is not None else "")

    def init_channel(self, app_id: int, channel_id: Optional[int] = None) -> None:
        t = self._table(app_id, channel_id)
        c = self._conn()
        with self._lock:
            if (t, id(c)) in self._known:
                return
            cur = c.cursor()
            cur.execute(
                f"""CREATE TABLE IF NOT EXISTS {t} (
                    id TEXT PRIMARY KEY,
                    event TEXT NOT NULL,
                    entityType TEXT NOT NULL,
                    entityId TEXT NOT NULL,
                    targetEntityType TEXT,
                    targetEntityId TEXT,
                    properties TEXT NOT NULL,
                    eventTime BIGINT NOT NULL,
                    eventTimeIso TEXT NOT NULL,
                    tags TEXT NOT NULL,
                    prId TEXT,
                    creationTime BIGINT NOT NULL,
                    creationTimeIso TEXT NOT NULL
                )"""
            )
            for name, cols in (("time", "eventTime"), ("entity", "entityType, entityId"),
                               ("name", "event"), ("ctime", "creationTime")):
                cur.execute(f"CREATE INDEX IF NOT EXISTS {t}_{name} ON {t}({cols})")
            c.commit()
            self._known.add((t, id(c)))

    def remove_channel(self, app_id: int, channel_id: Optional[int] = None) -> None:
        t = self._table(app_id, channel_id)
        c = self._conn()
        with self._lock:
            c.execute(f"DROP TABLE IF EXISTS {t}")
            c.commit()
            self._known = {k for k in self._known if k[0] != t}

    @staticmethod
    def _row(event: Event) -> Tuple:
        return (
            event.event_id,
            event.event,
            event.entity_type,
            event.entity_id,
            event.target_entity_type,
            event.target_entity_id,
            json.dumps(event.properties, separators=(",", ":")),
            _ts(event.event_time),
            format_event_time(event.event_time),
            json.dumps(event.tags),
            event.pr_id,
            _ts(event.creation_time),
            format_event_time(event.creation_time),
        )

    def insert(self, event: Event, app_id: int, channel_id: Optional[int] = None) -> str:
        return self.insert_batch([event], app_id, channel_id)[0]

    def insert_batch(
        self, events: Sequence[Event], app_id: int, channel_id: Optional[int] = None
    ) -> List[str]:
        t = self._table(app_id, channel_id)
        rows, ids = [], []
        for e in events:
            validate_event(e)
            e = e.with_id()
            rows.append(self._row(e))
            ids.append(e.event_id)
        self.init_channel(app_id, channel_id)
        c = self._conn()
        with self._lock:
            # re-inserting an existing eventId overwrites (put semantics)
            c.cursor().executemany(
                f"INSERT OR REPLACE INTO {t} ({','.join(_EVENT_COLS)}) "
                f"VALUES ({','.join('?' * len(_EVENT_COLS))})", rows)
            c.commit()
        return ids  # type: ignore[return-value]

    @staticmethod
    def _missing_table(c: sqlite3.Connection, e: BaseException) -> bool:
        """After a failed statement: roll back, then say whether the
        namespace's table does not exist yet (a fresh app reads empty)."""
        try:
            c.rollback()
        except sqlite3.Error:
            pass
        return isinstance(e, sqlite3.OperationalError) and "no such table" in str(e)

    @staticmethod
    def _event_from_row(row: Tuple) -> Event:
        return Event(
            event_id=row[0],
            event=row[1],
            entity_type=row[2],
            entity_id=row[3],
            target_entity_type=row[4],
            target_entity_id=row[5],
            properties=json.loads(row[6]),
            event_time=parse_event_time(row[8]),
            tags=json.loads(row[9]),
            pr_id=row[10],
            creation_time=parse_event_time(row[12]),
        )

    def get(self, event_id: str, app_id: int, channel_id: Optional[int] = None) -> Optional[Event]:
        t = self._table(app_id, channel_id)
        c = self._conn()
        try:
            cur = c.cursor()
            cur.execute(f"SELECT {','.join(_EVENT_COLS)} FROM {t} WHERE id=?", (event_id,))
            row = cur.fetchone()
            c.commit()
        except sqlite3.Error as e:
            if self._missing_table(c, e):
                return None
            raise
        return self._event_from_row(row) if row else None

    def delete(self, event_id: str, app_id: int, channel_id: Optional[int] = None) -> bool:
        t = self._table(app_id, channel_id)
        c = self._conn()
        with self._lock:
            try:
                cur = c.cursor()
                cur.execute(f"DELETE FROM {t} WHERE id=?", (event_id,))
                c.commit()
            except sqlite3.Error as e:
                if self._missing_table(c, e):
                    return False
                raise
        return cur.rowcount > 0

    def wipe(self, app_id: int, channel_id: Optional[int] = None) -> None:
        t = self._table(app_id, channel_id)
        c = self._conn()
        with self._lock:
            try:
                c.cursor().execute(f"DELETE FROM {t}")
                c.commit()
            except sqlite3.Error as e:
                if self._missing_table(c, e):
                    return
                raise

    def find(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        entity_id: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Optional[str] = None,
        target_entity_id: Optional[str] = None,
        limit: Optional[int] = None,
        reversed: bool = False,
    ) -> Iterator[Event]:
        t = self._table(app_id, channel_id)
        clauses, args = [], []
        for col, op, val in (("eventTime", ">=", start_time), ("eventTime", "<", until_time)):
            if val is not None:
                clauses.append(f"{col} {op} ?")
                args.append(_ts(val))
        for col, val in (("entityType", entity_type), ("entityId", entity_id),
                         ("targetEntityType", target_entity_type),
                         ("targetEntityId", target_entity_id)):
            if val is not None:
                clauses.append(f"{col} = ?")
                args.append(val)
        if event_names is not None:
            clauses.append(f"event IN ({','.join('?' * len(event_names))})")
            args.extend(event_names)
        where = (" WHERE " + " AND ".join(clauses)) if clauses else ""
        order = "DESC" if reversed else "ASC"
        lim = f" LIMIT {int(limit)}" if (limit is not None and limit >= 0) else ""
        # the trailing id makes the order total, as in the reference
        sql = (f"SELECT {','.join(_EVENT_COLS)} FROM {t}{where} "
               f"ORDER BY eventTime {order}, creationTime {order}, id {order}{lim}")
        c = self._conn()
        try:
            cur = c.cursor()
            cur.execute(sql, args)
            first = cur.fetchmany(1024)
        except sqlite3.Error as e:
            if self._missing_table(c, e):
                return iter(())
            raise
        if len(first) < 1024:
            c.commit()
            return iter([self._event_from_row(r) for r in first])

        def stream():
            # stream in batches (a training read must not hold the whole
            # table), then end the read transaction
            rows = first
            try:
                while rows:
                    for r in rows:
                        yield self._event_from_row(r)
                    rows = cur.fetchmany(1024)
            finally:
                c.commit()

        return stream()
