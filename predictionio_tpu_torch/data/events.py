"""Event stores: the backend SPI, the in-memory store and the SQL stores.

The port's copy of the JAX package's ``data/events.py``: ``MEMORY`` and
the SQL store on any dialect of
:mod:`predictionio_tpu_torch.storage.sqldialect` (``SQLITE``, the
default, and the ``PGSQL`` and ``MYSQL`` servers); the native event log
(``EVENTLOG``) is :mod:`predictionio_tpu_torch.data.filestore` and the
embedded index (``ELASTICSEARCH``) :mod:`predictionio_tpu_torch.storage.indexed`.
The SQL store keeps the reference's table per (app, channel) namespace
(``pio_event_<appId>[_<channelId>]``), its schema, its indexes and its
scan order, so events the JAX package wrote into a ``PIO_HOME`` or a
database are read by the port and the other way round. It also has the
JAX package's columnar training read (:meth:`SQLEventStore.scan_columnar`)
with the snapshot cache's probes (``cache_identity``, ``sqlite:<abspath>``
on SQLite, and :meth:`~SQLEventStore.creation_stats`), so every backend
takes the reference's read path. Replication is not ported yet.
"""

from __future__ import annotations

import datetime as _dt
import json
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

    # Stable identity of the backing data for the snapshot cache (an
    # absolute path). None: no durable identity (in-memory stores), so
    # scans are never snapshot-cached.
    cache_identity: Optional[str] = None

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

    def creation_stats(
        self, app_id: int, channel_id: Optional[int] = None,
        until_us: Optional[int] = None,
    ) -> Optional[Tuple[int, Optional[int]]]:
        """(live event count, max creationTime epoch-µs) over the
        namespace, optionally restricted to creationTime ≤ ``until_us``:
        the snapshot cache's watermark and invalidation probe. Returns
        ``(0, None)`` for an empty namespace and None when the backend
        cannot answer cheaply (caching is then skipped)."""
        return None

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


class SQLEventStore(EventStore):
    """Durable event store on any SQL engine with a dialect
    (:mod:`predictionio_tpu_torch.storage.sqldialect`): the JAX package's
    ``SQLEventStore``. One table per (app, channel) namespace,
    ``pio_event_<appId>[_<channelId>]``, indexed on eventTime, entity,
    event name and creationTime; one connection per thread. Each
    connection commits at the dialect's normal durability, or at its
    durable level (SQLite: an fsync of the WAL per commit) after
    ``set_durable``."""

    def __init__(self, dialect) -> None:
        self._d = dialect
        self._conns = dialect.thread_conns()
        self._lock = threading.RLock()
        self._tl = threading.local()  # the sync level this thread's connection has
        self._known: set = set()  # (table, connection) whose DDL already ran
        self._sync = "NORMAL"

    @property
    def cache_identity(self) -> Optional[str]:  # type: ignore[override]
        # the snapshot cache's key: the dialect's identity, the JAX
        # package's, so one snapshot serves both packages
        return self._d.cache_identity

    def set_durable(self, durable: bool = True) -> None:
        # each thread's connection takes the level the next time it is used
        self._sync = "FULL" if durable else "NORMAL"

    def _conn(self):
        c = self._conns.get()
        sync = self._sync
        if getattr(self._tl, "sync", "NORMAL") != sync:
            self._d.set_sync_durable(c, sync == "FULL")
            self._tl.sync = sync
        return c

    @staticmethod
    def _table(app_id: int, channel_id: Optional[int]) -> str:
        return f"pio_event_{app_id}" + (f"_{channel_id}" if channel_id is not None else "")

    def init_channel(self, app_id: int, channel_id: Optional[int] = None) -> None:
        t = self._table(app_id, channel_id)
        d = self._d
        c = self._conn()
        with self._lock:
            if (t, id(c)) in self._known:
                return
            c.cursor().execute(
                f"""CREATE TABLE IF NOT EXISTS {t} (
                    id {d.key_type} PRIMARY KEY,
                    event {d.str_type} NOT NULL,
                    entityType {d.str_type} NOT NULL,
                    entityId {d.str_type} NOT NULL,
                    targetEntityType {d.str_type},
                    targetEntityId {d.str_type},
                    properties TEXT NOT NULL,
                    eventTime BIGINT NOT NULL,
                    eventTimeIso TEXT NOT NULL,
                    tags TEXT NOT NULL,
                    prId {d.str_type},
                    creationTime BIGINT NOT NULL,
                    creationTimeIso TEXT NOT NULL
                )"""
            )
            for name, cols in (("time", "eventTime"), ("entity", "entityType, entityId"),
                               ("name", "event"), ("ctime", "creationTime")):
                d.create_index(c, f"{t}_{name}", t, cols)
            c.commit()
            self._known.add((t, id(c)))

    def remove_channel(self, app_id: int, channel_id: Optional[int] = None) -> None:
        t = self._table(app_id, channel_id)
        c = self._conn()
        with self._lock:
            c.cursor().execute(f"DROP TABLE IF EXISTS {t}")
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
                self._d.sql(self._d.upsert(t, _EVENT_COLS, "id")), rows)
            c.commit()
        return ids  # type: ignore[return-value]

    def _missing_table(self, c, e: BaseException) -> bool:
        """After a failed statement: put the connection back in a usable
        state (PostgreSQL aborts the transaction), then say whether the
        namespace's table does not exist yet (a fresh app reads empty).
        Callers re-raise anything else."""
        self._d.recover(c)
        return self._d.is_missing_table(e)

    def _end_read(self, c) -> None:
        """Commit a read: server engines otherwise pin a stale snapshot
        (MySQL REPEATABLE READ) or sit idle in a transaction (PostgreSQL)
        on this thread's cached connection."""
        try:
            c.commit()
        except Exception:
            self._d.recover(c)

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
            cur.execute(self._d.sql(f"SELECT {','.join(_EVENT_COLS)} FROM {t} WHERE id=?"),
                        (event_id,))
            row = cur.fetchone()
            c.commit()
        except Exception as e:
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
                cur.execute(self._d.sql(f"DELETE FROM {t} WHERE id=?"), (event_id,))
                c.commit()
            except Exception as e:
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
            except Exception as e:
                if self._missing_table(c, e):
                    return
                raise

    @staticmethod
    def _where(start_time, until_time, entity_type, entity_id,
               event_names, target_entity_type, target_entity_id):
        """The filters as SQL, shared by find() and scan_columnar so that
        the two read paths never filter differently."""
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
        return clauses, args

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
        clauses, args = self._where(start_time, until_time, entity_type, entity_id,
                                    event_names, target_entity_type, target_entity_id)
        where = (" WHERE " + " AND ".join(clauses)) if clauses else ""
        order = "DESC" if reversed else "ASC"
        lim = f" LIMIT {int(limit)}" if (limit is not None and limit >= 0) else ""
        # the trailing id makes the order total, as in the reference
        sql = (f"SELECT {','.join(_EVENT_COLS)} FROM {t}{where} "
               f"ORDER BY eventTime {order}, creationTime {order}, id {order}{lim}")
        c = self._conn()
        try:
            # a server-side cursor streams; server engines report a
            # missing table at the first fetch, so it is inside the try
            cur = self._d.stream_cursor(c)
            cur.execute(self._d.sql(sql), args)
            first = cur.fetchmany(1024)
        except Exception as e:
            if self._missing_table(c, e):
                return iter(())
            raise
        if len(first) < 1024:
            # all read: end the read transaction now, since an abandoned
            # generator would never commit
            self._end_read(c)
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
                self._end_read(c)

        return stream()

    def scan_columnar(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        target_entity_type: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        value_key: Optional[str] = None,
        created_after_us: Optional[int] = None,
        created_until_us: Optional[int] = None,
    ):
        """Columnar training read (the contract of the EVENTLOG scan,
        :class:`~predictionio_tpu_torch.data.pipeline.ColumnarEvents`):
        select only the five columns training needs and accumulate them
        straight into index arrays and first-seen vocabularies; a row's
        properties JSON is parsed only when ``value_key`` is set and the
        text can hold it. Values follow the shared grammar
        (``data/store._parse_value``), as on the other paths.

        ``created_after_us`` (exclusive) and ``created_until_us``
        (inclusive) bound creationTime: the snapshot cache's delta
        window, on the ``{t}_ctime`` index."""
        from predictionio_tpu_torch.data.pipeline import columnar_from_rows

        t = self._table(app_id, channel_id)
        clauses, args = self._where(start_time, until_time, entity_type, None,
                                    event_names, target_entity_type, None)
        if created_after_us is not None:
            clauses.append("creationTime > ?")
            args.append(int(created_after_us))
        if created_until_us is not None:
            clauses.append("creationTime <= ?")
            args.append(int(created_until_us))
        clauses = ["targetEntityId IS NOT NULL",
                   "targetEntityId != ''"] + clauses
        sql = (f"SELECT event,entityId,targetEntityId,properties,eventTime "
               f"FROM {t} WHERE {' AND '.join(clauses)} "
               f"ORDER BY eventTime ASC, creationTime ASC, id ASC")
        c = self._conn()
        try:
            cur = self._d.stream_cursor(c)
            cur.execute(self._d.sql(sql), args)
            rows = cur.fetchmany(8192)
        except Exception as e:
            if not self._missing_table(c, e):
                raise
            rows = []

        def row_iter():
            nonlocal rows
            try:
                while rows:
                    yield from rows
                    rows = cur.fetchmany(8192)
            finally:
                self._end_read(c)

        cols = columnar_from_rows(row_iter(), value_key)
        if cols is not None:
            from predictionio_tpu_torch.utils import tracing

            tracing.add_attrs(scan_backend="sql", scan_records=int(cols.n))
        return cols

    def creation_stats(
        self, app_id: int, channel_id: Optional[int] = None,
        until_us: Optional[int] = None,
    ) -> Optional[Tuple[int, Optional[int]]]:
        t = self._table(app_id, channel_id)
        where = ""
        args: Tuple = ()
        if until_us is not None:
            where = " WHERE creationTime <= ?"
            args = (int(until_us),)
        c = self._conn()
        try:
            cur = c.cursor()
            cur.execute(self._d.sql(f"SELECT COUNT(*), MAX(creationTime) FROM {t}{where}"),
                        args)
            row = cur.fetchone()
            c.commit()
        except Exception as e:
            if self._missing_table(c, e):
                return (0, None)
            raise
        count = int(row[0]) if row and row[0] is not None else 0
        if count == 0:
            return (0, None)
        return (count, int(row[1]))


class SqliteEventStore(SQLEventStore):
    """Durable event store on SQLite (the default backend): the SQLite
    dialect's ``SQLEventStore``, one connection per thread in WAL mode
    (``':memory:'`` shares one connection, since such a database exists
    per connection); ``cache_identity`` is ``sqlite:<abspath>``."""

    def __init__(self, path: str) -> None:
        from predictionio_tpu_torch.storage.sqldialect import SqliteDialect

        super().__init__(SqliteDialect(path))
        self._path = path
