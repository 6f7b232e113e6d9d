"""Meta-data store: apps, access keys, channels, engine and evaluation
instances.

The port's copy of the JAX package's ``storage/meta.py``, on the same
SQLite schema and time format, so an app, key, channel, trained instance
or evaluation instance that one package writes into a ``PIO_HOME`` is
found by the other. The CLI's ``app`` and ``accesskey`` verbs and the
event server's auth read and write apps, keys and channels; training
resolves the app (and channel) named in the variant; serving loads the
latest COMPLETED instance for (engine factory, variant) — the
reference's ``EngineInstances.getLatestCompleted``; ``pio eval`` records
one evaluation instance per grid search, which ``pio evals`` lists.
:class:`MetaStore` runs on any dialect of
:mod:`predictionio_tpu_torch.storage.sqldialect` (SQLite by default, the
PGSQL and MYSQL servers with ``dialect=``); the embedded index's
``ESMetaStore`` (:mod:`predictionio_tpu_torch.storage.indexed`) has the
same methods.
"""

from __future__ import annotations

import datetime as _dt
import json
import secrets
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


# -- meta mutation epoch -------------------------------------------------------
#
# Process-wide generation counter over access-key and channel state. Every
# key or channel mutation bumps it; the event server's AuthCache compares it
# on each lookup and drops its entries when it moves, so a revocation in
# the same process is immediate. Mutations by another process are seen
# only after the cache's TTL.

_META_EPOCH = 0
_META_EPOCH_LOCK = threading.Lock()


def bump_meta_epoch() -> None:
    """Record an access-key/channel mutation (invalidates auth caches)."""
    global _META_EPOCH
    with _META_EPOCH_LOCK:
        _META_EPOCH += 1


def meta_epoch() -> int:
    return _META_EPOCH


def utcnow() -> _dt.datetime:
    return _dt.datetime.now(_dt.timezone.utc)


def format_time(dt: _dt.datetime) -> str:
    """ISO-8601 with milliseconds, e.g. ``2026-07-29T12:34:56.789+00:00``."""
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=_dt.timezone.utc)
    return dt.isoformat(timespec="milliseconds")


def parse_time(value: str) -> _dt.datetime:
    s = value.strip()
    if s.endswith("Z"):
        s = s[:-1] + "+00:00"
    dt = _dt.datetime.fromisoformat(s)
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=_dt.timezone.utc)
    return dt


@dataclass
class App:
    id: int
    name: str
    description: str = ""


@dataclass
class AccessKey:
    key: str
    app_id: int
    events: List[str] = field(default_factory=list)  # empty = all events permitted


@dataclass
class Channel:
    id: int
    name: str
    app_id: int


@dataclass
class EngineInstance:
    """One train run's record; serving loads the latest COMPLETED one."""

    id: str
    status: str  # INIT | TRAINING | COMPLETED | FAILED
    start_time: _dt.datetime
    end_time: Optional[_dt.datetime]
    engine_factory: str  # "module.path:factory_callable"
    engine_variant: str
    batch: str
    env: Dict[str, str]
    mesh_conf: Dict[str, Any]
    data_source_params: str
    preparator_params: str
    algorithms_params: str
    serving_params: str


@dataclass
class EvaluationInstance:
    """One ``pio eval`` run's record (EVALUATING → EVALCOMPLETED or FAILED)."""

    id: str
    status: str
    start_time: _dt.datetime
    end_time: Optional[_dt.datetime]
    evaluation_class: str
    engine_params_generator_class: str
    batch: str
    env: Dict[str, str]
    evaluator_results: str = ""        # human-readable summary
    evaluator_results_html: str = ""
    evaluator_results_json: str = ""   # structured per-candidate scores


def _schema(d) -> List[str]:
    """The DDL on dialect ``d``: the autoincrement key's spelling and the
    indexable string types come from the dialect (MySQL cannot make a
    bare TEXT a key or UNIQUE); on SQLite it is the JAX package's."""
    return [
        f"""CREATE TABLE IF NOT EXISTS apps (
    id {d.autoinc_pk},
    name {d.str_type} UNIQUE NOT NULL,
    description TEXT NOT NULL
)""",
        f"""CREATE TABLE IF NOT EXISTS access_keys (
    accesskey {d.key_type} PRIMARY KEY,
    appid INTEGER NOT NULL,
    events TEXT NOT NULL
)""",
        f"""CREATE TABLE IF NOT EXISTS channels (
    id {d.autoinc_pk},
    name {d.str_type} NOT NULL,
    appid INTEGER NOT NULL,
    UNIQUE(name, appid)
)""",
        f"""CREATE TABLE IF NOT EXISTS engine_instances (
    id {d.key_type} PRIMARY KEY,
    status TEXT NOT NULL,
    startTime TEXT NOT NULL,
    endTime TEXT,
    engineFactory TEXT NOT NULL,
    engineVariant TEXT NOT NULL,
    batch TEXT NOT NULL,
    env TEXT NOT NULL,
    meshConf TEXT NOT NULL,
    dataSourceParams TEXT NOT NULL,
    preparatorParams TEXT NOT NULL,
    algorithmsParams TEXT NOT NULL,
    servingParams TEXT NOT NULL
)""",
        f"""CREATE TABLE IF NOT EXISTS evaluation_instances (
    id {d.key_type} PRIMARY KEY,
    status TEXT NOT NULL,
    startTime TEXT NOT NULL,
    endTime TEXT,
    evaluationClass TEXT NOT NULL,
    engineParamsGeneratorClass TEXT NOT NULL,
    batch TEXT NOT NULL,
    env TEXT NOT NULL,
    evaluatorResults TEXT NOT NULL,
    evaluatorResultsHTML TEXT NOT NULL,
    evaluatorResultsJSON TEXT NOT NULL
)""",
    ]

_EI_COLS = ("id", "status", "startTime", "endTime", "engineFactory",
            "engineVariant", "batch", "env", "meshConf", "dataSourceParams",
            "preparatorParams", "algorithmsParams", "servingParams")
_VI_COLS = ("id", "status", "startTime", "endTime", "evaluationClass",
            "engineParamsGeneratorClass", "batch", "env", "evaluatorResults",
            "evaluatorResultsHTML", "evaluatorResultsJSON")


class MetaStore:
    """SQL-backed meta store: SQLite at ``path`` by default
    (``':memory:'`` for tests), or any dialect given as ``dialect=``
    (PGSQL, MYSQL). One connection per thread; an in-memory SQLite
    database exists per connection, so all threads share one. Reads
    commit too, and a failed statement rolls the connection back: server
    engines run every statement in a transaction (PostgreSQL aborts it
    on an error)."""

    def __init__(self, path: str = ":memory:", dialect=None) -> None:
        from predictionio_tpu_torch.storage.sqldialect import SqliteDialect

        self._path = path
        self._d = dialect if dialect is not None else SqliteDialect(path)
        self._conns = self._d.thread_conns()
        self._lock = threading.RLock()
        with self._lock:
            c = self._conn()
            cur = c.cursor()
            for stmt in _schema(self._d):
                cur.execute(stmt)
            c.commit()

    def _conn(self):
        return self._conns.get()

    def _q(self, q: str, args: tuple = ()) -> List[tuple]:
        with self._lock:
            c = self._conn()
            try:
                cur = c.cursor()
                cur.execute(self._d.sql(q), args)
                rows = cur.fetchall()
                c.commit()
            except Exception:
                self._d.recover(c)
                raise
        return rows

    def _q1(self, q: str, args: tuple = ()) -> Optional[tuple]:
        rows = self._q(q, args)
        return rows[0] if rows else None

    def _x(self, q: str, args: tuple = ()) -> int:
        """Run one write; returns its row count."""
        with self._lock:
            c = self._conn()
            try:
                cur = c.cursor()
                cur.execute(self._d.sql(q), args)
                c.commit()
            except Exception:
                self._d.recover(c)
                raise
        return cur.rowcount

    def _insert_id(self, q: str, args: tuple) -> int:
        """Run one INSERT into a table with an autoincrement id; returns it."""
        with self._lock:
            c = self._conn()
            try:
                rid = self._d.insert_returning_id(c, q, args)
                c.commit()
            except Exception:
                # a duplicate-name race must not poison this thread's
                # cached connection
                self._d.recover(c)
                raise
        return rid

    # -- apps ------------------------------------------------------------------

    def create_app(self, name: str, description: str = "") -> App:
        rid = self._insert_id("INSERT INTO apps(name, description) VALUES (?,?)",
                              (name, description))
        return App(id=rid, name=name, description=description)

    def get_app(self, app_id: int) -> Optional[App]:
        row = self._q1("SELECT id,name,description FROM apps WHERE id=?", (app_id,))
        return App(*row) if row else None

    def get_app_by_name(self, name: str) -> Optional[App]:
        row = self._q1("SELECT id,name,description FROM apps WHERE name=?", (name,))
        return App(*row) if row else None

    def list_apps(self) -> List[App]:
        return [App(*r) for r in self._q(
            "SELECT id,name,description FROM apps ORDER BY id")]

    def delete_app(self, app_id: int) -> bool:
        """Delete the app with its keys and channels (one transaction)."""
        with self._lock:
            c = self._conn()
            try:
                cur = c.cursor()
                cur.execute(self._d.sql("DELETE FROM apps WHERE id=?"), (app_id,))
                existed = cur.rowcount > 0
                cur.execute(self._d.sql("DELETE FROM access_keys WHERE appid=?"), (app_id,))
                cur.execute(self._d.sql("DELETE FROM channels WHERE appid=?"), (app_id,))
                c.commit()
            except Exception:
                self._d.recover(c)
                raise
        bump_meta_epoch()  # the app's keys and channels went with it
        return existed

    # -- access keys -----------------------------------------------------------

    def create_access_key(self, app_id: int, events: Optional[List[str]] = None,
                          key: Optional[str] = None) -> AccessKey:
        key = key or secrets.token_urlsafe(48)
        self._x("INSERT INTO access_keys(accesskey, appid, events) VALUES (?,?,?)",
                (key, app_id, json.dumps(events or [])))
        bump_meta_epoch()
        return AccessKey(key=key, app_id=app_id, events=events or [])

    def get_access_key(self, key: str) -> Optional[AccessKey]:
        row = self._q1("SELECT accesskey,appid,events FROM access_keys "
                       "WHERE accesskey=?", (key,))
        return AccessKey(row[0], row[1], json.loads(row[2])) if row else None

    def list_access_keys(self, app_id: Optional[int] = None) -> List[AccessKey]:
        if app_id is None:
            rows = self._q("SELECT accesskey,appid,events FROM access_keys")
        else:
            rows = self._q("SELECT accesskey,appid,events FROM access_keys "
                           "WHERE appid=?", (app_id,))
        return [AccessKey(r[0], r[1], json.loads(r[2])) for r in rows]

    def delete_access_key(self, key: str) -> bool:
        deleted = self._x("DELETE FROM access_keys WHERE accesskey=?",
                          (key,)) > 0
        bump_meta_epoch()
        return deleted

    # -- channels --------------------------------------------------------------

    def create_channel(self, app_id: int, name: str) -> Channel:
        rid = self._insert_id("INSERT INTO channels(name, appid) VALUES (?,?)",
                              (name, app_id))
        bump_meta_epoch()
        return Channel(id=rid, name=name, app_id=app_id)

    def get_channel_by_name(self, app_id: int, name: str) -> Optional[Channel]:
        row = self._q1("SELECT id,name,appid FROM channels WHERE appid=? AND name=?",
                       (app_id, name))
        return Channel(*row) if row else None

    def list_channels(self, app_id: int) -> List[Channel]:
        return [Channel(*r) for r in self._q(
            "SELECT id,name,appid FROM channels WHERE appid=? ORDER BY id",
            (app_id,))]

    def delete_channel(self, channel_id: int) -> bool:
        deleted = self._x("DELETE FROM channels WHERE id=?",
                          (channel_id,)) > 0
        bump_meta_epoch()
        return deleted

    # -- engine instances --------------------------------------------------------

    def insert_engine_instance(self, ei: EngineInstance) -> None:
        self._x(
            self._d.upsert("engine_instances", _EI_COLS, "id"),
            (
                ei.id, ei.status, format_time(ei.start_time),
                format_time(ei.end_time) if ei.end_time else None,
                ei.engine_factory, ei.engine_variant, ei.batch,
                json.dumps(ei.env), json.dumps(ei.mesh_conf),
                ei.data_source_params, ei.preparator_params,
                ei.algorithms_params, ei.serving_params,
            ),
        )

    def update_engine_instance(self, ei: EngineInstance) -> None:
        self.insert_engine_instance(ei)

    @staticmethod
    def _ei_from_row(r) -> EngineInstance:
        return EngineInstance(
            id=r[0], status=r[1],
            start_time=parse_time(r[2]),
            end_time=parse_time(r[3]) if r[3] else None,
            engine_factory=r[4], engine_variant=r[5], batch=r[6],
            env=json.loads(r[7]), mesh_conf=json.loads(r[8]),
            data_source_params=r[9], preparator_params=r[10],
            algorithms_params=r[11], serving_params=r[12],
        )

    def get_engine_instance(self, instance_id: str) -> Optional[EngineInstance]:
        row = self._q1(
            f"SELECT {','.join(_EI_COLS)} FROM engine_instances WHERE id=?",
            (instance_id,))
        return self._ei_from_row(row) if row else None

    def get_latest_completed_engine_instance(
        self, engine_factory: str, engine_variant: str = ""
    ) -> Optional[EngineInstance]:
        q = (f"SELECT {','.join(_EI_COLS)} FROM engine_instances "
             "WHERE status='COMPLETED' AND engineFactory=?")
        args: List[Any] = [engine_factory]
        if engine_variant:
            q += " AND engineVariant=?"
            args.append(engine_variant)
        q += " ORDER BY startTime DESC LIMIT 1"
        row = self._q1(q, tuple(args))
        return self._ei_from_row(row) if row else None

    def list_engine_instances(self) -> List[EngineInstance]:
        """Every engine instance, newest first."""
        return [self._ei_from_row(r) for r in self._q(
            f"SELECT {','.join(_EI_COLS)} FROM engine_instances "
            "ORDER BY startTime DESC")]

    # -- evaluation instances --------------------------------------------------

    def insert_evaluation_instance(self, vi: EvaluationInstance) -> None:
        self._x(
            self._d.upsert("evaluation_instances", _VI_COLS, "id"),
            (
                vi.id, vi.status, format_time(vi.start_time),
                format_time(vi.end_time) if vi.end_time else None,
                vi.evaluation_class, vi.engine_params_generator_class,
                vi.batch, json.dumps(vi.env), vi.evaluator_results,
                vi.evaluator_results_html, vi.evaluator_results_json,
            ),
        )

    def update_evaluation_instance(self, vi: EvaluationInstance) -> None:
        self.insert_evaluation_instance(vi)

    @staticmethod
    def _vi_from_row(r) -> EvaluationInstance:
        return EvaluationInstance(
            id=r[0], status=r[1],
            start_time=parse_time(r[2]),
            end_time=parse_time(r[3]) if r[3] else None,
            evaluation_class=r[4], engine_params_generator_class=r[5],
            batch=r[6], env=json.loads(r[7]), evaluator_results=r[8],
            evaluator_results_html=r[9], evaluator_results_json=r[10],
        )

    def get_evaluation_instance(self, instance_id: str) -> Optional[EvaluationInstance]:
        row = self._q1(
            f"SELECT {','.join(_VI_COLS)} FROM evaluation_instances "
            "WHERE id=?", (instance_id,))
        return self._vi_from_row(row) if row else None

    def list_evaluation_instances(self) -> List[EvaluationInstance]:
        return [self._vi_from_row(r) for r in self._q(
            f"SELECT {','.join(_VI_COLS)} FROM evaluation_instances "
            "ORDER BY startTime DESC")]

    def new_instance_id(self) -> str:
        return utcnow().strftime("%Y%m%d%H%M%S") + "-" + secrets.token_hex(4)
