"""SQL dialect layer: one store implementation, many DB-API backends.

The port's copy of the JAX package's ``storage/sqldialect.py``. The SQL
stores (:class:`~predictionio_tpu_torch.data.events.SQLEventStore`,
:class:`~predictionio_tpu_torch.storage.meta.MetaStore` and
:class:`~predictionio_tpu_torch.storage.models.SQLModelStore`) are
written once against this small interface, which absorbs the engines'
differences:

- **paramstyle**: sqlite takes ``?`` (qmark); psycopg2 and pymysql take
  ``%s`` (format). Store code writes qmark and :meth:`SQLDialect.sql`
  rewrites it.
- **DDL types**: the autoincrement key's spelling, TEXT against VARCHAR
  for key and indexed columns (MySQL cannot index a bare TEXT), BLOB,
  BYTEA or LONGBLOB.
- **upsert**: INSERT OR REPLACE, ON CONFLICT DO UPDATE or REPLACE INTO.
- **generated keys**: ``lastrowid`` or ``RETURNING id``.
- **index creation**: MySQL has no CREATE INDEX IF NOT EXISTS.
- **errors**: which exception means "table missing", and whether the
  failed transaction must be rolled back first (PostgreSQL).

The tables, columns and types are the JAX package's, so a database that
either package writes through a dialect, the other reads. The PGSQL and
MYSQL dialects bind their drivers (psycopg2, pymysql) when constructed
and raise :class:`~predictionio_tpu_torch.storage.remote.StorageClientError`
naming the driver when it is missing.
"""

from __future__ import annotations

import itertools
import re
import threading
from abc import ABC, abstractmethod
from typing import Any, Dict, Optional, Sequence, Tuple


class SQLDialect(ABC):
    """Engine-specific SQL behavior; one instance per configured source."""

    name: str = "?"
    paramstyle: str = "qmark"          # "qmark" (?) or "format" (%s)
    autoinc_pk: str = "INTEGER PRIMARY KEY AUTOINCREMENT"
    key_type: str = "TEXT"             # string type usable as PK / index
    str_type: str = "TEXT"             # string type for indexed columns
    blob_type: str = "BLOB"
    # Stable identity of the backing database for the snapshot cache;
    # None ⇒ scans through this dialect are never snapshot-cached
    cache_identity: Optional[str] = None

    # -- connections -----------------------------------------------------------

    @abstractmethod
    def connect(self):
        """Open a NEW DB-API connection."""

    def thread_conns(self) -> "_ThreadConns":
        return _ThreadConns(self)

    def set_sync_durable(self, conn, durable: bool) -> None:
        """Raise (or restore) this connection's commit-durability level.
        Durable means a returned commit survives power loss, not just
        process death — the Event Server's durable-ack contract.
        Engines that are always durable (or have no such knob) no-op."""

    # -- statement shaping -----------------------------------------------------

    def sql(self, q: str) -> str:
        """Rewrite qmark placeholders to this dialect's paramstyle."""
        if self.paramstyle == "qmark":
            return q
        return q.replace("?", "%s")

    def upsert(self, table: str, cols: Sequence[str], pk: str) -> str:
        """Full INSERT-or-overwrite statement with qmark placeholders
        (callers pass it through :meth:`sql`)."""
        ph = ",".join("?" * len(cols))
        collist = ",".join(cols)
        return f"INSERT OR REPLACE INTO {table} ({collist}) VALUES ({ph})"

    def insert_returning_id(self, conn, q: str, args: Tuple) -> int:
        """Run an INSERT on a table with an autoincrement id; return it."""
        cur = conn.cursor()
        cur.execute(self.sql(q), args)
        rid = cur.lastrowid
        assert rid is not None
        return int(rid)

    def create_index(self, conn, name: str, table: str, cols: str) -> None:
        conn.cursor().execute(
            f"CREATE INDEX IF NOT EXISTS {name} ON {table}({cols})")

    def binary(self, blob: bytes):
        """Wrap bytes for a BLOB parameter."""
        return blob

    def stream_cursor(self, conn):
        """A cursor suitable for row-streaming large result sets (the
        training-read path must not materialize the whole event table).
        Default DB-API cursors often buffer everything at execute();
        engines with true server-side cursors override."""
        return conn.cursor()

    # -- error taxonomy --------------------------------------------------------

    @abstractmethod
    def is_missing_table(self, exc: BaseException) -> bool:
        """Whether ``exc`` means the statement hit a missing table —
        and ONLY that. Classifying broader error classes as "missing
        table" would let connection failures or SQL bugs read as
        "no events", silently training empty models."""

    def recover(self, conn) -> None:
        """Put the connection back in a usable state after an error
        (PostgreSQL aborts the transaction; others are no-ops)."""
        try:
            conn.rollback()
        except Exception:
            pass


class _ThreadConns:
    """Per-thread connection cache (DB-API conns aren't thread-safe)."""

    def __init__(self, dialect: SQLDialect,
                 shared: Optional[Any] = None) -> None:
        self._dialect = dialect
        self._local = threading.local()
        self._shared = shared  # e.g. sqlite ':memory:' single connection

    def get(self):
        if self._shared is not None:
            return self._shared
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = self._dialect.connect()
            self._local.conn = conn
        return conn


class SqliteDialect(SQLDialect):
    """The reference dialect: file-backed (or ':memory:') SQLite."""

    name = "SQLITE"
    paramstyle = "qmark"

    def __init__(self, path: str) -> None:
        self.path = path
        if path != ":memory:":
            import os

            self.cache_identity = "sqlite:" + os.path.abspath(path)

    def connect(self):
        import sqlite3

        conn = sqlite3.connect(self.path, timeout=30.0,
                               check_same_thread=self.path != ":memory:")
        if self.path != ":memory:":
            conn.execute("PRAGMA journal_mode=WAL")
            conn.execute("PRAGMA synchronous=NORMAL")
        return conn

    def thread_conns(self) -> _ThreadConns:
        # ':memory:' databases exist per-connection: all threads must
        # share the one connection or they see different databases
        if self.path == ":memory:":
            return _ThreadConns(self, shared=self.connect())
        return _ThreadConns(self)

    def set_sync_durable(self, conn, durable: bool) -> None:
        # WAL + NORMAL (the default) fsyncs only at checkpoint: an OS
        # crash can drop the last commits. FULL fsyncs the WAL per
        # commit — what a durable 201 ack requires.
        if self.path != ":memory:":
            conn.execute(
                f"PRAGMA synchronous={'FULL' if durable else 'NORMAL'}")

    def is_missing_table(self, exc: BaseException) -> bool:
        import sqlite3

        return (isinstance(exc, sqlite3.OperationalError)
                and "no such table" in str(exc))


def _server_props(props: Dict[str, str], default_port: int,
                  scheme: str) -> Dict[str, Any]:
    """host/port/user/password/database from a source's env settings —
    either a URL (``PIO_STORAGE_SOURCES_<S>_URL``, with or without the
    reference's ``jdbc:`` prefix) or discrete HOSTS/PORTS/USERNAME/
    PASSWORD/DATABASES keys. A malformed URL raises (silently falling
    back to localhost would point the store at the wrong server)."""
    url = re.sub(r"^jdbc:", "", props.get("URL", ""))
    out: Dict[str, Any] = {
        "host": props.get("HOSTS", "localhost").split(",")[0],
        "port": int(str(props.get("PORTS", default_port)).split(",")[0]),
        "user": props.get("USERNAME") or None,
        "password": props.get("PASSWORD") or None,
        "database": props.get("DATABASES", "pio").split(",")[0],
    }
    if not url:
        return out
    if not url.startswith(scheme + "://"):
        raise ValueError(
            f"cannot parse storage URL {url!r}: expected "
            f"{scheme}://[user[:password]@]host[:port][/database]")
    rest = url[len(scheme) + 3:]
    path = ""
    if "/" in rest:
        rest, path = rest.split("/", 1)
    # split credentials at the LAST '@' — passwords may contain '@'
    if "@" in rest:
        creds, hostport = rest.rsplit("@", 1)
        if ":" in creds:
            out["user"], out["password"] = creds.split(":", 1)
        else:
            out["user"] = creds
    else:
        hostport = rest
    if not hostport:
        raise ValueError(f"cannot parse storage URL {url!r}: empty host")
    if ":" in hostport:
        host, port = hostport.rsplit(":", 1)
        out["host"] = host
        out["port"] = int(port)
    else:
        out["host"] = hostport
    if path:
        out["database"] = path.split("?")[0]
    return out


# psycopg2 named (server-side) cursors need process-unique names
_PG_CURSOR_SEQ = itertools.count(1)


class PostgresDialect(SQLDialect):
    """PostgreSQL via psycopg2 (reference: [U] storage/jdbc on the
    PostgreSQL driver — the default production meta/event store)."""

    name = "PGSQL"
    paramstyle = "format"
    autoinc_pk = "SERIAL PRIMARY KEY"
    key_type = "TEXT"
    str_type = "TEXT"
    blob_type = "BYTEA"

    def __init__(self, props: Optional[Dict[str, str]] = None) -> None:
        from predictionio_tpu_torch.storage.remote import StorageClientError

        try:
            import psycopg2  # type: ignore[import-not-found]
        except ImportError as e:
            raise StorageClientError(
                "storage type PGSQL requires the psycopg2 driver "
                "(pip install psycopg2-binary)") from e
        self._psycopg2 = psycopg2
        self._conninfo = _server_props(props or {}, 5432, "postgresql")
        ci = self._conninfo
        self.cache_identity = (
            f"pgsql://{ci['host']}:{ci['port']}/{ci['database']}")

    def connect(self):
        ci = self._conninfo
        return self._psycopg2.connect(
            host=ci["host"], port=ci["port"], user=ci["user"],
            password=ci["password"], dbname=ci["database"])

    def upsert(self, table: str, cols: Sequence[str], pk: str) -> str:
        ph = ",".join("?" * len(cols))
        collist = ",".join(cols)
        sets = ",".join(f"{c}=EXCLUDED.{c}" for c in cols if c != pk)
        return (f"INSERT INTO {table} ({collist}) VALUES ({ph}) "
                f"ON CONFLICT ({pk}) DO UPDATE SET {sets}")

    def insert_returning_id(self, conn, q: str, args: Tuple) -> int:
        cur = conn.cursor()
        cur.execute(self.sql(q) + " RETURNING id", args)
        return int(cur.fetchone()[0])

    def binary(self, blob: bytes):
        return self._psycopg2.Binary(blob)

    def stream_cursor(self, conn):
        # a named (server-side) cursor actually streams; the default
        # client-side cursor buffers the whole result set at execute()
        return conn.cursor(name=f"pio_stream_{next(_PG_CURSOR_SEQ)}")

    def is_missing_table(self, exc: BaseException) -> bool:
        return isinstance(exc, self._psycopg2.errors.UndefinedTable)


class MySQLDialect(SQLDialect):
    """MySQL via pymysql (reference: [U] storage/jdbc on the MySQL
    driver)."""

    name = "MYSQL"
    paramstyle = "format"
    autoinc_pk = "INTEGER PRIMARY KEY AUTO_INCREMENT"
    # MySQL cannot index/PK bare TEXT; 191 chars keeps utf8mb4 keys
    # inside the 767-byte InnoDB prefix limit
    key_type = "VARCHAR(191)"
    str_type = "VARCHAR(191)"
    blob_type = "LONGBLOB"

    def __init__(self, props: Optional[Dict[str, str]] = None) -> None:
        from predictionio_tpu_torch.storage.remote import StorageClientError

        try:
            import pymysql  # type: ignore[import-not-found]
        except ImportError as e:
            raise StorageClientError(
                "storage type MYSQL requires the pymysql driver "
                "(pip install pymysql)") from e
        self._pymysql = pymysql
        self._conninfo = _server_props(props or {}, 3306, "mysql")
        ci = self._conninfo
        self.cache_identity = (
            f"mysql://{ci['host']}:{ci['port']}/{ci['database']}")

    def connect(self):
        ci = self._conninfo
        return self._pymysql.connect(
            host=ci["host"], port=ci["port"], user=ci["user"],
            password=ci["password"] or "", database=ci["database"])

    def upsert(self, table: str, cols: Sequence[str], pk: str) -> str:
        ph = ",".join("?" * len(cols))
        collist = ",".join(cols)
        return f"REPLACE INTO {table} ({collist}) VALUES ({ph})"

    def create_index(self, conn, name: str, table: str, cols: str) -> None:
        cur = conn.cursor()
        try:
            cur.execute(f"CREATE INDEX {name} ON {table}({cols})")
        except (self._pymysql.err.InternalError,
                self._pymysql.err.OperationalError) as e:
            # 1061 = duplicate key name (CREATE INDEX IF NOT EXISTS is
            # unsupported); anything else is a real failure
            if not (e.args and e.args[0] == 1061):
                raise

    def stream_cursor(self, conn):
        # SSCursor = unbuffered (server-side) streaming cursor
        return conn.cursor(self._pymysql.cursors.SSCursor)

    def is_missing_table(self, exc: BaseException) -> bool:
        # 1146 = ER_NO_SUCH_TABLE; plain ProgrammingError also covers
        # SQL syntax bugs (1064), which must propagate
        return (isinstance(exc, (self._pymysql.err.ProgrammingError,
                                 self._pymysql.err.OperationalError))
                and bool(exc.args) and exc.args[0] == 1146)


def dialect_for(type_name: str, props: Dict[str, str],
                sqlite_path: str) -> SQLDialect:
    """Factory used by the storage registry."""
    t = type_name.upper()
    if t == "SQLITE":
        return SqliteDialect(sqlite_path)
    if t == "PGSQL":
        return PostgresDialect(props)
    if t == "MYSQL":
        return MySQLDialect(props)
    raise KeyError(f"no SQL dialect named {type_name!r}")
