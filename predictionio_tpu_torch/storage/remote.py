"""Network storage backends: the S3 and HDFS model stores, the SQL
servers' registrations and the segment cold tiers.

The port's copy of the JAX package's ``storage/remote.py``. Each store
binds its client library when constructed (boto3 for S3, pyarrow with
libhdfs for HDFS, psycopg2 or pymysql for the SQL servers) and raises
:class:`StorageClientError` naming it when it is missing; nothing falls
back to another store. The PGSQL and MYSQL types run the shared SQL
stores (events, meta, model blobs) on their engine's dialect
(:mod:`predictionio_tpu_torch.storage.sqldialect`). Every network call
goes through :class:`_ResilientCalls`: retries with backoff, a breaker
per backend and a named fault site (``models.s3``, ``models.hdfs``,
``segments.cold``). The model stores keep the JAX package's layout,
``<base>/<instance_id>.bin`` beside a ``.sha256`` digest object, so a
bucket or directory one package writes, the other reads.

Config (the reference's ``pio-env.sh`` names)::

    PIO_STORAGE_SOURCES_<S>_TYPE=S3|HDFS|PGSQL|MYSQL
    PIO_STORAGE_SOURCES_<S>_BUCKET_NAME / _BASE_PATH   (S3)
    PIO_STORAGE_SOURCES_<S>_HOSTS / _PORTS / _PATH     (HDFS)
    PIO_STORAGE_SOURCES_<S>_URL / _USERNAME / _PASSWORD (SQL)

Sealed event-log segments ship to :class:`LocalDirSegmentTier`,
:class:`S3SegmentTier` or :class:`HDFSSegmentTier`, selected by
``PIO_SEGMENT_COLD`` (:func:`segment_cold_tier`).
"""

from __future__ import annotations

import os
import re
from typing import Any, Callable, List, Optional

from predictionio_tpu_torch.storage.models import ModelStore
from predictionio_tpu_torch.utils import faults, integrity, tracing
from predictionio_tpu_torch.utils.resilience import (
    CircuitBreaker,
    parse_retry_after,
    retry_with_backoff,
)


class StorageClientError(RuntimeError):
    """Backend selected but unusable (missing client library / bad config) —
    reference: StorageClientException."""


class _ResilientCalls:
    """Retry + circuit-breaker wrapping shared by the network model
    stores: transient faults are retried with backoff + full jitter,
    repeated failures trip the store's breaker open so model fetches
    fail fast (``CircuitOpenError``) instead of stacking SDK timeouts —
    a serving-path ``/reload`` against a dead object store then answers
    in milliseconds, not after minutes of retry stacking.

    Each call also passes the store's named fault-injection site, so a
    hung or down S3/HDFS is reproducible in tests.
    """

    #: per-store-type breakers are shared across instances of the same
    #: backend — two handles on one dead S3 endpoint should learn from
    #: each other's failures
    _breakers: dict = {}

    def _init_resilience(self, kind: str, retries: int = 2,
                         fault_site: Optional[str] = None) -> None:
        """``fault_site`` overrides the default ``models.{kind}`` site
        — the segment cold tiers share one ``segments.cold`` site
        across backends (one drill covers local/S3/HDFS alike)."""
        self._kind = kind
        self._fault_site = fault_site or f"models.{kind}"
        self._retries = retries
        breaker = _ResilientCalls._breakers.get(kind)
        if breaker is None:
            breaker = CircuitBreaker(f"model_store_{kind}",
                                     failure_threshold=4, reset_timeout=15.0)
            _ResilientCalls._breakers[kind] = breaker
        self.breaker = breaker

    @staticmethod
    def _attach_retry_hint(e: BaseException) -> None:
        """Copy a server-provided ``Retry-After`` (botocore throttling
        responses carry one in the response metadata) onto the
        exception, where ``retry_with_backoff`` reads it and waits the
        server's window instead of its own exponential guess."""
        if getattr(e, "retry_after", None) is not None:
            return
        meta = getattr(e, "response", None)
        if not isinstance(meta, dict):
            return
        headers = (meta.get("ResponseMetadata") or {}).get(
            "HTTPHeaders") or {}
        hint = parse_retry_after(headers.get("retry-after"))
        if hint is not None:
            try:
                e.retry_after = hint
            except AttributeError:
                pass

    def _call(self, fn: Callable[[], Any]) -> Any:
        site = self._fault_site

        def guarded() -> Any:
            # the fault fires INSIDE the breaker so injected failures
            # trip it exactly like real ones
            faults.inject(site)
            try:
                return fn()
            except Exception as e:
                self._attach_retry_hint(e)
                raise

        def attempt() -> Any:
            return self.breaker.call(guarded)

        return retry_with_backoff(
            self._retries, base=0.05, cap=1.0)(attempt)()


def _source_env(key: str, default: str = "") -> str:
    # any source name may carry the setting; first match wins. Source
    # names are discovered from their (mandatory) _TYPE key, so names
    # with underscores (MY_PG) resolve too — and because the name is
    # matched as a whole, *_BASE_PATH can never shadow a lookup of PATH.
    names = [m.group(1) for k in os.environ
             if (m := re.match(r"^PIO_STORAGE_SOURCES_(.+)_TYPE$", k))]
    for name in names:
        v = os.environ.get(f"PIO_STORAGE_SOURCES_{name}_{key}")
        if v is not None:
            return v
    return default


class S3ModelStore(_ResilientCalls, ModelStore):
    """Model blobs on S3 (reference: [U] storage/s3/ S3Models).

    ``props`` = the backing source's settings (StorageConfig
    ``source_properties``); direct construction may pass bucket/base
    explicitly or fall back to a single-source env scan.
    """

    def __init__(self, bucket: Optional[str] = None,
                 base_path: Optional[str] = None,
                 props: Optional[dict] = None) -> None:
        try:
            import boto3  # type: ignore[import-not-found]
        except ImportError as e:
            raise StorageClientError(
                "MODELDATA type S3 requires the boto3 driver "
                "(pip install boto3)") from e
        props = props or {}
        self.bucket = (bucket or props.get("BUCKET_NAME")
                       or _source_env("BUCKET_NAME"))
        if not self.bucket:
            raise StorageClientError(
                "S3 model store needs PIO_STORAGE_SOURCES_<S>_BUCKET_NAME")
        self.base = (base_path or props.get("BASE_PATH")
                     or _source_env("BASE_PATH", "pio_models")).strip("/")
        self._s3 = boto3.client("s3")
        self._init_resilience("s3")

    def _key(self, instance_id: str) -> str:
        return f"{self.base}/{instance_id}.bin"

    def put(self, instance_id: str, blob: bytes) -> None:
        key = self._key(instance_id)
        with tracing.span("storage.s3.put", instance_id=instance_id,
                          bytes=len(blob)):
            # blob first, digest sidecar last: a failure between the two
            # leaves a pair that get() refuses — fail-safe
            self._call(lambda: self._s3.put_object(
                Bucket=self.bucket, Key=key, Body=blob))
            self._call(lambda: self._s3.put_object(
                Bucket=self.bucket, Key=key + integrity.DIGEST_SUFFIX,
                Body=integrity.sha256_hex(blob).encode("ascii")))

    def get(self, instance_id: str) -> Optional[bytes]:
        key = self._key(instance_id)

        def fetch() -> Optional[bytes]:
            # a missing key is a RESULT, not a fault: kept inside the
            # guarded call so it neither retries nor trips the breaker
            try:
                r = self._s3.get_object(Bucket=self.bucket, Key=key)
            except self._s3.exceptions.NoSuchKey:
                return None
            return r["Body"].read()

        def fetch_digest() -> Optional[bytes]:
            try:
                r = self._s3.get_object(
                    Bucket=self.bucket, Key=key + integrity.DIGEST_SUFFIX)
            except self._s3.exceptions.NoSuchKey:
                return None  # pre-integrity blob: accepted, fsck flags it
            return r["Body"].read()

        with tracing.span("storage.s3.get", instance_id=instance_id) as sp:
            blob = self._call(fetch)
            if blob is None:
                sp.set_attr("found", False)
                return None
            sp.set_attr("bytes", len(blob))
            expected = self._call(fetch_digest)
            blob = faults.corrupt_bytes("data.corrupt.model", blob)
            integrity.verify_blob(
                blob, expected.decode("ascii") if expected else None,
                "model", instance_id)
            return blob

    def delete(self, instance_id: str) -> bool:
        key = self._key(instance_id)
        self._call(lambda: self._s3.delete_object(
            Bucket=self.bucket, Key=key))
        self._call(lambda: self._s3.delete_object(
            Bucket=self.bucket, Key=key + integrity.DIGEST_SUFFIX))
        return True

    def list_ids(self) -> List[str]:
        def scan() -> List[str]:
            out, token = [], None
            while True:
                kw = {"Bucket": self.bucket, "Prefix": self.base + "/"}
                if token:
                    kw["ContinuationToken"] = token
                r = self._s3.list_objects_v2(**kw)
                out += [o["Key"][len(self.base) + 1:-4]
                        for o in r.get("Contents", ())
                        if o["Key"].endswith(".bin")]
                if not r.get("IsTruncated"):
                    return out
                token = r.get("NextContinuationToken")

        return self._call(scan)


class HDFSModelStore(_ResilientCalls, ModelStore):
    """Model blobs on HDFS via pyarrow (reference: [U] storage/hdfs/
    HDFSModels). Needs libhdfs (a Hadoop install) at runtime."""

    def __init__(self, host: Optional[str] = None, port: Optional[int] = None,
                 path: Optional[str] = None,
                 props: Optional[dict] = None) -> None:
        try:
            from pyarrow import fs
        except ImportError as e:  # pragma: no cover - pyarrow is baked in
            raise StorageClientError(
                "MODELDATA type HDFS requires pyarrow") from e
        props = props or {}
        host = host or props.get("HOSTS") or _source_env("HOSTS", "default")
        port = port if port is not None else int(
            props.get("PORTS") or _source_env("PORTS", "8020"))
        self.root = (path or props.get("PATH")
                     or _source_env("PATH", "/pio_models")).rstrip("/")
        try:
            self._fs = fs.HadoopFileSystem(host, port)
        except Exception as e:
            raise StorageClientError(
                f"cannot reach HDFS at {host}:{port} (libhdfs present?): {e}"
            ) from e
        self._init_resilience("hdfs")

    def _key(self, instance_id: str) -> str:
        return f"{self.root}/{instance_id}.bin"

    def put(self, instance_id: str, blob: bytes) -> None:
        key = self._key(instance_id)

        def write() -> None:
            self._fs.create_dir(self.root, recursive=True)
            with self._fs.open_output_stream(key) as f:
                f.write(blob)

        def write_digest() -> None:
            with self._fs.open_output_stream(
                    key + integrity.DIGEST_SUFFIX) as f:
                f.write(integrity.sha256_hex(blob).encode("ascii"))

        # blob first, digest sidecar last — fail-safe ordering
        with tracing.span("storage.hdfs.put", instance_id=instance_id,
                          bytes=len(blob)):
            self._call(write)
            self._call(write_digest)

    def get(self, instance_id: str) -> Optional[bytes]:
        from pyarrow import fs

        key = self._key(instance_id)

        def read() -> Optional[bytes]:
            info = self._fs.get_file_info(key)
            if info.type == fs.FileType.NotFound:
                return None
            with self._fs.open_input_stream(key) as f:
                return f.read()

        def read_digest() -> Optional[bytes]:
            side = key + integrity.DIGEST_SUFFIX
            info = self._fs.get_file_info(side)
            if info.type == fs.FileType.NotFound:
                return None  # pre-integrity blob: accepted, fsck flags it
            with self._fs.open_input_stream(side) as f:
                return f.read()

        with tracing.span("storage.hdfs.get", instance_id=instance_id) as sp:
            blob = self._call(read)
            if blob is None:
                sp.set_attr("found", False)
                return None
            sp.set_attr("bytes", len(blob))
            expected = self._call(read_digest)
            blob = faults.corrupt_bytes("data.corrupt.model", blob)
            integrity.verify_blob(
                blob, expected.decode("ascii") if expected else None,
                "model", instance_id)
            return blob

    def delete(self, instance_id: str) -> bool:
        from pyarrow import fs

        key = self._key(instance_id)

        def remove() -> bool:
            info = self._fs.get_file_info(key)
            if info.type == fs.FileType.NotFound:
                return False
            self._fs.delete_file(key)
            side = key + integrity.DIGEST_SUFFIX
            if self._fs.get_file_info(side).type != fs.FileType.NotFound:
                self._fs.delete_file(side)
            return True

        return self._call(remove)

    def list_ids(self) -> List[str]:
        from pyarrow import fs

        def scan() -> List[str]:
            sel = fs.FileSelector(self.root, allow_not_found=True)
            return [i.base_name[:-4] for i in self._fs.get_file_info(sel)
                    if i.base_name.endswith(".bin")]

        return self._call(scan)


# Sealed event-log segments (data/segments.py) ship to a cold tier and
# are fetched back on demand. Same resilience plumbing (retry + breaker
# + named fault site) and the same sha256 digest-sidecar convention as
# the model stores; the caller additionally verifies the fetched blob
# against the segment manifest's digest and refuses mismatches.


class LocalDirSegmentTier(_ResilientCalls):
    """Cold tier on a local (or NFS-mounted) directory —
    ``PIO_SEGMENT_COLD=local:<dir>``. The dev/test tier; shares the
    put/get/delete contract and digest sidecars with the network
    tiers."""

    def __init__(self, root: str) -> None:
        self.root = os.path.abspath(root)
        self._init_resilience("segment_local", fault_site="segments.cold")

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key.lstrip("/"))

    def put(self, key: str, blob: bytes) -> None:
        from predictionio_tpu_torch.utils.atomic_write import atomic_write_bytes

        path = self._path(key)

        def write() -> None:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            # blob first, digest sidecar last — fail-safe ordering
            atomic_write_bytes(path, blob)
            atomic_write_bytes(path + integrity.DIGEST_SUFFIX,
                               integrity.sha256_hex(blob).encode("ascii"))

        self._call(write)

    def get(self, key: str) -> Optional[bytes]:
        path = self._path(key)

        def read() -> Optional[bytes]:
            try:
                with open(path, "rb") as f:
                    return f.read()
            except FileNotFoundError:
                return None

        blob = self._call(read)
        if blob is None:
            return None
        try:
            with open(path + integrity.DIGEST_SUFFIX, "rb") as f:
                expected = f.read().decode("ascii").strip()
        except FileNotFoundError:
            expected = None  # pre-integrity object: manifest still checks
        integrity.verify_blob(blob, expected, "segment", key)
        return blob

    def delete(self, key: str) -> bool:
        path = self._path(key)
        found = False
        for p in (path, path + integrity.DIGEST_SUFFIX):
            try:
                os.unlink(p)
                found = True
            except FileNotFoundError:
                pass
        return found


class S3SegmentTier(_ResilientCalls):
    """Segment cold tier on S3 — ``PIO_SEGMENT_COLD=s3://bucket/prefix``."""

    def __init__(self, bucket: str, prefix: str) -> None:
        try:
            import boto3  # type: ignore[import-not-found]
        except ImportError as e:
            raise StorageClientError(
                "PIO_SEGMENT_COLD=s3:// requires the boto3 client library "
                "(pip install boto3)") from e
        if not bucket:
            raise StorageClientError(
                "PIO_SEGMENT_COLD=s3:// needs a bucket name")
        self.bucket = bucket
        self.prefix = prefix.strip("/")
        self._s3 = boto3.client("s3")
        self._init_resilience("segment_s3", fault_site="segments.cold")

    def _key(self, key: str) -> str:
        key = key.lstrip("/")
        return f"{self.prefix}/{key}" if self.prefix else key

    def put(self, key: str, blob: bytes) -> None:
        k = self._key(key)
        self._call(lambda: self._s3.put_object(
            Bucket=self.bucket, Key=k, Body=blob))
        self._call(lambda: self._s3.put_object(
            Bucket=self.bucket, Key=k + integrity.DIGEST_SUFFIX,
            Body=integrity.sha256_hex(blob).encode("ascii")))

    def get(self, key: str) -> Optional[bytes]:
        k = self._key(key)

        def fetch() -> Optional[bytes]:
            try:
                r = self._s3.get_object(Bucket=self.bucket, Key=k)
            except self._s3.exceptions.NoSuchKey:
                return None
            return r["Body"].read()

        def fetch_digest() -> Optional[bytes]:
            try:
                r = self._s3.get_object(
                    Bucket=self.bucket, Key=k + integrity.DIGEST_SUFFIX)
            except self._s3.exceptions.NoSuchKey:
                return None
            return r["Body"].read()

        blob = self._call(fetch)
        if blob is None:
            return None
        expected = self._call(fetch_digest)
        integrity.verify_blob(
            blob, expected.decode("ascii").strip() if expected else None,
            "segment", key)
        return blob

    def delete(self, key: str) -> bool:
        k = self._key(key)
        self._call(lambda: self._s3.delete_object(Bucket=self.bucket, Key=k))
        self._call(lambda: self._s3.delete_object(
            Bucket=self.bucket, Key=k + integrity.DIGEST_SUFFIX))
        return True


class HDFSSegmentTier(_ResilientCalls):
    """Segment cold tier on HDFS via pyarrow —
    ``PIO_SEGMENT_COLD=hdfs://host:port/path``."""

    def __init__(self, host: str, port: int, root: str) -> None:
        try:
            from pyarrow import fs
        except ImportError as e:  # pragma: no cover - pyarrow is baked in
            raise StorageClientError(
                "PIO_SEGMENT_COLD=hdfs:// requires pyarrow") from e
        self.root = root.rstrip("/") or "/pio_segments"
        try:
            self._fs = fs.HadoopFileSystem(host, port)
        except Exception as e:
            raise StorageClientError(
                f"cannot reach HDFS at {host}:{port} (libhdfs present?): {e}"
            ) from e
        self._init_resilience("segment_hdfs", fault_site="segments.cold")

    def _path(self, key: str) -> str:
        return f"{self.root}/{key.lstrip('/')}"

    def put(self, key: str, blob: bytes) -> None:
        path = self._path(key)

        def write() -> None:
            self._fs.create_dir(os.path.dirname(path), recursive=True)
            with self._fs.open_output_stream(path) as f:
                f.write(blob)

        def write_digest() -> None:
            with self._fs.open_output_stream(
                    path + integrity.DIGEST_SUFFIX) as f:
                f.write(integrity.sha256_hex(blob).encode("ascii"))

        self._call(write)
        self._call(write_digest)

    def get(self, key: str) -> Optional[bytes]:
        from pyarrow import fs

        path = self._path(key)

        def read_file(p: str) -> Optional[bytes]:
            info = self._fs.get_file_info(p)
            if info.type == fs.FileType.NotFound:
                return None
            with self._fs.open_input_stream(p) as f:
                return f.read()

        blob = self._call(lambda: read_file(path))
        if blob is None:
            return None
        expected = self._call(
            lambda: read_file(path + integrity.DIGEST_SUFFIX))
        integrity.verify_blob(
            blob, expected.decode("ascii").strip() if expected else None,
            "segment", key)
        return blob

    def delete(self, key: str) -> bool:
        from pyarrow import fs

        path = self._path(key)

        def remove() -> bool:
            if self._fs.get_file_info(path).type == fs.FileType.NotFound:
                return False
            self._fs.delete_file(path)
            side = path + integrity.DIGEST_SUFFIX
            if self._fs.get_file_info(side).type != fs.FileType.NotFound:
                self._fs.delete_file(side)
            return True

        return self._call(remove)


_segment_tiers: dict = {}


def segment_cold_tier():
    """The segment cold tier selected by ``PIO_SEGMENT_COLD``, or None.

    Accepted forms::

        local:/var/pio/cold       directory (dev / test / NFS mount)
        s3://bucket/prefix
        hdfs://host:port/path

    Instances are cached per spec so breaker state and client
    connections are shared across namespaces.
    """
    spec = os.environ.get("PIO_SEGMENT_COLD", "").strip()
    if not spec:
        return None
    tier = _segment_tiers.get(spec)
    if tier is not None:
        return tier
    if spec.startswith("local:"):
        tier = LocalDirSegmentTier(spec[len("local:"):])
    elif spec.startswith("s3://"):
        bucket, _, prefix = spec[len("s3://"):].partition("/")
        tier = S3SegmentTier(bucket, prefix)
    elif spec.startswith("hdfs://"):
        loc, _, path = spec[len("hdfs://"):].partition("/")
        host, _, port = loc.partition(":")
        tier = HDFSSegmentTier(host or "default", int(port or 8020),
                               "/" + path)
    else:
        raise StorageClientError(
            f"unrecognized PIO_SEGMENT_COLD {spec!r} "
            "(want local:<dir>, s3://bucket/prefix, or "
            "hdfs://host:port/path)")
    _segment_tiers[spec] = tier
    return tier


def _sql_dialect(type_name: str, cfg, repo: str):
    """Dialect for a SQL-server source; raises StorageClientError with
    install instructions when the DB-API driver is absent."""
    from predictionio_tpu_torch.storage.sqldialect import dialect_for

    return dialect_for(type_name, cfg.source_properties(repo), "")


def register_all() -> None:
    from predictionio_tpu_torch.storage import registry as reg
    from predictionio_tpu_torch.data.events import SQLEventStore
    from predictionio_tpu_torch.storage.meta import MetaStore
    from predictionio_tpu_torch.storage.models import SQLModelStore

    reg.register_model_backend(
        "S3", lambda cfg: S3ModelStore(
            props=cfg.source_properties("MODELDATA")))
    reg.register_model_backend(
        "HDFS", lambda cfg: HDFSModelStore(
            props=cfg.source_properties("MODELDATA")))
    # SQL-server backends (reference: [U] storage/jdbc/ — every repo type
    # on PostgreSQL/MySQL). The shared SQL store implementations run on
    # the engine's dialect; the reference's pio-env idiom points all
    # three repositories at the same SQL source.
    for t in ("PGSQL", "MYSQL"):
        reg.register_event_backend(
            t, lambda cfg, _t=t: SQLEventStore(
                _sql_dialect(_t, cfg, "EVENTDATA")))
        reg.register_meta_backend(
            t, lambda cfg, _t=t: MetaStore(
                dialect=_sql_dialect(_t, cfg, "METADATA")))
        reg.register_model_backend(
            t, lambda cfg, _t=t: SQLModelStore(
                _sql_dialect(_t, cfg, "MODELDATA")))
