"""Segment cold tiers: where sealed event-log segments ship and are fetched.

The port's copy of the segment half of the JAX package's
``storage/remote.py``: :class:`LocalDirSegmentTier`,
:class:`S3SegmentTier` and :class:`HDFSSegmentTier` behind
:func:`segment_cold_tier` (``PIO_SEGMENT_COLD``), with the shared
retry, circuit-breaker and fault-site plumbing (:class:`_ResilientCalls`)
and the sha256 digest sidecar beside every shipped object. S3 and HDFS
raise :class:`StorageClientError` without their client libraries (boto3,
pyarrow with libhdfs). The network model stores and the SQL server
registrations of that module are not here.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Optional

from predictionio_tpu_torch.utils import faults, integrity
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
