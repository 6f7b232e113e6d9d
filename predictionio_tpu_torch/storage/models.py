"""Model blob stores: the port's copy of the LOCALFS and MEMORY backends.

A "model" is an opaque byte blob keyed by engine-instance id. The LOCALFS
layout is the JAX package's: ``<root>/<instance_id>/model.bin`` beside a
``model.bin.sha256`` digest sidecar, written durably (fsync, replace,
fsync the directory) and verified on every read, so a blob either
package wrote loads in the other and a corrupt one is refused.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import tempfile
import threading
from abc import ABC, abstractmethod
from typing import List, Optional

DIGEST_SUFFIX = ".sha256"


class IntegrityError(RuntimeError):
    """A checksummed blob failed verification; the read is refused."""


def _atomic_write_bytes(path: str, data: bytes) -> None:
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".atomic-", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    try:
        dfd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(dfd)
    except OSError:
        pass
    finally:
        os.close(dfd)


class ModelStore(ABC):
    @abstractmethod
    def put(self, instance_id: str, blob: bytes) -> None: ...

    @abstractmethod
    def get(self, instance_id: str) -> Optional[bytes]: ...

    @abstractmethod
    def delete(self, instance_id: str) -> bool: ...

    @abstractmethod
    def list_ids(self) -> List[str]: ...

    def model_dir(self, instance_id: str) -> Optional[str]:
        """Directory for structured per-instance artifacts; None when the
        backend has no filesystem locality."""
        return None


class MemoryModelStore(ModelStore):
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._blobs: dict[str, bytes] = {}

    def put(self, instance_id: str, blob: bytes) -> None:
        with self._lock:
            self._blobs[instance_id] = blob

    def get(self, instance_id: str) -> Optional[bytes]:
        return self._blobs.get(instance_id)

    def delete(self, instance_id: str) -> bool:
        with self._lock:
            return self._blobs.pop(instance_id, None) is not None

    def list_ids(self) -> List[str]:
        return sorted(self._blobs)


class LocalFSModelStore(ModelStore):
    """Blobs under ``<root>/<instance_id>/model.bin`` with a digest
    sidecar. Blobs from before the sidecar existed load unverified."""

    def __init__(self, root: str) -> None:
        self._root = root
        os.makedirs(root, exist_ok=True)

    def _dir(self, instance_id: str) -> str:
        return os.path.join(self._root, instance_id.replace("/", "_"))

    def put(self, instance_id: str, blob: bytes) -> None:
        d = self._dir(instance_id)
        os.makedirs(d, exist_ok=True)
        # blob first, digest last: a crash between the two leaves a
        # mismatched pair that get() refuses
        _atomic_write_bytes(os.path.join(d, "model.bin"), blob)
        _atomic_write_bytes(os.path.join(d, "model.bin" + DIGEST_SUFFIX),
                            hashlib.sha256(blob).hexdigest().encode("ascii"))

    def get(self, instance_id: str) -> Optional[bytes]:
        p = os.path.join(self._dir(instance_id), "model.bin")
        if not os.path.exists(p):
            return None
        with open(p, "rb") as f:
            blob = f.read()
        try:
            with open(p + DIGEST_SUFFIX, "r", encoding="ascii") as f:
                expected = f.read().strip()
        except OSError:
            return blob  # written before digests existed
        actual = hashlib.sha256(blob).hexdigest()
        if actual != expected:
            raise IntegrityError(
                f"model checksum mismatch for {instance_id}: expected "
                f"{expected[:16]}…, got {actual[:16]}… ({len(blob)} bytes) "
                "— refusing to serve corrupt data")
        return blob

    def delete(self, instance_id: str) -> bool:
        d = self._dir(instance_id)
        if os.path.isdir(d):
            shutil.rmtree(d)
            return True
        return False

    def list_ids(self) -> List[str]:
        return sorted(
            d for d in os.listdir(self._root)
            if os.path.isdir(os.path.join(self._root, d)))

    def model_dir(self, instance_id: str) -> str:
        d = self._dir(instance_id)
        os.makedirs(d, exist_ok=True)
        return d
