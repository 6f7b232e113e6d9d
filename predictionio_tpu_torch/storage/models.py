"""Model blob stores: the port's copy of the LOCALFS and MEMORY backends,
and a read-only lookup in the model registry's manifest.

A "model" is an opaque byte blob keyed by engine-instance id. The LOCALFS
layout is the JAX package's: ``<root>/<instance_id>/model.bin`` beside a
``model.bin.sha256`` digest sidecar, written durably (fsync, replace,
fsync the directory) and verified on every read, so a blob either
package wrote loads in the other and a corrupt one is refused.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional

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


#: the JAX package's model registry, ``<home>/model_registry``: a
#: ``registry.json`` manifest of generations, each naming the engine
#: instance behind it. The port reads it; its writers (the continuous
#: trainer's register, promote and rollback) are not ported yet.
REGISTRY_DIR = "model_registry"
REGISTRY_MANIFEST = "registry.json"


def registry_manifest(home: str) -> Optional[Dict[str, Any]]:
    """The registry manifest under ``home``, or None when there is no
    registry there. Creates nothing (the JAX package's ``model_registry``
    creates the directory when it looks)."""
    path = os.path.join(home, REGISTRY_DIR, REGISTRY_MANIFEST)
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except FileNotFoundError:
        return None
    if doc.get("schema") != 1:
        raise ValueError(f"unknown model-registry schema {doc.get('schema')!r}")
    return doc


def find_gen(home: str, instance_id: str) -> Optional[int]:
    """Newest registry generation backed by ``instance_id`` (the JAX
    package's ``ModelRegistry.find_gen``), or None when the instance was
    never registered or there is no registry at ``home``."""
    doc = registry_manifest(home)
    if doc is None:
        return None
    gens = [e["gen"] for e in doc.get("generations", [])
            if e.get("instance_id") == instance_id]
    return max(gens) if gens else None
