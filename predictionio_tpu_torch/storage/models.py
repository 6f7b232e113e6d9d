"""Model blob stores: the port's copy of the LOCALFS, MEMORY and SQL
backends, the checksummed artifact helpers and the generation-aware model
registry. (The S3 and HDFS stores are in
:mod:`predictionio_tpu_torch.storage.remote`, the embedded index's in
:mod:`predictionio_tpu_torch.storage.indexed`.)

A "model" is an opaque byte blob keyed by engine-instance id. The LOCALFS
layout is the JAX package's: ``<root>/<instance_id>/model.bin`` beside a
``model.bin.sha256`` digest sidecar, written durably (fsync, replace,
fsync the directory) and verified on every read, so a blob either
package wrote loads in the other and a corrupt one is refused. The
registry's manifest and generation directories are the JAX package's
bytes too (``registry.json`` with sorted keys, ``gen-%06d`` directories,
sha256 sidecars): a registry either package writes, the other reads.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional

from predictionio_tpu_torch.utils.atomic_write import atomic_write_bytes
from predictionio_tpu_torch.utils.integrity import (
    DIGEST_SUFFIX,
    IntegrityError,  # noqa: F401  (raised by verify_blob; callers catch it here)
    sha256_hex,
    verify_blob,
)


def _read_sidecar(path: str) -> Optional[str]:
    try:
        with open(path + DIGEST_SUFFIX, "r", encoding="ascii") as f:
            return f.read()
    except OSError:
        return None


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


class SQLModelStore(ModelStore):
    """Model blobs in a SQL table, ``pio_model_data`` with a blob column
    (the JAX package's ``SQLModelStore``, reference: [U] storage/jdbc/
    JDBCModels.scala), on any dialect of
    :mod:`predictionio_tpu_torch.storage.sqldialect`: the PGSQL and MYSQL
    sources keep models in the database, with no shared filesystem."""

    _TABLE = "pio_model_data"

    def __init__(self, dialect) -> None:
        self._d = dialect
        self._conns = dialect.thread_conns()
        self._lock = threading.Lock()
        c = self._conns.get()
        c.cursor().execute(
            f"""CREATE TABLE IF NOT EXISTS {self._TABLE} (
                id {dialect.key_type} PRIMARY KEY,
                model {dialect.blob_type} NOT NULL
            )""")
        c.commit()

    def put(self, instance_id: str, blob: bytes) -> None:
        with self._lock:
            c = self._conns.get()
            c.cursor().execute(
                self._d.sql(self._d.upsert(self._TABLE, ("id", "model"), "id")),
                (instance_id, self._d.binary(blob)))
            c.commit()

    def _read(self, q: str, args: tuple = ()) -> list:
        """One SELECT, committed (server engines otherwise hold the read
        transaction open on this thread's connection)."""
        c = self._conns.get()
        try:
            cur = c.cursor()
            cur.execute(self._d.sql(q), args)
            rows = cur.fetchall()
            c.commit()
        except Exception:
            self._d.recover(c)
            raise
        return rows

    def get(self, instance_id: str) -> Optional[bytes]:
        rows = self._read(f"SELECT model FROM {self._TABLE} WHERE id=?", (instance_id,))
        return bytes(rows[0][0]) if rows else None

    def delete(self, instance_id: str) -> bool:
        with self._lock:
            c = self._conns.get()
            cur = c.cursor()
            cur.execute(self._d.sql(f"DELETE FROM {self._TABLE} WHERE id=?"),
                        (instance_id,))
            c.commit()
            return cur.rowcount > 0

    def list_ids(self) -> List[str]:
        return [r[0] for r in self._read(f"SELECT id FROM {self._TABLE} ORDER BY id")]


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
        write_artifact(os.path.join(d, "model.bin"), blob)

    def get(self, instance_id: str) -> Optional[bytes]:
        p = os.path.join(self._dir(instance_id), "model.bin")
        if not os.path.exists(p):
            return None
        with open(p, "rb") as f:
            blob = f.read()
        verify_blob(blob, _read_sidecar(p), "model", instance_id)
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


# -- checksummed artifact files (sidecar layout helpers) -----------------------
#
# The model artifact is no longer a single blob: per-algorithm
# directories beside ``model.bin`` carry structured artifacts (Orbax
# checkpoints, the PQ retrieval index ``ann_index.bin``). These helpers pin the ONE sidecar discipline
# for all of them: ``<name>`` + ``<name>.sha256``, blob durably first
# and digest last, so a crash between the two reads back as REFUSED
# (mismatch) or unchecksummed (missing sidecar), never silently wrong.


def write_artifact(path: str, blob: bytes) -> str:
    """Write ``blob`` at ``path`` with its ``.sha256`` sidecar; returns
    the digest hex."""
    digest = sha256_hex(blob)
    atomic_write_bytes(path, blob)
    atomic_write_bytes(path + DIGEST_SUFFIX,
                       digest.encode("ascii"))
    return digest


def read_artifact(path: str, artifact: str,
                  what: str = "") -> Optional[bytes]:
    """Read + sidecar-verify an artifact file (None when absent;
    missing sidecar = legacy/torn write, accepted here and reported as
    ``unchecksummed`` by ``pio fsck``). Raises
    :class:`IntegrityError` on
    digest mismatch — loaders turn that into a refused ``/reload``
    candidate."""
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        blob = f.read()
    verify_blob(blob, _read_sidecar(path), artifact, what or path)
    return blob


# -- generation-aware model registry ------------------------------------------


class FencedWriteError(RuntimeError):
    """A registry write carried a fencing token older than one the
    registry has already seen — the caller's lease was superseded and
    its (late) write is refused."""


class ModelRegistry:
    """Promotion history for the continuous-training loop.

    The plain :class:`ModelStore` answers "give me the blob for instance
    X"; it has no notion of which instance SHOULD serve. This registry
    adds that layer: every delta-train registers its candidate as a new
    **generation** (monotonic integer), promotion moves the **champion**
    pointer, and rollback moves it back — all recorded in one manifest
    (``registry.json``) so ``pio models list`` and ``pio fsck`` can
    reconstruct the full promote/refuse/rollback history after the fact.

    ``create=False`` opens it read-only for a lookup: the directory is
    not made, and a home with no registry reads as an empty one.

    Layout under ``<home>/model_registry``::

        registry.json            manifest (atomic, fsync-before-replace)
        gen-000007/model.bin     the generation's engine blob
        gen-000007/model.bin.sha256

    Integrity: the manifest records each generation's sha256 and a
    sidecar rides next to the blob; :meth:`get_blob` verifies on every
    read and ``pio fsck`` audits manifest ↔ dirs ↔ sidecars (an orphaned
    ``gen-*`` dir is the signature of a trainer crash between blob write
    and manifest commit — harmless, ``--repair`` deletes it).

    Fencing: writes accept an optional integer ``token`` (the caller's
    lease fencing token). The manifest remembers the highest token ever
    seen; a write with a LOWER token raises :class:`FencedWriteError`
    **before any blob is written** — a wedged trainer that lost its
    lease mid-train can never publish. ``token=None`` (operator CLI)
    bypasses the fence deliberately.

    Generation statuses: ``candidate`` (registered, not yet judged),
    ``champion`` (serving pointer), ``retired`` (was champion, a newer
    one was promoted), ``refused`` (failed the offline guardrail),
    ``rolled_back`` (promoted, then regressed during the bake window).
    Retention keeps the champion plus the newest ``retain`` other
    generations; older blob dirs are pruned.
    """

    MANIFEST = "registry.json"
    _GEN_DIR = re.compile(r"^gen-(\d{6,})$")

    def __init__(self, root: str, retain: int = 5,
                 create: bool = True) -> None:
        self.root = root
        self.retain = max(0, retain)
        self._lock = threading.RLock()
        if create:
            os.makedirs(root, exist_ok=True)

    # -- manifest --------------------------------------------------------------

    def _manifest_path(self) -> str:
        return os.path.join(self.root, self.MANIFEST)

    def _load(self) -> Dict[str, Any]:
        try:
            with open(self._manifest_path(), "r", encoding="utf-8") as f:
                doc = json.load(f)
        except FileNotFoundError:
            return {"schema": 1, "next_gen": 1, "champion": None,
                    "fence_token": 0, "generations": []}
        if doc.get("schema") != 1:
            raise ValueError(
                f"unknown model-registry schema {doc.get('schema')!r}")
        return doc

    def _save(self, doc: Dict[str, Any]) -> None:
        atomic_write_bytes(
            self._manifest_path(),
            json.dumps(doc, indent=1, sort_keys=True).encode("utf-8"))

    def _fence(self, doc: Dict[str, Any], token: Optional[int]) -> None:
        if token is None:
            return
        seen = int(doc.get("fence_token", 0))
        if token < seen:
            raise FencedWriteError(
                f"fencing token {token} is stale (registry has seen "
                f"{seen}); this writer's lease was superseded")
        doc["fence_token"] = token

    def _entry(self, doc: Dict[str, Any], gen: int) -> Dict[str, Any]:
        for e in doc["generations"]:
            if e["gen"] == gen:
                return e
        raise KeyError(f"no generation {gen} in the model registry")

    # -- reads -----------------------------------------------------------------

    def generations(self) -> List[Dict[str, Any]]:
        with self._lock:
            doc = self._load()
            return list(doc["generations"])

    def champion(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            doc = self._load()
            if doc["champion"] is None:
                return None
            return self._entry(doc, doc["champion"])

    def fence_token(self) -> int:
        with self._lock:
            return int(self._load().get("fence_token", 0))

    def find_gen(self, instance_id: str) -> Optional[int]:
        """Newest generation backed by ``instance_id`` (an instance can
        appear once per registration), or None if never registered."""
        with self._lock:
            gens = [e["gen"] for e in self._load()["generations"]
                    if e["instance_id"] == instance_id]
            return max(gens) if gens else None

    def gen_dir(self, gen: int) -> str:
        return os.path.join(self.root, f"gen-{gen:06d}")

    def get_blob(self, gen: int) -> bytes:
        """The generation's blob, digest-verified against the manifest
        (raises :class:`IntegrityError`
        on mismatch — a corrupt generation is refused, never served)."""
        with self._lock:
            entry = self._entry(self._load(), gen)
        p = os.path.join(self.gen_dir(gen), "model.bin")
        with open(p, "rb") as f:
            blob = f.read()
        verify_blob(blob, entry.get("sha256"), "model",
                              f"gen-{gen:06d}")
        return blob

    def orphan_dirs(self) -> List[str]:
        """``gen-*`` dirs on disk with no manifest entry (crash between
        blob write and manifest commit). ``pio fsck --repair`` deletes."""
        with self._lock:
            known = {e["gen"] for e in self._load()["generations"]}
        out = []
        for name in sorted(os.listdir(self.root)):
            m = self._GEN_DIR.match(name)
            if m and int(m.group(1)) not in known:
                out.append(os.path.join(self.root, name))
        return out

    # -- writes ----------------------------------------------------------------

    def register(self, instance_id: str, blob: bytes,
                 token: Optional[int] = None,
                 created_us: Optional[int] = None) -> int:
        """Record a freshly trained candidate as a new generation.

        The fence check runs FIRST — a superseded trainer never gets as
        far as writing a blob (acceptance: a second trainer against a
        held lease leaves zero bytes behind). Blob + sidecar land before
        the manifest commit, so a crash in between leaves an orphaned
        dir (fsck-visible), never a manifest entry pointing at nothing.
        """
        with self._lock:
            doc = self._load()
            self._fence(doc, token)
            gen = int(doc["next_gen"])
            d = self.gen_dir(gen)
            os.makedirs(d, exist_ok=True)
            digest = write_artifact(os.path.join(d, "model.bin"), blob)
            doc["next_gen"] = gen + 1
            doc["generations"].append({
                "gen": gen, "instance_id": instance_id, "sha256": digest,
                "status": "candidate", "created_us": created_us,
                "promoted_us": None, "token": token,
            })
            self._save(doc)
            return gen

    def promote(self, gen: int, token: Optional[int] = None,
                now_us: Optional[int] = None) -> Dict[str, Any]:
        """Move the champion pointer to ``gen`` (previous champion →
        ``retired``), then prune past the retention window."""
        with self._lock:
            doc = self._load()
            self._fence(doc, token)
            entry = self._entry(doc, gen)
            prev = doc["champion"]
            if prev is not None and prev != gen:
                self._entry(doc, prev)["status"] = "retired"
            entry["status"] = "champion"
            entry["promoted_us"] = now_us
            doc["champion"] = gen
            self._prune(doc)
            self._save(doc)
            return dict(entry)

    def mark(self, gen: int, status: str,
             token: Optional[int] = None) -> Dict[str, Any]:
        """Set a generation's status (``refused`` from the guardrail
        gate, etc.) without moving the champion pointer."""
        with self._lock:
            doc = self._load()
            self._fence(doc, token)
            entry = self._entry(doc, gen)
            entry["status"] = status
            self._save(doc)
            return dict(entry)

    def rollback(self, token: Optional[int] = None) -> Dict[str, Any]:
        """Demote the current champion (→ ``rolled_back``) and restore
        the most recently promoted ``retired`` generation. Raises
        LookupError when there is nothing to roll back to."""
        with self._lock:
            doc = self._load()
            self._fence(doc, token)
            cur = doc["champion"]
            if cur is None:
                raise LookupError("no champion generation to roll back")
            candidates = [e for e in doc["generations"]
                          if e["status"] == "retired"]
            if not candidates:
                raise LookupError(
                    "no retired generation to roll back to")
            target = max(candidates,
                         key=lambda e: (e.get("promoted_us") or 0, e["gen"]))
            self._entry(doc, cur)["status"] = "rolled_back"
            target["status"] = "champion"
            doc["champion"] = target["gen"]
            self._save(doc)
            return dict(target)

    def _prune(self, doc: Dict[str, Any]) -> None:
        """Keep the champion + the newest ``retain`` other generations;
        drop older entries and their blob dirs (manifest first would
        orphan the dir on crash — delete dirs after the commit below,
        so a crash can only leave fsck-repairable orphans)."""
        champ = doc["champion"]
        others = sorted((e for e in doc["generations"] if e["gen"] != champ),
                        key=lambda e: e["gen"], reverse=True)
        drop = others[self.retain:]
        if not drop:
            return
        gone = {e["gen"] for e in drop}
        doc["generations"] = [e for e in doc["generations"]
                              if e["gen"] not in gone]
        for g in sorted(gone):
            shutil.rmtree(self.gen_dir(g), ignore_errors=True)

    # -- meta-store bridge -----------------------------------------------------

    def sync_meta(self, meta) -> None:
        """Make ``prepare_deploy``'s latest-COMPLETED resolution agree
        with the champion pointer: the champion's engine instance is
        COMPLETED, every newer or demoted generation's instance is moved
        to a non-serving status (``SHELVED`` for unjudged candidates,
        ``REFUSED``/``REGRESSED`` for guardrail/bake failures), so a
        plain ``/reload`` anywhere in the fleet always lands on the
        champion — including right after a rollback."""
        with self._lock:
            doc = self._load()
        champ = doc["champion"]
        for e in doc["generations"]:
            ei = meta.get_engine_instance(e["instance_id"])
            if ei is None:
                continue
            if e["gen"] == champ:
                want = "COMPLETED"
            elif e["status"] == "refused":
                want = "REFUSED"
            elif e["status"] == "rolled_back":
                want = "REGRESSED"
            elif e["status"] == "candidate":
                want = "SHELVED"
            elif champ is not None and e["gen"] > champ:
                want = "SHELVED"
            else:
                want = ei.status  # older retired instance: leave it be
            if ei.status != want:
                ei.status = want
                meta.update_engine_instance(ei)


def model_registry(storage, retain: int = 5) -> ModelRegistry:
    """The storage home's model registry (``<home>/model_registry``)."""
    return ModelRegistry(
        os.path.join(storage.config.home, "model_registry"), retain=retain)


def find_gen(home: str, instance_id: str) -> Optional[int]:
    """Newest registry generation backed by ``instance_id`` under
    ``home``, or None when the instance was never registered or there is
    no registry there. Creates nothing (the engine server's ``/health``
    asks this of homes that never had a registry)."""
    return ModelRegistry(os.path.join(home, "model_registry"),
                         create=False).find_gen(instance_id)
