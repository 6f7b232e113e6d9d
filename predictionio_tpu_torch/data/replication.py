"""Replicated event plane: the port's copy of the JAX package's
``data/replication.py`` (WAL shipping, follower apply, fencing).

It makes the event log (``data/segments.py``, ``data/filestore.py``)
survive the loss of its box. The design is primary-backup WAL shipping
over the PEL on-disk contract, and the wire and the files are the JAX
package's, so either package's leader feeds either package's follower:

- **Leader side** (:class:`Replicator`): attached to a
  :class:`~predictionio_tpu_torch.data.filestore.NativeEventLogStore`
  through ``set_replicator``. After every committed append (inside the
  same per-namespace writer lock, so ordering is exact) it tails the
  active segment file from the last replicated byte offset and pushes
  the new bytes to every follower as one **WAL batch**: raw file bytes
  and ``(namespace, segment id, start offset, crc32c, epoch)``. The
  payload is the file's own bytes, 8-byte ``PELOGv2`` header included,
  so a follower that applies every batch holds a **byte-identical**
  copy. Rollover ships a **seal** command carrying the sealed file's
  sha256; the follower renames its copy and refuses a digest mismatch.

- **Follower side** (:class:`ReplicaHome`): a pure-Python applier over
  a storage-home-shaped directory (``<home>/eventlog/...``). It appends
  verified bytes, keeps ``segments.json`` manifests that
  :class:`~predictionio_tpu_torch.data.segments.SegMeta` reads, and
  persists an acked-offset cursor in ``replica_state.json``, fsynced in
  the ack path. On promotion the event server opens a real store over
  the same home.

- **Fencing**: every batch carries the leader's **epoch**, its fencing
  token from the shared election lease (``server/repl_server.py`` over
  ``server/trainer.TrainerLease``). A follower records the highest
  epoch it has seen and refuses anything older
  (:class:`StaleEpochError`). Locally, a demoted leader's own appends
  raise :class:`FencedWriteError` before touching the log.

Failures are explicit: a CRC mismatch is :class:`WalTornError` (drilled
through the ``replication.wal.torn`` byte-flip site), an offset mismatch
is :class:`WalGapError` carrying the follower's true cursor so that the
leader resends from it, and sealed segments the push stream missed are
healed by :meth:`ReplicaHome.sync_sealed`, a digest-verified full-file
fetch; a sealed file whose size and mtime have not moved since it was
last hashed is not hashed again on the next pass, and one whose manifest
row has no digest yet is kept while its size matches the row and held
against a fresh fetch every ``REVERIFY_SECONDS``, outside the apply lock
(the JAX package hashes every sealed file each pass and fetches an
undigested one again each pass, under that lock).
``replication.follower.lag`` slows or fails the follower's apply.
The ``pio_repl_*`` series count batches, seals, promotions, lag, the
epoch and the role.

- **Reading a live home** (:class:`LogView`, the port's own): a process
  that reads an event log another process writes (a trainer over a
  follower's replica, or over a leader's home under its event server)
  reads a private copy that ends at the follower's acknowledged cursor,
  or at the last whole frame, and is rebuilt by ``refresh``: the native
  engine indexes a file only when it opens it and cuts a torn tail when
  it does, so it never opens the writer's files.
"""

from __future__ import annotations

import atexit
import json
import math
import os
import shutil
import struct
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from predictionio_tpu_torch.data.filestore import NativeEventLogStore
from predictionio_tpu_torch.data.pel_integrity import PEL_MAGIC, crc32c
from predictionio_tpu_torch.data.segments import (
    MANIFEST_NAME,
    MANIFEST_SCHEMA,
    SEG_DIR_SUFFIX,
    SegMeta,
)
from predictionio_tpu_torch.utils import faults, tracing
from predictionio_tpu_torch.utils.atomic_write import atomic_write_text
from predictionio_tpu_torch.utils.metrics import REGISTRY

_U32 = struct.Struct("<I")

#: follower state gauge values (``pio_repl_follower_state``)
STATE_IDLE, STATE_FOLLOWING, STATE_PROMOTING, STATE_LEADER, STATE_FENCED = (
    0, 1, 2, 3, 4)

REPL_LAG_BYTES = REGISTRY.gauge(
    "pio_repl_lag_bytes",
    "Active-segment bytes appended on the leader but not yet acked by "
    "the follower", ("follower",))
REPL_LAG_RECORDS = REGISTRY.gauge(
    "pio_repl_lag_records",
    "Event records appended on the leader but not yet acked by the "
    "follower", ("follower",))
REPL_EPOCH = REGISTRY.gauge(
    "pio_repl_epoch",
    "This node's current replication fencing epoch (the election "
    "lease token)")
REPL_STATE = REGISTRY.gauge(
    "pio_repl_follower_state",
    "Replication role state: 0 idle, 1 following, 2 promoting, "
    "3 leader, 4 fenced (demoted)")
REPL_BATCHES = REGISTRY.counter(
    "pio_repl_batches_total",
    "WAL batches applied/refused by result (ok, stale_epoch, "
    "crc_refused, gap, error)", ("result",))
REPL_PROMOTIONS = REGISTRY.counter(
    "pio_repl_promotions_total", "Follower promotions to leader")
#: seconds before a sealed file that the leader has not digested is
#: fetched again and held against the follower's copy (``sync_sealed``)
REVERIFY_SECONDS = 600.0

REPL_SEALS = REGISTRY.counter(
    "pio_repl_seals_total",
    "Sealed-segment transfers applied on the follower by result",
    ("result",))


class ReplicationError(RuntimeError):
    """Base class for replication protocol failures."""


class StaleEpochError(ReplicationError):
    """A write carried a fencing epoch older than one already seen —
    a demoted leader is trying to land a late write. Always refused."""


class WalTornError(ReplicationError):
    """A WAL batch failed its CRC — torn or corrupted in flight. The
    follower's log is untouched; the leader must resend."""


class WalGapError(ReplicationError):
    """A WAL batch does not start where the follower's log ends.
    Carries the follower's true cursor so the leader can resend."""

    def __init__(self, message: str, seg_id: int, offset: int) -> None:
        super().__init__(message)
        self.seg_id = seg_id
        self.offset = offset


class FencedWriteError(ReplicationError):
    """A local append was attempted on a node whose leadership was
    lost. Raised BEFORE bytes touch the log — a demoted leader can
    never corrupt the log it no longer owns."""


# -- WAL batch ----------------------------------------------------------------


@dataclass
class WalBatch:
    """One replicated chunk of an active segment file."""

    ns_tag: str            # e.g. "events_1" / "events_1_2" / "events_1.s1"
    seg_id: int            # the id this ACTIVE file will get when sealed
    offset: int            # byte offset the payload starts at
    payload: bytes         # raw file bytes (offset 0 includes the header)
    crc: int               # crc32c over payload
    epoch: int             # leader's fencing token
    records: int = 0       # complete frames in the payload (lag metric)

    @classmethod
    def build(cls, ns_tag: str, seg_id: int, offset: int, payload: bytes,
              epoch: int) -> "WalBatch":
        return cls(ns_tag=ns_tag, seg_id=seg_id, offset=offset,
                   payload=payload, crc=crc32c(payload), epoch=epoch,
                   records=count_frames(payload, offset == 0))


def count_frames(payload: bytes, file_start: bool, version: int = 2) -> int:
    """Number of complete PEL frames in ``payload``. ``file_start``
    skips the 8-byte magic header. Counts only — the byte-level CRC of
    each frame is the follower's fsck's job, not the wire protocol's
    (the batch has its own CRC)."""
    return _frames(payload, len(PEL_MAGIC) if file_start else 0, version)[0]


def _frames(payload: bytes, off: int, version: int) -> Tuple[int, int]:
    """(complete frames from ``off``, the offset where they end)."""
    trailer = 4 if version == 2 else 0
    n = 0
    size = len(payload)
    while off + 5 <= size:
        rec_len = _U32.unpack_from(payload, off)[0]
        if rec_len < 1 or off + 4 + rec_len + trailer > size:
            break
        off += 4 + rec_len + trailer
        n += 1
    return n, off


# -- follower: the replica home -----------------------------------------------

REPLICA_STATE_NAME = "replica_state.json"


class ReplicaHome:
    """Byte-level applier over a storage-home-shaped directory.

    Not a store: while following, nothing opens the files through the
    native engine — this class appends verified bytes and keeps the
    manifests that a real :class:`NativeEventLogStore` will read the
    moment the node is promoted. All mutation is serialized by one
    lock (follower apply is single-streamed by design: the leader
    pushes in commit order)."""

    def __init__(self, root: str,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.root = root
        self.log_dir = os.path.join(root, "eventlog")
        os.makedirs(self.log_dir, exist_ok=True)
        self.lock = threading.Lock()
        self.epoch = 0
        #: ns_tag -> {"seg": active seg id, "offset": bytes applied}
        self.cursors: Dict[str, Dict[str, int]] = {}
        #: True once this home's node was promoted: its store appends
        #: past the cursors, which stop where following ended
        self.leading = False
        #: sealed file path -> (size, mtime_ns, sha256) of its last hashing
        self._digests: Dict[str, Tuple[int, int, str]] = {}
        #: sealed file path -> when it was last held against the leader's
        #: bytes (install included); see :meth:`sync_sealed`
        self._verified: Dict[str, float] = {}
        self._clock = clock
        self._load_state()

    # -- persisted state ---------------------------------------------------

    @property
    def state_path(self) -> str:
        return os.path.join(self.root, REPLICA_STATE_NAME)

    def _load_state(self) -> None:
        try:
            with open(self.state_path, "r", encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return
        self.epoch = int(doc.get("epoch", 0))
        self.cursors = {str(k): {"seg": int(v["seg"]),
                                 "offset": int(v["offset"])}
                        for k, v in doc.get("cursors", {}).items()}
        self.leading = bool(doc.get("leading", False))

    def _save_state(self) -> None:
        doc: Dict[str, Any] = {"epoch": self.epoch, "cursors": self.cursors}
        if self.leading:
            # the port's own key (the JAX package ignores it): readers
            # of this home (:class:`LogView`) stop bounding by the cursors
            doc["leading"] = True
        atomic_write_text(self.state_path, json.dumps(
            doc, indent=1, sort_keys=True))

    # -- paths -------------------------------------------------------------

    def active_path(self, ns_tag: str) -> str:
        return os.path.join(self.log_dir, ns_tag + ".pel")

    def seg_dir(self, ns_tag: str) -> str:
        return os.path.join(self.log_dir, ns_tag + ".peld")

    def manifest_path(self, ns_tag: str) -> str:
        return os.path.join(self.seg_dir(ns_tag), "segments.json")

    def _load_manifest(self, ns_tag: str) -> Dict[str, Any]:
        try:
            with open(self.manifest_path(ns_tag), "r",
                      encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            return {"schema": MANIFEST_SCHEMA, "next_id": 0, "segments": []}

    def _write_manifest(self, ns_tag: str, doc: Dict[str, Any]) -> None:
        os.makedirs(self.seg_dir(ns_tag), exist_ok=True)
        atomic_write_text(self.manifest_path(ns_tag),
                          json.dumps(doc, indent=1, sort_keys=True))

    def _sealed_sha256(self, path: str, known: Optional[str] = None) -> str:
        """sha256 of a sealed file, hashed again only when its size or
        mtime moved since the last hashing (``known``: a digest just
        verified for these bytes). Catch-up compares every sealed
        segment against the leader's manifest each pass, under the
        apply lock; re-reading gigabytes a pass would stall the WAL
        applies behind it past the leader's push timeout."""
        st = os.stat(path)
        seen = self._digests.get(path)
        if known is None and seen and seen[:2] == (st.st_size, st.st_mtime_ns):
            return seen[2]
        digest = known or _file_sha256(path)
        self._digests[path] = (st.st_size, st.st_mtime_ns, digest)
        return digest

    # -- epoch fencing -----------------------------------------------------

    def check_epoch(self, epoch: int) -> None:
        """Refuse anything older than the highest epoch seen; learn a
        newer one. Must hold ``lock``."""
        if epoch < self.epoch:
            REPL_BATCHES.inc(("stale_epoch",))
            raise StaleEpochError(
                f"write carries epoch {epoch} but this replica has "
                f"seen epoch {self.epoch} — refusing a demoted "
                "leader's late write")
        if epoch > self.epoch:
            self.epoch = epoch
            REPL_EPOCH.set(epoch)

    # -- WAL apply ---------------------------------------------------------

    def cursor(self, ns_tag: str) -> Tuple[int, int]:
        """(active seg id, applied byte offset) for one namespace."""
        cur = self.cursors.get(ns_tag)
        if cur is None:
            return 0, 0
        return cur["seg"], cur["offset"]

    def apply_wal(self, batch: WalBatch) -> int:
        """Verify and append one WAL batch; returns the new applied
        offset. The follower-lag drill site lives here: an armed
        ``replication.follower.lag`` latency plan slows every apply,
        which the leader sees as ack latency → lag."""
        faults.inject("replication.follower.lag")
        with self.lock:
            self.check_epoch(batch.epoch)
            payload = faults.corrupt_bytes("replication.wal.torn",
                                           batch.payload)
            if crc32c(payload) != batch.crc:
                REPL_BATCHES.inc(("crc_refused",))
                raise WalTornError(
                    f"WAL batch for {batch.ns_tag} @ {batch.offset} "
                    "failed crc32c — refusing torn frame")
            seg, off = self.cursor(batch.ns_tag)
            path = self.active_path(batch.ns_tag)
            have = os.path.getsize(path) if os.path.exists(path) else 0
            # the authoritative offset is the FILE, not the cursor doc
            # (a crash between append and state write leaves the file
            # ahead by exactly one acked batch — trust the bytes)
            off = max(off, have) if seg == batch.seg_id else off
            if batch.seg_id != seg or batch.offset != off:
                REPL_BATCHES.inc(("gap",))
                raise WalGapError(
                    f"WAL batch for {batch.ns_tag} starts at "
                    f"seg {batch.seg_id}/{batch.offset} but replica is "
                    f"at seg {seg}/{off}", seg, off)
            if off == 0 and not payload.startswith(PEL_MAGIC):
                REPL_BATCHES.inc(("error",))
                raise ReplicationError(
                    f"first batch for {batch.ns_tag} does not begin "
                    "with the PELOGv2 header")
            with open(path, "ab") as f:
                f.write(payload)
                f.flush()
                # follower apply is single-streamed (the leader pushes
                # serially, in commit order) — no other writer exists
                # to stall behind this sync, and the ack contract
                # requires it inside the cursor update
                os.fsync(f.fileno())  # pio-lint: disable=PL03
            new_off = off + len(payload)
            self.cursors[batch.ns_tag] = {"seg": batch.seg_id,
                                          "offset": new_off}
            self.leading = False
            self._save_state()
            REPL_BATCHES.inc(("ok",))
            return new_off

    def apply_seal(self, ns_tag: str, seg_meta: Dict[str, Any],
                   epoch: int) -> None:
        """The leader sealed its active segment: rename our copy into
        the ``.peld`` dir, verify the byte-identity claim against the
        leader's digest, and record the manifest row. A digest mismatch
        refuses the seal and leaves the file in place for resync."""
        meta = SegMeta.from_dict(seg_meta)
        with self.lock:
            self.check_epoch(epoch)
            src = self.active_path(ns_tag)
            if not os.path.exists(src):
                REPL_SEALS.inc(("error",))
                raise ReplicationError(
                    f"seal for {ns_tag}/{meta.file} but replica has no "
                    "active file — resync needed")
            if meta.sha256 is not None:
                actual = _file_sha256(src)
                if actual != meta.sha256:
                    REPL_SEALS.inc(("digest_mismatch",))
                    raise ReplicationError(
                        f"sealed segment {ns_tag}/{meta.file} digest "
                        f"mismatch (leader {meta.sha256[:12]}…, replica "
                        f"{actual[:12]}…) — replica diverged, resync "
                        "needed")
            os.makedirs(self.seg_dir(ns_tag), exist_ok=True)
            dst = os.path.join(self.seg_dir(ns_tag), meta.file)
            os.rename(src, dst)
            if meta.sha256 is not None:
                self._sealed_sha256(dst, meta.sha256)
            doc = self._load_manifest(ns_tag)
            rows = [d for d in doc["segments"]
                    if int(d.get("id", -1)) != meta.id]
            row = meta.to_dict()
            # local-cache sidecars (columnar, id filter) do not ship
            # over the WAL stream; the promoted store rebuilds them
            row["cols"] = None
            row["idf"] = None
            rows.append(row)
            rows.sort(key=lambda d: int(d["id"]))
            doc["segments"] = rows
            doc["next_id"] = max(int(doc.get("next_id", 0)), meta.id + 1)
            self._write_manifest(ns_tag, doc)
            cur = self.cursors.setdefault(ns_tag, {"seg": 0, "offset": 0})
            cur["seg"] = meta.id + 1
            cur["offset"] = 0
            self.leading = False
            self._save_state()
            REPL_SEALS.inc(("ok",))

    # -- sealed-segment catch-up ------------------------------------------

    def sync_sealed(self, ns_tag: str, manifest: Dict[str, Any],
                    fetch: Callable[[str, str], Optional[bytes]],
                    epoch: int) -> int:
        """Heal sealed segments the push stream missed: for every row
        in the leader's ``manifest`` whose frame file we lack (or whose
        digest moved — tombstone re-seals), fetch the blob, verify its
        sha256, and install it. ``fetch(ns_tag, file)`` returns the
        blob or None (cold segments have no local frame file on the
        leader either; their manifest row is copied as-is and the
        cold-tier digest check applies on any later fetch). Returns
        the number of files installed.

        A row the leader has not digested yet (a segment sealed without
        finalizing, as ``pio import`` and a plain rollover seal) is kept
        while its file's size matches the row; one such file a pass, the
        one held against the leader's bytes longest ago, is fetched again
        once ``REVERIFY_SECONDS`` have passed since and replaced when its bytes
        differ. The JAX package fetches every such row again on every
        pass, under the lock the WAL applies wait on; this fetch runs
        outside it."""
        again = self._due_recheck(ns_tag, manifest)
        blob_again = fetch(ns_tag, again) if again else None
        if blob_again is not None:
            # hashed outside the lock; cached while the file is unchanged
            try:
                self._sealed_sha256(os.path.join(self.seg_dir(ns_tag), again))
            except OSError:
                pass
        installed = 0
        with self.lock:
            self.check_epoch(epoch)
            doc = self._load_manifest(ns_tag)
            rows = {int(d["id"]): d for d in doc["segments"]}
            for d in manifest.get("segments", []):
                meta = SegMeta.from_dict(d)
                path = os.path.join(self.seg_dir(ns_tag), meta.file)
                have = rows.get(meta.id)
                digest_ok = os.path.exists(path) and (
                    self._sealed_sha256(path) == meta.sha256 if meta.sha256
                    else os.path.getsize(path) == meta.bytes)
                fetched = blob_again if meta.file == again else None
                if have and digest_ok:
                    if fetched is not None and not meta.sha256:
                        self._verified[path] = self._clock()
                        if _sha256(fetched) != self._sealed_sha256(path):
                            self._install(path, fetched)
                            installed += 1
                            REPL_SEALS.inc(("ok",))
                    continue
                if meta.state != "cold":
                    blob = (fetched if fetched is not None
                            else fetch(ns_tag, meta.file))
                    if blob is None:
                        REPL_SEALS.inc(("error",))
                        continue
                    blob = faults.corrupt_bytes("replication.wal.torn",
                                                blob)
                    if meta.sha256 and _sha256(blob) != meta.sha256:
                        REPL_SEALS.inc(("digest_mismatch",))
                        raise ReplicationError(
                            f"fetched segment {ns_tag}/{meta.file} "
                            "failed digest verification — refusing it")
                    self._install(path, blob)
                    if meta.sha256:
                        self._sealed_sha256(path, meta.sha256)
                    installed += 1
                row = meta.to_dict()
                row["cols"] = None
                row["idf"] = None
                rows[meta.id] = row
                REPL_SEALS.inc(("ok",))
            doc["segments"] = sorted(rows.values(),
                                     key=lambda r: int(r["id"]))
            doc["next_id"] = max(
                [int(manifest.get("next_id", 0)),
                 int(doc.get("next_id", 0))]
                + [int(r["id"]) + 1 for r in doc["segments"]])
            self._write_manifest(ns_tag, doc)
            cur = self.cursors.setdefault(ns_tag, {"seg": 0, "offset": 0})
            if cur["seg"] < int(doc["next_id"]):
                # sealed rows beyond our cursor: the active stream
                # restarts at the leader's current active segment
                cur["seg"] = int(doc["next_id"])
                cur["offset"] = 0
            self._save_state()
        return installed

    def _install(self, path: str, blob: bytes) -> None:
        """Write a fetched sealed file in place (must hold ``lock``)."""
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".part"
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            # catch-up runs on the follower's watch thread; the apply
            # stream shares this lock by design (sealed installs must
            # serialize with WAL appends), so there is no writer to stall
            os.fsync(f.fileno())  # pio-lint: disable=PL03
        os.rename(tmp, path)
        # both calls (in sync_sealed) hold ``lock``, which the lint cannot
        # see through the call
        self._verified[path] = self._clock()  # pio-lint: disable=PL03

    def _due_recheck(self, ns_tag: str,
                     manifest: Dict[str, Any]) -> Optional[str]:
        """The undigested sealed file of ``manifest`` to hold against the
        leader's bytes on this pass (never held first, then the one held
        longest ago), or None when none is due."""
        now = self._clock()
        due = []
        with self.lock:
            for d in manifest.get("segments", []):
                if d.get("sha256") or d.get("state") == "cold":
                    continue
                path = os.path.join(self.seg_dir(ns_tag), str(d["file"]))
                seen = self._verified.get(path)
                if ((seen is None or now - seen >= REVERIFY_SECONDS)
                        and os.path.exists(path)):
                    due.append((-math.inf if seen is None else seen,
                                str(d["file"])))
        return min(due)[1] if due else None

    def status(self) -> Dict[str, Any]:
        with self.lock:
            return {"epoch": self.epoch,
                    "cursors": {k: dict(v)
                                for k, v in sorted(self.cursors.items())}}


def _sha256(blob: bytes) -> str:
    import hashlib

    return hashlib.sha256(blob).hexdigest()


def _file_sha256(path: str) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


# -- leader: the replicator ----------------------------------------------------


class FollowerLink:
    """Leader's view of one follower: transport + replication cursor.

    The transport is injectable (``apply_fn``/``seal_fn`` — HTTP in
    production via :class:`~predictionio_tpu_torch.server.repl_server.`
    ``FollowerClient``, in-process in tests). A :class:`WalGapError`
    raised by the transport resets the cursor to the follower's true
    position so the next push resends from there."""

    def __init__(self, name: str,
                 apply_fn: Callable[[WalBatch], int],
                 seal_fn: Callable[[str, Dict[str, Any], int], None],
                 status_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 ) -> None:
        self.name = name
        self.apply_fn = apply_fn
        self.seal_fn = seal_fn
        self.status_fn = status_fn
        #: ns_tag -> [seg_id, offset] acked by this follower
        self.cursors: Dict[str, List[int]] = {}
        self.healthy = True
        self.last_error: Optional[str] = None
        self.probe_countdown = 0


class Replicator:
    """Leader-side push replication, attached to the native store.

    ``on_append(ns)`` runs under the namespace writer lock right after
    a committed append: it reads the active file's new bytes and
    pushes them to every follower, waiting for acks — an acked client
    write therefore implies the bytes are fsynced on every healthy
    follower (semi-synchronous replication; a follower that errors is
    marked unhealthy and skipped until it resyncs, so one dead
    follower degrades durability, never availability)."""

    def __init__(self, followers: List[FollowerLink],
                 epoch: Callable[[], int],
                 fenced: Callable[[], bool] = lambda: False,
                 max_batch_bytes: int = 4 << 20) -> None:
        self.followers = followers
        self._epoch = epoch
        self._fenced = fenced
        self.max_batch_bytes = max_batch_bytes

    # -- fencing (local) ---------------------------------------------------

    def check_fenced(self) -> None:
        if self._fenced():
            raise FencedWriteError(
                "this node's event-plane leadership was lost "
                f"(epoch {self._epoch()}) — writes are fenced; retry "
                "against the new leader")

    # -- hooks (called by NativeEventLogStore under ns.lock) ---------------

    def on_append(self, ns) -> None:
        """Push everything between each follower's cursor and the
        active file's current end."""
        tag = ns.namespace_tag()
        path = ns.base_path
        try:
            size = os.path.getsize(path)
        except OSError:
            return
        with open(path, "rb") as f:
            for link in self.followers:
                if not link.healthy and not self._probe(link, tag,
                                                        ns.next_id):
                    continue
                self._push_range(link, tag, ns.next_id, f, size)

    def _probe(self, link: FollowerLink, tag: str, seg_id: int) -> bool:
        """Try to revive an unhealthy link: every 64th append, ask the
        follower where it actually is (it may have healed itself via
        :meth:`ReplicaHome.sync_sealed`). Revives the link when the
        follower's cursor is back on the current active segment."""
        link.probe_countdown -= 1
        if link.probe_countdown > 0 or link.status_fn is None:
            return False
        link.probe_countdown = 64
        try:
            doc = link.status_fn()
        except Exception as e:  # noqa: BLE001
            link.last_error = f"{type(e).__name__}: {e}"
            return False
        cur = doc.get("cursors", {}).get(tag)
        if cur is None and not doc.get("cursors"):
            # a blank follower starts wherever we start it
            link.cursors[tag] = [seg_id, 0]
            link.healthy = True
            return True
        if cur is not None and int(cur.get("seg", -1)) == seg_id:
            link.cursors[tag] = [seg_id, int(cur.get("offset", 0))]
            link.healthy = True
            return True
        return False

    def _push_range(self, link: FollowerLink, tag: str, seg_id: int,
                    f, size: int) -> None:
        cur = link.cursors.setdefault(tag, [seg_id, 0])
        if cur[0] != seg_id:
            # follower is on an older active file than we think —
            # a seal push must have failed; mark for resync
            link.healthy = False
            link.last_error = (f"cursor on seg {cur[0]} but active is "
                               f"seg {seg_id}")
            return
        while cur[1] < size:
            f.seek(cur[1])
            payload = f.read(min(size - cur[1], self.max_batch_bytes))
            if not payload:
                break
            batch = WalBatch.build(tag, seg_id, cur[1], payload,
                                   self._epoch())
            try:
                with tracing.span("repl.push", follower=link.name,
                                  ns=tag, bytes=len(payload)):
                    acked = link.apply_fn(batch)
                cur[1] = acked
                link.last_error = None
            except WalGapError as e:
                if e.seg_id != seg_id:
                    link.healthy = False
                    link.last_error = str(e)
                    break
                cur[1] = e.offset        # resend from the true cursor
            except StaleEpochError as e:
                link.healthy = False
                link.last_error = str(e)
                break
            except Exception as e:  # noqa: BLE001 — degrade, don't block
                link.healthy = False
                link.last_error = f"{type(e).__name__}: {e}"
                break
            self._lag(link, tag, size, cur[1])
        self._lag(link, tag, size, cur[1], f)

    def _lag(self, link: FollowerLink, tag: str, size: int,
             acked: int, f=None) -> None:
        lag = max(0, size - acked)
        REPL_LAG_BYTES.set(lag, (link.name,))
        if lag == 0:
            REPL_LAG_RECORDS.set(0, (link.name,))
        elif f is not None:
            f.seek(acked)
            rem = f.read(lag)
            REPL_LAG_RECORDS.set(count_frames(rem, acked == 0),
                                 (link.name,))

    def on_seal(self, ns, seg) -> None:
        """The active segment just rolled: finalize its digest (the
        follower verifies byte identity against it) and push the seal.
        Cursors move to (new active seg id, 0)."""
        ns.finalize(seg)
        tag = ns.namespace_tag()
        meta = seg.meta.to_dict()
        for link in self.followers:
            if not link.healthy:
                continue
            cur = link.cursors.setdefault(tag, [seg.meta.id, 0])
            try:
                # drain any unpushed tail of the sealed file first
                sealed_path = ns.seg_path(seg)
                with open(sealed_path, "rb") as f:
                    size = os.path.getsize(sealed_path)
                    self._push_range(link, tag, seg.meta.id, f, size)
                if not link.healthy:
                    continue
                link.seal_fn(tag, meta, self._epoch())
                cur[0] = seg.meta.id + 1
                cur[1] = 0
            except Exception as e:  # noqa: BLE001
                link.healthy = False
                link.last_error = f"{type(e).__name__}: {e}"

    def status(self) -> Dict[str, Any]:
        return {"followers": [
            {"name": l.name, "healthy": l.healthy,
             "lastError": l.last_error,
             "cursors": {k: list(v) for k, v in sorted(l.cursors.items())}}
            for l in self.followers]}


# -- read fan-out --------------------------------------------------------------


def select_read_home(read_from: str, leader_home: str,
                     replica_home: Optional[str] = None) -> str:
    """Resolve ``--read-from follower|leader|any`` to a storage home.

    ``follower`` requires a replica home (``--replica-home`` or
    ``PIO_REPL_REPLICA_HOME``) holding a replicated event log;
    ``any`` prefers the replica when it exists (training reads then
    never contend with the leader's ingest fsyncs) and falls back to
    the leader's home; ``leader`` is the default passthrough."""
    replica_home = replica_home or os.environ.get("PIO_REPL_REPLICA_HOME")
    if read_from == "leader":
        return leader_home
    has_replica = bool(replica_home) and os.path.isdir(
        os.path.join(replica_home, "eventlog"))
    if read_from == "follower":
        if not has_replica:
            raise ValueError(
                "--read-from follower needs a replica home with a "
                "replicated event log (set --replica-home or "
                "PIO_REPL_REPLICA_HOME)")
        return replica_home  # type: ignore[return-value]
    if read_from == "any":
        return replica_home if has_replica else leader_home
    raise ValueError(f"unknown --read-from {read_from!r} "
                     "(want follower|leader|any)")


# -- reading a live home ---------------------------------------------------------

#: under a storage home: the private views of the processes that read it
LOG_VIEWS_DIR = "log_views"


class ReadOnlyViewError(ReplicationError):
    """A write reached a :class:`LogView`: events go in through the
    event server that owns the log."""


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def _prune_views(root: str) -> None:
    """Remove the views of reading processes that died without closing
    them (a kill -9 mid-train)."""
    try:
        names = os.listdir(root)
    except FileNotFoundError:
        return
    for name in names:
        pid = name.split("-", 1)[0]
        if pid.isdigit() and int(pid) != os.getpid() and not _pid_alive(int(pid)):
            shutil.rmtree(os.path.join(root, name), ignore_errors=True)


def _mark(path: str) -> Optional[Tuple[int, int, int]]:
    try:
        st = os.stat(path)
    except FileNotFoundError:
        return None
    return st.st_ino, st.st_size, st.st_mtime_ns


def _link(src: str, dst: str) -> None:
    """Hard-link a sealed file into a view (a copy where the file system
    cannot link); FileNotFoundError when the writer moved it away."""
    try:
        os.link(src, dst)
    except FileNotFoundError:
        raise
    except OSError:
        shutil.copyfile(src, dst)


def _append_range(src_fd: int, dst_fd: int, start: int, end: int) -> None:
    """Append bytes ``start .. end`` of ``src_fd`` at the same offsets of
    ``dst_fd`` (in the kernel where it can)."""
    off = start
    while off < end:
        try:
            k = os.copy_file_range(src_fd, dst_fd, end - off, off, off)
        except OSError:
            k = 0
        if k <= 0:
            chunk = os.pread(src_fd, min(end - off, 1 << 24), off)
            if not chunk:
                raise ReplicationError(
                    f"the event log ended at byte {off}, before {end}")
            k = os.pwrite(dst_fd, chunk, off)
        off += k


class LogView(NativeEventLogStore):
    """A read-only view of the event log of a storage home that another
    process writes: a follower's replica (``train --read-from
    follower``), or a leader's home under its event server (``train
    --continuous``).

    The native engine indexes a file when it opens it and cuts a torn
    tail when it does, so a second process that opened the writer's
    active file would see none of its later appends and could truncate
    bytes the writer has acknowledged (a WAL batch may end inside a
    frame). A view never opens the writer's files through the engine.
    Each build is a private generation under
    ``<home>/log_views/<pid>-<id>/``: the sealed segments hard-linked,
    the active file's prefix held in a working copy that grows by the
    new bytes only, and a manifest of its own. The prefix ends at the
    follower's acknowledged cursor (``replica_state.json``) while the
    home follows, and at the last whole frame otherwise (a promoted
    replica, a leader's home). The engine only ever opens the copy.

    :meth:`refresh` rebuilds the view when the log moved (the continuous
    trainer calls it at every wake) and swaps the store onto the new
    generation. The engine handles of sealed segments carry over to the
    generation that links the same files, so a long-lived reader indexes
    each sealed segment once. The view keeps the home's snapshot-cache
    identity, since it is always a prefix of the home's log. Writes raise
    :class:`ReadOnlyViewError`. Views of dead processes are removed by
    the next view of the same home."""

    def __init__(self, home: str) -> None:
        self.home = os.path.abspath(home)
        self.source = os.path.join(self.home, "eventlog")
        views = os.path.join(self.home, LOG_VIEWS_DIR)
        _prune_views(views)
        self._root = os.path.join(views, f"{os.getpid()}-{uuid.uuid4().hex[:8]}")
        self._work = os.path.join(self._root, "work")
        os.makedirs(self._work)
        atexit.register(shutil.rmtree, self._root, True)
        self._gen = 0
        #: tag -> (source inode, whole-frame bytes in the working copy,
        #: format version)
        self._copied: Dict[str, Tuple[int, int, int]] = {}
        #: (tag, segment id, file, inode) -> an open engine handle on it,
        #: taken from the generation before
        self._carried: Dict[Tuple[str, int, str, int], int] = {}
        self._seen, gen_dir = self._build()
        super().__init__(gen_dir)
        self.cache_identity = "eventlog:" + self.source

    # -- what the writer has acknowledged ----------------------------------

    def _cursors(self) -> Optional[Dict[str, Tuple[int, int]]]:
        """The follower's acknowledged cursors, or None when the home
        does not follow (no replica state, or a promoted node's)."""
        try:
            with open(os.path.join(self.home, REPLICA_STATE_NAME),
                      encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return None
        if doc.get("leading"):
            return None
        return {str(k): (int(v["seg"]), int(v["offset"]))
                for k, v in doc.get("cursors", {}).items()}

    def _tags(self) -> List[str]:
        try:
            names = os.listdir(self.source)
        except FileNotFoundError:
            return []
        tags = {n[:-len(".pel")] for n in names if n.endswith(".pel")}
        tags |= {n[:-len(SEG_DIR_SUFFIX)] for n in names
                 if n.endswith(SEG_DIR_SUFFIX)}
        return sorted(tags)

    def _probe(self) -> Tuple[Any, ...]:
        """What a build depends on: the cursors and the manifests while
        the home follows, the active files and the manifests otherwise."""
        cursors = self._cursors()
        tags = sorted(cursors) if cursors is not None else self._tags()
        return cursors, tuple(
            (tag,
             None if cursors is not None
             else _mark(os.path.join(self.source, tag + ".pel")),
             _mark(os.path.join(self.source, tag + SEG_DIR_SUFFIX,
                                MANIFEST_NAME)))
            for tag in tags)

    # -- building a generation ---------------------------------------------

    def _build(self) -> Tuple[Any, str]:
        for _ in range(50):
            probe = self._probe()
            cursors = probe[0]
            gen_dir = os.path.join(self._root, f"{self._gen:06d}")
            self._gen += 1
            os.makedirs(gen_dir)
            ok = all(self._copy_ns(tag, gen_dir,
                                   None if cursors is None else cursors[tag])
                     for tag, _, _ in probe[1])
            if ok and cursors is not None:
                # a seal between reading the cursors and copying moves
                # the active file: build again
                now = self._cursors()
                ok = now is not None and all(
                    now.get(tag, (None, 0))[0] == seg
                    for tag, (seg, _) in cursors.items())
            if ok:
                return probe, gen_dir
            shutil.rmtree(gen_dir, ignore_errors=True)
            time.sleep(0.01)
        raise ReplicationError(
            f"the event log under {self.source} moved during 50 attempts "
            "to read it")

    def _copy_ns(self, tag: str, gen_dir: str,
                 cursor: Optional[Tuple[int, int]]) -> bool:
        """One namespace into ``gen_dir``; False when the writer moved it
        meanwhile."""
        src_dir = os.path.join(self.source, tag + SEG_DIR_SUFFIX)
        manifest_path = os.path.join(src_dir, MANIFEST_NAME)
        before = _mark(manifest_path)
        try:
            with open(manifest_path, encoding="utf-8") as f:
                manifest: Optional[Dict[str, Any]] = json.load(f)
        except FileNotFoundError:
            manifest = None
        except ValueError:
            return False
        if manifest is not None:
            dst_dir = os.path.join(gen_dir, tag + SEG_DIR_SUFFIX)
            os.makedirs(dst_dir)
            rows = []
            for d in manifest.get("segments", []):
                if cursor is not None and int(d["id"]) >= cursor[0]:
                    continue
                row = dict(d)
                if row.get("state") != "cold":
                    try:
                        _link(os.path.join(src_dir, row["file"]),
                              os.path.join(dst_dir, row["file"]))
                    except FileNotFoundError:
                        return False
                    if os.path.getsize(os.path.join(dst_dir, row["file"])) \
                            != int(row["bytes"]):
                        return False
                for side in ("cols", "idf"):
                    if row.get(side):
                        try:
                            _link(os.path.join(src_dir, row[side]["file"]),
                                  os.path.join(dst_dir, row[side]["file"]))
                        except FileNotFoundError:
                            row[side] = None   # the reader rebuilds it
                rows.append(row)
            with open(os.path.join(dst_dir, MANIFEST_NAME), "w",
                      encoding="utf-8") as f:
                json.dump({"schema": MANIFEST_SCHEMA,
                           "next_id": int(manifest.get("next_id", 0)),
                           "segments": rows}, f, indent=1, sort_keys=True)
        if cursor is not None and cursor[1] == 0:
            return True
        active = os.path.join(self.source, tag + ".pel")
        try:
            f = open(active, "rb")
        except FileNotFoundError:
            return cursor is None
        with f:
            st = os.fstat(f.fileno())
            bound = st.st_size if cursor is None else cursor[1]
            if st.st_size < bound:
                return False
            work = self._grow(tag, f.fileno(), st.st_ino, bound)
        if work is not None:
            os.link(work, os.path.join(gen_dir, tag + ".pel"))
        if cursor is None:
            # a leader's home: the file copied must still be the active
            # one, and no seal may have moved the manifest meanwhile
            now = _mark(active)
            if now is None or now[0] != st.st_ino \
                    or _mark(manifest_path) != before:
                return False
        return True

    def _grow(self, tag: str, fd: int, ino: int, bound: int) -> Optional[str]:
        """The working copy of ``tag``'s active file, grown to the last
        whole frame below ``bound`` (None while it holds no frame)."""
        work = os.path.join(self._work, tag + ".pel")
        seen, have, version = self._copied.get(tag, (None, 0, 0))
        if seen != ino or have > bound:
            # a new active file (a seal) or a shorter one: start over in
            # a new inode, since the views built so far link the old one
            if os.path.exists(work):
                os.unlink(work)
            have = 0
            head = os.pread(fd, len(PEL_MAGIC), 0)
            if len(head) < len(PEL_MAGIC) and PEL_MAGIC.startswith(head):
                return None      # not even the header yet
            version = 2 if head == PEL_MAGIC else 1
            start = len(PEL_MAGIC) if version == 2 else 0
        else:
            start = have
        _, end = _frames(os.pread(fd, bound - start, start), 0, version)
        end += start
        if end == 0:
            return None
        out = os.open(work, os.O_WRONLY | os.O_CREAT, 0o644)
        try:
            _append_range(fd, out, have, end)
        finally:
            os.close(out)
        self._copied[tag] = (ino, end, version)
        return work

    # -- the store's side ----------------------------------------------------

    @staticmethod
    def _seg_key(ns: Any, seg: Any) -> Optional[Tuple[str, int, str, int]]:
        mark = _mark(ns.seg_path(seg))
        return None if mark is None else (
            ns.namespace_tag(), seg.meta.id, seg.meta.file, mark[0])

    def _ns(self, app_id: int, channel_id: Optional[int], shard: int = 0):
        with self._lock:
            fresh = (app_id, channel_id, shard) not in self._namespaces
            ns = super()._ns(app_id, channel_id, shard)
            if fresh and self._carried:
                for seg in ns.sealed:
                    h = self._carried.pop(self._seg_key(ns, seg), None)
                    if h is not None:
                        seg.handle = h
            return ns

    def refresh(self) -> bool:
        """Build a new generation when the home's log moved since the
        last one, and read from it; True when it did."""
        if self._probe() == self._seen:
            return False
        seen, gen_dir = self._build()
        with self._lock:
            old = self._dir
            for ns in self._namespaces.values():
                with ns.lock:
                    for seg in ns.sealed:
                        key = self._seg_key(ns, seg) if seg.handle else None
                        if key is not None:
                            # the next generation links the same inode
                            self._carried[key] = seg.handle
                            seg.handle = None
                ns.close()
            self._namespaces.clear()
            self._disk_shards.clear()
            self._dir = gen_dir
            self._seen = seen
        shutil.rmtree(old, ignore_errors=True)
        return True

    def close(self) -> None:
        super().close()
        with self._lock:
            for h in self._carried.values():
                self._lib.pel_close(h)
            self._carried.clear()
        shutil.rmtree(self._root, ignore_errors=True)

    def _read_only(self, *_args: Any, **_kwargs: Any) -> Any:
        raise ReadOnlyViewError(
            f"{self.source} is read through a view of this process; "
            "events go in through the event server that writes it")

    insert = insert_batch = append_jsonl = delete = wipe = _read_only
    remove_channel = _read_only
