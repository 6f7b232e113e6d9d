"""Segmented, tiered event-log namespaces for the EVENTLOG backend.

The port's copy of the JAX package's ``data/segments.py``: the same
manifest, segment files and sidecars, so either package opens, rolls,
compacts and ships the other's segments.

Upstream PredictionIO scaled its event store by partitioning across
HBase regions; this is the repo-native equivalent for the C++ log
engine. Each (app, channel) namespace is an ACTIVE segment — the plain
``events_<app>[_<ch>].pel`` file, identical to the pre-segment layout,
receiving group-commit appends under one per-namespace writer lock —
plus zero or more SEALED segments under ``events_<app>[_<ch>].peld/``:

    events_1.pel                  active segment (engine wire format)
    events_1.peld/
        segments.json             manifest (atomic-replace writes)
        seg-000000.pel            sealed segment, immutable
        seg-000000.cols.npz       columnar compaction sidecar
        seg-000000.ids.bf         live-id filter (ship-time fetch guard)
        seg-000001.pel            ...

A legacy single-file log therefore IS a valid namespace (its lone
active segment); the first write that crosses the rollover threshold
migrates it in place — rename into the directory as the next sealed
segment, reopen a fresh active file. Rollover reuses the old active
handle as the sealed read handle (the engine reads through the open
fd, so the rename is invisible to it) — no close/reopen race, no
re-index of a file we just finished writing.

Sealed segments are immutable except for tombstones (cross-segment
overwrite/delete propagation), which re-seal the metadata and drop the
sidecar. Compaction scans a sealed segment once through the native
extended columnar scan and persists the result as an npz sidecar, so
training scans read it back without record-by-record decode; shipment
moves the sealed frame file to a cold tier (``storage/remote.py``)
keyed by the manifest's sha256, which the fetch path re-verifies — a
corrupt cold blob is refused (:class:`IntegrityError`), never served.

Scan fan-out: segments whose creationTime bounds fall entirely outside
the requested window are pruned (the snapshot cache's watermark becomes
a per-segment watermark), the rest scan on a thread pool (the engine
releases the GIL inside native calls) in bounded windows, and
:func:`~predictionio_tpu_torch.data.pipeline.merge_columnar_segments`
restores the global (eventTime, creationTime, seq) order.
"""

from __future__ import annotations

import ctypes
import hashlib
import io
import json
import logging
import os
import struct
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from predictionio_tpu_torch.utils import faults, tracing
from predictionio_tpu_torch.utils.atomic_write import (
    atomic_write_bytes,
    atomic_write_text,
)
from predictionio_tpu_torch.utils.integrity import (
    INTEGRITY_FAILED,
    INTEGRITY_VERIFIED,
    IntegrityError,
    sha256_hex,
)
from predictionio_tpu_torch.utils.metrics import REGISTRY

logger = logging.getLogger("pio.segments")

SEG_DIR_SUFFIX = ".peld"
MANIFEST_NAME = "segments.json"
MANIFEST_SCHEMA = 1
COLS_SUFFIX = ".cols.npz"
IDF_SUFFIX = ".ids.bf"
FAULT_SEGMENT = "data.corrupt.segment"
DEFAULT_SEGMENT_BYTES = 64 * 1024 * 1024
_UNBOUNDED_LO = -(2**62)
_UNBOUNDED_HI = 2**62

SEG_ROLLS = REGISTRY.counter(
    "pio_segment_rolls_total", "Active segments sealed (rollovers)")
SEG_COMPACTIONS = REGISTRY.counter(
    "pio_segment_compactions_total", "Sealed segments compacted to columnar")
SEG_SHIPPED = REGISTRY.counter(
    "pio_segment_shipped_total", "Sealed segments shipped to the cold tier")
SEG_SHIP_VERIFY = REGISTRY.counter(
    "pio_segment_ship_verify_total",
    "Post-ship cold-tier read-back digest checks by result", ("result",))
SEG_FETCHES = REGISTRY.counter(
    "pio_segment_fetches_total", "Cold segments fetched back on demand")
SEG_MAINT_ERRORS = REGISTRY.counter(
    "pio_segment_maintenance_errors_total",
    "Errors contained by segment maintenance sweeps")


def segment_bytes_threshold() -> int:
    """Rollover threshold; ``PIO_SEGMENT_BYTES=0`` disables rollover."""
    try:
        return int(os.environ.get("PIO_SEGMENT_BYTES",
                                  DEFAULT_SEGMENT_BYTES))
    except ValueError:
        return DEFAULT_SEGMENT_BYTES


def scan_workers_default() -> int:
    try:
        w = int(os.environ.get("PIO_SCAN_WORKERS", "0"))
    except ValueError:
        w = 0
    if w > 0:
        return w
    # IO overlap pays even on one core, so floor at 2
    return max(2, min(8, os.cpu_count() or 1))


def _file_sha256(path: str) -> str:
    d = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            d.update(chunk)
    return d.hexdigest()


@dataclass
class SegMeta:
    """One sealed segment's manifest entry."""

    id: int
    file: str
    state: str                      # "sealed" | "cold"
    records: int
    bytes: int
    min_creation_us: Optional[int]
    max_creation_us: Optional[int]
    sha256: Optional[str]           # None until finalized (lazy, off the
    version: int                    # group-commit path)
    cols: Optional[dict] = None     # {"file","sha256","value_keys":[...]}
    remote_key: Optional[str] = None
    idf: Optional[dict] = None      # {"file","sha256","k","n"} id filter

    def to_dict(self) -> dict:
        return {
            "id": self.id, "file": self.file, "state": self.state,
            "records": self.records, "bytes": self.bytes,
            "min_creation_us": self.min_creation_us,
            "max_creation_us": self.max_creation_us,
            "sha256": self.sha256, "version": self.version,
            "cols": self.cols, "remote_key": self.remote_key,
            "idf": self.idf,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "SegMeta":
        return cls(
            id=int(d["id"]), file=str(d["file"]), state=str(d["state"]),
            records=int(d["records"]), bytes=int(d["bytes"]),
            min_creation_us=d.get("min_creation_us"),
            max_creation_us=d.get("max_creation_us"),
            sha256=d.get("sha256"), version=int(d.get("version", 2)),
            cols=d.get("cols"), remote_key=d.get("remote_key"),
            idf=d.get("idf"),
        )


class Segment:
    """Runtime state for one sealed segment: manifest row + (lazy)
    engine handle. The handle, once open, stays open for the namespace
    lifetime — in-flight scans on other threads may hold it. ``gen``
    counts mutations (tombstone re-seals): slow paths that scan outside
    the lock snapshot it and abort their commit when it moved."""

    __slots__ = ("meta", "handle", "gen", "idf")

    def __init__(self, meta: SegMeta, handle: Optional[int] = None) -> None:
        self.meta = meta
        self.handle = handle
        self.gen = 0
        self.idf = None        # cached IdFilter | False (known absent)


# ---------------- extended native scan plumbing ---------------------------


@dataclass
class SegBlock:
    """Parsed pel_scan_columnar_ex blob: ColumnarEvents columns plus a
    creationTime column and entity/target TYPE columns."""

    times: "object"
    creation: "object"
    values: Dict[str, "object"]      # value_key → f64[n]
    ent_idx: "object"
    tgt_idx: "object"
    name_idx: "object"
    etype_idx: "object"
    ttype_idx: "object"
    ents: List[str]
    tgts: List[str]
    names: List[str]
    etypes: List[str]
    ttypes: List[str]
    nbytes: int


def _scan_ex(lib, h: int, start_us: int, until_us: int,
             created_after_us: int, created_until_us: int,
             entity_type: Optional[str], target_entity_type: Optional[str],
             event_names: Optional[Sequence[str]],
             value_keys: Optional[Sequence[str]]) -> Optional[bytes]:
    """Run the extended scan; None = engine declined (vocab overflow)."""
    out = ctypes.c_void_p()
    n = lib.pel_scan_columnar_ex(
        h, start_us, until_us, created_after_us, created_until_us,
        entity_type.encode() if entity_type is not None else None,
        target_entity_type.encode()
        if target_entity_type is not None else None,
        "\n".join(event_names).encode()
        if event_names is not None else None,
        "\n".join(value_keys).encode() if value_keys else None,
        ctypes.byref(out))
    if n == -2:
        return None
    if n < 0:
        raise IOError("segment columnar scan failed")
    try:
        return ctypes.string_at(out, n)
    finally:
        lib.pel_free(out)


def parse_scan_ex_blob(buf: bytes,
                       value_keys: Sequence[str]) -> SegBlock:
    import struct

    import numpy as np

    n, n_ent, n_tgt, n_nam, n_et, n_tt, n_keys = struct.unpack_from(
        "<QQQQQQQ", buf, 0)
    assert n_keys == len(value_keys), "value-key count mismatch"
    off = 56
    times = np.frombuffer(buf, "<i8", n, off); off += 8 * n
    creation = np.frombuffer(buf, "<i8", n, off); off += 8 * n
    values = {}
    for k in value_keys:
        values[k] = np.frombuffer(buf, "<f8", n, off); off += 8 * n
    ent_idx = np.frombuffer(buf, "<u4", n, off); off += 4 * n
    off += -off % 8
    tgt_idx = np.frombuffer(buf, "<u4", n, off); off += 4 * n
    off += -off % 8
    name_idx = np.frombuffer(buf, "<u2", n, off); off += 2 * n
    off += -off % 8
    etype_idx = np.frombuffer(buf, "<u2", n, off); off += 2 * n
    off += -off % 8
    ttype_idx = np.frombuffer(buf, "<u2", n, off); off += 2 * n
    off += -off % 8

    u32 = struct.Struct("<I")

    def table(off: int, count: int):
        strs = []
        for _ in range(count):
            (sl,) = u32.unpack_from(buf, off)
            off += 4
            strs.append(buf[off:off + sl].decode("utf-8"))
            off += sl
        return strs, off + (-off % 8)

    names_t, off = table(off, n_nam)
    ents_t, off = table(off, n_ent)
    tgts_t, off = table(off, n_tgt)
    etypes_t, off = table(off, n_et)
    ttypes_t, off = table(off, n_tt)
    return SegBlock(times=times, creation=creation, values=values,
                    ent_idx=ent_idx, tgt_idx=tgt_idx, name_idx=name_idx,
                    etype_idx=etype_idx, ttype_idx=ttype_idx,
                    ents=ents_t, tgts=tgts_t, names=names_t,
                    etypes=etypes_t, ttypes=ttypes_t, nbytes=len(buf))


def block_to_cols(block: SegBlock, value_key: Optional[str]):
    import numpy as np

    from predictionio_tpu_torch.data.pipeline import ColumnarEvents

    if value_key is not None:
        values = block.values[value_key]
    else:
        values = np.full(block.times.shape[0], np.nan)
    return ColumnarEvents(
        entity_idx=block.ent_idx, target_idx=block.tgt_idx,
        name_idx=block.name_idx, values=values, times_us=block.times,
        entity_ids=block.ents, target_ids=block.tgts, names=block.names)


# ---------------- columnar compaction sidecars ----------------------------


def sidecar_bytes(block: SegBlock, value_keys: Sequence[str]) -> bytes:
    """Serialize a wildcard-scan block as an npz sidecar (no pickle)."""
    import numpy as np

    def tab(strs: List[str]):
        return np.asarray(strs, dtype=str) if strs else np.asarray(
            [], dtype="<U1")

    arrays = {
        "times": block.times, "creation": block.creation,
        "ent_idx": block.ent_idx, "tgt_idx": block.tgt_idx,
        "name_idx": block.name_idx, "etype_idx": block.etype_idx,
        "ttype_idx": block.ttype_idx,
        "ent_tab": tab(block.ents), "tgt_tab": tab(block.tgts),
        "name_tab": tab(block.names), "etype_tab": tab(block.etypes),
        "ttype_tab": tab(block.ttypes),
        "value_keys": tab(list(value_keys)),
    }
    for i, k in enumerate(value_keys):
        arrays[f"val_{i}"] = block.values[k]
    bio = io.BytesIO()
    import numpy as _np
    _np.savez(bio, **arrays)
    return bio.getvalue()


def load_sidecar(path: str, expected_sha: str) -> Tuple[dict, int]:
    """Read + digest-verify a compaction sidecar. The sidecar is a
    cache of the raw segment, never authoritative — callers treat any
    failure here as a miss and fall back to the raw frame scan."""
    import numpy as np

    with open(path, "rb") as f:
        blob = f.read()
    if sha256_hex(blob) != expected_sha:
        INTEGRITY_FAILED.inc(("segment_cols",))
        raise IntegrityError(f"segment sidecar digest mismatch: {path}")
    npz = np.load(io.BytesIO(blob), allow_pickle=False)
    return {k: npz[k] for k in npz.files}, len(blob)


def sidecar_scan(sc: dict, start_us: int, until_us: int,
                 created_after_us: int, created_until_us: int,
                 entity_type: Optional[str],
                 target_entity_type: Optional[str],
                 event_names: Optional[Sequence[str]],
                 value_key: Optional[str]):
    """Serve one scan_columnar filter set from a loaded sidecar, or
    None when it cannot (value_key the compaction did not extract).
    Vocabularies are renumbered to first-seen order of the FILTERED
    rows — identical to what a native scan of the raw segment with the
    same filters would build."""
    import numpy as np

    from predictionio_tpu_torch.data.pipeline import (
        ColumnarEvents,
        _reindex_first_seen,
    )

    vkeys = [str(s) for s in sc["value_keys"]]
    if value_key is not None and value_key not in vkeys:
        return None
    times = sc["times"]
    creation = sc["creation"]
    mask = np.ones(times.shape[0], bool)
    if start_us > _UNBOUNDED_LO:
        mask &= times >= start_us
    if until_us < _UNBOUNDED_HI:
        mask &= times < until_us
    if created_after_us > _UNBOUNDED_LO:
        mask &= creation > created_after_us
    if created_until_us < _UNBOUNDED_HI:
        mask &= creation <= created_until_us

    def type_mask(filter_val: Optional[str], tab_key: str, idx_key: str):
        nonlocal mask
        if filter_val is None:
            return
        tab = sc[tab_key].tolist()
        if filter_val in tab:
            mask &= sc[idx_key] == tab.index(filter_val)
        else:
            mask &= False

    type_mask(entity_type, "etype_tab", "etype_idx")
    type_mask(target_entity_type, "ttype_tab", "ttype_idx")
    if event_names is not None:
        allowed_set = set(event_names)
        tab = sc["name_tab"].tolist()
        allowed = np.asarray([s in allowed_set for s in tab], bool)
        if tab:
            mask &= allowed[sc["name_idx"]]
        # empty name table ⇒ empty segment scan; mask already matches
    if mask.all():
        # nothing filtered: the compaction already stored first-seen
        # vocabularies, so the block passes through untouched (numpy
        # <U tables — the segment merge normalizes to lists)
        if value_key is not None:
            values = sc[f"val_{vkeys.index(value_key)}"]
        else:
            values = np.full(times.shape[0], np.nan)
        cols = ColumnarEvents(
            entity_idx=sc["ent_idx"], target_idx=sc["tgt_idx"],
            name_idx=sc["name_idx"], values=values, times_us=times,
            entity_ids=sc["ent_tab"], target_ids=sc["tgt_tab"],
            names=sc["name_tab"])
        return cols, creation
    times_f = times[mask]
    creation_f = creation[mask]
    if value_key is not None:
        values = sc[f"val_{vkeys.index(value_key)}"][mask]
    else:
        values = np.full(times_f.shape[0], np.nan)
    e_idx, e_tab = _reindex_first_seen(
        sc["ent_idx"][mask], sc["ent_tab"].tolist(), np.uint32)
    t_idx, t_tab = _reindex_first_seen(
        sc["tgt_idx"][mask], sc["tgt_tab"].tolist(), np.uint32)
    n_idx, n_tab = _reindex_first_seen(
        sc["name_idx"][mask], sc["name_tab"].tolist(), np.uint16)
    cols = ColumnarEvents(
        entity_idx=e_idx, target_idx=t_idx, name_idx=n_idx,
        values=values, times_us=times_f,
        entity_ids=e_tab, target_ids=t_tab, names=n_tab)
    return cols, creation_f


# ---------------- id membership filters -----------------------------------


class IdFilter:
    """Bloom filter over a sealed segment's live event ids, persisted
    at ship time so the synchronous write path can prove "this id is
    not in that cold segment" without fetching the frame file back
    from the tier. A false positive costs one extra fetch; false
    negatives cannot happen, so a miss is always safe to skip."""

    __slots__ = ("bits", "k", "m")

    BITS_PER_ID = 12
    K = 7                           # ~0.3% false positives at 12 b/id

    def __init__(self, bits: bytes, k: int) -> None:
        self.bits = bits
        self.k = k
        self.m = len(bits) * 8

    @staticmethod
    def _hashes(id_: bytes) -> Tuple[int, int]:
        d = hashlib.blake2b(id_, digest_size=16).digest()
        # double hashing: h1 + i*h2 — h2 forced odd so strides cover m
        return (int.from_bytes(d[:8], "little"),
                int.from_bytes(d[8:], "little") | 1)

    @classmethod
    def build(cls, ids: Sequence[bytes]) -> "IdFilter":
        m = max(1024, len(ids) * cls.BITS_PER_ID)
        m += -m % 8
        bits = bytearray(m // 8)
        for id_ in ids:
            h1, h2 = cls._hashes(id_)
            for i in range(cls.K):
                b = (h1 + i * h2) % m
                bits[b >> 3] |= 1 << (b & 7)
        return cls(bytes(bits), cls.K)

    def __contains__(self, id_: str) -> bool:
        h1, h2 = self._hashes(id_.encode())
        for i in range(self.k):
            b = (h1 + i * h2) % self.m
            if not (self.bits[b >> 3] >> (b & 7)) & 1:
                return False
        return True


# ---------------- cold tier -----------------------------------------------


def cold_tier():
    """The configured segment cold tier, or None (lazy import — the
    remote module pulls in breaker/retry plumbing)."""
    from predictionio_tpu_torch.storage.remote import segment_cold_tier

    return segment_cold_tier()


# ---------------- namespace -----------------------------------------------


class LogNamespace:
    """One (app, channel) namespace: active engine handle + sealed
    segment list + manifest. All mutation happens under ``lock`` (the
    per-namespace writer lock); readers snapshot the handle/segment
    list under the lock and then run lock-free — handles are never
    closed while the namespace lives."""

    def __init__(self, lib, base_path: str, fmt: int) -> None:
        self._lib = lib
        self.base_path = base_path
        root, _ext = os.path.splitext(base_path)
        self.dir_path = root + SEG_DIR_SUFFIX
        self.fmt = fmt
        self.lock = threading.RLock()
        self.sealed: List[Segment] = []
        self.next_id = 0
        self.last_scan: Optional[dict] = None
        # handles swapped out of service (wipe, cold re-materialize):
        # lock-free readers may still hold them, so they are parked
        # here and only closed when the namespace itself closes
        self._retired: List[int] = []
        self._load_manifest()
        self.h = lib.pel_open_ex(base_path.encode(), fmt)
        if not self.h:
            raise IOError(f"cannot open event log {base_path}")

    # -- manifest ----------------------------------------------------------

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.dir_path, MANIFEST_NAME)

    def _load_manifest(self) -> None:
        try:
            with open(self.manifest_path, "r", encoding="utf-8") as f:
                doc = json.load(f)
        except FileNotFoundError:
            return
        except (OSError, json.JSONDecodeError) as e:
            raise IOError(
                f"unreadable segment manifest {self.manifest_path}: {e}"
            ) from e
        if doc.get("schema") != MANIFEST_SCHEMA:
            raise IOError(
                f"unknown segment manifest schema in {self.manifest_path}")
        self.sealed = [Segment(SegMeta.from_dict(d))
                       for d in doc.get("segments", [])]
        self.sealed.sort(key=lambda s: s.meta.id)
        ids = [s.meta.id for s in self.sealed]
        self.next_id = max([int(doc.get("next_id", 0))] +
                           [i + 1 for i in ids])

    def _write_manifest(self) -> None:
        doc = {
            "schema": MANIFEST_SCHEMA,
            "next_id": self.next_id,
            "segments": [s.meta.to_dict() for s in self.sealed],
        }
        os.makedirs(self.dir_path, exist_ok=True)
        atomic_write_text(self.manifest_path,
                          json.dumps(doc, indent=1, sort_keys=True))

    def seg_path(self, seg: Segment) -> str:
        return os.path.join(self.dir_path, seg.meta.file)

    def cols_path(self, seg: Segment) -> Optional[str]:
        if not seg.meta.cols:
            return None
        return os.path.join(self.dir_path, seg.meta.cols["file"])

    def idf_path(self, seg: Segment) -> Optional[str]:
        if not seg.meta.idf:
            return None
        return os.path.join(self.dir_path, seg.meta.idf["file"])

    # -- rollover ----------------------------------------------------------

    def maybe_roll(self, threshold_bytes: int) -> bool:
        """Seal the active segment when it crosses the size threshold.
        Called with appends quiesced (writer lock held by caller or
        taken here). The seal is cheap — rename + index-only bounds +
        manifest write; the content digest is deferred to
        :meth:`finalize` so group commits never pay a full-file hash."""
        if threshold_bytes <= 0:
            return False
        with self.lock:
            try:
                size = os.path.getsize(self.base_path)
            except OSError:
                return False
            if size < threshold_bytes:
                return False
            return self.roll()

    def roll(self) -> bool:
        """Unconditionally seal the active segment (no-op when empty)."""
        with self.lock:
            lib = self._lib
            h = self.h
            lib.pel_sync(h)
            try:
                if os.path.getsize(self.base_path) <= 8:
                    return False  # header-only / empty file
            except OSError:
                return False
            mn = ctypes.c_longlong(0)
            mx = ctypes.c_longlong(0)
            count = lib.pel_creation_bounds(
                h, ctypes.byref(mn), ctypes.byref(mx))
            ver = ctypes.c_longlong(2)
            lib.pel_info(h, ctypes.byref(ver), None, None, None)
            seg_id = self.next_id
            self.next_id += 1
            fname = f"seg-{seg_id:06d}.pel"
            os.makedirs(self.dir_path, exist_ok=True)
            dst = os.path.join(self.dir_path, fname)
            os.rename(self.base_path, dst)
            meta = SegMeta(
                id=seg_id, file=fname, state="sealed",
                records=int(count), bytes=os.path.getsize(dst),
                min_creation_us=int(mn.value) if count else None,
                max_creation_us=int(mx.value) if count else None,
                sha256=None, version=int(ver.value))
            # the old active handle becomes the sealed read handle: the
            # engine reads through the open fd, so the rename (and a
            # later cold-tier unlink) is invisible to it
            self.sealed.append(Segment(meta, handle=h))
            self._write_manifest()
            nh = lib.pel_open_ex(self.base_path.encode(), self.fmt)
            if not nh:
                raise IOError(
                    f"cannot reopen active segment {self.base_path}")
            self.h = nh
            SEG_ROLLS.inc()
            return True

    def finalize(self, seg: Segment) -> None:
        """Fill in the deferred content digest of a sealed segment."""
        with self.lock:
            if seg.meta.sha256 is not None:
                return
            path = self.seg_path(seg)
            if seg.handle is not None:
                self._lib.pel_sync(seg.handle)
            seg.meta.sha256 = _file_sha256(path)
            seg.meta.bytes = os.path.getsize(path)
            self._write_manifest()

    def finalize_all(self) -> None:
        for seg in list(self.sealed):
            if seg.meta.sha256 is None and seg.meta.state == "sealed":
                self.finalize(seg)

    # -- handles / locality ------------------------------------------------

    def handle_for(self, seg: Segment) -> int:
        with self.lock:
            if seg.handle is not None:
                return seg.handle
            self.ensure_local(seg)
            h = self._lib.pel_open_ex(self.seg_path(seg).encode(), self.fmt)
            if not h:
                raise IOError(f"cannot open segment {self.seg_path(seg)}")
            corrupt = ctypes.c_longlong(0)
            torn = ctypes.c_longlong(-1)
            self._lib.pel_info(h, None, ctypes.byref(corrupt),
                               ctypes.byref(torn), None)
            if corrupt.value > 0 or torn.value >= 0:
                # a sealed segment should never recover records; serve
                # what is readable but surface it — fsck flags it hard
                INTEGRITY_FAILED.inc(("segment",))
            seg.handle = h
            return h

    def ensure_local(self, seg: Segment) -> None:
        """Fetch a cold segment's frame file back from the tier,
        verifying the manifest digest; a mismatch refuses the segment."""
        path = self.seg_path(seg)
        if os.path.exists(path):
            return
        meta = seg.meta
        if meta.state != "cold" or not meta.remote_key:
            raise IOError(f"segment file missing: {path}")
        tier = cold_tier()
        if tier is None:
            raise IOError(
                f"segment {meta.file} is cold but no cold tier is "
                "configured (PIO_SEGMENT_COLD)")
        with tracing.span("storage.segment.fetch", key=meta.remote_key):
            blob = tier.get(meta.remote_key)
        if blob is None:
            raise IOError(
                f"cold tier has no object for segment {meta.file} "
                f"({meta.remote_key})")
        blob = faults.corrupt_bytes(FAULT_SEGMENT, blob)
        if meta.sha256 is None or sha256_hex(blob) != meta.sha256:
            INTEGRITY_FAILED.inc(("segment",))
            raise IntegrityError(
                f"cold segment {meta.file} failed digest verification "
                "— refusing to serve it")
        INTEGRITY_VERIFIED.inc(("segment",))
        atomic_write_bytes(path, blob)
        SEG_FETCHES.inc()

    def _mutable_handle(self, seg: Segment) -> int:
        """A handle safe to append tombstones through. A shipped
        segment's lingering read handle sits on an unlinked inode
        (:meth:`ship` removes the local path), so appends there would
        vanish when the handle closes. Re-materialize the authoritative
        cold copy first and open a fresh handle on it; the stale handle
        is parked, never closed — lock-free readers may still hold it."""
        with self.lock:
            if not os.path.exists(self.seg_path(seg)):
                self.ensure_local(seg)
                if seg.handle is not None:
                    self._retired.append(seg.handle)
                    seg.handle = None
            return self.handle_for(seg)

    # -- id membership filters ---------------------------------------------

    def build_id_filter(self, seg: Segment) -> Optional[dict]:
        """Build + persist the live-id filter for a segment about to go
        cold (index-only native walk, no payload IO). Best effort: the
        filter only short-circuits tombstone probes, so on any failure
        the segment ships without one and probes fall back to fetching."""
        try:
            h = self.handle_for(seg)
            out = ctypes.c_void_p()
            n = self._lib.pel_live_ids(h, ctypes.byref(out))
            if n < 0:
                return None
            try:
                buf = ctypes.string_at(out, n)
            finally:
                self._lib.pel_free(out)
            ids = []
            pos = 0
            while pos < len(buf):
                (ln,) = struct.unpack_from("<I", buf, pos)
                pos += 4
                ids.append(buf[pos:pos + ln])
                pos += ln
            f = IdFilter.build(ids)
            fname = seg.meta.file[:-len(".pel")] + IDF_SUFFIX
            atomic_write_bytes(os.path.join(self.dir_path, fname), f.bits)
            seg.idf = f
            return {"file": fname, "sha256": sha256_hex(f.bits),
                    "k": f.k, "n": len(ids)}
        except Exception:
            logger.warning("id-filter build failed for %s; cold "
                           "tombstone probes will fetch", seg.meta.file,
                           exc_info=True)
            return None

    def _load_id_filter(self, seg: Segment) -> Optional[IdFilter]:
        """The segment's persisted id filter (lazy, digest-verified),
        or None when absent/unreadable — callers then treat every id
        as a possible member (correct, just slower)."""
        if seg.idf is not None:
            return seg.idf or None      # False sentinel = known absent
        meta = seg.meta.idf
        path = self.idf_path(seg)
        if not meta or path is None:
            seg.idf = False
            return None
        try:
            with open(path, "rb") as f:
                blob = f.read()
            if sha256_hex(blob) != meta.get("sha256"):
                raise IntegrityError(
                    f"id-filter digest mismatch: {path}")
            seg.idf = IdFilter(blob, int(meta.get("k", IdFilter.K)))
        except (OSError, IntegrityError, ValueError):
            seg.idf = False
            return None
        return seg.idf

    # -- compaction --------------------------------------------------------

    def sample_value_keys(self, h: int, sample: int = 256) -> List[str]:
        """Pick the property keys worth extracting into value columns:
        explicit ``PIO_SEGMENT_VALUE_KEYS`` wins, else the most common
        top-level keys of a record sample (up to 4)."""
        env = os.environ.get("PIO_SEGMENT_VALUE_KEYS")
        if env is not None:
            return [k for k in (p.strip() for p in env.split(","))
                    if k][:8]
        from predictionio_tpu_torch.data.filestore import deserialize_payload

        import struct as _struct

        out = ctypes.c_void_p()
        n = self._lib.pel_find(
            h, _UNBOUNDED_LO, _UNBOUNDED_HI, None, None, None, None,
            None, 0, sample, ctypes.byref(out))
        if n < 0:
            return []
        try:
            buf = ctypes.string_at(out, n)
        finally:
            self._lib.pel_free(out)
        counts: Dict[str, int] = {}
        pos = 0
        while pos < len(buf):
            (plen,) = _struct.unpack_from("<I", buf, pos)
            pos += 4
            try:
                e = deserialize_payload(buf, pos, plen)
            except Exception:
                pos += plen
                continue
            pos += plen
            for k in e.properties:
                counts[k] = counts.get(k, 0) + 1
        top = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
        return [k for k, _c in top[:4]]

    def compact(self, seg: Segment,
                value_keys: Optional[Sequence[str]] = None) -> bool:
        """Compact one sealed segment into its columnar sidecar."""
        with self.lock:
            if seg.meta.cols is not None or seg.meta.records == 0:
                return False
            gen = seg.gen
        h = self.handle_for(seg)
        keys = list(value_keys) if value_keys is not None \
            else self.sample_value_keys(h)
        blob = _scan_ex(self._lib, h, _UNBOUNDED_LO, _UNBOUNDED_HI,
                        _UNBOUNDED_LO, _UNBOUNDED_HI, None, None, None,
                        keys)
        if blob is None:
            return False  # vocab overflow: raw scans only
        block = parse_scan_ex_blob(blob, keys)
        data = sidecar_bytes(block, keys)
        fname = seg.meta.file[:-len(".pel")] + COLS_SUFFIX
        path = os.path.join(self.dir_path, fname)
        atomic_write_bytes(path, data)
        with self.lock:
            if seg.gen != gen:
                # the segment mutated (tombstone re-seal) while we
                # scanned outside the lock: committing would resurrect
                # deleted events from the stale snapshot — drop it and
                # let the next maintenance sweep recompact
                try:
                    os.unlink(path)
                except OSError:
                    pass
                return False
            self.finalize(seg)
            seg.meta.cols = {"file": fname, "sha256": sha256_hex(data),
                             "value_keys": keys}
            self._write_manifest()
        SEG_COMPACTIONS.inc()
        return True

    # -- cold tier ---------------------------------------------------------

    def namespace_tag(self) -> str:
        return os.path.splitext(os.path.basename(self.base_path))[0]

    def ship(self, seg: Segment, tier=None, verify: bool = False) -> bool:
        """Ship one sealed segment's frame file to the cold tier and
        drop the local copy (the compaction sidecar stays local, so
        warm scans never refetch).

        ``verify`` closes the silent-ship-corruption gap: after the
        put, re-fetch the object from the tier and compare its sha256
        against the manifest digest BEFORE trusting the cold copy and
        unlinking the local file. A mismatch (bit rot in flight, a
        lying proxy, an eventually-consistent tier serving a stale
        body) deletes the bad remote object, keeps the local file, and
        raises :class:`IntegrityError` — the segment stays ``sealed``
        and a later ship retries."""
        tier = tier or cold_tier()
        if tier is None:
            return False
        with self.lock:
            if seg.meta.state != "sealed":
                return False
            if seg.meta.cols is None:
                self.compact(seg)   # best effort; ship regardless
            self.finalize(seg)
            # live-id filter, persisted locally: the write path probes
            # it so tombstone misses never fetch the segment back
            if seg.meta.idf is None:
                seg.meta.idf = self.build_id_filter(seg)
            path = self.seg_path(seg)
        with open(path, "rb") as f:
            blob = f.read()
        if sha256_hex(blob) != seg.meta.sha256:
            raise IntegrityError(
                f"sealed segment {seg.meta.file} changed under us — "
                "refusing to ship")
        key = f"segments/{self.namespace_tag()}/{seg.meta.file}"
        with tracing.span("storage.segment.ship", key=key,
                          bytes=len(blob)):
            tier.put(key, blob)
        if verify:
            with tracing.span("storage.segment.ship_verify", key=key):
                back = tier.get(key)
                digest = sha256_hex(back) if back is not None else None
                if digest != seg.meta.sha256:
                    SEG_SHIP_VERIFY.inc(("mismatch",))
                    try:
                        tier.delete(key)
                    except Exception:  # noqa: BLE001 — best effort
                        pass
                    raise IntegrityError(
                        f"cold tier read-back of {key} does not match "
                        f"the manifest digest (got "
                        f"{digest[:12] if digest else 'nothing'}…, want "
                        f"{seg.meta.sha256[:12]}…) — keeping the local "
                        "copy, remote object deleted")
                SEG_SHIP_VERIFY.inc(("ok",))
        with self.lock:
            seg.meta.state = "cold"
            seg.meta.remote_key = key
            self._write_manifest()
            # an already-open handle keeps reading through its fd; new
            # opens fetch from the tier
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass
        SEG_SHIPPED.inc()
        return True

    # -- tombstones (cross-segment overwrite / delete) ---------------------

    def tombstone_sealed(self, ids: Sequence[str]) -> int:
        """Propagate deletes/overwrites into sealed segments. Each id
        lives in at most one segment (overwrites tombstone the old copy
        at insert time), so the walk stops at the first hit per id.
        Cold segments are probed through their shipped-time id filter
        first: a definite miss skips the segment entirely, so appends
        with brand-new client-supplied ids never fetch from the tier."""
        deleted = 0
        with self.lock:
            segs = list(self.sealed)
        remaining = list(ids)
        for seg in reversed(segs):
            if not remaining:
                break
            candidates = remaining
            if seg.meta.state == "cold":
                f = self._load_id_filter(seg)
                if f is not None:
                    candidates = [i for i in remaining if i in f]
                if not candidates:
                    continue        # definite miss: no fetch, no probe
            # cold segment with a possible hit: re-materialize the
            # frame file before any mutation (the lingering read handle
            # sits on an unlinked inode — appends there would be lost)
            h = self._mutable_handle(seg)
            hit = set()
            for id_ in candidates:
                b = id_.encode()
                r = self._lib.pel_delete(h, b, len(b))
                if r < 0:
                    raise IOError("segment tombstone append failed")
                if r:
                    hit.add(id_)
                    deleted += 1
            if hit:
                remaining = [i for i in remaining if i not in hit]
                self._reseal(seg)
        return deleted

    def _reseal(self, seg: Segment) -> None:
        """A sealed segment mutated (tombstones): refresh its metadata
        and drop the now-stale sidecar. The local frame file is the new
        authoritative copy — its digest is recorded in the manifest
        BEFORE the (now stale) cold-tier object is deleted, so at no
        point is the only surviving copy an unlinked inode or a
        remote object about to be removed."""
        with self.lock:
            h = seg.handle
            path = self.seg_path(seg)
            if h is None or not os.path.exists(path):
                raise IOError(
                    f"re-seal of {seg.meta.file} without a local frame "
                    "file — refusing to drop the authoritative copy")
            self._lib.pel_sync(h)
            mn = ctypes.c_longlong(0)
            mx = ctypes.c_longlong(0)
            count = self._lib.pel_creation_bounds(
                h, ctypes.byref(mn), ctypes.byref(mx))
            cols = self.cols_path(seg)
            if cols:
                try:
                    os.unlink(cols)
                except FileNotFoundError:
                    pass
            old_remote = seg.meta.remote_key
            seg.meta.state = "sealed"
            seg.meta.remote_key = None
            seg.meta.cols = None
            # the id filter stays: tombstones only remove ids, so the
            # persisted filter remains a superset — still sound
            seg.meta.records = int(count)
            seg.meta.min_creation_us = int(mn.value) if count else None
            seg.meta.max_creation_us = int(mx.value) if count else None
            seg.meta.sha256 = _file_sha256(path)
            seg.meta.bytes = os.path.getsize(path)
            seg.gen += 1
            self._write_manifest()
        # only now — local copy durable and its digest recorded — may
        # the stale cold object go (network IO, outside the lock)
        if old_remote:
            tier = cold_tier()
            if tier is not None:
                try:
                    tier.delete(old_remote)
                except Exception:
                    pass  # orphaned object is harmless: state says
                    # sealed, nothing fetches it, re-ship overwrites it

    # -- stats -------------------------------------------------------------

    def creation_stats(self, until_us: int) -> Tuple[int, Optional[int]]:
        with self.lock:
            segs = list(self.sealed)
            h = self.h
        total = 0
        max_c: Optional[int] = None
        for seg in segs:
            m = seg.meta
            if m.records == 0 or m.min_creation_us is None:
                continue
            if until_us >= (m.max_creation_us or 0):
                total += m.records
                if max_c is None or m.max_creation_us > max_c:
                    max_c = m.max_creation_us
            elif until_us < m.min_creation_us:
                continue
            else:
                sh = self.handle_for(seg)
                mo = ctypes.c_longlong(0)
                n = self._lib.pel_creation_stats(
                    sh, until_us, ctypes.byref(mo))
                if n > 0:
                    total += int(n)
                    if max_c is None or mo.value > max_c:
                        max_c = int(mo.value)
        mo = ctypes.c_longlong(0)
        n = self._lib.pel_creation_stats(h, until_us, ctypes.byref(mo))
        if n > 0:
            total += int(n)
            if max_c is None or mo.value > max_c:
                max_c = int(mo.value)
        return (total, max_c) if total else (0, None)

    # -- scan fan-out ------------------------------------------------------

    def scan_columnar(self, start_us: int, until_us: int,
                      created_after_us: int, created_until_us: int,
                      entity_type: Optional[str],
                      target_entity_type: Optional[str],
                      event_names: Optional[Sequence[str]],
                      value_key: Optional[str],
                      workers: int):
        """Multi-segment columnar scan: prune by per-segment creation
        bounds, scan survivors (sidecar first, raw frames otherwise) on
        a bounded thread-pool window, merge into global order."""
        from predictionio_tpu_torch.data.pipeline import merge_columnar_segments

        return merge_columnar_segments(self.scan_blocks(
            start_us, until_us, created_after_us, created_until_us,
            entity_type, target_entity_type, event_names, value_key,
            workers))

    def scan_blocks(self, start_us: int, until_us: int,
                    created_after_us: int, created_until_us: int,
                    entity_type: Optional[str],
                    target_entity_type: Optional[str],
                    event_names: Optional[Sequence[str]],
                    value_key: Optional[str],
                    workers: int):
        """The scan fan-out as a ``(cols, creation)`` block generator,
        in segment order, WITHOUT the final merge — so a caller can
        chain several namespaces' streams (the writer-shard read path
        in ``data/filestore.py``) into ONE
        :func:`~predictionio_tpu_torch.data.pipeline.merge_columnar_segments`
        call and still get a result identical to a single-file scan of
        the union. Scan stats (``last_scan``, trace attrs) are recorded
        when the generator is exhausted."""
        with self.lock:
            segs = list(self.sealed)
            active_h = self.h
        targets: List[Optional[Segment]] = []
        pruned = 0
        for seg in segs:
            m = seg.meta
            if (m.records == 0 or m.min_creation_us is None
                    or m.max_creation_us <= created_after_us
                    or m.min_creation_us > created_until_us):
                pruned += 1
                continue
            targets.append(seg)
        targets.append(None)  # the active segment, always scanned
        stats: List[dict] = [None] * len(targets)  # type: ignore

        value_keys = [value_key] if value_key is not None else []

        def scan_one(i: int, seg: Optional[Segment]):
            if seg is not None and seg.meta.cols is not None:
                vk = seg.meta.cols.get("value_keys", [])
                if value_key is None or value_key in vk:
                    try:
                        sc, nbytes = load_sidecar(
                            self.cols_path(seg), seg.meta.cols["sha256"])
                        served = sidecar_scan(
                            sc, start_us, until_us, created_after_us,
                            created_until_us, entity_type,
                            target_entity_type, event_names, value_key)
                        if served is not None:
                            cols, creation = served
                            stats[i] = {
                                "segment": seg.meta.id,
                                "source": "columnar",
                                "records": int(cols.n),
                                "bytes": int(nbytes)}
                            return cols, creation
                    except (OSError, IntegrityError, ValueError,
                            KeyError):
                        pass  # sidecar is a cache: fall back to frames
            h = active_h if seg is None else self.handle_for(seg)
            blob = _scan_ex(self._lib, h, start_us, until_us,
                            created_after_us, created_until_us,
                            entity_type, target_entity_type, event_names,
                            value_keys)
            if blob is None:
                return None, None  # vocab overflow → whole scan declines
            block = parse_scan_ex_blob(blob, value_keys)
            stats[i] = {
                "segment": -1 if seg is None else seg.meta.id,
                "source": "active" if seg is None else "raw",
                "records": int(block.times.shape[0]),
                "bytes": int(block.nbytes)}
            return block_to_cols(block, value_key), block.creation

        def blocks():
            # bounded fan-out window: at most `workers` segment scans
            # (and their blocks) in flight, results consumed in segment
            # order so peak memory stays O(result + window)
            if workers <= 1 or len(targets) == 1:
                for i, seg in enumerate(targets):
                    yield scan_one(i, seg)
                return
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(
                    max_workers=min(workers, len(targets))) as ex:
                pending = []
                idx = 0
                while pending or idx < len(targets):
                    while idx < len(targets) and len(pending) < workers:
                        pending.append(
                            ex.submit(scan_one, idx, targets[idx]))
                        idx += 1
                    fut = pending.pop(0)
                    yield fut.result()

        yield from blocks()
        seg_stats = [s for s in stats if s]
        self.last_scan = {
            "segments": len(targets), "pruned": pruned,
            "per_segment": seg_stats,
        }
        tracing.add_attrs(
            scan_segments=len(targets), scan_segments_pruned=pruned,
            scan_segment_detail=seg_stats)

    # -- lifecycle ---------------------------------------------------------

    def wipe(self) -> bool:
        with self.lock:
            if self._lib.pel_wipe(self.h) != 0:
                return False
            tier = cold_tier() if any(
                s.meta.state == "cold" for s in self.sealed) else None
            for seg in self.sealed:
                if seg.handle is not None:
                    # lock-free readers may hold a snapshot of this
                    # handle: park it (closed at namespace close),
                    # never free it out from under an in-flight scan
                    self._retired.append(seg.handle)
                    seg.handle = None
                for p in (self.seg_path(seg), self.cols_path(seg),
                          self.idf_path(seg)):
                    if p:
                        try:
                            os.unlink(p)
                        except FileNotFoundError:
                            pass
                if tier is not None and seg.meta.remote_key:
                    try:
                        tier.delete(seg.meta.remote_key)
                    except Exception:
                        pass
            self.sealed = []
            self.next_id = 0
            try:
                os.unlink(self.manifest_path)
                os.rmdir(self.dir_path)
            except OSError:
                pass
            return True

    def close(self) -> None:
        with self.lock:
            self._lib.pel_close(self.h)
            for seg in self.sealed:
                if seg.handle is not None:
                    self._lib.pel_close(seg.handle)
                    seg.handle = None
            for h in self._retired:
                self._lib.pel_close(h)
            self._retired = []

    def remove(self) -> None:
        with self.lock:
            self.close()
            try:
                os.unlink(self.base_path)
            except FileNotFoundError:
                pass
            import shutil

            shutil.rmtree(self.dir_path, ignore_errors=True)


# ---------------- background maintenance ----------------------------------


class SegmentMaintenance(threading.Thread):
    """Background compaction + cold-tier shipment for an EVENTLOG
    store. One sweep per interval: compact every sealed-uncompacted
    segment, then (when a tier is configured) ship all but the newest
    ``keep_local`` sealed segments. Errors are contained per segment —
    a bad segment never stops the sweep."""

    def __init__(self, store, interval: float = 30.0,
                 keep_local: int = 2) -> None:
        super().__init__(name="segment-maintenance", daemon=True)
        self._store = store
        self.interval = interval
        self.keep_local = max(0, keep_local)
        # NOT named _stop: Thread.join() calls the private Thread._stop
        # method internally, and shadowing it with an Event breaks join
        self._halt = threading.Event()
        self.sweeps = 0

    def run(self) -> None:
        while not self._halt.wait(self.interval):
            try:
                res = self.run_once()
                if res["errors"]:
                    logger.warning(
                        "segment maintenance sweep finished with %d "
                        "contained error(s): %s", res["errors"], res)
            except Exception:
                # systemic failure (bad tier config, permissions):
                # must be observable, not silently retried forever
                SEG_MAINT_ERRORS.inc()
                logger.exception("segment maintenance sweep failed")

    def run_once(self) -> dict:
        compacted = shipped = errors = 0
        tier = cold_tier()
        for ns in self._store.namespaces():
            with ns.lock:
                segs = list(ns.sealed)
            for seg in segs:
                try:
                    if (seg.meta.state == "sealed"
                            and seg.meta.cols is None
                            and seg.meta.records > 0):
                        if ns.compact(seg):
                            compacted += 1
                    elif seg.meta.state == "sealed":
                        ns.finalize(seg)
                except Exception:
                    errors += 1
                    SEG_MAINT_ERRORS.inc()
                    logger.warning("segment maintenance: compaction/"
                                   "finalize failed for %s",
                                   seg.meta.file, exc_info=True)
            if tier is not None:
                local = [s for s in segs if s.meta.state == "sealed"]
                for seg in local[:max(0, len(local) - self.keep_local)]:
                    try:
                        if ns.ship(seg, tier):
                            shipped += 1
                    except Exception:
                        errors += 1
                        SEG_MAINT_ERRORS.inc()
                        logger.warning("segment maintenance: ship "
                                       "failed for %s", seg.meta.file,
                                       exc_info=True)
        self.sweeps += 1
        return {"compacted": compacted, "shipped": shipped,
                "errors": errors}

    def stop(self) -> None:
        self._halt.set()
        self.join(timeout=5.0)
