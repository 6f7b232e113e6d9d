"""Offline integrity scanner behind ``pio fsck``.

The port's copy of the JAX package's ``data/pel_integrity.py``; model
blobs, ANN index blobs and the model registry are checked with the
port's own modules, and the report is the JAX package's.

A pure-Python re-implementation of the eventlog on-disk contract (see
``native/eventlog.cc``'s header comment — the C++ side is the writer,
this side only ever reads), plus digest checks for the other two
persisted artifact classes (snapshot npz + manifest, model blobs +
sidecars). Deliberately NOT the engine:

- it runs without a compiler (the native engine needs g++ to build;
  an operator fscking a damaged volume may not have one);
- it never repairs implicitly — ``pel_open`` quarantines torn tails as
  a side effect of opening, this walks read-only unless ``repair=True``
  is requested explicitly;
- it hosts the ``data.corrupt.eventlog`` fault site, so checksum
  detection is testable without manufacturing real bit rot.

Verdicts per artifact: ``ok`` (all checks pass), ``corrupt`` (checksum
or structural mismatch in the body), ``torn`` (incomplete tail — a
crash mid-append), ``unchecksummed`` (pre-integrity artifact with no
digest to verify), ``repaired`` (was torn, tail quarantined and
truncated under ``--repair``).

Repair policy mirrors what each artifact can afford:

- **eventlog**: copy the torn tail to ``<log>.quarantine-<offset>``
  (never destroy operator data, even garbage), then truncate to the
  last intact record boundary. Checksummed records are never touched.
- **snapshot**: delete the pair — it is a cache; the next train
  rebuilds it from the log.
- **model**: report only. A model blob is not rebuildable from
  anything here; the operator must retrain or restore.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
from typing import Dict, List, Optional

from predictionio_tpu_torch.utils import faults
from predictionio_tpu_torch.utils.atomic_write import fsync_dir
from predictionio_tpu_torch.utils.integrity import DIGEST_SUFFIX

#: v2 file header (must match kMagic in eventlog.cc)
PEL_MAGIC = b"PELOGv2\n"

_U32 = struct.Struct("<I")

# CRC-32C (Castagnoli), reflected, table-driven — bit-for-bit the
# engine's crc32c(): crc32c(b"123456789") == 0xE3069283
_CRC_TABLE: List[int] = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes, crc: int = 0) -> int:
    if len(data) >= _CRC_SPLIT_MIN:
        return _crc32c_split(data, crc)
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


_CRC_CHUNK = 1024          # bytes of each chunk the split CRC runs in parallel
# shorter inputs take the byte loop: the split pays a fixed ~9 ms for
# its 1,024 numpy steps, the byte loop ~0.25 µs a byte. On an x86 host
# ``python -m predictionio_tpu_torch.tools.crc_crossover`` gave 7.970 ms
# for the loop against 8.367 ms for the split at 32 KiB, and 9.752 ms
# against 9.493 ms at 40 KiB
_CRC_SPLIT_MIN = 40 << 10
_CRC_SHIFT: List = []      # the chunk's zero-byte operator as 4 byte tables


def _crc32c_split(data: bytes, crc: int) -> int:
    """crc32c of a long buffer, bit-for-bit the byte loop's: the register
    update is linear over GF(2), so the register after a chunk is the
    chunk's zero-byte operator applied to the register before it, xor the
    chunk's CRC from a zero register. Every chunk's CRC from zero runs at
    once in numpy, a byte a step; the chunks then fold in order through
    the operator (four 256-entry tables). A long WAL batch of the
    replicated event log takes milliseconds instead of seconds."""
    import numpy as np

    t8, _ = _crc_tables()
    if not _CRC_SHIFT:
        basis = []
        for k in range(32):
            reg = 1 << k
            for _ in range(_CRC_CHUNK):
                reg = _CRC_TABLE[reg & 0xFF] ^ (reg >> 8)
            basis.append(reg)
        tables = []
        for b in range(4):
            t = np.zeros(256, np.uint32)
            for x in range(256):
                v = 0
                for k in range(8):
                    if x >> k & 1:
                        v ^= basis[8 * b + k]
                t[x] = v
            tables.append(t.tolist())
        _CRC_SHIFT.extend(tables)
    n_chunks = len(data) // _CRC_CHUNK
    head = len(data) - n_chunks * _CRC_CHUNK
    reg = crc32c(data[:head], crc) ^ 0xFFFFFFFF
    cols = np.frombuffer(data, np.uint8, count=n_chunks * _CRC_CHUNK,
                         offset=head).reshape(n_chunks, _CRC_CHUNK)
    part = np.zeros(n_chunks, np.uint32)
    for j in range(_CRC_CHUNK):
        part = t8[(part ^ cols[:, j]) & 0xFF] ^ (part >> 8)
    s0, s1, s2, s3 = _CRC_SHIFT
    for v in part.tolist():
        reg = (s0[reg & 0xFF] ^ s1[(reg >> 8) & 0xFF] ^ s2[(reg >> 16) & 0xFF]
               ^ s3[reg >> 24] ^ v)
    return reg ^ 0xFFFFFFFF


def _walk(data: bytes, off: int, trailer: int):
    """Record start offsets up to the first frame that runs past the end
    (a torn tail: no record markers, so no resynchronisation); returns
    ``(offsets, torn offset or None, end)``."""
    size = len(data)
    offsets: List[int] = []
    append = offsets.append
    unpack = _U32.unpack_from
    torn: Optional[int] = None
    while off < size:
        if off + 5 > size:
            torn = off
            break
        (rec_len,) = unpack(data, off)
        if rec_len < 1 or off + 4 + rec_len + trailer > size:
            torn = off
            break
        append(off)
        off += 4 + rec_len + trailer
    return offsets, torn, off


def _u32_at(buf, at):
    """Little-endian u32s of ``buf`` (uint8) at the offsets ``at`` (each
    at most ``len(buf) - 4``), as int64."""
    import numpy as np
    from numpy.lib.stride_tricks import sliding_window_view

    return sliding_window_view(buf, 4)[at].view("<u4")[:, 0].astype(np.int64)


_CRC_CELLS = 1 << 24   # bytes of records one vectorised CRC pass holds
_CRC_LONG = 1 << 14    # longer records take the scalar crc32c


def _crc_tables():
    import numpy as np

    t8 = np.asarray(_CRC_TABLE, np.uint32)
    x = np.arange(1 << 16, dtype=np.uint32)
    t = t8[x & 0xFF] ^ (x >> 8)
    # two bytes a step: reg' = t16[(reg ^ w) & 0xFFFF] ^ (reg >> 16)
    return t8, t8[t & 0xFF] ^ (t >> 8)


def _crc32c_many(buf, starts, lens):
    """crc32c of ``buf[s:s + n]`` for each (s, n), every record at once:
    records sorted by length, a (length, records) matrix of 16-bit words,
    one table step per column over the records still running."""
    import numpy as np
    from numpy.lib.stride_tricks import sliding_window_view

    t8, t16 = _crc_tables()
    out = np.empty(len(starts), np.uint32)
    order = np.argsort(-lens, kind="stable")
    long_n = int(np.count_nonzero(lens > _CRC_LONG))
    raw = buf.tobytes() if long_n else b""
    for r in order[:long_n]:
        s, n = int(starts[r]), int(lens[r])
        out[r] = crc32c(raw[s:s + n])
    lo = long_n
    while lo < len(order):
        width = int(lens[order[lo]]) + 1
        width += width & 1
        hi = min(len(order), lo + max(1, _CRC_CELLS // width))
        sel = order[lo:hi]
        L = lens[sel]
        pad = np.concatenate([buf, np.zeros(width, np.uint8)])
        words = np.ascontiguousarray(
            sliding_window_view(pad, width)[starts[sel]]
            .view("<u2").T).astype(np.uint32)
        # records still running at each 16-bit step: L sorted descending
        negl = -L
        full = np.searchsorted(negl, -(2 * np.arange(width // 2) + 2), "right")
        part = np.searchsorted(negl, -(2 * np.arange(width // 2) + 1), "right")
        crc = np.full(len(sel), 0xFFFFFFFF, np.uint32)
        for k in range(width // 2):
            m2, m1 = int(full[k]), int(part[k])
            if m1 == 0:
                break
            if m2:
                c = crc[:m2]
                crc[:m2] = t16[(c ^ words[k, :m2]) & 0xFFFF] ^ (c >> 16)
            if m1 > m2:  # odd lengths: one byte left
                c = crc[m2:m1]
                crc[m2:m1] = t8[(c ^ words[k, m2:m1]) & 0xFF] ^ (c >> 8)
        out[sel] = crc ^ 0xFFFFFFFF
        lo = hi
    return out


def _payloads_ok(buf, kinds, pstarts, plens):
    """Structural walk of every record payload at once — the only
    corruption signal a v1 (checksum-less) file offers, and a cheap
    cross-check on v2. Kind 0: two i64 timestamps then 9 length-prefixed
    strings consuming the payload exactly; kind 1: one length-prefixed
    id; any other kind byte is corrupt."""
    import numpy as np

    ok = np.zeros(len(kinds), bool)
    pad = np.concatenate([buf, np.zeros(4, np.uint8)])
    ev = np.flatnonzero(kinds == 0)
    ps, pl = pstarts[ev], plens[ev]
    pos = np.full(len(ev), 16, np.int64)
    good = pl >= 16
    for _ in range(9):
        good &= pos + 4 <= pl
        pos = pos + 4 + _u32_at(pad, np.where(good, ps + pos, 0))
        good &= pos <= pl
    ok[ev] = good & (pos == pl)
    tomb = np.flatnonzero(kinds == 1)
    ps, pl = pstarts[tomb], plens[tomb]
    good = pl >= 4
    ok[tomb] = good & (4 + _u32_at(pad, np.where(good, ps, 0)) == pl)
    return ok


def scan_pel(path: str, repair: bool = False) -> Dict[str, object]:
    """Walk one ``.pel`` segment record-by-record.

    Returns a report dict: ``version``, ``records``, ``tombstones``,
    ``corrupt`` (+ ``corrupt_offsets``, capped), ``torn_offset`` (None
    when the tail is clean), ``valid_end`` (last intact record
    boundary), ``status``, and under ``repair`` the ``quarantine``
    sidecar path written before truncation.

    The JAX package's report, computed otherwise: the frame walk is one
    Python loop, and the checksums and structural checks run over every
    record at once in numpy (:func:`_crc32c_many`,
    :func:`_payloads_ok`), so that a log of tens of millions of events
    is checked in seconds, not hours.
    """
    import numpy as np

    report: Dict[str, object] = {
        "path": path, "version": 0, "records": 0, "tombstones": 0,
        "corrupt": 0, "corrupt_offsets": [], "torn_offset": None,
        "valid_end": 0, "quarantine": None, "status": "ok",
    }
    with open(path, "rb") as f:
        data = f.read()
    # byte-flip-on-read fault site (detection drill, not repair drill:
    # the flip lives in this read, not on disk)
    data = faults.corrupt_bytes("data.corrupt.eventlog", data)

    if data.startswith(PEL_MAGIC):
        version, off, trailer = 2, len(PEL_MAGIC), 4
    else:
        version, off, trailer = 1, 0, 0
    report["version"] = version
    offsets, torn, end = _walk(data, off, trailer)
    if offsets:
        buf = np.frombuffer(data, np.uint8)
        offs = np.asarray(offsets, np.int64)
        rec_len = _u32_at(buf, offs)
        kinds = buf[offs + 4]
        bad = ~_payloads_ok(buf, kinds, offs + 5, rec_len - 1)
        if version == 2:
            bad |= _crc32c_many(buf, offs, rec_len + 4) != _u32_at(
                buf, offs + 4 + rec_len)
        n_bad = int(np.count_nonzero(bad))
        report["corrupt"] = n_bad
        report["corrupt_offsets"] = offs[bad][:32].tolist()
        report["records"] = len(offsets) - n_bad
        report["tombstones"] = int(np.count_nonzero((kinds == 1) & ~bad))
    report["valid_end"] = torn if torn is not None else end

    if torn is not None:
        report["torn_offset"] = torn
        report["status"] = "torn"
        if repair:
            side = f"{path}.quarantine-{torn}"
            with open(side, "wb") as qf:
                qf.write(data[torn:])
                qf.flush()
                os.fsync(qf.fileno())
            with open(path, "r+b") as lf:
                lf.truncate(torn)
                lf.flush()
                os.fsync(lf.fileno())
            fsync_dir(os.path.dirname(os.path.abspath(path)))
            report["quarantine"] = side
            report["status"] = "repaired"
    elif report["corrupt"]:
        report["status"] = "corrupt"
    return report


#: sealed segments of more bytes than this together are scanned in
#: worker processes (one a core), unless a fault is armed
PARALLEL_SCAN_BYTES = 256 << 20


def _scan_sealed(path: str):
    """:func:`scan_pel` of a sealed segment and the sha256 of its bytes."""
    report = scan_pel(path)
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 22), b""):
            digest.update(chunk)
    return report, digest.hexdigest()


def _scan_all_sealed(paths: List[str]) -> Optional[Dict[str, tuple]]:
    """``{path: (scan report, sha256)}`` from worker processes when the
    segments are large enough to pay for them, else None (the caller
    scans in this process). An armed fault keeps the scan here, where
    its hits are counted in the reference's order."""
    if len(paths) < 2 or faults.FAULTS.armed or sum(
            os.path.getsize(p) for p in paths) < PARALLEL_SCAN_BYTES:
        return None
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    workers = min(len(paths), os.cpu_count() or 1)
    with ProcessPoolExecutor(workers, multiprocessing.get_context("spawn")) as pool:
        return dict(zip(paths, pool.map(_scan_sealed, paths)))


def check_segment_dir(dir_path: str,
                      repair: bool = False) -> List[Dict[str, object]]:
    """Audit one ``.peld`` segment directory against its manifest.

    Sealed segments are immutable, so the rules differ from the active
    log: a torn tail here is CORRUPTION (never quarantined — only the
    active segment may legitimately tear in a crash); the manifest's
    sha256 must match the file when present (``None`` = not yet
    finalized → ``unchecksummed``); compaction sidecars must match
    their recorded digest. Cold segments whose frame file has shipped
    are reported as ``cold`` and content-checked on fetch instead.
    Under ``repair`` a bad compaction sidecar or live-id filter is
    deleted (both are caches; the raw frames remain authoritative) —
    frame-file corruption is report-only.
    """
    reports: List[Dict[str, object]] = []
    man_path = os.path.join(dir_path, "segments.json")
    try:
        with open(man_path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        return [{"path": man_path, "artifact": "segment",
                 "status": "corrupt", "detail": f"unreadable manifest: {e}"}]
    if doc.get("schema") != 1:
        return [{"path": man_path, "artifact": "segment",
                 "status": "corrupt",
                 "detail": f"unknown manifest schema {doc.get('schema')!r}"}]
    scanned = _scan_all_sealed([
        p for p in (os.path.join(dir_path, str(d.get("file")))
                    for d in doc.get("segments", [])) if os.path.exists(p)])
    for d in doc.get("segments", []):
        path = os.path.join(dir_path, str(d.get("file")))
        r: Dict[str, object] = {
            "path": path, "artifact": "segment",
            "segment_id": d.get("id"), "state": d.get("state"),
            "records": d.get("records"), "status": "ok",
        }
        reports.append(r)
        if not os.path.exists(path):
            if d.get("state") == "cold":
                # frame file shipped to the cold tier; its digest is
                # enforced on fetch (ensure_local refuses mismatches)
                r["status"] = "cold"
            else:
                r["status"] = "corrupt"
                r["detail"] = "segment file missing"
        else:
            s, digest = (scanned[path] if scanned is not None
                         else (scan_pel(path, repair=False), None))
            r["version"] = s["version"]
            r["records"] = s["records"]
            r["corrupt_records"] = s["corrupt"]
            if s["torn_offset"] is not None:
                r["status"] = "corrupt"
                r["detail"] = (f"torn tail at {s['torn_offset']} in a "
                               "sealed (immutable) segment")
            elif s["corrupt"]:
                r["status"] = "corrupt"
            elif d.get("sha256"):
                if digest is None:
                    with open(path, "rb") as f:
                        data = f.read()
                    data = faults.corrupt_bytes("data.corrupt.segment", data)
                    digest = hashlib.sha256(data).hexdigest()
                if digest != d["sha256"]:
                    r["status"] = "corrupt"
                    r["detail"] = "content digest mismatch vs manifest"
            else:
                r["status"] = "unchecksummed"  # sealed, not yet finalized
        cols = d.get("cols")
        if cols and r["status"] in ("ok", "unchecksummed", "cold"):
            cp = os.path.join(dir_path, str(cols.get("file")))
            if not os.path.exists(cp):
                # the sidecar is a cache — scans fall back to frames
                r["cols_status"] = "missing"
            else:
                with open(cp, "rb") as f:
                    cdata = f.read()
                cdata = faults.corrupt_bytes("data.corrupt.segment", cdata)
                if hashlib.sha256(cdata).hexdigest() != cols.get("sha256"):
                    if repair:
                        try:
                            os.unlink(cp)
                        except OSError:
                            pass
                        fsync_dir(dir_path)
                        r["cols_status"] = "repaired"
                        r["status"] = "repaired"
                    else:
                        r["cols_status"] = "corrupt"
                        r["status"] = "corrupt"
                        r["detail"] = "compaction sidecar digest mismatch"
                else:
                    r["cols_status"] = "ok"
        idf = d.get("idf")
        if idf and r["status"] in ("ok", "unchecksummed", "cold"):
            # the live-id filter is a cache like the compaction
            # sidecar: the tombstone path falls back to fetching the
            # frames when it is missing, so repair may delete it
            ip = os.path.join(dir_path, str(idf.get("file")))
            if not os.path.exists(ip):
                r["idf_status"] = "missing"
            else:
                with open(ip, "rb") as f:
                    fdata = f.read()
                if hashlib.sha256(fdata).hexdigest() != idf.get("sha256"):
                    if repair:
                        try:
                            os.unlink(ip)
                        except OSError:
                            pass
                        fsync_dir(dir_path)
                        r["idf_status"] = "repaired"
                        r["status"] = "repaired"
                    else:
                        r["idf_status"] = "corrupt"
                        r["status"] = "corrupt"
                        r["detail"] = "id-filter digest mismatch"
                else:
                    r["idf_status"] = "ok"
    return reports


def check_snapshot(npz_path: str, repair: bool = False) -> Dict[str, object]:
    """Verify one snapshot pair against its manifest digests. Uses
    ``data/snapshot.load_snapshot``'s own validation (same digest walk
    the training read runs), so fsck can never pass what a train would
    reject. Under ``repair`` a bad pair is deleted — it is a cache."""
    from predictionio_tpu_torch.data import snapshot as snap

    report: Dict[str, object] = {"path": npz_path, "status": "ok"}
    directory = os.path.dirname(npz_path)
    base = os.path.basename(npz_path)
    # snap_<fingerprint>.npz
    fingerprint = base[len("snap_"):-len(".npz")]
    man_path = os.path.join(directory, f"snap_{fingerprint}.json")
    if not os.path.exists(man_path):
        report["status"] = "corrupt"
        report["detail"] = "manifest missing"
    else:
        try:
            with open(man_path, "r", encoding="utf-8") as f:
                digests = json.load(f).get("digests")
        except (OSError, ValueError):
            digests = None
        if not isinstance(digests, dict):
            report["status"] = "unchecksummed"
        elif snap.load_snapshot(directory, fingerprint) is None:
            report["status"] = "corrupt"
    if repair and report["status"] in ("corrupt", "unchecksummed"):
        for p in (npz_path, man_path):
            try:
                os.unlink(p)
            except OSError:
                pass
        fsync_dir(directory)
        report["status"] = "repaired"
    return report


def check_model(blob_path: str) -> Dict[str, object]:
    """Verify one model blob against its digest sidecar (report-only:
    a model is not rebuildable here)."""
    report: Dict[str, object] = {"path": blob_path, "status": "ok"}
    try:
        with open(blob_path, "rb") as f:
            blob = f.read()
    except OSError as e:
        report["status"] = "corrupt"
        report["detail"] = str(e)
        return report
    blob = faults.corrupt_bytes("data.corrupt.model", blob)
    try:
        with open(blob_path + DIGEST_SUFFIX, "r", encoding="ascii") as f:
            expected = f.read().strip()
    except OSError:
        report["status"] = "unchecksummed"
        return report
    if hashlib.sha256(blob).hexdigest() != expected:
        report["status"] = "corrupt"
    return report


def check_ann_index(blob_path: str) -> Dict[str, object]:
    """Verify one ANN retrieval index blob (``ann_index.bin``,
    ``ann/index.py``) against its sha256 sidecar AND its internal
    header payload digest (the blob is self-verifying, so an index
    embedded without a sidecar still gets a real verdict). Report-only:
    an index is rebuilt by re-running ``pio train``, not by fsck."""
    report: Dict[str, object] = {"path": blob_path, "status": "ok"}
    try:
        with open(blob_path, "rb") as f:
            blob = f.read()
    except OSError as e:
        report["status"] = "corrupt"
        report["detail"] = str(e)
        return report
    sidecar = None
    try:
        with open(blob_path + DIGEST_SUFFIX, "r", encoding="ascii") as f:
            sidecar = f.read().strip()
    except OSError:
        pass
    if sidecar is not None and hashlib.sha256(blob).hexdigest() != sidecar:
        report["status"] = "corrupt"
        report["detail"] = "blob digest mismatch vs sidecar"
        return report
    from predictionio_tpu_torch.ann.index import PQIndex

    try:
        PQIndex.from_bytes(blob)
    except Exception as e:
        report["status"] = "corrupt"
        report["detail"] = f"index blob failed verification: {e}"
        return report
    if sidecar is None:
        report["status"] = "unchecksummed"
    return report


def check_model_registry(root: str,
                         repair: bool = False) -> List[Dict[str, object]]:
    """Audit the generation-aware model registry (``model_registry/``).

    Checks, per manifest generation: the blob dir + ``model.bin``
    exist, the sha256 sidecar exists and agrees with the manifest, and
    the blob content matches the recorded digest. Also surfaces
    **orphaned** ``gen-*`` dirs — dirs with no manifest entry, the
    signature of a trainer crash between blob write and manifest commit
    (the write order is deliberate: an orphan is harmless; a manifest
    entry pointing at nothing would not be).

    Repair policy: orphaned dirs are deleted (the crashed cycle never
    published, the next delta train re-registers); a missing or
    mismatched *sidecar* over an intact blob is rewritten from the
    manifest digest (the manifest is authoritative); blob corruption is
    report-only — like ``check_model``, a generation blob is not
    rebuildable here.
    """
    import shutil as _shutil

    from predictionio_tpu_torch.storage.models import ModelRegistry

    reports: List[Dict[str, object]] = []
    man_path = os.path.join(root, ModelRegistry.MANIFEST)
    try:
        with open(man_path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except FileNotFoundError:
        return reports  # no registry at this home: nothing to audit
    except (OSError, ValueError) as e:
        return [{"path": man_path, "artifact": "model_registry",
                 "status": "corrupt", "detail": f"unreadable manifest: {e}"}]
    if doc.get("schema") != 1:
        return [{"path": man_path, "artifact": "model_registry",
                 "status": "corrupt",
                 "detail": f"unknown manifest schema {doc.get('schema')!r}"}]
    champ = doc.get("champion")
    if champ is not None and not any(
            e.get("gen") == champ for e in doc.get("generations", [])):
        reports.append({
            "path": man_path, "artifact": "model_registry",
            "status": "corrupt",
            "detail": f"champion generation {champ} has no manifest entry"})
    known = set()
    for entry in doc.get("generations", []):
        gen = entry.get("gen")
        known.add(gen)
        d = os.path.join(root, f"gen-{int(gen):06d}")
        blob_path = os.path.join(d, "model.bin")
        r: Dict[str, object] = {
            "path": blob_path, "artifact": "model_registry",
            "generation": gen, "gen_status": entry.get("status"),
            "status": "ok",
        }
        reports.append(r)
        try:
            with open(blob_path, "rb") as f:
                blob = f.read()
        except OSError as e:
            r["status"] = "corrupt"
            r["detail"] = f"generation blob missing: {e}"
            continue
        blob = faults.corrupt_bytes("data.corrupt.model", blob)
        expected = entry.get("sha256")
        if not expected:
            r["status"] = "unchecksummed"
            continue
        if hashlib.sha256(blob).hexdigest() != expected:
            r["status"] = "corrupt"
            r["detail"] = "blob digest mismatch vs manifest"
            continue
        side = blob_path + DIGEST_SUFFIX
        side_ok = False
        try:
            with open(side, "r", encoding="ascii") as f:
                side_ok = f.read().strip() == expected
        except OSError:
            pass
        if not side_ok:
            if repair:
                with open(side, "w", encoding="ascii") as f:
                    f.write(expected)
                    f.flush()
                    os.fsync(f.fileno())
                fsync_dir(d)
                r["status"] = "repaired"
                r["detail"] = "sidecar rewritten from manifest digest"
            else:
                r["status"] = "corrupt"
                r["detail"] = "sha256 sidecar missing or mismatched"
    gen_dir_re = ModelRegistry._GEN_DIR
    for name in sorted(os.listdir(root)):
        m = gen_dir_re.match(name)
        if not m or int(m.group(1)) in known:
            continue
        p = os.path.join(root, name)
        r = {"path": p, "artifact": "model_registry",
             "status": "corrupt", "detail": "orphaned generation dir "
             "(no manifest entry; crash between blob write and commit)"}
        if repair:
            _shutil.rmtree(p, ignore_errors=True)
            fsync_dir(root)
            r["status"] = "repaired"
            r["detail"] = "orphaned generation dir deleted"
        reports.append(r)
    return reports


def check_replica_state(home: str) -> Optional[Dict[str, object]]:
    """Follower cursor doc (``<home>/replica_state.json``, written by
    data/replication.py): must be well-formed JSON, and no cursor may
    claim more replicated bytes than the active file actually holds —
    an offset past EOF means the follower acked bytes it does not
    have, which is a replication bug, not a crash artifact. Absent
    file = not a follower = no-op (returns ``None``)."""
    path = os.path.join(home, "replica_state.json")
    if not os.path.exists(path):
        return None
    report: Dict[str, object] = {
        "path": path, "artifact": "replica", "status": "ok",
        "errors": [],
    }
    errors: List[str] = report["errors"]  # type: ignore[assignment]
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        cursors = doc.get("cursors")
        if cursors is None:
            cursors = {}
        if not isinstance(cursors, dict):
            raise ValueError(f"cursors is {type(cursors).__name__}")
    except (OSError, ValueError, AttributeError) as e:
        report["status"] = "corrupt"
        errors.append(f"unreadable replica state: {e}")
        return report
    for tag in sorted(cursors):
        cur = cursors[tag]
        try:
            offset = int(cur.get("offset", 0))
        except (AttributeError, TypeError, ValueError):
            report["status"] = "corrupt"
            errors.append(f"{tag}: malformed cursor {cur!r}")
            continue
        active = os.path.join(home, "eventlog", f"{tag}.pel")
        size = os.path.getsize(active) if os.path.exists(active) else 0
        if offset > size:
            report["status"] = "corrupt"
            errors.append(f"{tag}: cursor at byte {offset} but the "
                          f"active file holds {size}")
    return report


def fsck_home(home: str, repair: bool = False) -> Dict[str, object]:
    """Scan every persisted artifact under one storage home.

    Covers ``<home>/eventlog/*.pel`` (record walk), the snapshot cache
    (``PIO_SCAN_CACHE_DIR`` or ``<home>/scan_cache``),
    ``<home>/models/*/model.bin``, and the continuous-training model
    registry (``<home>/model_registry``: manifest ↔ dirs ↔ sidecars,
    orphaned candidate dirs). Also lists quarantine sidecars left
    by previous recoveries so the runbook's "inspect, then delete"
    step has an inventory to work from.
    """
    artifacts: List[Dict[str, object]] = []
    quarantines: List[str] = []

    rep_state = check_replica_state(home)
    if rep_state is not None:
        artifacts.append(rep_state)

    log_dir = os.path.join(home, "eventlog")
    if os.path.isdir(log_dir):
        for name in sorted(os.listdir(log_dir)):
            p = os.path.join(log_dir, name)
            if name.endswith(".pel"):
                # the ACTIVE segment: the one place a torn tail is a
                # legitimate crash artifact, so repair may quarantine
                r = scan_pel(p, repair=repair)
                r["artifact"] = "eventlog"
                artifacts.append(r)
            elif name.endswith(".peld") and os.path.isdir(p):
                artifacts.extend(check_segment_dir(p, repair=repair))
            elif ".quarantine-" in name:
                quarantines.append(p)

    snap_dir = os.environ.get("PIO_SCAN_CACHE_DIR") or os.path.join(
        home, "scan_cache")
    if os.path.isdir(snap_dir):
        for name in sorted(os.listdir(snap_dir)):
            if name.startswith("snap_") and name.endswith(".npz"):
                r = check_snapshot(os.path.join(snap_dir, name),
                                   repair=repair)
                r["artifact"] = "snapshot"
                artifacts.append(r)

    model_dir = os.path.join(home, "models")
    if os.path.isdir(model_dir):
        for inst in sorted(os.listdir(model_dir)):
            inst_dir = os.path.join(model_dir, inst)
            p = os.path.join(inst_dir, "model.bin")
            if os.path.exists(p):
                r = check_model(p)
                r["artifact"] = "model"
                r["instance"] = inst
                artifacts.append(r)
            # per-algorithm ANN index blobs beside the model blob
            # (<inst>/<algo>/ann_index.bin, ann/index.py)
            if os.path.isdir(inst_dir):
                for algo in sorted(os.listdir(inst_dir)):
                    ip = os.path.join(inst_dir, algo, "ann_index.bin")
                    if os.path.exists(ip):
                        r = check_ann_index(ip)
                        r["artifact"] = "ann_index"
                        r["instance"] = inst
                        artifacts.append(r)

    reg_dir = os.path.join(home, "model_registry")
    if os.path.isdir(reg_dir):
        artifacts.extend(check_model_registry(reg_dir, repair=repair))

    statuses = [a["status"] for a in artifacts]
    report = {
        "home": home,
        "artifacts": artifacts,
        "quarantines": quarantines,
        "checked": len(artifacts),
        "clean": statuses.count("ok"),
        "corrupt": sum(1 for s in statuses if s in ("corrupt", "torn")),
        "repaired": statuses.count("repaired"),
        "unchecksummed": statuses.count("unchecksummed"),
        "cold": statuses.count("cold"),
    }
    return report
