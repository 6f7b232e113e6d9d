"""Columnar snapshot cache: persisted ``ColumnarEvents`` + watermark.

The port's copy of the JAX package's ``data/snapshot.py``: the same npz
and manifest format and the same cache key, so a snapshot written by
one package is a hit for the other.

The reference's training contract re-reads the FULL event history on
every ``pio train`` (PEventStore → RDD per invocation).
For the steady-state retrain loop over a mostly-append-only log that
makes train startup O(total events) forever. This module is the disk
layer of the incremental scan cache that turns it into O(events since
last train):

- a **snapshot** is one ``ColumnarEvents`` (the arrays
  ``data/pipeline.columnar_from_rows`` builds) persisted as an ``.npz``
  next to a small JSON **manifest**;
- the manifest carries a **watermark** — the maximum ``creationTime``
  (epoch µs) the snapshot covers, taken from the store BEFORE the
  building scan started — plus the live-event count at that watermark
  and the hash of the filter key;
- on the next train, ``data/store.py`` loads the snapshot, asks the
  backend to scan only ``creationTime > watermark`` (predicate pushed
  down into C++/SQL/doc-values), and concatenates the delta
  (:func:`data.pipeline.concat_columnar`).

Invalidation rules (any failure falls back to a full rescan — the
cache can cost a rebuild, never correctness):

- manifest missing/unreadable, schema version bump, filter-key hash
  mismatch, npz corrupt/truncated, or array lengths disagreeing with
  the manifest;
- a per-column SHA-256 digest in the manifest disagreeing with the
  loaded array bytes (bit rot in the npz): counted on
  ``pio_integrity_failed_total{artifact="snapshot"}`` and treated as
  a cold cache — a corrupt snapshot costs a rebuild, never a wrong
  training set and never a crash;
- the live-event count at the old watermark no longer matches the
  manifest (events were deleted, or arrived bearing creationTimes at
  or below the watermark);
- the delta contains an event whose eventTime is ≤ the snapshot's
  maximum (out-of-order append: concatenation would not reproduce the
  (eventTime, creationTime, id) scan order);
- ``startTime``/``untilTime`` filters bypass the cache entirely (a
  time-windowed read is not the repeat-train shape).

Cache keys hash the full filter tuple PLUS a backend-provided
``cache_identity`` string (e.g. the sqlite path), so two stores that
happen to share an app id can never serve each other's snapshots.
Files live under ``<storage home>/scan_cache/`` (override with
``PIO_SCAN_CACHE_DIR``).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from predictionio_tpu_torch.utils import faults
from predictionio_tpu_torch.utils.atomic_write import atomic_file, atomic_write_text
from predictionio_tpu_torch.utils.integrity import (
    INTEGRITY_FAILED,
    INTEGRITY_VERIFIED,
)

# v2: per-column sha256 digests in the manifest. The bump itself
# invalidates pre-integrity snapshots (a cache miss, rebuilt on the
# next train).
SCHEMA_VERSION = 2

# watermark of an empty namespace: below every real creationTime, and
# matching the native scan's unbounded sentinel so `creation > W`
# selects everything and `creation <= W` selects nothing
EMPTY_WATERMARK = -(2**62)

_ARRAY_FIELDS = ("entity_idx", "target_idx", "name_idx", "values",
                 "times_us")
_TABLE_FIELDS = ("entity_ids", "target_ids", "names")
_DTYPES = {"entity_idx": "uint32", "target_idx": "uint32",
           "name_idx": "uint16", "values": "float64",
           "times_us": "int64"}


@dataclass
class SnapshotManifest:
    """The validity contract of one persisted snapshot."""

    schema: int
    filter_hash: str
    watermark_us: int
    pre_count: int  # live events with creationTime <= watermark_us
    n_rows: int     # rows in the npz arrays (post-filter)
    created_at: float
    digests: Dict[str, str] = field(default_factory=dict)  # field -> sha256


def cache_dir(storage) -> str:
    """Snapshot directory for a Storage (env-overridable)."""
    override = os.environ.get("PIO_SCAN_CACHE_DIR")
    if override:
        return override
    return os.path.join(storage.config.home, "scan_cache")


def filter_fingerprint(
    identity: str,
    app_id: int,
    channel_id: Optional[int],
    entity_type: Optional[str],
    target_entity_type: Optional[str],
    event_names: Optional[Sequence[str]],
    value_key: Optional[str],
) -> str:
    """Hash of (store identity, namespace, scan filters) — the cache
    key. Hashed rather than embedded so arbitrary ids/filters can't
    produce unbounded or path-hostile filenames."""
    payload = json.dumps(
        {"identity": identity, "app": app_id, "channel": channel_id,
         "entity_type": entity_type,
         "target_entity_type": target_entity_type,
         "event_names": (list(event_names)
                         if event_names is not None else None),
         "value_key": value_key},
        sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(payload.encode("utf-8")).hexdigest()


def _paths(directory: str, fingerprint: str) -> Tuple[str, str]:
    base = os.path.join(directory, f"snap_{fingerprint}")
    return base + ".npz", base + ".json"


def _table_array(strings) -> np.ndarray:
    # numpy U-dtype: fixed-width unicode, loadable without pickle
    if len(strings):
        return np.asarray(list(strings), dtype=np.str_)
    return np.empty(0, dtype="U1")


def _digest(a: np.ndarray) -> str:
    """Per-column integrity digest over the exact array bytes."""
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def save_snapshot(
    directory: str,
    fingerprint: str,
    cols,
    watermark_us: int,
    pre_count: int,
) -> bool:
    """Persist ``cols`` + manifest atomically AND durably (fsync'd tmp
    file + rename + dir fsync via utils.atomic_write; the manifest
    lands LAST, so a manifest's presence implies a complete npz).
    Returns False instead of raising — a full disk or read-only cache
    dir must never fail the training read it rides on."""
    npz_path, man_path = _paths(directory, fingerprint)
    try:
        os.makedirs(directory, exist_ok=True)
        arrays = {
            "entity_idx": np.ascontiguousarray(cols.entity_idx),
            "target_idx": np.ascontiguousarray(cols.target_idx),
            "name_idx": np.ascontiguousarray(cols.name_idx),
            "values": np.ascontiguousarray(cols.values),
            "times_us": np.ascontiguousarray(cols.times_us),
            "entity_ids": _table_array(cols.entity_ids),
            "target_ids": _table_array(cols.target_ids),
            "names": _table_array(cols.names),
        }
        digests = {k: _digest(a) for k, a in arrays.items()}
        with atomic_file(npz_path, "wb") as f:
            np.savez(f, **arrays)
        return _write_manifest(man_path, fingerprint, watermark_us,
                               pre_count, cols.n, digests)
    except Exception:
        return False


def update_manifest(
    directory: str,
    fingerprint: str,
    watermark_us: int,
    pre_count: int,
    n_rows: int,
) -> bool:
    """Advance the watermark of an existing snapshot whose arrays are
    unchanged (an empty delta still moves the watermark forward, so
    later delta scans stay O(new events) instead of re-walking the
    whole post-watermark window). The column digests carry over from
    the existing manifest — the npz did not change."""
    _npz, man_path = _paths(directory, fingerprint)
    try:
        with open(man_path, "r", encoding="utf-8") as f:
            digests = json.load(f).get("digests")
        if not isinstance(digests, dict):
            return False  # pre-integrity manifest: let it invalidate
        return _write_manifest(man_path, fingerprint, watermark_us,
                               pre_count, n_rows, digests)
    except Exception:
        return False


def _write_manifest(man_path: str, fingerprint: str, watermark_us: int,
                    pre_count: int, n_rows: int,
                    digests: Dict[str, str]) -> bool:
    doc = {"schema": SCHEMA_VERSION, "filter": fingerprint,
           "watermark_us": int(watermark_us), "pre_count": int(pre_count),
           "n_rows": int(n_rows), "created_at": time.time(),
           "digests": digests}
    atomic_write_text(man_path, json.dumps(doc, separators=(",", ":")))
    return True


def load_snapshot(directory: str, fingerprint: str):
    """Load and validate one snapshot.

    Returns ``(ColumnarEvents, SnapshotManifest)``, or None on ANY
    defect — missing files, unreadable JSON, schema/filter mismatch,
    corrupt or truncated npz, wrong dtypes, or lengths that disagree
    with the manifest. Callers treat None as a cold cache."""
    from predictionio_tpu_torch.data.pipeline import ColumnarEvents

    npz_path, man_path = _paths(directory, fingerprint)
    try:
        with open(man_path, "r", encoding="utf-8") as f:
            doc = json.load(f)
        if (doc.get("schema") != SCHEMA_VERSION
                or doc.get("filter") != fingerprint):
            return None
        digests = doc.get("digests")
        if not isinstance(digests, dict):
            return None
        man = SnapshotManifest(
            schema=int(doc["schema"]), filter_hash=doc["filter"],
            watermark_us=int(doc["watermark_us"]),
            pre_count=int(doc["pre_count"]), n_rows=int(doc["n_rows"]),
            created_at=float(doc.get("created_at", 0.0)),
            digests={str(k): str(v) for k, v in digests.items()})
        with open(npz_path, "rb") as f:
            raw = f.read()
        # byte-flip-on-read fault site, feeding the checks below
        raw = faults.corrupt_bytes("data.corrupt.snapshot", raw)
        try:
            with np.load(io.BytesIO(raw), allow_pickle=False) as z:
                arrays = {}
                for k in _ARRAY_FIELDS:
                    a = z[k]
                    if (a.ndim != 1 or a.shape[0] != man.n_rows
                            or a.dtype != np.dtype(_DTYPES[k])):
                        return None
                    arrays[k] = a
                tables = {}
                raw_tables = {}
                for k in _TABLE_FIELDS:
                    t = z[k]
                    if t.ndim != 1 or t.dtype.kind != "U":
                        return None
                    raw_tables[k] = t
                    tables[k] = t.tolist()
        except Exception:
            # valid manifest but unreadable npz = damage, not a cold
            # cache (the zip container's own CRC often trips before
            # the per-column digests get their chance)
            INTEGRITY_FAILED.inc(("snapshot",))
            return None
        # per-column digest verification: a flipped bit anywhere in the
        # arrays is a counted cache miss (rebuild), never a wrong
        # training set
        for k in (*_ARRAY_FIELDS, *_TABLE_FIELDS):
            stored = man.digests.get(k)
            a = arrays[k] if k in arrays else raw_tables[k]
            if stored is None or _digest(a) != stored:
                INTEGRITY_FAILED.inc(("snapshot",))
                return None
        INTEGRITY_VERIFIED.inc(("snapshot",))
        # index columns must point inside their tables, or downstream
        # vectorized gathers would read garbage
        for idx_k, tab_k in (("entity_idx", "entity_ids"),
                             ("target_idx", "target_ids"),
                             ("name_idx", "names")):
            a = arrays[idx_k]
            if a.size and int(a.max()) >= len(tables[tab_k]):
                return None
        cols = ColumnarEvents(
            entity_idx=arrays["entity_idx"],
            target_idx=arrays["target_idx"],
            name_idx=arrays["name_idx"], values=arrays["values"],
            times_us=arrays["times_us"],
            entity_ids=tables["entity_ids"],
            target_ids=tables["target_ids"], names=tables["names"])
        return cols, man
    except Exception:
        return None
