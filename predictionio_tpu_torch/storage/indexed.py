"""Embedded indexed document store: the ELASTICSEARCH backend.

The port's copy of the JAX package's ``storage/indexed.py``. The
reference ships an Elasticsearch storage module for every repository
(events, apps, access keys, channels, engine and evaluation instances,
models) with ``ESSequences`` for ids, and the Universal Recommender's
serving is an ES bool/terms query over indicator fields (reference: [U]
storage/elasticsearch/{StorageClient,ESEvents,ESApps,ESAccessKeys,
ESChannels,ESEngineInstances,ESEvaluationInstances,ESSequences}.scala,
SURVEY.md §2a). This is an embedded index engine with the same surface,
no server:

- :class:`EmbeddedIndex`: documents with an inverted term index per
  field, bool search (``must`` terms, ``must_any`` terms queries,
  ``should`` scored terms with boosts, numeric ranges on sorted doc
  values), sort and size; a constant score per matched term, the shape
  of the UR's indicator query.
- Durability: per index an append-only JSONL write-ahead log (the
  translog), replayed at open with a torn tail cut off, and a pickled
  ``{"version", "docs", "postings"}`` snapshot written at compaction
  and on a clean close (the segments). The snapshot holds builtins
  only, and the WAL lines are the JAX package's, so an index root that
  either package writes, the other opens.
- :class:`IndexedStorageClient` (named indices in one directory) and
  :class:`Sequences` (ids).
- The repositories on top: :class:`ESEventStore` (with the columnar
  training read and the snapshot cache's probes, ``cache_identity``
  ``es:<abspath>``), :class:`ESMetaStore` and :class:`ESModelStore`
  (base64 blobs), registered as ``ELASTICSEARCH``
  (``PIO_STORAGE_SOURCES_<S>_TYPE=ELASTICSEARCH``, ``_PATH`` the root).

:func:`index_indicators` writes a trained CCO model's indicator lists
into an index and :func:`search_similar` runs the reference-shaped
similar-items query over it; the port serves the UR from resident
indicators (:class:`predictionio_tpu_torch.models.cco.CCOResidentScorer`).
"""

from __future__ import annotations

import base64
import datetime as _dt
import json
import os
import threading
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from predictionio_tpu_torch.data.event import (
    Event,
    format_event_time,
    parse_event_time,
    utcnow,
    validate_event,
)
from predictionio_tpu_torch.data.events import EventStore, _ts as _ts_us
from predictionio_tpu_torch.storage.meta import (
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EvaluationInstance,
    bump_meta_epoch as _bump_meta_epoch,
)
from predictionio_tpu_torch.storage.models import ModelStore


class EmbeddedIndex:
    """One named index: documents with an inverted term index per field.

    Field values: strings/numbers/bools index as single terms; lists
    index one term per element (how ES indicator fields work). Numeric
    fields additionally support range queries.
    """

    _SNAP_VERSION = 1

    def __init__(self, path: Optional[str] = None,
                 no_index: frozenset = frozenset()) -> None:
        # ``no_index``: fields stored in documents but NOT posted to the
        # inverted index (the ES ``index: false`` mapping) — payload
        # fields the owning store never term-queries (e.g. the event
        # store's serialized properties). Cuts ingest work and postings
        # memory; term queries on these fields match nothing, numeric
        # doc-values (ranges, sort) still work.
        self._no_index = no_index
        self._path = path
        self._lock = threading.RLock()
        self._docs: Dict[str, Dict[str, Any]] = {}
        self._postings: Dict[Tuple[str, Any], set] = {}
        self._wal_ops = 0
        self._wal = None
        self._gen = 0  # mutation counter (invalidates doc-values caches)
        self._dv: Dict[str, Any] = {}  # field → (gen, sorted vals, ids)
        if path is not None:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._load_snapshot()
            self._replay()
            self._wal = open(path, "a", encoding="utf-8")

    # -- durability ------------------------------------------------------------
    #
    # Two files — the ES translog + segments split (SURVEY.md §2a
    # storage/elasticsearch):
    #   <path>       append-only JSONL WAL (the translog)
    #   <path>.snap  pickled (docs, postings) snapshot (the segments)
    # A snapshot is written on compaction and on clean close; the WAL is
    # then truncated, so restart = one pickle load + replay of the WAL
    # TAIL ONLY. Ops are
    # idempotent upserts/deletes, so a crash between snapshot replace
    # and WAL truncate just replays ops the snapshot already contains.
    # The snapshot lives in the store's own data directory — same trust
    # domain as the WAL it replaces.

    def _load_snapshot(self) -> None:
        snap = self._path + ".snap"
        if not os.path.exists(snap):
            return
        import pickle

        try:
            with open(snap, "rb") as f:
                payload = pickle.load(f)
            if payload.get("version") != self._SNAP_VERSION:
                raise ValueError(f"snapshot version {payload.get('version')}")
            self._docs = payload["docs"]
            self._postings = payload["postings"]
        except Exception as exc:  # noqa: BLE001 — any corruption
            # fall back to whatever the WAL holds; after a compaction
            # the WAL is only a tail, so surface the loss loudly
            # instead of silently serving a partial index
            import warnings

            self._docs, self._postings = {}, {}
            warnings.warn(
                f"index snapshot {snap!r} is unreadable ({exc}); "
                f"recovering from the WAL alone — documents indexed "
                f"before the last compaction may be missing",
                RuntimeWarning)

    def _write_snapshot(self) -> None:
        """Durably persist (docs, postings); then the WAL can truncate."""
        assert self._path is not None
        import pickle

        tmp = self._path + ".snap.tmp"
        with open(tmp, "wb") as f:
            pickle.dump({"version": self._SNAP_VERSION, "docs": self._docs,
                         "postings": self._postings}, f,
                        protocol=pickle.HIGHEST_PROTOCOL)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._path + ".snap")

    def _replay(self) -> None:
        """Runs during construction, before the store is shared —
        the caller holds exclusive access."""
        if self._path is None or not os.path.exists(self._path):
            return
        good_end = 0  # byte offset after the last intact record
        self._wal_ops = 0
        with open(self._path, "rb") as f:
            for line in f:
                try:
                    op = json.loads(line.decode("utf-8"))
                except (json.JSONDecodeError, UnicodeDecodeError):
                    break  # torn tail from a crash mid-append: stop here
                if op["op"] == "index":
                    self._apply_index(op["id"], op["doc"])
                elif op["op"] == "delete":
                    self._apply_delete(op["id"])
                good_end += len(line)
                self._wal_ops += 1
        if good_end < os.path.getsize(self._path):
            # drop the torn tail NOW — appending after it would weld the
            # next record onto the partial line, and the following
            # replay would discard that record and everything after it
            with open(self._path, "r+b") as f:
                f.truncate(good_end)

    def _log(self, op: Dict[str, Any]) -> None:
        """Caller holds the lock."""
        self._log_line(json.dumps(op, separators=(",", ":")))

    def _log_line(self, line: str) -> None:
        """Caller holds the lock."""
        if self._wal is None:
            return
        self._wal.write(line + "\n")
        self._wal.flush()
        self._wal_ops += 1
        if self._wal_ops > 4 * max(len(self._docs), 64):
            self._compact()

    def _compact(self) -> None:
        """Snapshot + truncate the WAL (segment-merge analogue); the
        caller holds the lock. One pickle dump rather than a rewrite
        of the whole JSONL, and restart replays only the post-snapshot
        tail."""
        assert self._path is not None and self._wal is not None
        self._write_snapshot()
        self._wal.close()
        self._wal = open(self._path, "w", encoding="utf-8")
        self._wal_ops = 0

    def close(self) -> None:
        with self._lock:
            if self._wal is not None:
                if self._wal_ops:
                    # clean close → snapshot, so the next open replays
                    # nothing
                    self._compact()
                self._wal.close()
                self._wal = None

    # -- indexing --------------------------------------------------------------

    @staticmethod
    def _terms(value: Any) -> List[Any]:
        if isinstance(value, list):
            return value
        return [value]

    def _apply_index(self, doc_id: str, doc: Dict[str, Any]) -> None:
        self._apply_delete(doc_id)
        self._gen += 1
        self._docs[doc_id] = doc
        postings = self._postings
        no_index = self._no_index
        for field, value in doc.items():
            if field in no_index:
                continue
            for term in (value if isinstance(value, list) else (value,)):
                if isinstance(term, (str, int, float, bool)):
                    s = postings.get((field, term))
                    if s is None:
                        postings[(field, term)] = {doc_id}
                    else:
                        s.add(doc_id)
        # _apply_delete intentionally does NOT honor no_index: discards
        # of never-posted terms are cheap no-ops, and staying symmetric
        # keeps pre-no_index snapshots/WALs (whose docs DID post these
        # fields) from leaking dead ids into the postings

    def _apply_delete(self, doc_id: str) -> bool:
        doc = self._docs.pop(doc_id, None)
        if doc is None:
            return False
        self._gen += 1
        for field, value in doc.items():
            for term in self._terms(value):
                s = self._postings.get((field, term))
                if s is not None:
                    s.discard(doc_id)
                    if not s:
                        del self._postings[(field, term)]
        return True

    def _doc_values(self, field: str):
        """Sorted numeric doc values for ``field`` — (vals float64
        ascending, ids in (val, id) order), covering exactly the docs
        whose value is int/float/bool (the domain of range queries).
        Lazily built, invalidated by any mutation; one O(n log n) build
        amortizes every subsequent range/sorted-truncation query (the
        ES doc-values analogue). Returns None for non-numeric fields.
        """
        import numpy as np

        cached = self._dv.get(field)
        if cached is not None and cached[0] == self._gen:
            return cached[1], cached[2]
        ids_l, vals_l = [], []
        for doc_id, doc in self._docs.items():
            v = doc.get(field)
            if isinstance(v, (int, float)):  # bool is int: matches
                ids_l.append(doc_id)         # the range-filter domain
                vals_l.append(float(v))
        if not ids_l:
            self._dv[field] = (self._gen, None, None)
            return None, None
        vals = np.asarray(vals_l, np.float64)
        ids_a = np.asarray(ids_l)
        order = np.lexsort((ids_a, vals))  # (value, doc_id) — the same
        vals = vals[order]                 # tie-break search() sorts by
        ids = ids_a[order].tolist()
        self._dv[field] = (self._gen, vals, ids)
        return vals, ids

    def numeric_stats(
        self, field: str, until: Optional[float] = None,
    ) -> Optional[Tuple[int, Optional[int]]]:
        """(count, max as int) over docs whose ``field`` ≤ ``until``
        (no bound when None) — the snapshot cache's watermark probe,
        answered from the sorted doc values with two binary searches.

        Returns ``(0, None)`` for an empty index and None when ANY doc
        lacks a numeric value for ``field`` (incomplete coverage: a
        count over the indexed subset would silently miss documents,
        so callers must treat the stat as unanswerable)."""
        import numpy as np

        with self._lock:
            if not self._docs:
                return (0, None)
            vals, _ids = self._doc_values(field)
            if vals is None or len(vals) != len(self._docs):
                return None
            k = (len(vals) if until is None
                 else int(np.searchsorted(vals, until, "right")))
            if k == 0:
                return (0, None)
            return (k, int(vals[k - 1]))

    def _check_open(self) -> None:
        # a closed durable index must reject writes loudly: silently
        # skipping the WAL would apply mutations in memory only, and a
        # restart would resurrect stale state (e.g. reused sequence ids
        # overwriting live documents)
        if self._path is not None and self._wal is None:
            raise ValueError(f"index {self._path!r} is closed")

    def index(self, doc_id: str, doc: Dict[str, Any]) -> None:
        """Upsert one document (ES index-by-id semantics)."""
        with self._lock:
            self._check_open()
            # serialize before applying (same memory/WAL-sync argument
            # as index_batch): a non-JSON-able doc must fail before it
            # goes live in memory, or it silently vanishes on restart
            line = json.dumps({"op": "index", "id": doc_id, "doc": doc},
                              separators=(",", ":"))
            self._apply_index(doc_id, doc)
            self._log_line(line)

    def index_batch(self, docs) -> None:
        """Upsert many documents with ONE WAL append + flush (the ES
        _bulk analogue): the per-op flush dominates one-at-a-time
        ingest."""
        with self._lock:
            self._check_open()
            # serialize EVERY line before touching the in-memory index:
            # if one doc is non-serializable, rejecting the whole batch
            # up front keeps memory and WAL in sync (applying first
            # would leave earlier docs live in memory but lost on
            # restart, and desync the rest of the batch)
            docs = list(docs)
            lines = [json.dumps({"op": "index", "id": doc_id, "doc": doc},
                                separators=(",", ":"))
                     for doc_id, doc in docs]
            for doc_id, doc in docs:
                self._apply_index(doc_id, doc)
            if self._wal is not None and lines:
                self._wal.write("\n".join(lines) + "\n")
                self._wal.flush()
                self._wal_ops += len(lines)
                if self._wal_ops > 4 * max(len(self._docs), 64):
                    self._compact()

    def delete(self, doc_id: str) -> bool:
        with self._lock:
            self._check_open()
            existed = self._apply_delete(doc_id)
            if existed:
                self._log({"op": "delete", "id": doc_id})
            return existed

    def get(self, doc_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            doc = self._docs.get(doc_id)
            return dict(doc) if doc is not None else None

    def __len__(self) -> int:
        return len(self._docs)

    # -- search ----------------------------------------------------------------

    def search(
        self,
        must: Optional[Sequence[Tuple[str, Any]]] = None,
        must_any: Optional[Sequence[Tuple[str, Sequence[Any]]]] = None,
        should: Optional[Sequence[Tuple[str, Any, float]]] = None,
        ranges: Optional[Sequence[Tuple[str, Optional[float], Optional[float]]]] = None,
        sort: Optional[str] = None,
        reverse: bool = False,
        size: Optional[int] = None,
    ) -> List[Tuple[str, float, Dict[str, Any]]]:
        """Bool query → [(doc_id, score, doc)].

        ``must``: (field, term) filters ANDed; ``must_any``: (field,
        [terms]) — at least one term per clause (ES ``terms`` query);
        ``should``: (field, term, boost) scored clauses, score = Σ
        boosts of matches (docs matching none are dropped unless there
        are no should clauses); ``ranges``: (field, lo, hi) with lo
        inclusive / hi exclusive on numeric fields. Sorted by ``sort``
        field (else score desc), truncated to ``size``.
        """
        if size is not None and size <= 0:
            return []  # limit=0 find — every path must agree on empty
        with self._lock:
            candidates: Optional[set] = None

            def narrow(ids: set) -> None:
                nonlocal candidates
                candidates = ids if candidates is None else candidates & ids

            # intersect smallest posting set first: a selective clause
            # (entityId) after a broad one (entityType matches every
            # doc) would start by copying the whole broad set
            filter_sets: List[set] = [
                self._postings.get((field, term), set())
                for field, term in (must or [])]
            for field, terms in (must_any or []):
                terms = list(terms)
                if len(terms) == 1:  # single term: no union copy
                    filter_sets.append(
                        self._postings.get((field, terms[0]), set()))
                    continue
                hit: set = set()
                for t in terms:
                    hit |= self._postings.get((field, t), set())
                filter_sets.append(hit)
            if filter_sets:
                filter_sets.sort(key=len)
                # aliasing the live posting set is safe: candidates is
                # only read or REBOUND below (&, comprehension), never
                # mutated in place — and a one-clause query over a big
                # posting list skips an O(n) copy
                candidates = filter_sets[0]
                for s in filter_sets[1:]:
                    candidates = candidates & s
            if ranges:
                import numpy as np

                for field, lo, hi in ranges:
                    if candidates is not None and len(candidates) <= 2048:
                        # small candidate set: per-doc check beats the
                        # doc-values set build
                        def in_range(doc):
                            v = doc.get(field)
                            return (isinstance(v, (int, float))
                                    and (lo is None or v >= lo)
                                    and (hi is None or v < hi))
                        candidates = {i for i in candidates
                                      if in_range(self._docs[i])}
                        continue
                    # doc-values path: two binary searches instead of a
                    # Python scan over every candidate
                    vals, ids = self._doc_values(field)
                    if vals is None:
                        narrow(set())
                        continue
                    a = 0 if lo is None else int(
                        np.searchsorted(vals, lo, "left"))
                    b = len(ids) if hi is None else int(
                        np.searchsorted(vals, hi, "left"))
                    narrow(set(ids[a:b]))
            if candidates is None:
                candidates = set(self._docs)

            scores: Dict[str, float] = {}
            if should:
                for field, term, boost in should:
                    for doc_id in self._postings.get((field, term), ()):
                        if doc_id in candidates:
                            scores[doc_id] = scores.get(doc_id, 0.0) + boost
                hits = scores  # dict: iterates keys, O(1) membership
            else:
                hits = candidates

            def sort_key(doc_id: str):
                if sort is not None:
                    v = self._docs[doc_id].get(sort)
                    # docs missing the sort field order below every
                    # present value (ES missing:_last on desc) instead
                    # of raising on a None/value comparison
                    return (1, v) if v is not None else (0, 0)
                return scores.get(doc_id, 0.0)

            key = (lambda i: (sort_key(i), i))
            desc = (sort is None) or reverse
            if size is not None and len(hits) > max(64, 4 * size):
                if sort is not None:
                    # walk the presorted doc values and early-exit at
                    # `size` members — for dense matches (find by event
                    # name over a big index) this touches ~size/density
                    # ids instead of every hit
                    vals, ids = self._doc_values(sort)
                    if ids is not None and len(ids) == len(self._docs):
                        # full coverage → every hit has a sortable
                        # value; partial coverage falls through to the
                        # heap to keep missing-field semantics
                        out = []
                        for i in (reversed(ids) if desc else ids):
                            if i in hits:
                                out.append(i)
                                if len(out) == size:
                                    break
                        return [(i, scores.get(i, 0.0),
                                 dict(self._docs[i])) for i in out]
                # truncated result over a large candidate set: heap
                # selection is O(n log size), not O(n log n)
                import heapq

                pick = heapq.nlargest if desc else heapq.nsmallest
                hits = pick(size, hits, key=key)
            else:
                hits = sorted(hits, key=key, reverse=desc)
                if size is not None:
                    hits = hits[:size]
            return [(i, scores.get(i, 0.0), dict(self._docs[i]))
                    for i in hits]


class IndexedStorageClient:
    """Named indices in one directory (the ES StorageClient analogue)."""

    def __init__(self, root: Optional[str] = None) -> None:
        self._root = root
        self._lock = threading.Lock()
        self._indices: Dict[str, EmbeddedIndex] = {}
        if root is not None:
            os.makedirs(root, exist_ok=True)

    def index(self, name: str,
              no_index: frozenset = frozenset()) -> EmbeddedIndex:
        """``no_index`` applies on first open of the named index (the
        mapping is the creator's contract, like an ES index mapping)."""
        with self._lock:
            if name not in self._indices:
                path = (os.path.join(self._root, name + ".jsonl")
                        if self._root is not None else None)
                self._indices[name] = EmbeddedIndex(path, no_index=no_index)
            return self._indices[name]

    def drop(self, name: str) -> None:
        with self._lock:
            idx = self._indices.pop(name, None)
            if idx is not None:
                idx.close()
            if self._root is not None:
                base = os.path.join(self._root, name + ".jsonl")
                for p in (base, base + ".snap"):  # WAL and snapshot
                    try:
                        os.remove(p)
                    except FileNotFoundError:
                        pass

    def list_indices(self) -> List[str]:
        with self._lock:
            names = set(self._indices)
            if self._root is not None:
                names |= {f[:-6] for f in os.listdir(self._root)
                          if f.endswith(".jsonl")}
            return sorted(names)

    def close(self) -> None:
        with self._lock:
            for idx in self._indices.values():
                idx.close()
            self._indices.clear()


class Sequences:
    """Monotonic id generator on an index (ESSequences analogue).

    Resolves the index through the client on every call — stores
    sharing one client may close and reopen it (``close()`` clears the
    client's index table), and a cached handle would then point at a
    closed index."""

    def __init__(self, client: IndexedStorageClient) -> None:
        self._c = client

    def next(self, name: str) -> int:
        idx = self._c.index("pio_sequences")
        with idx._lock:
            doc = idx.get(name) or {"n": 0}
            doc["n"] = int(doc["n"]) + 1
            idx.index(name, doc)
            return doc["n"]


# -- event store ---------------------------------------------------------------


class ESEventStore(EventStore):
    """Events as index documents, one index per (app, channel) —
    mirroring the reference's per-app ES event indices."""

    # stored-but-not-posted fields (ES ``index: false``): the store
    # never term-queries these — properties is a serialized JSON blob,
    # the *Iso strings duplicate the numeric timestamps, and the
    # timestamps themselves are queried only as ranges/sort, which run
    # on doc values. Near-unique per doc, they would dominate postings
    # memory and the ingest loop.
    _NO_INDEX = frozenset({"properties", "eventTime", "eventTimeIso",
                           "creationTime", "creationTimeIso",
                           "eventTimeUs", "creationTimeUs"})

    def __init__(self, client: IndexedStorageClient) -> None:
        self._c = client

    def _name(self, app_id: int, channel_id: Optional[int]) -> str:
        return (f"pio_event_{app_id}" if channel_id is None
                else f"pio_event_{app_id}_{channel_id}")

    def _idx(self, app_id: int, channel_id: Optional[int]) -> EmbeddedIndex:
        return self._c.index(self._name(app_id, channel_id),
                             no_index=self._NO_INDEX)

    @staticmethod
    def _doc(e: Event) -> Dict[str, Any]:
        return {
            "event": e.event,
            "entityType": e.entity_type,
            "entityId": e.entity_id,
            "targetEntityType": e.target_entity_type,
            "targetEntityId": e.target_entity_id,
            "properties": (json.dumps(e.properties, separators=(",", ":"))
                           if e.properties else "{}"),
            "eventTime": e.event_time.timestamp(),
            "eventTimeIso": format_event_time(e.event_time),
            "tags": list(e.tags),
            "prId": e.pr_id,
            "creationTime": e.creation_time.timestamp(),
            "creationTimeIso": format_event_time(e.creation_time),
            # exact integer epoch-µs: the float-second fields above are
            # lossy (≈0.5 µs spacing), so columnar times_us and the
            # snapshot cache's creationTime watermark read these
            "eventTimeUs": _ts_us(e.event_time),
            "creationTimeUs": _ts_us(e.creation_time),
        }

    @staticmethod
    def _event(doc_id: str, d: Dict[str, Any]) -> Event:
        return Event(
            event_id=doc_id,
            event=d["event"],
            entity_type=d["entityType"],
            entity_id=d["entityId"],
            target_entity_type=d.get("targetEntityType"),
            target_entity_id=d.get("targetEntityId"),
            properties=json.loads(d["properties"]),
            event_time=parse_event_time(d["eventTimeIso"]),
            tags=list(d.get("tags", [])),
            pr_id=d.get("prId"),
            creation_time=parse_event_time(d["creationTimeIso"]),
        )

    def insert(self, event: Event, app_id: int,
               channel_id: Optional[int] = None) -> str:
        validate_event(event)
        e = event.with_id()
        self._idx(app_id, channel_id).index(
            e.event_id, self._doc(e))
        return e.event_id  # type: ignore[return-value]

    def insert_batch(self, events, app_id: int,
                     channel_id: Optional[int] = None):
        """Bulk ingest through one WAL append (ES _bulk analogue)."""
        docs, ids = [], []
        for event in events:
            validate_event(event)
            e = event.with_id()
            docs.append((e.event_id, self._doc(e)))
            ids.append(e.event_id)
        self._idx(app_id, channel_id).index_batch(docs)
        return ids

    def get(self, event_id: str, app_id: int,
            channel_id: Optional[int] = None) -> Optional[Event]:
        d = self._idx(app_id, channel_id).get(event_id)
        return self._event(event_id, d) if d is not None else None

    def delete(self, event_id: str, app_id: int,
               channel_id: Optional[int] = None) -> bool:
        return self._idx(app_id, channel_id).delete(event_id)

    def wipe(self, app_id: int, channel_id: Optional[int] = None) -> None:
        idx = self._idx(app_id, channel_id)
        for doc_id, _, _ in idx.search():
            idx.delete(doc_id)

    def remove_channel(self, app_id: int,
                       channel_id: Optional[int] = None) -> None:
        self._c.drop(self._name(app_id, channel_id))

    def close(self) -> None:
        self._c.close()

    @staticmethod
    def _query(start_time, until_time, entity_type, entity_id,
               event_names, target_entity_type, target_entity_id):
        """Shared filter→search mapping for find() and scan_columnar —
        one copy, so the two read paths (and therefore the columnar/
        generic vocabulary orders) can never diverge."""
        must: List[Tuple[str, Any]] = []
        if entity_type is not None:
            must.append(("entityType", entity_type))
        if entity_id is not None:
            must.append(("entityId", entity_id))
        if target_entity_type is not None:
            must.append(("targetEntityType", target_entity_type))
        if target_entity_id is not None:
            must.append(("targetEntityId", target_entity_id))
        must_any = ([("event", list(event_names))]
                    if event_names is not None else None)
        ranges = None
        if start_time is not None or until_time is not None:
            ranges = [("eventTime",
                       start_time.timestamp() if start_time else None,
                       until_time.timestamp() if until_time else None)]
        return must, must_any, ranges

    def find(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        entity_id: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Optional[str] = None,
        target_entity_id: Optional[str] = None,
        limit: Optional[int] = None,
        reversed: bool = False,
    ) -> Iterator[Event]:
        must, must_any, ranges = self._query(
            start_time, until_time, entity_type, entity_id, event_names,
            target_entity_type, target_entity_id)
        hits = self._idx(app_id, channel_id).search(
            must=must, must_any=must_any, ranges=ranges,
            sort="eventTime", reverse=reversed,
            size=limit if (limit is not None and limit >= 0) else None)
        return iter([self._event(i, d) for i, _, d in hits])

    def scan_columnar(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        target_entity_type: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        value_key: Optional[str] = None,
        created_after_us: Optional[int] = None,
        created_until_us: Optional[int] = None,
    ):
        """Columnar training read over the index (same contract as the
        EVENTLOG/SQL scans — `data/pipeline.ColumnarEvents`): the SAME
        search the generic ``find()`` runs supplies the hits, so scan
        order (hence vocabulary order) matches by construction, but no
        Event objects, timestamp parses, or full-properties decodes
        are built per doc.

        ``times_us`` comes from the exact integer ``eventTimeUs`` field
        (falling back to the rounded float-second field for documents
        written before it existed), so it is bit-identical to the
        EVENTLOG/SQL scans. ``created_after_us`` (exclusive) /
        ``created_until_us`` (inclusive) bound ``creationTimeUs`` — the
        snapshot cache's delta window, run on doc values; documents
        without the field never match a bounded scan, which is why the
        cache also requires :meth:`creation_stats` coverage."""
        from predictionio_tpu_torch.data.pipeline import columnar_from_rows

        must, must_any, ranges = self._query(
            start_time, until_time, entity_type, None, event_names,
            target_entity_type, None)
        if created_after_us is not None or created_until_us is not None:
            # search ranges are lo-inclusive / hi-exclusive over exact
            # integer µs, so shift both bounds up by one
            ranges = list(ranges or [])
            ranges.append((
                "creationTimeUs",
                created_after_us + 1 if created_after_us is not None
                else None,
                created_until_us + 1 if created_until_us is not None
                else None))
        hits = self._idx(app_id, channel_id).search(
            must=must, must_any=must_any, ranges=ranges, sort="eventTime")

        def rows():
            for _i, _score, d in hits:
                tgt = d.get("targetEntityId")
                if not tgt:
                    continue
                t_us = d.get("eventTimeUs")
                if t_us is None:
                    # pre-eventTimeUs doc: float seconds only. round,
                    # not truncate — int(x*1e6) lands 1 µs low for ~1%
                    # of values
                    t_us = round(d["eventTime"] * 1e6)
                yield (d["event"], d["entityId"], tgt,
                       d.get("properties"), int(t_us))

        cols = columnar_from_rows(rows(), value_key)
        if cols is not None:
            from predictionio_tpu_torch.utils import tracing

            tracing.add_attrs(scan_backend="index", scan_records=int(cols.n))
        return cols

    @property
    def cache_identity(self) -> Optional[str]:  # type: ignore[override]
        root = getattr(self._c, "_root", None)
        if root is None:
            return None  # in-memory client: nothing durable to key on
        return "es:" + os.path.abspath(root)

    def creation_stats(
        self, app_id: int, channel_id: Optional[int] = None,
        until_us: Optional[int] = None,
    ) -> Optional[Tuple[int, Optional[int]]]:
        """Watermark probe over exact ``creationTimeUs`` doc values.
        None (cache disabled) when any document predates the field —
        a bounded delta scan could not see those docs."""
        stats = self._idx(app_id, channel_id).numeric_stats(
            "creationTimeUs",
            until=float(until_us) if until_us is not None else None)
        return stats


# -- meta store ----------------------------------------------------------------


def _iso(t: Optional[_dt.datetime]) -> Optional[str]:
    return format_event_time(t) if t is not None else None


def _from_iso(s: Optional[str]) -> Optional[_dt.datetime]:
    return parse_event_time(s) if s else None


class ESMetaStore:
    """All meta repositories on the embedded index — the duck-typed
    equivalent of :class:`predictionio_tpu_torch.storage.meta.MetaStore`
    (apps / access keys / channels / engine & evaluation instances),
    with ids from :class:`Sequences`."""

    def __init__(self, client: IndexedStorageClient) -> None:
        self._c = client
        self._seq = Sequences(client)

    # -- apps --

    def create_app(self, name: str, description: str = "") -> App:
        idx = self._c.index("pio_apps")
        if idx.search(must=[("name", name)], size=1):
            raise ValueError(f"app named {name!r} already exists")
        app_id = self._seq.next("apps")
        idx.index(str(app_id), {"id": app_id, "name": name,
                                "description": description})
        return App(app_id, name, description)

    def get_app(self, app_id: int) -> Optional[App]:
        d = self._c.index("pio_apps").get(str(app_id))
        return App(d["id"], d["name"], d.get("description", "")) if d else None

    def get_app_by_name(self, name: str) -> Optional[App]:
        hits = self._c.index("pio_apps").search(must=[("name", name)], size=1)
        if not hits:
            return None
        _, _, d = hits[0]
        return App(d["id"], d["name"], d.get("description", ""))

    def list_apps(self) -> List[App]:
        return [App(d["id"], d["name"], d.get("description", ""))
                for _, _, d in self._c.index("pio_apps").search(sort="id")]

    def delete_app(self, app_id: int) -> bool:
        existed = self._c.index("pio_apps").delete(str(app_id))
        for k in self.list_access_keys(app_id):
            self.delete_access_key(k.key)
        for ch in self.list_channels(app_id):
            self.delete_channel(ch.id)
        return existed

    # -- access keys --

    def create_access_key(self, app_id: int,
                          events: Optional[List[str]] = None,
                          key: Optional[str] = None) -> AccessKey:
        if not key:
            import secrets

            key = secrets.token_urlsafe(48)
        ak = AccessKey(key, app_id, list(events or []))
        self._c.index("pio_access_keys").index(
            key, {"key": key, "appId": app_id, "events": ak.events})
        _bump_meta_epoch()
        return ak

    def get_access_key(self, key: str) -> Optional[AccessKey]:
        d = self._c.index("pio_access_keys").get(key)
        return (AccessKey(d["key"], d["appId"], list(d.get("events", [])))
                if d else None)

    def list_access_keys(self, app_id: Optional[int] = None) -> List[AccessKey]:
        idx = self._c.index("pio_access_keys")
        hits = (idx.search(must=[("appId", app_id)], sort="key")
                if app_id is not None else idx.search(sort="key"))
        return [AccessKey(d["key"], d["appId"], list(d.get("events", [])))
                for _, _, d in hits]

    def delete_access_key(self, key: str) -> bool:
        deleted = self._c.index("pio_access_keys").delete(key)
        _bump_meta_epoch()
        return deleted

    # -- channels --

    def create_channel(self, app_id: int, name: str) -> Channel:
        idx = self._c.index("pio_channels")
        if idx.search(must=[("appId", app_id), ("name", name)], size=1):
            raise ValueError(f"channel {name!r} already exists for app {app_id}")
        ch_id = self._seq.next("channels")
        idx.index(str(ch_id), {"id": ch_id, "name": name, "appId": app_id})
        _bump_meta_epoch()
        return Channel(ch_id, name, app_id)

    def get_channel_by_name(self, app_id: int, name: str) -> Optional[Channel]:
        hits = self._c.index("pio_channels").search(
            must=[("appId", app_id), ("name", name)], size=1)
        if not hits:
            return None
        _, _, d = hits[0]
        return Channel(d["id"], d["name"], d["appId"])

    def list_channels(self, app_id: int) -> List[Channel]:
        return [Channel(d["id"], d["name"], d["appId"])
                for _, _, d in self._c.index("pio_channels").search(
                    must=[("appId", app_id)], sort="id")]

    def delete_channel(self, channel_id: int) -> bool:
        deleted = self._c.index("pio_channels").delete(str(channel_id))
        _bump_meta_epoch()
        return deleted

    # -- engine instances --

    @staticmethod
    def _ei_doc(ei: EngineInstance) -> Dict[str, Any]:
        return {
            "id": ei.id, "status": ei.status,
            "startTime": _iso(ei.start_time), "endTime": _iso(ei.end_time),
            "engineFactory": ei.engine_factory,
            "engineVariant": ei.engine_variant, "batch": ei.batch,
            "env": json.dumps(ei.env), "meshConf": json.dumps(ei.mesh_conf),
            "dataSourceParams": ei.data_source_params,
            "preparatorParams": ei.preparator_params,
            "algorithmsParams": ei.algorithms_params,
            "servingParams": ei.serving_params,
            # dedicated search field: latest-completed lookup is a term
            # query on (factory, variant, status) + sort on startTime
            "startTs": ei.start_time.timestamp(),
        }

    @staticmethod
    def _ei(d: Dict[str, Any]) -> EngineInstance:
        return EngineInstance(
            id=d["id"], status=d["status"],
            start_time=_from_iso(d["startTime"]),
            end_time=_from_iso(d.get("endTime")),
            engine_factory=d["engineFactory"],
            engine_variant=d["engineVariant"], batch=d.get("batch", ""),
            env=json.loads(d.get("env", "{}")),
            mesh_conf=json.loads(d.get("meshConf", "{}")),
            data_source_params=d.get("dataSourceParams", ""),
            preparator_params=d.get("preparatorParams", ""),
            algorithms_params=d.get("algorithmsParams", ""),
            serving_params=d.get("servingParams", ""),
        )

    def insert_engine_instance(self, ei: EngineInstance) -> None:
        self._c.index("pio_engine_instances").index(ei.id, self._ei_doc(ei))

    update_engine_instance = insert_engine_instance

    def get_engine_instance(self, instance_id: str) -> Optional[EngineInstance]:
        d = self._c.index("pio_engine_instances").get(instance_id)
        return self._ei(d) if d else None

    def get_latest_completed_engine_instance(
        self, engine_factory: str, engine_variant: str = ""
    ) -> Optional[EngineInstance]:
        must: List[Tuple[str, Any]] = [("engineFactory", engine_factory),
                                       ("status", "COMPLETED")]
        if engine_variant:
            must.append(("engineVariant", engine_variant))
        hits = self._c.index("pio_engine_instances").search(
            must=must, sort="startTs", reverse=True, size=1)
        return self._ei(hits[0][2]) if hits else None

    def list_engine_instances(self) -> List[EngineInstance]:
        # newest first, matching MetaStore's ORDER BY startTime DESC
        return [self._ei(d) for _, _, d in
                self._c.index("pio_engine_instances").search(
                    sort="startTs", reverse=True)]

    # -- evaluation instances --

    @staticmethod
    def _vi_doc(vi: EvaluationInstance) -> Dict[str, Any]:
        return {
            "id": vi.id, "status": vi.status,
            "startTime": _iso(vi.start_time), "endTime": _iso(vi.end_time),
            "evaluationClass": vi.evaluation_class,
            "generatorClass": vi.engine_params_generator_class,
            "batch": vi.batch, "env": json.dumps(vi.env),
            "results": vi.evaluator_results,
            "resultsHTML": vi.evaluator_results_html,
            "resultsJSON": vi.evaluator_results_json,
            "startTs": vi.start_time.timestamp(),
        }

    @staticmethod
    def _vi(d: Dict[str, Any]) -> EvaluationInstance:
        return EvaluationInstance(
            id=d["id"], status=d["status"],
            start_time=_from_iso(d["startTime"]),
            end_time=_from_iso(d.get("endTime")),
            evaluation_class=d.get("evaluationClass", ""),
            engine_params_generator_class=d.get("generatorClass", ""),
            batch=d.get("batch", ""), env=json.loads(d.get("env", "{}")),
            evaluator_results=d.get("results", ""),
            evaluator_results_html=d.get("resultsHTML", ""),
            evaluator_results_json=d.get("resultsJSON", ""),
        )

    def insert_evaluation_instance(self, vi: EvaluationInstance) -> None:
        self._c.index("pio_evaluation_instances").index(vi.id, self._vi_doc(vi))

    update_evaluation_instance = insert_evaluation_instance

    def get_evaluation_instance(self, instance_id: str) -> Optional[EvaluationInstance]:
        d = self._c.index("pio_evaluation_instances").get(instance_id)
        return self._vi(d) if d else None

    def list_evaluation_instances(self) -> List[EvaluationInstance]:
        return [self._vi(d) for _, _, d in
                self._c.index("pio_evaluation_instances").search(
                    sort="startTs", reverse=True)]

    def new_instance_id(self) -> str:
        n = self._seq.next("instances")
        return utcnow().strftime("%Y%m%d%H%M%S") + f"-{n:08x}"


# -- model store ---------------------------------------------------------------


class ESModelStore(ModelStore):
    """Model blobs as base64 documents (the reference's ESModels)."""

    def __init__(self, client: IndexedStorageClient) -> None:
        self._c = client

    def put(self, instance_id: str, blob: bytes) -> None:
        self._c.index("pio_models").index(
            instance_id, {"id": instance_id,
                          "blob": base64.b64encode(blob).decode("ascii")})

    def get(self, instance_id: str) -> Optional[bytes]:
        d = self._c.index("pio_models").get(instance_id)
        return base64.b64decode(d["blob"]) if d else None

    def delete(self, instance_id: str) -> bool:
        return self._c.index("pio_models").delete(instance_id)

    def list_ids(self) -> List[str]:
        return [i for i, _, _ in self._c.index("pio_models").search(sort="id")]


# -- indicator indexing (Universal Recommender parity) -------------------------


def index_indicators(client: IndexedStorageClient, index_name: str,
                     indicators, item_ids) -> EmbeddedIndex:
    """Write a trained CCO model's indicator lists into an index, the
    way the reference's UR stores them in Elasticsearch: one document
    per item, one list field per event type holding the correlated item
    ids. A similar-items query is then the reference-shaped ES query:
    ``should`` terms over the indicator fields (see
    :func:`search_similar`)."""
    import numpy as np

    idx = client.index(index_name)
    inv = item_ids.inverse()
    n = len(item_ids)
    docs = []
    for i in range(n):
        doc: Dict[str, Any] = {"item": inv[i]}
        for event, (idxs, vals) in indicators.items():
            doc[event] = [inv[int(j)] for j, v in zip(idxs[i], vals[i])
                          if np.isfinite(v)]
        docs.append((inv[i], doc))
    # one WAL append for the whole model (see index_batch)
    idx.index_batch(docs)
    return idx


def search_similar(index: EmbeddedIndex, history: Dict[str, Sequence[str]],
                   num: int,
                   boosts: Optional[Dict[str, float]] = None) -> List[Tuple[str, float]]:
    """The reference-shaped UR query: bool/should terms over indicator
    fields, scored by matched-term boosts → top items."""
    should: List[Tuple[str, Any, float]] = []
    for event, items in history.items():
        b = (boosts or {}).get(event, 1.0)
        for it in items:
            should.append((event, it, b))
    return [(d["item"], score)
            for _, score, d in index.search(should=should, size=num)]


def register_all() -> None:
    """Register the ELASTICSEARCH TYPE for every repository."""
    from predictionio_tpu_torch.storage import registry

    _clients: Dict[str, IndexedStorageClient] = {}
    _lock = threading.Lock()

    def client(cfg, repo: str) -> IndexedStorageClient:
        # each repository resolves ITS source's PATH (two differently-
        # rooted ES sources must not shadow each other — the same
        # contract as StorageConfig.source_properties); repos sharing a
        # root share one client
        root = cfg.source_properties(repo).get("PATH") or \
            os.path.join(cfg.home, "es_index")
        with _lock:
            if root not in _clients:
                _clients[root] = IndexedStorageClient(root)
            return _clients[root]

    registry.register_event_backend(
        "ELASTICSEARCH", lambda cfg: ESEventStore(client(cfg, "EVENTDATA")))
    registry.register_meta_backend(
        "ELASTICSEARCH", lambda cfg: ESMetaStore(client(cfg, "METADATA")))
    registry.register_model_backend(
        "ELASTICSEARCH", lambda cfg: ESModelStore(client(cfg, "MODELDATA")))
