"""Streaming training read: event store → columnar host arrays.

The port's copy of the JAX package's ``data/pipeline.py``:

- :func:`iter_columnar` — stream the store's ``find()`` iterator into
  fixed-size columnar chunks (ids + values), never holding more than
  ``chunk_size`` Event objects;
- :func:`read_interactions` — the two-pass reader for (user, item[,
  rating]) training data: pass 1 builds the id vocabularies in first-seen
  order, pass 2 re-streams yielding index-mapped chunks
  (:class:`InteractionData`);
- :func:`read_event_groups` — the multi-event two-pass reader (the
  Universal Recommender's shape): several named streams over ONE shared
  vocabulary pair, demuxed by event name;
- :func:`subset_columnar` — a fold's rows with both vocabularies trimmed
  to the entities present (the eval-fold cold-entity rule);
- :class:`DevicePrefetcher` — double-buffered host → device transfer
  over an iterator of host arrays (the streaming trainer's input);
- the columnar half: :class:`ColumnarEvents` (what a store's
  ``scan_columnar`` returns), :func:`columnar_from_rows` (the SQLite
  accumulator), :func:`concat_columnar` (the snapshot cache's delta
  append), :func:`merge_columnar_segments` (the segmented log's block
  merge), and :func:`interactions_from_columnar` /
  :func:`event_groups_from_columnar`, which give the same arrays and
  vocabularies as the two-pass readers without a per-event object.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from predictionio_tpu_torch.utils.bimap import BiMap


def iter_columnar(
    events: Iterator,
    chunk_size: int = 65536,
    value_fn: Optional[Callable[[Any], Optional[float]]] = None,
) -> Iterator[Tuple[List[str], List[str], np.ndarray]]:
    """Group an event iterator into columnar chunks.

    Yields ``(entity_ids, target_ids, values)`` with lists of length ≤
    ``chunk_size``; events without a target entity are skipped, and
    ``value_fn`` returning None drops the event (malformed rating).
    """
    ents: List[str] = []
    tgts: List[str] = []
    vals: List[float] = []
    for e in events:
        # falsy (None or "") — the columnar scans treat an empty-string
        # target as no target, and the paths must agree
        if not e.target_entity_id:
            continue
        v = 1.0
        if value_fn is not None:
            maybe = value_fn(e)
            if maybe is None:
                continue
            v = maybe
        ents.append(e.entity_id)
        tgts.append(e.target_entity_id)
        vals.append(v)
        if len(ents) == chunk_size:
            yield ents, tgts, np.asarray(vals, np.float32)
            ents, tgts, vals = [], [], []
    if ents:
        yield ents, tgts, np.asarray(vals, np.float32)


class InteractionData:
    """Index-mapped interaction data with its vocabularies.

    ``chunks()`` re-streams the store in columnar chunks (beyond-RAM
    path); ``arrays()`` concatenates them (fits-in-RAM path).
    """

    def __init__(self, user_ids: BiMap, item_ids: BiMap,
                 chunk_factory: Callable[[], Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]],
                 n_events: int) -> None:
        self.user_ids = user_ids
        self.item_ids = item_ids
        self._chunk_factory = chunk_factory
        self.n_events = n_events

    def chunks(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Yield (user_idx, item_idx, value) int32/int32/f32 chunks."""
        return self._chunk_factory()

    def arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        us, is_, vs = [], [], []
        for u, i, v in self.chunks():
            us.append(u)
            is_.append(i)
            vs.append(v)
        if not us:
            return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                    np.zeros(0, np.float32))
        return np.concatenate(us), np.concatenate(is_), np.concatenate(vs)


class ColumnarEvents:
    """One store scan as parallel numpy columns + deduped id tables —
    what a native ``scan_columnar`` (EVENTLOG backend) returns. Index
    arrays point into the id tables in FIRST-SEEN scan order, the same
    order the two-pass Python reader assigns, so the two paths build
    identical vocabularies."""

    def __init__(self, entity_idx, target_idx, name_idx, values, times_us,
                 entity_ids, target_ids, names) -> None:
        self.entity_idx = entity_idx    # u32 [n]
        self.target_idx = target_idx    # u32 [n]
        self.name_idx = name_idx        # u16 [n] → names
        self.values = values            # f64 [n], NaN = no value
        self.times_us = times_us        # i64 [n]
        self.entity_ids = entity_ids    # list[str]
        self.target_ids = target_ids    # list[str]
        self.names = names              # list[str]

    @property
    def n(self) -> int:
        return int(self.entity_idx.shape[0])


def columnar_from_rows(
    rows: Iterator[Tuple[str, str, str, Optional[str], int]],
    value_key: Optional[str] = None,
) -> Optional[ColumnarEvents]:
    """Shared Python-side columnar accumulator for stores without a
    native scan engine (SQL, embedded index): consume
    ``(event, entity_id, target_id, properties_json, time_us)`` rows in
    scan order and build the :class:`ColumnarEvents` columns +
    first-seen vocabularies. Rows must already be target-filtered.
    ``value_key`` extraction applies the shared grammar
    (`data/store._parse_value`); a cheap substring prefilter skips
    `json.loads` for rows that cannot carry the key. Returns None when
    >65535 distinct event names would overflow the u16 name column
    (callers fall back to the generic reader)."""
    import json

    from predictionio_tpu_torch.data.store import _parse_value

    ents: Dict[str, int] = {}
    tgts: Dict[str, int] = {}
    names: Dict[str, int] = {}
    e_idx: List[int] = []
    t_idx: List[int] = []
    n_idx: List[int] = []
    vals: List[float] = []
    times: List[int] = []
    nan = float("nan")
    needle = None
    if value_key:
        plain = (value_key.isascii() and '"' not in value_key
                 and "\\" not in value_key
                 and all(c >= " " for c in value_key))  # json.dumps
        # escapes control chars, so a literal-tab needle never hits
        needle = f'"{value_key}"' if plain else ""
    try:
        for name, ent, tgt, props, t_us in rows:
            e_idx.append(ents.setdefault(ent, len(ents)))
            t_idx.append(tgts.setdefault(tgt, len(tgts)))
            n_idx.append(names.setdefault(name, len(names)))
            times.append(t_us)
            v = nan
            if (needle is not None and props and props != "{}"
                    and (needle == "" or needle in props)):
                try:
                    pv = _parse_value(json.loads(props).get(value_key))
                    if pv is not None:
                        v = pv
                except ValueError:
                    pass
            vals.append(v)
            if len(names) > 65535:  # u16 name_idx would wrap
                return None
    finally:
        # the early None return must not abandon a generator mid-flight:
        # the SQL row source ends its read transaction in ITS finally,
        # which only runs when the generator closes — deterministically
        # here, not at GC time (idle-in-transaction hazard)
        closer = getattr(rows, "close", None)
        if closer is not None:
            closer()
    return ColumnarEvents(
        entity_idx=np.asarray(e_idx, np.uint32),
        target_idx=np.asarray(t_idx, np.uint32),
        name_idx=np.asarray(n_idx, np.uint16),
        values=np.asarray(vals, np.float64),
        times_us=np.asarray(times, np.int64),
        entity_ids=list(ents), target_ids=list(tgts),
        names=list(names))


def concat_columnar(
    base: ColumnarEvents, delta: ColumnarEvents,
) -> Optional[ColumnarEvents]:
    """Append a delta scan to a base scan, remapping the delta's id
    tables into the base's.

    Correctness contract (what the snapshot cache relies on): if every
    delta event sorts strictly AFTER every base event in the store's
    scan order, the result is identical — arrays and vocabularies — to
    one cold scan over base∪delta, because first-seen order over the
    concatenation equals first-seen over base followed by first-seen
    over the delta's unseen ids. The cache layer enforces that
    precondition (it rejects deltas whose min eventTime ties or
    precedes the base's max) before calling this.

    Returns None when the merged name table would overflow the u16
    ``name_idx`` column, mirroring :func:`columnar_from_rows`.
    """
    if delta.n == 0:
        return base
    if base.n == 0:
        return delta

    def merge(base_tab: List[str],
              delta_tab: List[str]) -> Tuple[List[str], np.ndarray]:
        pos = {s: i for i, s in enumerate(base_tab)}
        merged = list(base_tab)
        lut = np.empty(len(delta_tab), np.int64)
        for j, s in enumerate(delta_tab):
            i = pos.get(s)
            if i is None:
                i = len(merged)
                pos[s] = i
                merged.append(s)
            lut[j] = i
        return merged, lut

    ents, lut_e = merge(base.entity_ids, delta.entity_ids)
    tgts, lut_t = merge(base.target_ids, delta.target_ids)
    names, lut_n = merge(base.names, delta.names)
    if len(names) > 65535:
        return None
    return ColumnarEvents(
        entity_idx=np.concatenate(
            [base.entity_idx,
             lut_e[delta.entity_idx].astype(np.uint32)]),
        target_idx=np.concatenate(
            [base.target_idx,
             lut_t[delta.target_idx].astype(np.uint32)]),
        name_idx=np.concatenate(
            [base.name_idx, lut_n[delta.name_idx].astype(np.uint16)]),
        values=np.concatenate([base.values, delta.values]),
        times_us=np.concatenate([base.times_us, delta.times_us]),
        entity_ids=ents, target_ids=tgts, names=names)


def _reindex_first_seen(idx: np.ndarray, table: List[str],
                        out_dtype) -> Tuple[np.ndarray, List[str]]:
    """Renumber a vocabulary to first-seen order of ``idx`` (every table
    entry is referenced at least once — merge output invariant)."""
    uniq, first = np.unique(idx, return_index=True)
    order = np.argsort(first, kind="stable")
    seen = uniq[order]
    lut = np.empty(len(table), np.int64)
    lut[seen] = np.arange(len(seen))
    return lut[idx].astype(out_dtype), [table[int(u)] for u in seen]


def merge_columnar_segments(
    blocks,
) -> Optional[ColumnarEvents]:
    """Merge per-segment columnar scans into one global scan result.

    ``blocks`` is an iterable of ``(ColumnarEvents, creation_us)``
    pairs in global sequence order (segment seal order, active last);
    each block is internally sorted by (eventTime, creationTime, local
    seq) with first-seen vocabularies — exactly what one native scan
    over that segment returns. The result is row- and vocabulary-
    identical to a single scan over the union: blocks are consumed one
    at a time (peak memory stays O(result + one block), never a
    per-event object list), and a final stable (time, creation)
    lexsort runs only when segment time ranges actually interleave —
    the append-mostly common case concatenates straight through.
    Per-block vocabularies are unioned in one vectorized pass at the
    end (offset-concatenate the tables, ``np.unique`` to collapse
    duplicate strings, renumber to first-seen row order) rather than
    string-by-string — the union must not cost more than the decode
    it replaces. Block tables may be Python lists or numpy ``<U``
    arrays; output tables are always lists. Returns None when any
    block was declined (name-vocab overflow) or the union would
    overflow u16, mirroring :func:`columnar_from_rows`.
    """
    e_parts: List[np.ndarray] = []
    t_parts: List[np.ndarray] = []
    n_parts: List[np.ndarray] = []
    v_parts: List[np.ndarray] = []
    tm_parts: List[np.ndarray] = []
    c_parts: List[np.ndarray] = []
    e_tabs: List[np.ndarray] = []
    t_tabs: List[np.ndarray] = []
    n_tabs: List[np.ndarray] = []
    e_off = t_off = n_off = 0
    in_order = True
    last_key = None

    for cols, creation in blocks:
        if cols is None:
            return None
        if cols.n == 0:
            continue
        # shift each block's indices into the concatenated-table space;
        # duplicate strings across blocks are collapsed after the loop
        e_parts.append(cols.entity_idx.astype(np.int64) + e_off)
        t_parts.append(cols.target_idx.astype(np.int64) + t_off)
        n_parts.append(cols.name_idx.astype(np.int64) + n_off)
        e_tabs.append(np.asarray(cols.entity_ids, dtype=str))
        t_tabs.append(np.asarray(cols.target_ids, dtype=str))
        n_tabs.append(np.asarray(cols.names, dtype=str))
        e_off += e_tabs[-1].shape[0]
        t_off += t_tabs[-1].shape[0]
        n_off += n_tabs[-1].shape[0]
        v_parts.append(cols.values)
        tm_parts.append(cols.times_us)
        c_parts.append(creation)
        first_key = (int(cols.times_us[0]), int(creation[0]))
        if last_key is not None and first_key < last_key:
            in_order = False
        last_key = (int(cols.times_us[-1]), int(creation[-1]))

    if not tm_parts:
        z = np.zeros(0, np.uint32)
        return ColumnarEvents(
            entity_idx=z, target_idx=z.copy(),
            name_idx=np.zeros(0, np.uint16),
            values=np.zeros(0, np.float64), times_us=np.zeros(0, np.int64),
            entity_ids=[], target_ids=[], names=[])
    if len(tm_parts) == 1:
        # single surviving block: vocabularies are already first-seen
        # and indices unshifted (offset 0) — only normalize types
        if len(n_tabs[0]) > 65535:
            return None
        return ColumnarEvents(
            entity_idx=e_parts[0].astype(np.uint32),
            target_idx=t_parts[0].astype(np.uint32),
            name_idx=n_parts[0].astype(np.uint16),
            values=v_parts[0], times_us=tm_parts[0],
            entity_ids=e_tabs[0].tolist(), target_ids=t_tabs[0].tolist(),
            names=n_tabs[0].tolist())
    times = np.concatenate(tm_parts)
    creations = np.concatenate(c_parts)
    e_idx = np.concatenate(e_parts)
    t_idx = np.concatenate(t_parts)
    n_idx = np.concatenate(n_parts)
    values = np.concatenate(v_parts)
    del tm_parts, c_parts, e_parts, t_parts, n_parts, v_parts
    if in_order:
        # concatenation in segment order is already the global row
        # order, and each block table is in first-seen order of its own
        # rows — so first-seen over rows equals first-seen over the
        # concatenated TABLES, and the union never has to sort a
        # row-length array: collapse duplicate strings with one unique
        # over the (small) table space, order by first slot, and map
        # rows with a single O(n) gather
        def renumber(gidx: np.ndarray, tabs: List[np.ndarray],
                     out_dtype):
            cat = np.concatenate(tabs)
            uniq_strs, first_slot, slot_uid = np.unique(
                cat, return_index=True, return_inverse=True)
            order = np.argsort(first_slot, kind="stable")
            lut = np.empty(uniq_strs.shape[0], np.int64)
            lut[order] = np.arange(order.shape[0])
            return (lut[slot_uid][gidx].astype(out_dtype),
                    uniq_strs[order].tolist())
    else:
        # interleaved segment time ranges: restore global order with a
        # stable sort (ties keep concatenation order = global seq
        # order), then renumber to first-seen of the SORTED row stream
        # so the result matches one single-file scan of the union
        perm = np.lexsort((creations, times))
        times = times[perm]
        values = values[perm]
        e_idx = e_idx[perm]
        t_idx = t_idx[perm]
        n_idx = n_idx[perm]

        def renumber(gidx: np.ndarray, tabs: List[np.ndarray],
                     out_dtype):
            cat = np.concatenate(tabs)
            uniq_strs, slot_uid = np.unique(cat, return_inverse=True)
            sidx = slot_uid[gidx]
            uniq, first = np.unique(sidx, return_index=True)
            seen = uniq[np.argsort(first, kind="stable")]
            lut = np.empty(uniq_strs.shape[0], np.int64)
            lut[seen] = np.arange(seen.shape[0])
            return lut[sidx].astype(out_dtype), uniq_strs[seen].tolist()
    del creations

    n_idx, n_tab = renumber(n_idx, n_tabs, np.uint16)
    if len(n_tab) > 65535:
        return None
    e_idx, e_tab = renumber(e_idx, e_tabs, np.uint32)
    t_idx, t_tab = renumber(t_idx, t_tabs, np.uint32)
    return ColumnarEvents(
        entity_idx=e_idx, target_idx=t_idx, name_idx=n_idx,
        values=values, times_us=times,
        entity_ids=e_tab, target_ids=t_tab, names=n_tab)


def interactions_from_columnar(
    cols: ColumnarEvents,
    value_spec: Optional[Dict[str, Any]] = None,
    default_spec: Any = 1.0,
    chunk_size: int = 65536,
) -> InteractionData:
    """Vectorized :class:`InteractionData` from a columnar scan.

    ``value_spec`` maps event name → ``"prop"`` (use the scan's
    extracted numeric property; non-finite drops the event, mirroring
    the generic path's ``value_fn → None``) or a float constant.
    Unlisted names take ``default_spec``. Vocabularies are re-densified
    to kept events only (first-seen order), so the result is
    indistinguishable from :func:`read_interactions` over ``find()``.
    """
    # per-NAME lookup arrays, then one gather over name_idx — O(n),
    # independent of how many distinct event names the log holds
    specs = [(value_spec or {}).get(name, default_spec)
             for name in cols.names]
    is_prop = np.asarray([s == "prop" for s in specs], bool)
    consts = np.asarray([1.0 if s == "prop" else float(s) for s in specs],
                        np.float64)
    prop_row = is_prop[cols.name_idx]
    vals = np.where(prop_row, cols.values, consts[cols.name_idx])
    keep = ~prop_row | np.isfinite(cols.values)

    def densify(idx_arr: np.ndarray, table: List[str]):
        """Trim the vocab to kept events, preserving first-seen order."""
        uniq, first_pos = np.unique(idx_arr, return_index=True)
        order = np.argsort(first_pos, kind="stable")
        uniq = uniq[order]
        remap = np.full(len(table), -1, np.int32)
        remap[uniq] = np.arange(len(uniq), dtype=np.int32)
        ids = [table[int(u)] for u in uniq]
        return remap, BiMap({s: i for i, s in enumerate(ids)})

    ent_kept = cols.entity_idx[keep]
    tgt_kept = cols.target_idx[keep]
    v_kept = vals[keep].astype(np.float32)
    remap_e, user_ids = densify(ent_kept, cols.entity_ids)
    remap_t, item_ids = densify(tgt_kept, cols.target_ids)
    uu = remap_e[ent_kept]
    ii = remap_t[tgt_kept]
    n_events = int(uu.shape[0])

    def chunk_factory():
        for s in range(0, max(n_events, 1), chunk_size):
            if s >= n_events:
                return
            yield (uu[s:s + chunk_size], ii[s:s + chunk_size],
                   v_kept[s:s + chunk_size])

    return InteractionData(user_ids, item_ids, chunk_factory, n_events)

def _vocab_add(vocab: Dict[str, int], keys) -> None:
    """First-seen dense index assignment (shared vocabulary pass)."""
    for k in keys:
        if k not in vocab:
            vocab[k] = len(vocab)


def _map_chunk(users: Dict[str, int], items: Dict[str, int],
               ents, tgts) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Map one chunk's string ids through the vocabularies. Events
    ingested AFTER the vocabulary pass may carry unknown ids (training
    against a live store re-runs find() per pass); they are skipped,
    not crashed on — the next train picks them up. Returns
    ``(user_idx, item_idx, keep_mask)`` so callers can mask parallel
    value columns."""
    u = np.asarray([users.get(x, -1) for x in ents], np.int32)
    i = np.asarray([items.get(x, -1) for x in tgts], np.int32)
    keep = (u >= 0) & (i >= 0)
    return u[keep], i[keep], keep


def read_interactions(
    find: Callable[[], Iterator],
    chunk_size: int = 65536,
    value_fn: Optional[Callable[[Any], Optional[float]]] = None,
) -> InteractionData:
    """Two-pass streaming read of (user, item[, value]) interactions.

    ``find`` is a zero-argument callable returning a FRESH event
    iterator (it runs twice: vocabulary pass + data pass), e.g.
    ``lambda: event_store.find(app_name, ...)``. Memory is O(chunk +
    vocabulary) regardless of event-log size.
    """
    users: Dict[str, int] = {}
    items: Dict[str, int] = {}
    n_events = 0
    for ents, tgts, _vals in iter_columnar(find(), chunk_size, value_fn):
        _vocab_add(users, ents)
        _vocab_add(items, tgts)
        n_events += len(ents)
    user_ids = BiMap(users)
    item_ids = BiMap(items)

    def chunk_factory():
        for ents, tgts, vals in iter_columnar(find(), chunk_size, value_fn):
            u, i, keep = _map_chunk(users, items, ents, tgts)
            yield u, i, vals[keep]

    return InteractionData(user_ids, item_ids, chunk_factory, n_events)


def event_groups_from_columnar(
    cols: ColumnarEvents, names: Sequence[str],
) -> Tuple[Dict[str, Tuple[np.ndarray, np.ndarray]], BiMap, BiMap]:
    """Vectorized :func:`read_event_groups` result from a columnar
    scan: demuxing by event name is a mask over ``name_idx``, and the
    scan's first-seen id tables ARE the shared vocabulary pair (same
    encounter order as the generic two-pass reader — no value policy
    applies here, so no re-densify is needed)."""
    pos = {n: i for i, n in enumerate(cols.names)}
    out: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for n in names:
        i = pos.get(n)
        if i is None:
            out[n] = (np.zeros(0, np.int32), np.zeros(0, np.int32))
        else:
            m = cols.name_idx == i
            out[n] = (cols.entity_idx[m].astype(np.int32),
                      cols.target_idx[m].astype(np.int32))
    user_ids = BiMap({s: k for k, s in enumerate(cols.entity_ids)})
    item_ids = BiMap({s: k for k, s in enumerate(cols.target_ids)})
    return out, user_ids, item_ids


def read_event_groups(
    find: Callable[[], Iterator],
    names: Sequence[str],
    chunk_size: int = 65536,
) -> Tuple[Dict[str, Tuple[np.ndarray, np.ndarray]], BiMap, BiMap]:
    """Multi-event streaming read with ONE SHARED vocabulary pair —
    the Universal-Recommender shape: several named event streams over
    the same user/item spaces, index-mapped consistently.

    ``find`` is a zero-argument callable returning a FRESH iterator
    over ALL the named events (two combined scans total — vocabulary
    pass + data pass — demuxed by ``e.event``; per-name finds would
    cost 2·N scans of the log). Returns ``({name: (user_idx,
    item_idx)}, user_ids, item_ids)`` with ids assigned in
    encounter order. Memory is O(chunk + vocabulary) transient plus
    the 8 B/event columnar outputs."""
    wanted = set(names)
    users: Dict[str, int] = {}
    items: Dict[str, int] = {}
    for e in find():
        if not e.target_entity_id or e.event not in wanted:
            continue
        if e.entity_id not in users:
            users[e.entity_id] = len(users)
        if e.target_entity_id not in items:
            items[e.target_entity_id] = len(items)
    user_ids = BiMap(users)
    item_ids = BiMap(items)

    bufs: Dict[str, Tuple[List[str], List[str]]] = \
        {n: ([], []) for n in names}
    parts: Dict[str, Tuple[list, list]] = {n: ([], []) for n in names}

    def flush(name: str) -> None:
        ents, tgts = bufs[name]
        if ents:
            u, i, _keep = _map_chunk(users, items, ents, tgts)
            parts[name][0].append(u)
            parts[name][1].append(i)
            bufs[name] = ([], [])

    for e in find():
        if not e.target_entity_id or e.event not in wanted:
            continue
        ents, tgts = bufs[e.event]
        ents.append(e.entity_id)
        tgts.append(e.target_entity_id)
        if len(ents) == chunk_size:
            flush(e.event)
    out: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for n in names:
        flush(n)
        us, is_ = parts[n]
        out[n] = ((np.concatenate(us) if us else np.zeros(0, np.int32)),
                  (np.concatenate(is_) if is_ else np.zeros(0, np.int32)))
    return out, user_ids, item_ids


def subset_columnar(
    mask: np.ndarray,
    user_idx: np.ndarray,
    item_idx: np.ndarray,
    user_ids: BiMap,
    item_ids: BiMap,
    *values: np.ndarray,
) -> tuple:
    """Rows where ``mask`` holds, with both vocabularies TRIMMED to the
    entities present and the index columns re-mapped to the trimmed
    maps. The eval-fold primitive: a training fold must NOT know the
    held-out fold's cold users/items (they would score 0.0 instead of
    being skipped by the OptionAverageMetric convention).

    Returns ``(user_idx, item_idx, user_ids, item_ids, *values)`` with
    each extra ``values`` column masked alongside.
    """
    uu, ii = user_idx[mask], item_idx[mask]
    uniq_u = np.unique(uu)
    uniq_i = np.unique(ii)
    lut_u = np.full(len(user_ids), -1, np.int32)
    lut_u[uniq_u] = np.arange(len(uniq_u), dtype=np.int32)
    lut_i = np.full(len(item_ids), -1, np.int32)
    lut_i[uniq_i] = np.arange(len(uniq_i), dtype=np.int32)
    u_inv = user_ids.inverse()
    i_inv = item_ids.inverse()
    return (lut_u[uu], lut_i[ii],
            BiMap({u_inv[int(u)]: int(j) for j, u in enumerate(uniq_u)}),
            BiMap({i_inv[int(i)]: int(j) for j, i in enumerate(uniq_i)}),
            *(v[mask] for v in values))


PREFETCH_DEPTH = 2


class DevicePrefetcher:
    """Double-buffered host → device transfer over an iterator.

    A background thread pulls the next item (a numpy array or a tuple of
    them) and, for a CUDA ``device``, copies it into pinned host buffers
    and on to the card ``non_blocking`` on a side CUDA stream, while the
    consumer computes on the current item. The consumer's stream waits on
    that copy before an item is handed out, so it is safe to use at once.
    With ``PREFETCH_DEPTH`` items in flight the device never waits on host
    decode unless the host is genuinely slower end to end. ``device`` is CUDA
    unless the caller names another (raising without a card); on the
    CPU the items pass through as the host arrays they are.

    Iterate it, or use as a context manager to guarantee the thread
    shuts down on early exit. Exceptions from the source re-raise at the
    consumer.
    """

    _DONE = object()

    def __init__(self, source: Iterator, device: Any = None) -> None:
        import torch

        from predictionio_tpu_torch.utils.device import resolve_device

        self._source = source
        self._device = resolve_device(device)
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device.type == "cuda" else None)
        self._q: "queue.Queue" = queue.Queue(maxsize=PREFETCH_DEPTH)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="pio-prefetch")
        self._thread.start()

    def _put_device(self, item):
        """(item on the device, the copy's CUDA event or None)."""
        import torch

        if self._stream is None:
            return item, None

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).pin_memory().to(
                self._device, non_blocking=True)

        with torch.cuda.stream(self._stream):
            out = (tuple(put(a) for a in item) if isinstance(item, tuple)
                   else put(item))
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _run(self) -> None:
        try:
            for item in self._source:
                if self._stop.is_set():
                    return
                item = self._put_device(item)
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
            self._q.put(self._DONE)
        except BaseException as e:  # propagate to the consumer
            # retried like the success path: dropping the exception when
            # the queue is momentarily full would end the thread with
            # neither the error nor the DONE sentinel, and the consumer
            # would wait forever
            while not self._stop.is_set():
                try:
                    self._q.put(e, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        import torch

        got = self._q.get()
        if got is self._DONE:
            raise StopIteration
        if isinstance(got, BaseException):
            raise got
        item, event = got
        if event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            # the caching allocator must not hand these blocks to the
            # side stream again before the consumer's work on them ends
            for t in (item if isinstance(item, tuple) else (item,)):
                t.record_stream(stream)
        return item

    def close(self) -> None:
        self._stop.set()
        # drain so the producer can observe the stop flag
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
