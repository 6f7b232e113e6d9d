"""EVENTLOG backend: the event store on the native C++ log engine.

The port's copy of the JAX package's ``data/filestore.py``. The engine
(:mod:`predictionio_tpu_torch.native`, ``eventlog.cc``, a byte-equal
copy of the JAX package's) keeps an append-only framed binary log per
(app, channel) namespace with an in-memory index; filtered scans, the
columnar training read and the ``$set/$unset/$delete`` property fold
run in C++, so a training read builds no per-event Python object. The
on-disk layout is the JAX package's (``eventlog/events_<app>[_<ch>].pel``,
its ``.peld/`` segment directory, the writer shards
``events_<app>[_<ch>].s<k>.pel``), so a home written by one package is
read by the other.

Wire format (shared with the C++ side): see eventlog.cc's header comment.
One writer per namespace file; in-process thread safety through the
engine's per-handle mutex plus a per-namespace writer lock that covers
segment rollover (:mod:`predictionio_tpu_torch.data.segments`).

**Writer shards.** One ``(app, channel)`` namespace can fan its
active-segment appends across N writer shards (shard 0 is
``events_<app>[_<ch>].pel``; shard k ≥ 1 is
``events_<app>[_<ch>].s<k>.pel``), each a full
:class:`~predictionio_tpu_torch.data.segments.LogNamespace` with its own
writer lock, rollover, manifest and crash recovery. Raising the count
(``set_shard_policy``, fed by ``quotas.json``'s ``writer_shards``) only
routes new writes by entity hash; no data moves. Reads merge the shards:
``find()`` heapq-merges per-shard streams, ``scan_columnar`` chains every
shard's blocks into one
:func:`~predictionio_tpu_torch.data.pipeline.merge_columnar_segments`
call, and tombstones walk all shards.

``set_replicator`` attaches the event-plane replicator
(``data/replication.Replicator``, set by ``server/repl_server.ReplNode``
when this node leads): every committed append and every seal is pushed
to the followers under the namespace's writer lock, and a fenced node's
appends raise ``FencedWriteError`` before any byte lands.
"""

from __future__ import annotations

import ctypes
import datetime as _dt
import heapq
import itertools
import json
import os
import struct
import threading
import zlib
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from predictionio_tpu_torch.data.event import (
    Event,
    PropertyMap,
    validate_event,
)
from predictionio_tpu_torch.data.events import EventStore, _ts as _ts_us
from predictionio_tpu_torch.data.segments import (
    LogNamespace,
    SegmentMaintenance,
    scan_workers_default,
    segment_bytes_threshold,
)
from predictionio_tpu_torch.utils import faults, tracing

_UNBOUNDED_LO = -(2**62)
_UNBOUNDED_HI = 2**62


def _dt_us(us: int) -> _dt.datetime:
    return _dt.datetime.fromtimestamp(us / 1_000_000, tz=_dt.timezone.utc)


def _pack_str(s: Optional[str]) -> bytes:
    b = (s or "").encode("utf-8")
    return struct.pack("<I", len(b)) + b


def serialize_event(e: Event) -> bytes:
    """One framed kind-0 record ([u32 len][u8 kind=0][payload])."""
    payload = struct.pack("<qq", _ts_us(e.event_time), _ts_us(e.creation_time))
    payload += b"".join(_pack_str(s) for s in (
        e.event_id, e.event, e.entity_type, e.entity_id,
        e.target_entity_type, e.target_entity_id,
        (json.dumps(e.properties, separators=(",", ":"))
         if e.properties else "{}"),
        json.dumps(e.tags, separators=(",", ":")) if e.tags else "[]",
        e.pr_id,
    ))
    return struct.pack("<IB", len(payload) + 1, 0) + payload


_U32 = struct.Struct("<I")


def deserialize_payload(buf: bytes, off: int, plen: int) -> Event:
    # find()'s hot loop: one header unpack, a precompiled u32 struct
    # per string, bare __new__ instead of the 11-field dataclass
    # __init__, and no json.loads for the common empty properties/tags
    t_us, c_us = struct.unpack_from("<qq", buf, off)
    pos = off + 16
    unpack = _U32.unpack_from
    strs = []
    for _ in range(9):
        (n,) = unpack(buf, pos)
        pos += 4
        strs.append(buf[pos:pos + n].decode("utf-8"))
        pos += n
    assert pos == off + plen, "corrupt event payload"
    props = strs[6]
    tags = strs[7]
    e = object.__new__(Event)
    e.__dict__.update(
        event_id=strs[0],
        event=strs[1],
        entity_type=strs[2],
        entity_id=strs[3],
        target_entity_type=strs[4] or None,
        target_entity_id=strs[5] or None,
        properties={} if props == "{}" else json.loads(props),
        tags=[] if tags == "[]" else json.loads(tags),
        pr_id=strs[8] or None,
        event_time=_dt_us(t_us),
        creation_time=_dt_us(c_us),
    )
    return e


class NativeEventLogStore(EventStore):
    """Event store backed by the C++ append-only log engine."""

    def __init__(self, directory: str) -> None:
        from predictionio_tpu_torch import native

        # raises NativeBuildError (with g++'s stderr) when the engine
        # cannot be built: EVENTLOG data is never served by another store
        self._lib = native.eventlog_library()
        self._dir = directory
        os.makedirs(directory, exist_ok=True)
        # keyed (app_id, channel_id, shard) — shard 0 is the legacy
        # unsharded file, so existing deployments open unchanged
        self._namespaces: Dict[
            Tuple[int, Optional[int], int], LogNamespace] = {}
        self._lock = threading.RLock()
        # writer-shard policy (app_id -> shard count) and the per-key
        # count actually visible on disk (monotonic: reads must keep
        # covering shards even after a policy shrink)
        self._shard_policy: Optional[Callable[[int], int]] = None
        self._disk_shards: Dict[Tuple[int, Optional[int]], int] = {}
        from predictionio_tpu_torch.utils.metrics import REGISTRY

        self._m_shard_appends = REGISTRY.counter(
            "pio_eventlog_shard_appends_total",
            "Events appended per writer shard", ("app", "shard"))
        # segment rollover threshold (PIO_SEGMENT_BYTES; 0 disables) and
        # scan fan-out width (None → PIO_SCAN_WORKERS / cpu default)
        self.segment_bytes = segment_bytes_threshold()
        self.scan_workers: Optional[int] = None
        self._maintenance: Optional[SegmentMaintenance] = None
        # snapshot-cache key component: same directory ⇒ same log
        self.cache_identity = "eventlog:" + os.path.abspath(directory)
        # floor for append_jsonl's defaulted timestamps — a chunk
        # reserves [now_us, now_us + n_lines) so consecutive chunks
        # never interleave even when the wall clock stalls or steps back
        self._now_floor = 0
        # durable-ack mode: fsync after each append call (one sync per
        # group commit, not per event — pel_sync covers the whole batch)
        self._durable = False
        # leader-side replication (data/replication.Replicator): when
        # set, every committed mutation pushes its active-file tail to
        # the followers before the call returns, and a fenced
        # ex-leader's writes are refused before any byte lands
        self._replicator = None

    def set_durable(self, durable: bool = True) -> None:
        self._durable = durable

    def set_replicator(self, replicator) -> None:
        """Attach (or detach, with None) the event-plane replicator.
        Hooks run under each namespace's writer lock, so followers see
        mutations in exactly the commit order."""
        self._replicator = replicator

    def _repl_commit(self, ns: LogNamespace) -> None:
        """Post-append tail of every write path (must hold ns.lock):
        push the new active-file bytes to the followers, then roll if
        over threshold — and if rolled, ship the seal (digest included)
        so the follower renames its byte-identical copy in lockstep."""
        r = self._replicator
        if r is None:
            ns.maybe_roll(self.segment_bytes)
            return
        r.on_append(ns)
        if ns.maybe_roll(self.segment_bytes):
            r.on_seal(ns, ns.sealed[-1])

    # -- plumbing ----------------------------------------------------------

    def _stem(self, app_id: int, channel_id: Optional[int]) -> str:
        return f"events_{app_id}" + (
            f"_{channel_id}" if channel_id is not None else "")

    def _path(self, app_id: int, channel_id: Optional[int],
              shard: int = 0) -> str:
        name = self._stem(app_id, channel_id)
        if shard:
            name += f".s{shard}"
        return os.path.join(self._dir, name + ".pel")

    def _ns(self, app_id: int, channel_id: Optional[int],
            shard: int = 0) -> LogNamespace:
        key = (app_id, channel_id, shard)
        with self._lock:
            ns = self._namespaces.get(key)
            if ns is None:
                # PIO_EVENTLOG_FORMAT=1 writes legacy (un-checksummed)
                # frames into fresh files (the JAX package's switch).
                # Existing files always keep their on-disk format.
                fmt = 1 if os.environ.get(
                    "PIO_EVENTLOG_FORMAT", "2") == "1" else 2
                ns = LogNamespace(
                    self._lib, self._path(app_id, channel_id, shard), fmt)
                self._namespaces[key] = ns
                self._account_recovery(ns.h)
                if shard:
                    dk = (app_id, channel_id)
                    self._disk_shards[dk] = max(
                        self._disk_shards.get(dk, 1), shard + 1)
            return ns

    def _handle(self, app_id: int, channel_id: Optional[int]) -> int:
        """The ACTIVE segment's engine handle (writer shard 0)."""
        return self._ns(app_id, channel_id).h

    # -- writer sharding ---------------------------------------------------

    def set_shard_policy(
            self, policy: Optional[Callable[[int], int]]) -> None:
        """Install the writer-shard policy: ``policy(app_id)`` names
        how many ACTIVE writer shards that app's namespaces fan NEW
        appends across. Raising the count is a writer-lock-free split
        (new shard files appear on first write); lowering it only
        redirects new writes — existing shard files keep being read."""
        self._shard_policy = policy

    def _discovered_shards(self, app_id: int,
                           channel_id: Optional[int]) -> int:
        """Shard files present on disk for this namespace (>= 1), so a
        restarted store (or a shrunk policy) still reads every shard."""
        key = (app_id, channel_id)
        with self._lock:
            n = self._disk_shards.get(key)
            if n is None:
                n = 1
                prefix = self._stem(app_id, channel_id) + ".s"
                try:
                    names = os.listdir(self._dir)
                except OSError:
                    names = []
                for name in names:
                    if name.startswith(prefix) and name.endswith(".pel"):
                        idx = name[len(prefix):-4]
                        if idx.isdigit():
                            n = max(n, int(idx) + 1)
                self._disk_shards[key] = n
            return n

    def _shard_count(self, app_id: int, channel_id: Optional[int]) -> int:
        """Shards READS must cover: max(policy, what's on disk)."""
        want = 1
        if self._shard_policy is not None:
            try:
                want = max(1, int(self._shard_policy(app_id)))
            except Exception:
                want = 1
        return max(want, self._discovered_shards(app_id, channel_id))

    def _write_shards(self, app_id: int) -> int:
        """Shards NEW writes fan across (policy only)."""
        if self._shard_policy is None:
            return 1
        try:
            return max(1, int(self._shard_policy(app_id)))
        except Exception:
            return 1

    def _all_ns(self, app_id: int,
                channel_id: Optional[int]) -> List[LogNamespace]:
        return [self._ns(app_id, channel_id, s)
                for s in range(self._shard_count(app_id, channel_id))]

    def _pick_shard(self, entity_id: str, n: int) -> int:
        if n <= 1:
            return 0
        try:
            # chaos drill: an armed error collapses the hash — every
            # append lands on shard 0, the visible hot-shard signature
            # (watch pio_eventlog_shard_appends_total skew)
            faults.inject("segments.shard.hot")
        except faults.FaultError:
            return 0
        return zlib.crc32((entity_id or "").encode("utf-8")) % n

    def namespaces(self) -> List[LogNamespace]:
        with self._lock:
            return list(self._namespaces.values())

    def _scan_workers(self) -> int:
        return (self.scan_workers if self.scan_workers
                else scan_workers_default())

    def start_maintenance(self, interval: float = 30.0,
                          keep_local: int = 2) -> SegmentMaintenance:
        """Start (or return) the background compaction/cold-tier
        maintenance thread for this store."""
        with self._lock:
            if self._maintenance is None or not self._maintenance.is_alive():
                self._maintenance = SegmentMaintenance(
                    self, interval=interval, keep_local=keep_local)
                self._maintenance.start()
            return self._maintenance

    def _account_recovery(self, h: int) -> None:
        """Surface the engine's open-time recovery report (pel_info)
        as integrity metrics: checksum-failed records and quarantined
        torn tails must be visible on /metrics, not only on stderr."""
        from predictionio_tpu_torch.utils.integrity import (
            INTEGRITY_FAILED,
            QUARANTINED,
        )

        corrupt = ctypes.c_longlong(0)
        torn = ctypes.c_longlong(-1)
        quarantined = ctypes.c_longlong(0)
        self._lib.pel_info(h, None, ctypes.byref(corrupt),
                           ctypes.byref(torn), ctypes.byref(quarantined))
        if corrupt.value > 0:
            INTEGRITY_FAILED.inc(("eventlog",), corrupt.value)
        if torn.value >= 0:
            QUARANTINED.inc(("eventlog",))

    def _take(self, ptr: ctypes.c_void_p, length: int) -> bytes:
        try:
            return ctypes.string_at(ptr, length)
        finally:
            self._lib.pel_free(ptr)

    # -- lifecycle ----------------------------------------------------------

    def init_channel(self, app_id: int, channel_id: Optional[int] = None) -> None:
        self._ns(app_id, channel_id)

    def remove_channel(self, app_id: int, channel_id: Optional[int] = None) -> None:
        shards = self._shard_count(app_id, channel_id)
        with self._lock:
            for s in range(shards):
                ns = self._namespaces.pop((app_id, channel_id, s), None)
                if ns is not None:
                    ns.remove()
                else:
                    try:
                        os.unlink(self._path(app_id, channel_id, s))
                    except FileNotFoundError:
                        pass
            self._disk_shards.pop((app_id, channel_id), None)

    def close(self) -> None:
        with self._lock:
            if self._maintenance is not None:
                self._maintenance.stop()
                self._maintenance = None
            for ns in self._namespaces.values():
                ns.close()
            self._namespaces.clear()

    # -- writes -------------------------------------------------------------

    def insert(self, event: Event, app_id: int, channel_id: Optional[int] = None) -> str:
        return self.insert_batch([event], app_id, channel_id)[0]

    # frames per native append call: bounds the joined buffer (and the
    # engine's single locked write) when a group commit or `pio import`
    # hands over a very large batch
    _APPEND_CHUNK = 8192

    def insert_batch(
        self, events: Sequence[Event], app_id: int, channel_id: Optional[int] = None
    ) -> List[str]:
        # validate every event BEFORE appending any: an append-only log
        # has no rollback, so a bad event mid-batch must fail the call
        # without leaving a partial prefix behind
        n_shards = self._write_shards(app_id)
        frames = []
        ids = []
        client_ids = []
        shards = []
        for e in events:
            validate_event(e)
            if e.event_id:
                # caller-supplied id: may overwrite a copy that now
                # lives in a sealed segment (generated ids cannot)
                client_ids.append(e.event_id)
            shards.append(self._pick_shard(e.entity_id, n_shards))
            e = e.with_id()
            frames.append(serialize_event(e))
            ids.append(e.event_id)
        if n_shards <= 1 and self._shard_count(app_id, channel_id) <= 1:
            self._append_frames(self._ns(app_id, channel_id), frames,
                                client_ids)
            return ids  # type: ignore[return-value]
        # sharded namespace: group frames per writer shard, append each
        # group under ITS OWN shard lock — concurrent batches for the
        # same hot app pipeline across shards instead of serializing
        groups: Dict[int, List[bytes]] = {}
        for frame, shard in zip(frames, shards):
            groups.setdefault(shard, []).append(frame)
        for shard in sorted(groups):
            self._append_frames(self._ns(app_id, channel_id, shard),
                                groups[shard], client_ids=None)
            self._m_shard_appends.inc((app_id, shard),
                                      n=len(groups[shard]))
        if client_ids:
            # a client-supplied id's previous copy may live in ANY
            # shard (the shard count can change across an id's
            # lifetime): tombstone sealed copies everywhere, delete
            # active copies in every shard the new copy did NOT go to
            dest = {e.event_id: s
                    for e, s in zip(events, shards) if e.event_id}
            for s, ns in enumerate(self._all_ns(app_id, channel_id)):
                with ns.lock:
                    for eid in client_ids:
                        if dest.get(eid) == s:
                            continue  # engine overwrote in-place here
                        b = eid.encode()
                        self._lib.pel_delete(ns.h, b, len(b))
                    if ns.sealed:
                        ns.tombstone_sealed(client_ids)
                    if self._replicator is not None:
                        # cross-shard tombstones are appended frames:
                        # ship them so followers converge per shard
                        self._replicator.on_append(ns)
        return ids  # type: ignore[return-value]

    def _append_frames(self, ns: LogNamespace, frames: List[bytes],
                       client_ids: Optional[List[str]]) -> None:
        # per-namespace writer lock: appends to different (app, channel)
        # partitions — and different writer shards of one hot partition
        # — never contend; rollover swaps the active handle under the
        # same lock
        if self._replicator is not None:
            self._replicator.check_fenced()
        with ns.lock:
            h = ns.h
            for lo in range(0, len(frames), self._APPEND_CHUNK):
                chunk = frames[lo:lo + self._APPEND_CHUNK]
                buf = b"".join(chunk)
                n = self._lib.pel_append_batch(h, buf, len(buf), len(chunk))
                if n != len(chunk):
                    raise IOError(
                        f"event log append failed ({lo + n}/{len(frames)})")
            if self._durable and self._lib.pel_sync(h) != 0:
                raise IOError("event log fsync failed")
            if client_ids and ns.sealed:
                # propagate overwrites into sealed segments; cold
                # segments are probed through their ship-time id
                # filters, so a brand-new id never stalls the writer
                # lock behind a cold-tier fetch
                ns.tombstone_sealed(client_ids)
            self._repl_commit(ns)

    def append_jsonl(
        self, lines: bytes, n_lines: int, app_id: int,
        channel_id: Optional[int] = None,
    ) -> Tuple[int, List[int]]:
        """Native NDJSON ingest (`pio import` hot path): parse + frame
        + append entirely in C++ for lines matching the strict common
        shape; returns ``(appended, fallback_line_numbers)`` — the
        caller routes fallback lines (blank = skipped silently; hairy
        OR invalid shapes) through ``Event.from_json`` + ``insert``,
        which applies the full validation semantics. The C++ grammar
        is strictly narrower than the Python parser, so the native
        path can never accept what Python would reject.

        Interleaving note: natively-accepted lines land before the
        caller's fallback inserts; `find()` ordering is by
        (eventTime, creationTime, seq), so only events with identical
        timestamps down to the microsecond can observe the reorder.

        Lines without their own eventTime/creationTime default to
        ``now_us + line_index`` (assigned in C++), so within-chunk
        arrival order survives the time sort and creationTime
        watermarks are strictly monotonic; the store-level floor below
        extends that guarantee across chunks.

        Bulk import always appends to writer shard 0 (the serving-path
        hot-partition problem sharding solves does not apply to a
        offline import); reads merge shard 0 with the others as usual.
        """
        import time as _time

        if self._replicator is not None:
            self._replicator.check_fenced()
        ns = self._ns(app_id, channel_id)
        status = ctypes.create_string_buffer(n_lines)
        now_us = int(_time.time() * 1e6)
        with self._lock:
            if now_us < self._now_floor:
                now_us = self._now_floor
            self._now_floor = now_us + n_lines
        seed = int.from_bytes(os.urandom(8), "little")
        # custom eventIds may overwrite copies living in sealed
        # segments: collect the accepted ids so tombstones propagate
        want_ids = bool(ns.sealed) and b'"eventId"' in lines
        ids_out = (ctypes.create_string_buffer(32 * n_lines)
                   if want_ids else None)
        with ns.lock:
            h = ns.h
            n = self._lib.pel_append_jsonl(
                h, lines, len(lines), now_us, seed, status, n_lines,
                ids_out)
            if n < 0:
                raise IOError("event log jsonl append failed")
            if self._durable and self._lib.pel_sync(h) != 0:
                raise IOError("event log fsync failed")
            if want_ids and n > 0:
                ids = []
                raw = ids_out.raw  # type: ignore[union-attr]
                unresolved = []
                for i in range(n_lines):
                    if status.raw[i] != 0:
                        continue
                    slot = raw[i * 32:(i + 1) * 32]
                    if slot[0]:
                        ids.append(slot.rstrip(b"\x00").decode())
                    else:
                        # non-32-char custom id: the engine cannot
                        # report it — recover it from the line itself
                        unresolved.append(i)
                if unresolved:
                    split = lines.split(b"\n")
                    for i in unresolved:
                        try:
                            eid = json.loads(split[i]).get("eventId")
                            if eid:
                                ids.append(eid)
                        except (ValueError, IndexError):
                            pass
                if ids:
                    ns.tombstone_sealed(ids)
            self._repl_commit(ns)
        fallback = [i for i in range(n_lines) if status.raw[i] == 1]
        return int(n), fallback

    def delete(self, event_id: str, app_id: int, channel_id: Optional[int] = None) -> bool:
        if self._replicator is not None:
            self._replicator.check_fenced()
        b = event_id.encode()
        deleted = False
        # the live copy sits in at most one segment of one shard, but a
        # resharded id may have stale copies elsewhere — walk them all
        for ns in self._all_ns(app_id, channel_id):
            with ns.lock:
                r = self._lib.pel_delete(ns.h, b, len(b))
                if r < 0:
                    raise IOError("event log delete failed")
                if r:
                    deleted = True
                    if self._replicator is not None:
                        # the tombstone is an APPENDED frame — same
                        # tail-ship as any other committed mutation
                        self._replicator.on_append(ns)
                    continue
            if ns.sealed and ns.tombstone_sealed([event_id]):
                deleted = True
        return deleted

    def wipe(self, app_id: int, channel_id: Optional[int] = None) -> None:
        for s, ns in enumerate(self._all_ns(app_id, channel_id)):
            if not ns.wipe():
                # the active handle may have lost its backing FILE* —
                # drop the namespace so the next call reopens instead
                # of segfaulting
                with self._lock:
                    if self._namespaces.pop(
                            (app_id, channel_id, s), None) is not None:
                        ns.close()
                raise IOError("event log wipe failed")

    # -- reads --------------------------------------------------------------

    def get(self, event_id: str, app_id: int, channel_id: Optional[int] = None) -> Optional[Event]:
        b = event_id.encode()
        for ns in self._all_ns(app_id, channel_id):
            # active first (freshest copy), then sealed newest→oldest
            for h in itertools.chain(
                    (ns.h,),
                    (ns.handle_for(seg) for seg in ns.sealed[::-1])):
                out = ctypes.c_void_p()
                n = self._lib.pel_get(h, b, len(b), ctypes.byref(out))
                if n < 0:
                    raise IOError("event log get failed")
                if n:
                    payload = self._take(out, n)
                    return deserialize_payload(payload, 0, len(payload))
        return None

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
        ns_list = self._all_ns(app_id, channel_id)
        args = (
            _ts_us(start_time) if start_time else _UNBOUNDED_LO,
            _ts_us(until_time) if until_time else _UNBOUNDED_HI,
            entity_type.encode() if entity_type is not None else None,
            entity_id.encode() if entity_id is not None else None,
            target_entity_type.encode() if target_entity_type is not None else None,
            target_entity_id.encode() if target_entity_id is not None else None,
            "\n".join(event_names).encode() if event_names is not None else None,
            bool(reversed),
            limit if (limit is not None and limit >= 0) else -1,
        )
        if len(ns_list) == 1 and not ns_list[0].sealed:
            yield from self._find_one(ns_list[0].h, *args)
            return
        # each segment returns its matches already (eventTime,
        # creationTime)-sorted; a stable k-way merge preserves the
        # global order. Ties fall back to iterable order, so segments
        # are listed in append order (reversed for descending scans) —
        # identical to what a single-file scan's seq tiebreak yields,
        # because rollover never splits identical (time, creation)
        # runs across a seq inversion. Writer shards join the same
        # merge (shard order breaks cross-shard ties — events with
        # identical timestamps down to the microsecond).
        streams = []
        for ns in ns_list:
            if reversed:
                handles = itertools.chain(
                    (ns.h,), (ns.handle_for(s) for s in ns.sealed[::-1]))
            else:
                handles = itertools.chain(
                    (ns.handle_for(s) for s in ns.sealed), (ns.h,))
            streams.extend(self._find_one(h, *args) for h in handles)
        merged = heapq.merge(
            *streams,
            key=lambda e: (e.event_time, e.creation_time),
            reverse=bool(reversed))
        if args[-1] >= 0:
            merged = itertools.islice(merged, args[-1])
        yield from merged

    def _find_one(self, h: int, start_us: int, until_us: int,
                  entity_type: Optional[bytes], entity_id: Optional[bytes],
                  target_entity_type: Optional[bytes],
                  target_entity_id: Optional[bytes], names: Optional[bytes],
                  rev: bool, limit: int) -> Iterator[Event]:
        out = ctypes.c_void_p()
        n = self._lib.pel_find(
            h, start_us, until_us, entity_type, entity_id,
            target_entity_type, target_entity_id, names,
            1 if rev else 0, limit, ctypes.byref(out))
        if n < 0:
            raise IOError("event log scan failed")
        buf = self._take(out, n)
        pos = 0
        while pos < len(buf):
            (plen,) = struct.unpack_from("<I", buf, pos)
            pos += 4
            yield deserialize_payload(buf, pos, plen)
            pos += plen

    def iter_jsonl_chunks(
        self, app_id: int, channel_id: Optional[int] = None,
        chunk_events: int = 100_000,
    ) -> Iterator[str]:
        """Native `pio export`: stream the namespace as NDJSON text
        chunks straight from C++ (Event.to_json_str key order;
        json-loads-equal — raw property spans re-emit verbatim). The
        cursor walks the time-sorted order; don't interleave writes."""
        ns = self._ns(app_id, channel_id)
        if ns.sealed or self._shard_count(app_id, channel_id) > 1:
            # partitioned/sharded namespace: the native export cursor
            # is per-file, so stream the merged find() order instead
            it = self.find(app_id, channel_id)
            while True:
                batch = list(itertools.islice(it, chunk_events))
                if not batch:
                    return
                yield "".join(e.to_json_str() + "\n" for e in batch)
        h = ns.h
        cursor = 0
        while True:
            out = ctypes.c_void_p()
            blob_len = ctypes.c_longlong()
            visited = self._lib.pel_export_jsonl(
                h, cursor, chunk_events, ctypes.byref(out),
                ctypes.byref(blob_len))
            if visited < 0:
                raise IOError("event log export failed")
            if visited == 0:
                return  # cursor past the end; nothing was allocated
            # visited ≠ emitted: a chunk of unreadable records yields
            # an empty blob but the walk continues
            text = self._take(out, blob_len.value).decode("utf-8")
            if text:
                yield text
            cursor += visited

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
        """Columnar training read: numpy arrays + deduped id tables,
        no per-event Python objects (the HBase-scan→RDD[Rating]
        analogue — the whole scan/parse/dedup runs in C++). Returns a
        :class:`~predictionio_tpu_torch.data.pipeline.ColumnarEvents`, or
        None when the engine declines (>65535 distinct event names) —
        callers fall back to the generic ``find()`` path.

        ``value_key`` extracts one top-level numeric property per event
        (the shared decimal grammar — numbers, bools, plain decimal
        strings; NaN = absent/malformed, same drop rule as the generic
        path's ``data/store._parse_value``) so rating-style reads
        avoid a JSON pass in Python entirely.

        ``created_after_us`` (exclusive) / ``created_until_us``
        (inclusive) bound creationTime — the snapshot cache's delta
        window, filtered off the in-memory index in C++.
        """
        import numpy as np

        from predictionio_tpu_torch.data.pipeline import ColumnarEvents

        ns_list = self._all_ns(app_id, channel_id)
        ns = ns_list[0]
        if len(ns_list) > 1 or ns.sealed:
            # partitioned and/or writer-sharded namespace: fan the scan
            # out across every shard's segments (sidecar-served where
            # compacted) and feed ALL block streams through ONE merge —
            # identical to a single-file scan of the union
            from predictionio_tpu_torch.data.pipeline import (
                merge_columnar_segments,
            )

            scan_args = (
                _ts_us(start_time) if start_time else _UNBOUNDED_LO,
                _ts_us(until_time) if until_time else _UNBOUNDED_HI,
                created_after_us if created_after_us is not None
                else _UNBOUNDED_LO,
                created_until_us if created_until_us is not None
                else _UNBOUNDED_HI,
                entity_type, target_entity_type,
                list(event_names) if event_names is not None else None,
                value_key)
            workers = self._scan_workers()
            cols = merge_columnar_segments(itertools.chain.from_iterable(
                n.scan_blocks(*scan_args, workers=workers)
                for n in ns_list))
            if cols is not None:
                detail = [s for n in ns_list
                          for s in (n.last_scan or {}).get(
                              "per_segment", [])]
                tracing.add_attrs(
                    scan_backend="eventlog",
                    scan_bytes=sum(s["bytes"] for s in detail),
                    scan_records=int(cols.n),
                    scan_shards=len(ns_list))
            return cols

        h = ns.h
        out = ctypes.c_void_p()
        names = ("\n".join(event_names).encode()
                 if event_names is not None else None)
        n = self._lib.pel_scan_columnar(
            h,
            _ts_us(start_time) if start_time else _UNBOUNDED_LO,
            _ts_us(until_time) if until_time else _UNBOUNDED_HI,
            created_after_us if created_after_us is not None
            else _UNBOUNDED_LO,
            created_until_us if created_until_us is not None
            else _UNBOUNDED_HI,
            entity_type.encode() if entity_type is not None else None,
            target_entity_type.encode() if target_entity_type is not None
            else None,
            names,
            value_key.encode() if value_key is not None else None,
            ctypes.byref(out),
        )
        if n == -2:
            return None  # engine declined; use the generic path
        if n < 0:
            raise IOError("event log columnar scan failed")
        buf = self._take(out, n)

        def table(off: int, count: int):
            strs = []
            for _ in range(count):
                (sl,) = _U32.unpack_from(buf, off)
                off += 4
                strs.append(buf[off:off + sl].decode("utf-8"))
                off += sl
            return strs, off + (-off % 8)

        ne, n_ent, n_tgt, n_nam = struct.unpack_from("<QQQQ", buf, 0)
        tracing.add_attrs(scan_backend="eventlog", scan_bytes=int(n),
                          scan_records=int(ne), scan_segments=1,
                          scan_segments_pruned=0)
        ns.last_scan = {
            "segments": 1, "pruned": 0,
            "per_segment": [{"segment": -1, "source": "active",
                             "records": int(ne), "bytes": int(n)}]}
        off = 32
        times = np.frombuffer(buf, "<i8", ne, off); off += 8 * ne
        values = np.frombuffer(buf, "<f8", ne, off); off += 8 * ne
        ent_idx = np.frombuffer(buf, "<u4", ne, off); off += 4 * ne
        off += -off % 8
        tgt_idx = np.frombuffer(buf, "<u4", ne, off); off += 4 * ne
        off += -off % 8
        name_idx = np.frombuffer(buf, "<u2", ne, off); off += 2 * ne
        off += -off % 8
        names_t, off = table(off, n_nam)
        ents_t, off = table(off, n_ent)
        tgts_t, off = table(off, n_tgt)
        return ColumnarEvents(
            entity_idx=ent_idx, target_idx=tgt_idx, name_idx=name_idx,
            values=values, times_us=times,
            entity_ids=ents_t, target_ids=tgts_t, names=names_t)

    def creation_stats(
        self, app_id: int, channel_id: Optional[int] = None,
        until_us: Optional[int] = None,
    ) -> Optional[Tuple[int, Optional[int]]]:
        """(live count, max creationTime µs) with creationTime ≤
        ``until_us`` — the snapshot cache's watermark/invalidation
        probe, answered from the in-memory index with no payload IO.
        For partitioned namespaces sealed segments answer from their
        manifest bounds where the window covers them entirely."""
        bound = until_us if until_us is not None else _UNBOUNDED_HI
        total = 0
        max_c: Optional[int] = None
        for ns in self._all_ns(app_id, channel_id):
            if ns.sealed:
                t, m = ns.creation_stats(bound)
            else:
                max_out = ctypes.c_longlong(0)
                n = self._lib.pel_creation_stats(
                    ns.h, bound, ctypes.byref(max_out))
                t, m = (int(n), int(max_out.value)) if n > 0 else (0, None)
            total += t
            if m is not None and (max_c is None or m > max_c):
                max_c = m
        return (total, max_c) if total else (0, None)

    # -- derived (native fold) ------------------------------------------------

    def aggregate_properties(
        self,
        app_id: int,
        entity_type: str,
        channel_id: Optional[int] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
    ) -> Dict[str, PropertyMap]:
        ns = self._ns(app_id, channel_id)
        if ns.sealed or self._shard_count(app_id, channel_id) > 1:
            # the native fold is per-file; $set/$unset/$delete order
            # across segments (and writer shards) matters, so fold the
            # merged find() stream through the generic path instead
            return super().aggregate_properties(
                app_id, entity_type, channel_id=channel_id,
                start_time=start_time, until_time=until_time)
        h = ns.h
        out = ctypes.c_void_p()
        n = self._lib.pel_aggregate(
            h, entity_type.encode(),
            _ts_us(start_time) if start_time else _UNBOUNDED_LO,
            _ts_us(until_time) if until_time else _UNBOUNDED_HI,
            ctypes.byref(out),
        )
        if n < 0:
            raise IOError("event log aggregate failed")
        folded = json.loads(self._take(out, n).decode("utf-8"))
        return {
            eid: PropertyMap(v["p"], _dt_us(v["f"]), _dt_us(v["l"]))
            for eid, v in folded.items()
        }
