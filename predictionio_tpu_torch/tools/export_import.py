"""Event export/import: events ↔ JSONL files.

The port's copy of the JAX package's ``tools/export_import.py``
(reference: [U] tools/.../export/EventsToFile.scala and
tools/.../imprt/FileToEvents.scala): streaming host-side JSONL, one event
per line in the wire format, so a file one package exports the other
imports, and both export the same bytes from the same events. On the
EVENTLOG backend export streams NDJSON chunks straight from C++
(``iter_jsonl_chunks``) and import feeds ~8 MB NDJSON chunks to the
engine (``append_jsonl``); only the lines its strict grammar declines go
through ``Event.from_json`` and ``insert_batch``. Other backends go
through ``find()`` and ``insert_batch``.
"""

from __future__ import annotations

import json
from typing import Optional, TextIO

from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.storage.registry import Storage, get_storage

# each insert_batch is one storage transaction: 10k-event batches
# amortize the commit (memory: ~10 MB of rows)
BATCH = 10_000


def export_events(
    app_id: int,
    out: TextIO,
    channel_id: Optional[int] = None,
    storage: Optional[Storage] = None,
) -> int:
    st = storage or get_storage()
    iter_chunks = getattr(st.events, "iter_jsonl_chunks", None)
    if iter_chunks is not None:
        # native path: C++ emits the NDJSON text directly (same key
        # order as Event.to_json_str, json-loads-equal lines)
        n = 0
        for chunk in iter_chunks(app_id, channel_id):
            out.write(chunk)
            n += chunk.count("\n")
        return n
    n = 0
    for ev in st.events.find(app_id, channel_id):
        out.write(ev.to_json_str() + "\n")
        n += 1
    return n


def import_events(
    app_id: int,
    src: TextIO,
    channel_id: Optional[int] = None,
    storage: Optional[Storage] = None,
) -> int:
    st = storage or get_storage()
    st.events.init_channel(app_id, channel_id)
    append_jsonl = getattr(st.events, "append_jsonl", None)
    if append_jsonl is not None:
        return _import_native(st, append_jsonl, src, app_id, channel_id)
    n = 0
    batch = []
    for line in src:
        line = line.strip()
        if not line:
            continue
        batch.append(Event.from_json(json.loads(line)))
        if len(batch) >= BATCH:
            st.events.insert_batch(batch, app_id, channel_id)
            n += len(batch)
            batch = []
    if batch:
        st.events.insert_batch(batch, app_id, channel_id)
        n += len(batch)
    return n


def _import_native(st, append_jsonl, src: TextIO, app_id: int,
                   channel_id: Optional[int]) -> int:
    """Feed raw NDJSON chunks to the store's native ingest; only lines
    the strict C++ grammar declines (unusual shapes — and anything
    invalid, so errors surface with the proper Python message) go
    through the ``Event.from_json`` path.

    Failure semantics (same class as the legacy loop, which committed
    10k-event batches before a bad line raised): an invalid line
    aborts the import with everything already-appended persisted —
    here that includes valid NATIVE lines of the same chunk. Re-running
    a corrected file duplicates only events WITHOUT explicit eventIds
    (ids are preserved, and re-appending an id overwrites), exactly as
    a legacy re-run would.
    """
    n = 0
    while True:
        lines = src.readlines(8 << 20)  # ~8 MB of lines per chunk
        if not lines:
            return n
        blob = "".join(lines).encode("utf-8")
        appended, fallback = append_jsonl(blob, len(lines), app_id,
                                          channel_id)
        n += appended
        if fallback:  # batched: a fallback-heavy file (e.g. unusual
            # field shapes) must not degrade to per-event appends.
            # Legacy-loop skip rule: lines that strip() to empty are
            # blank, not errors (the C++ trim knows only space/\t/\r,
            # so a \f- or \xa0-only line lands here)
            batch = []
            for i in fallback:
                text = lines[i].strip()
                if text:
                    batch.append(Event.from_json(json.loads(text)))
            if batch:
                st.events.insert_batch(batch, app_id, channel_id)
            n += len(batch)
