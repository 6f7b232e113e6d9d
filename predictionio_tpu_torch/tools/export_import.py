"""Event export/import: events ↔ JSONL files.

The port's copy of the JAX package's ``tools/export_import.py``
(reference: [U] tools/.../export/EventsToFile.scala and
tools/.../imprt/FileToEvents.scala): streaming host-side JSONL, one event
per line in the wire format, so a file one package exports the other
imports, and both export the same bytes from the same events. It goes
through ``find()`` and ``insert_batch``; the native event log's bulk
path comes with that backend.
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
