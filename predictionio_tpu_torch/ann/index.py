"""Versioned PQ index blob: build, persist, verify, load.

The port's copy of the JAX package's ``ann/index.py``: the same wire
format byte for byte, so an index either package writes, the other
loads. Numpy only; :func:`build_index` reaches torch through
:mod:`.pq`, inside the call.

The index is part of the model artifact (codebooks-as-model — PAPER.md
survey: the trained model IS the serving artifact). On-disk/in-blob
layout, all little-endian:

    b"PIOANN01" | u32 header_len | header JSON | payload

where payload = codebooks (m·K·dsub f32) ++ codes (N·m u8)
[++ ids (N i32) when ``has_ids``] and the header carries the payload's
sha256. :func:`PQIndex.from_bytes` verifies that digest on EVERY load —
file-backed or embedded in a pickled model blob — so a corrupt index is
refused at ``/reload`` exactly like a corrupt model blob. The fault site ``ann.index.corrupt`` byte-flips the blob at
this single choke point for chaos tests.

When the model store has a real directory (LOCALFS), :func:`save_index`
also writes ``ann_index.bin`` + ``.sha256`` sidecar + ``ann_index.json``
manifest next to the model blob; ``pio index status`` prints the
manifest and checks the pair without torch.
"""

from __future__ import annotations

import json
import os
import struct
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from predictionio_tpu_torch.utils import faults
from predictionio_tpu_torch.utils.atomic_write import atomic_write_bytes
from predictionio_tpu_torch.utils.integrity import (IntegrityError, sha256_hex,
                                                    verify_blob)

MAGIC = b"PIOANN01"
INDEX_BASENAME = "ann_index.bin"
MANIFEST_BASENAME = "ann_index.json"

#: bytes-per-item of the float re-rank embeddings are added on top of
#: codes+codebooks for the HBM estimate (the serving scorer keeps V
#: resident for the exact re-rank of the shortlist)
_F32 = 4


@dataclass
class PQIndex:
    """In-memory PQ index: ``codebooks`` (m, K, dsub) f32, ``codes``
    (N, m) u8, optional ``ids`` (N,) i32 mapping code rows to corpus
    rows (None = identity), optional OPQ ``rotation`` (dim, dim) f32
    (codes quantize ``V @ rotation``; serving rotates the query before
    the ADC LUT), plus build metadata."""

    codebooks: np.ndarray
    codes: np.ndarray
    ids: Optional[np.ndarray] = None
    meta: dict = field(default_factory=dict)
    rotation: Optional[np.ndarray] = None

    @property
    def m(self) -> int:
        return int(self.codebooks.shape[0])

    @property
    def k(self) -> int:
        return int(self.codebooks.shape[1])

    @property
    def dsub(self) -> int:
        return int(self.codebooks.shape[2])

    @property
    def dim(self) -> int:
        return self.m * self.dsub

    @property
    def n_items(self) -> int:
        return int(self.codes.shape[0])

    def code_bytes(self) -> int:
        return self.codes.size  # uint8

    def codebook_bytes(self) -> int:
        return self.codebooks.size * _F32

    def rotation_bytes(self) -> int:
        return 0 if self.rotation is None else self.rotation.size * _F32

    def hbm_estimate_bytes(self) -> int:
        """Device-resident footprint of ANN serving: codes + codebooks
        (+ OPQ rotation) + the float corpus kept for exact shortlist
        re-rank. Per-device under an S-way shard mesh:
        :func:`shard_view`."""
        return (self.code_bytes() + self.codebook_bytes()
                + self.rotation_bytes() + self.n_items * self.dim * _F32)

    # -- wire format ----------------------------------------------------------

    def to_bytes(self) -> bytes:
        """Serialize. Version 1 (the first layout, unchanged) when
        the index has no rotation and no shard-layout hint, so plain-PQ
        blobs stay readable by pre-OPQ loaders; version 2 appends the
        rotation to the payload and carries ``has_rotation`` + the
        intended serving ``shard_layout`` in the header."""
        codebooks = np.ascontiguousarray(self.codebooks, np.float32)
        codes = np.ascontiguousarray(self.codes, np.uint8)
        payload = codebooks.tobytes() + codes.tobytes()
        has_ids = self.ids is not None
        if has_ids:
            payload += np.ascontiguousarray(self.ids, np.int32).tobytes()
        has_rotation = self.rotation is not None
        shards = self.meta.get("shards")
        version = 2 if (has_rotation or shards) else 1
        if has_rotation:
            payload += np.ascontiguousarray(
                self.rotation, np.float32).tobytes()
        header = {
            "version": version,
            "m": self.m, "k": self.k, "dsub": self.dsub,
            "n": self.n_items, "dim": self.dim,
            "has_ids": has_ids,
            "payload_sha256": sha256_hex(payload),
            "build_sec": self.meta.get("build_sec"),
            "built_unix": self.meta.get("built_unix"),
        }
        if version >= 2:
            header["has_rotation"] = has_rotation
            if shards:
                header["shard_layout"] = shard_layout(self.n_items,
                                                      int(shards))
        hj = json.dumps(header, sort_keys=True).encode("utf-8")
        return MAGIC + struct.pack("<I", len(hj)) + hj + payload

    @classmethod
    def from_bytes(cls, blob: bytes) -> "PQIndex":
        """Parse + verify an index blob. The single load choke point:
        the ``ann.index.corrupt`` fault injects here (covers both the
        ``ann_index.bin`` file path and indexes embedded in pickled
        model blobs), and any structural damage or payload-digest
        mismatch raises :class:`IntegrityError` — which ``/reload``
        turns into a refused candidate, champion kept."""
        blob = faults.corrupt_bytes("ann.index.corrupt", blob)
        try:
            if blob[:len(MAGIC)] != MAGIC:
                raise ValueError(f"bad magic {blob[:len(MAGIC)]!r}")
            off = len(MAGIC)
            (hlen,) = struct.unpack_from("<I", blob, off)
            off += 4
            header = json.loads(blob[off:off + hlen].decode("utf-8"))
            off += hlen
            payload = blob[off:]
            if header.get("version") not in (1, 2):
                raise ValueError(f"unknown version {header.get('version')!r}")
            verify_blob(payload, header["payload_sha256"], "ann_index",
                        what="payload")
            m, k, dsub, n = (header["m"], header["k"], header["dsub"],
                             header["n"])
            pos = 0
            cb_n = m * k * dsub * _F32
            codebooks = np.frombuffer(
                payload, np.float32, count=m * k * dsub,
                offset=pos).reshape(m, k, dsub).copy()
            pos += cb_n
            codes = np.frombuffer(
                payload, np.uint8, count=n * m,
                offset=pos).reshape(n, m).copy()
            pos += n * m
            ids = None
            if header.get("has_ids"):
                ids = np.frombuffer(
                    payload, np.int32, count=n, offset=pos).copy()
                pos += n * _F32
            rotation = None
            if header.get("has_rotation"):    # v2-only key; absent in v1
                dim = m * dsub
                rotation = np.frombuffer(
                    payload, np.float32, count=dim * dim,
                    offset=pos).reshape(dim, dim).copy()
        except IntegrityError:
            raise
        except Exception as e:
            raise IntegrityError(f"ann index blob corrupt: {e}") from e
        meta = {"build_sec": header.get("build_sec"),
                "built_unix": header.get("built_unix")}
        layout = header.get("shard_layout")
        if layout:
            meta["shards"] = layout.get("shards")
        return cls(codebooks=codebooks, codes=codes, ids=ids, meta=meta,
                   rotation=rotation)


def shard_layout(n_items: int, shards: int) -> dict:
    """Contiguous item-wise partition of the corpus over an S-way
    ``shards`` mesh axis: the item axis is padded to a multiple of S
    and split into equal blocks (shard i owns rows
    [i·rows, (i+1)·rows)); pad rows live in the last shard's tail and
    are masked on device. Pure arithmetic — shared by the serving
    scorer, the blob header, and the torch-free ``pio index status``
    per-shard view."""
    shards = max(1, int(shards))
    rows = -(-n_items // shards)          # ceil → per-shard block
    return {"shards": shards, "rows_per_shard": rows,
            "padded_items": rows * shards}


def shard_view(man: dict, shards: int) -> dict:
    """Per-shard byte / per-device HBM breakdown from a manifest dict
    alone (torch-free — ``pio index status --shards N`` sizes a mesh from
    an ops box with no accelerator stack). Codebooks and the OPQ
    rotation are replicated on every device; codes and the re-rank
    floats are partitioned item-wise."""
    layout = shard_layout(int(man["n_items"]), shards)
    rows = layout["rows_per_shard"]
    per_item_code = int(man["m"])           # uint8 per subspace
    replicated = (int(man.get("codebook_bytes", 0))
                  + int(man.get("rotation_bytes") or 0))
    code_b = rows * per_item_code
    rerank_b = rows * int(man["dim"]) * _F32
    return {
        **layout,
        "code_bytes_per_shard": code_b,
        "rerank_bytes_per_shard": rerank_b,
        "replicated_bytes": replicated,
        "hbm_per_device_bytes": code_b + rerank_b + replicated,
    }


def build_index(V, m: int, k: int, *, iters: int = 8, seed: int = 0,
                sample: int = 65536, opq: bool = False,
                opq_iters: int = 4,
                shards: Optional[int] = None, device=None) -> PQIndex:
    """Train codebooks + encode the corpus on ``device`` (CUDA unless
    the caller names another) → :class:`PQIndex` with build timing in
    ``meta`` (surfaced by ``pio index status``; the in-memory ``meta``
    also splits it into ``lloyd_sec``, ``encode_sec`` and ``opq_sec``,
    which the blob does not carry).

    ``opq=True`` trains an OPQ-style orthogonal rotation first
    (:func:`predictionio_tpu_torch.ann.pq.train_opq`) and quantizes the
    ROTATED corpus — better recall at the same code bytes; the
    rotation rides in the (version-2) blob. ``shards`` records the
    intended serving mesh size in the blob header / manifest so
    ``pio index status`` and the deploy-time scorer agree on layout —
    it does not change the encoded payload (the blob is shard-count
    agnostic; partitioning happens at device placement)."""
    from predictionio_tpu_torch.ann import pq

    t0 = time.perf_counter()
    V = np.asarray(V, np.float32)
    rotation = None
    split = {"lloyd_sec": 0.0, "encode_sec": 0.0}
    if opq:
        rotation, codebooks = pq.train_opq(
            V, m, k, iters=iters, opq_iters=opq_iters, seed=seed,
            sample=sample, device=device, timings=split)
        V = V @ rotation
    else:
        codebooks = pq.train_codebooks(V, m, k, iters=iters, seed=seed,
                                       sample=sample, device=device)
        split["lloyd_sec"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    codes = pq.encode(V, codebooks, device=device)
    split["encode_sec"] += time.perf_counter() - t1
    build = time.perf_counter() - t0
    meta = {"build_sec": round(build, 3),
            "built_unix": int(time.time()),
            **split,
            "opq_sec": build - split["lloyd_sec"] - split["encode_sec"]}
    if shards and int(shards) > 1:
        meta["shards"] = int(shards)
    return PQIndex(codebooks=codebooks, codes=codes, meta=meta,
                   rotation=rotation)


def manifest_dict(index: PQIndex, blob_sha256: str) -> dict:
    """The torch-free geometry summary ``pio index status`` prints."""
    man = {
        "version": 2 if (index.rotation is not None
                         or index.meta.get("shards")) else 1,
        "m": index.m, "k": index.k, "dsub": index.dsub,
        "dim": index.dim, "n_items": index.n_items,
        "code_bytes": index.code_bytes(),
        "codebook_bytes": index.codebook_bytes(),
        "rotation_bytes": index.rotation_bytes(),
        "hbm_estimate_bytes": index.hbm_estimate_bytes(),
        "build_sec": index.meta.get("build_sec"),
        "built_unix": index.meta.get("built_unix"),
        "sha256": blob_sha256,
    }
    if index.meta.get("shards"):
        man["shards"] = int(index.meta["shards"])
    return man


def save_index(index: PQIndex, algo_dir: str) -> str:
    """Persist ``ann_index.bin`` + ``.sha256`` sidecar (via the shared
    ``storage/models`` artifact layout: blob durably first, digest
    last — a torn write reads back refused or unchecksummed, never
    silently wrong) and the ``ann_index.json`` manifest. Returns the
    blob path."""
    from predictionio_tpu_torch.storage.models import write_artifact

    blob = index.to_bytes()
    path = os.path.join(algo_dir, INDEX_BASENAME)
    digest = write_artifact(path, blob)
    atomic_write_bytes(
        os.path.join(algo_dir, MANIFEST_BASENAME),
        (json.dumps(manifest_dict(index, digest), indent=2, sort_keys=True)
         + "\n").encode("utf-8"))
    return path


def load_index(algo_dir: str) -> Optional[PQIndex]:
    """Load + verify ``ann_index.bin`` from ``algo_dir`` (None when
    absent). The file sidecar is checked against the raw bytes via the
    shared artifact reader; the header payload digest is checked in
    :func:`PQIndex.from_bytes` either way."""
    from predictionio_tpu_torch.storage.models import read_artifact

    path = os.path.join(algo_dir, INDEX_BASENAME)
    blob = read_artifact(path, "ann_index", what=path)
    if blob is None:
        return None
    return PQIndex.from_bytes(blob)
