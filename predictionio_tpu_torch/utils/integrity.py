"""Integrity primitives: sha256 digests and the refusal of bad bytes.

The port's copy of the JAX package's ``utils/integrity.py``. Every
checksummed artifact (model blobs, their ``.sha256`` sidecars, the PQ
index payload, snapshot columns, segment sidecars) is verified against a
SHA-256 digest on every load; a mismatch raises :class:`IntegrityError`
and the bytes are never served. The verdicts count in
``pio_integrity_verified_total`` / ``pio_integrity_failed_total`` and
quarantined torn event-log tails in ``pio_quarantined_total``, each
labelled by ``artifact``, as in the JAX package.
"""

from __future__ import annotations

import hashlib
from typing import Optional

from predictionio_tpu_torch.utils.metrics import REGISTRY

#: filename suffix for digest sidecars (``model.bin`` -> ``model.bin.sha256``)
DIGEST_SUFFIX = ".sha256"

INTEGRITY_VERIFIED = REGISTRY.counter(
    "pio_integrity_verified_total",
    "Artifact reads whose checksum verified", ("artifact",))
INTEGRITY_FAILED = REGISTRY.counter(
    "pio_integrity_failed_total",
    "Artifact reads refused or rebuilt on checksum mismatch",
    ("artifact",))
QUARANTINED = REGISTRY.counter(
    "pio_quarantined_total",
    "Corrupt byte ranges preserved in quarantine sidecars", ("artifact",))


class IntegrityError(RuntimeError):
    """A checksummed blob failed verification; the read is refused.
    Deliberately not an ``IOError``: retry logic must not treat bad
    bytes as a transient fault."""


def sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def verify_blob(blob: bytes, expected_hex: Optional[str], artifact: str,
                what: str = "") -> None:
    """Verify ``blob`` against a hex digest; None (no sidecar: written
    before digests existed) is accepted."""
    if expected_hex is None:
        return
    actual = sha256_hex(blob)
    if actual != expected_hex.strip():
        INTEGRITY_FAILED.inc((artifact,))
        raise IntegrityError(
            f"{artifact} checksum mismatch{f' for {what}' if what else ''}: "
            f"expected {expected_hex.strip()[:16]}…, got {actual[:16]}… "
            f"({len(blob)} bytes) — refusing to serve corrupt data")
    INTEGRITY_VERIFIED.inc((artifact,))
