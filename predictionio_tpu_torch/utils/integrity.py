"""Integrity primitives: sha256 digests and the refusal of bad bytes.

The port's copy of the JAX package's ``utils/integrity.py`` helpers.
Every checksummed artifact (model blobs, their ``.sha256`` sidecars, the
PQ index payload) is verified against a SHA-256 digest on every load; a
mismatch raises :class:`IntegrityError` and the bytes are never served.
"""

from __future__ import annotations

import hashlib
from typing import Optional

#: filename suffix for digest sidecars (``model.bin`` -> ``model.bin.sha256``)
DIGEST_SUFFIX = ".sha256"


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
        raise IntegrityError(
            f"{artifact} checksum mismatch{f' for {what}' if what else ''}: "
            f"expected {expected_hex.strip()[:16]}…, got {actual[:16]}… "
            f"({len(blob)} bytes) — refusing to serve corrupt data")
