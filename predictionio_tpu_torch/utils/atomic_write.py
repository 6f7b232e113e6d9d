"""Crash-durable atomic file replacement: the port's copy of the JAX
package's ``utils/atomic_write.py``.

``tmp-write + os.replace`` alone gives atomicity (readers see the old or
the new file, never half) but not durability: after a power cut the
rename can survive while the data blocks behind it do not. The
discipline is three steps: fsync the tmp file, rename, fsync the parent
directory so that the rename itself is on disk. The span JSONL rotation
(``utils/tracing.py``) and the tenant policy file (``server/tenancy.py``)
write through it.

Directory fsync is best-effort: some filesystems refuse O_RDONLY fsync
on directories; the file-level fsync (the important half) has already
happened by then.
"""

from __future__ import annotations

import os
import tempfile
from contextlib import contextmanager
from typing import Iterator, IO


def fsync_dir(path: str) -> None:
    """fsync a directory so a just-renamed entry survives power loss."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


@contextmanager
def atomic_file(path: str, mode: str = "wb",
                encoding: str | None = None) -> Iterator[IO]:
    """Write-to-tmp / fsync / replace / fsync-dir as a context manager.

    The target appears complete and durable or not at all; on any
    error the tmp file is removed and nothing at ``path`` changes.
    """
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".atomic-",
                               suffix=".tmp")
    try:
        f = os.fdopen(fd, mode, encoding=encoding)
        try:
            yield f
            f.flush()
            os.fsync(f.fileno())
        finally:
            f.close()
        os.replace(tmp, path)
        fsync_dir(directory)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_bytes(path: str, data: bytes) -> None:
    with atomic_file(path, "wb") as f:
        f.write(data)


def atomic_write_text(path: str, text: str,
                      encoding: str = "utf-8") -> None:
    with atomic_file(path, "w", encoding=encoding) as f:
        f.write(text)
