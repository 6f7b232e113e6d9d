"""Mid-training checkpoint/resume: the port's own format.

The JAX package's ``utils/checkpoint.py`` wraps Orbax; the port keeps its
API and its recovery semantics on a format of its own, which it alone
reads and writes (the JAX package never opens it, and the port never
reads an Orbax checkpoint). Training loops save their state every N
steps; a restarted job resumes from the newest step instead of from
scratch.

Layout: ``<dir>/<step>/state.npz`` with its ``state.npz.sha256``
sidecar, the newest ``keep`` steps retained. A step is written into a
hidden temporary directory (payload durably first, digest last, through
``utils/atomic_write``) and renamed into place, so a step directory
appears whole or not at all; a step whose payload no longer matches its
digest (a torn or truncated save) is detected on read. State is a dict,
possibly nested, of arrays and scalars; nested keys are stored as
``a/b`` paths and leaves compare in sorted-path order.
"""

from __future__ import annotations

import hashlib
import io
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from predictionio_tpu_torch.utils.atomic_write import (
    atomic_write_bytes,
    fsync_dir,
)

PAYLOAD = "state.npz"
DIGEST_SUFFIX = ".sha256"


class CheckpointGeometryError(Exception):
    """Every stored checkpoint read cleanly but with shapes that do not
    match the requested template — the directory holds state from a run
    with different geometry (rank/width/etc.). This is the one case
    where wiping the directory is safe and correct."""


class TornCheckpointError(OSError):
    """A step's payload does not match its digest (or either file is
    missing): a save torn by a crash, never a transient read error."""


def _flatten(state: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    if isinstance(state, dict):
        out: Dict[str, np.ndarray] = {}
        for key in sorted(state):
            out.update(_flatten(state[key], f"{prefix}{key}/"))
        return out
    return {prefix[:-1]: np.asarray(state)}


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, value in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return out


def _cast(flat: Dict[str, np.ndarray], want: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """``flat`` (keys and shapes already matched to ``want``) with
    ``want``'s dtypes, nested."""
    return _unflatten({k: flat[k].astype(want[k].dtype, copy=False) for k in want})


class TrainCheckpointer:
    """Step checkpoints under one directory.

    >>> ckpt = TrainCheckpointer(dir_, keep=3)
    >>> start = ckpt.latest_step()                  # None on fresh start
    >>> state = ckpt.restore(template=state) if start is not None else state
    >>> ckpt.save(step, state); ...; ckpt.close()
    """

    def __init__(self, directory: str, keep: int = 3) -> None:
        self.directory = os.path.abspath(directory)
        self._keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def all_steps(self) -> List[int]:
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        return sorted(int(n) for n in names
                      if n.isdigit() and os.path.isdir(os.path.join(
                          self.directory, n)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any) -> None:
        """Write ``state`` as ``step``; raises if that step is present
        (a silent skip would drop training progress on the floor)."""
        final = self._step_dir(step)
        if os.path.exists(final):
            raise RuntimeError(
                f"checkpoint save at step {step} under {self.directory} "
                f"refused: the step is already present")
        buf = io.BytesIO()
        np.savez(buf, **_flatten(state))
        data = buf.getvalue()
        tmp = os.path.join(self.directory, f".tmp-{int(step)}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            atomic_write_bytes(os.path.join(tmp, PAYLOAD), data)
            atomic_write_bytes(os.path.join(tmp, PAYLOAD + DIGEST_SUFFIX),
                               hashlib.sha256(data).hexdigest().encode("ascii"))
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        fsync_dir(self.directory)
        for old in self.all_steps()[:-self._keep] if self._keep > 0 else []:
            self._tombstone_delete(self._step_dir(old), f".pio-pruned-{old}")

    def _read_flat(self, step: int) -> Dict[str, np.ndarray]:
        """The step's arrays, digest-verified. Missing step:
        FileNotFoundError; torn payload: TornCheckpointError; any other
        read failure propagates as it is."""
        d = self._step_dir(step)
        if not os.path.isdir(d):
            raise FileNotFoundError(f"no checkpoint step {step} under {self.directory}")
        path = os.path.join(d, PAYLOAD)
        try:
            with open(path, "rb") as f:
                data = f.read()
            with open(path + DIGEST_SUFFIX, "r", encoding="ascii") as f:
                want = f.read().strip()
        except FileNotFoundError as exc:
            raise TornCheckpointError(
                f"checkpoint step {step} under {self.directory} is missing "
                f"{os.path.basename(exc.filename or path)} (torn save?)") from None
        if hashlib.sha256(data).hexdigest() != want:
            raise TornCheckpointError(
                f"checkpoint step {step} under {self.directory} does not match "
                f"its digest ({len(data)} bytes; torn save?)")
        with np.load(io.BytesIO(data), allow_pickle=False) as z:
            return {k: z[k] for k in z.files}

    @staticmethod
    def _shapes(flat: Dict[str, Any]) -> List[Tuple[str, Tuple[int, ...]]]:
        """Keys and shapes in sorted-path order: compared positionally,
        so a permutation of the shapes across the keys is a mismatch."""
        return [(k, tuple(np.shape(v))) for k, v in sorted(flat.items())]

    def restore(self, step: Optional[int] = None,
                template: Optional[Any] = None) -> Any:
        """Restore ``step`` (default: latest) as a nested dict; with
        ``template`` the leaves take its dtypes and must have its shapes."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        flat = self._read_flat(step)
        if template is None:
            return _unflatten(flat)
        want = _flatten(template)
        if self._shapes(flat) != self._shapes(want):
            raise ValueError(
                f"checkpoint step {step} under {self.directory} does not "
                f"have the template's keys and shapes")
        return _cast(flat, want)

    def restore_latest_compatible(self, template: Any) -> Tuple[Any, int]:
        """Restore the newest step whose keys and shapes match ``template``.

        Walks steps newest→oldest so a save torn by the crash being
        recovered from falls back to the previous good step. Returns
        ``(state, step)``. Raises:

        - ``FileNotFoundError`` — no checkpoints exist;
        - ``CheckpointGeometryError`` — every step read cleanly but with
          mismatched shapes (stale geometry from an earlier run: the
          caller should ``clear()`` so the stale ``latest_step`` cannot
          shadow the fresh run's saves);
        - the underlying read error otherwise — a transient failure must
          NOT be treated as staleness: the checkpoints stay intact for
          the next attempt instead of being wiped into a full retrain.

        After a fallback, the newer steps proven torn or stale are pruned
        (so the resumed run's saves at those steps land); a step skipped
        on any other error is kept.
        """
        steps = sorted(self.all_steps(), reverse=True)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        want = _flatten(template)
        t_shapes = self._shapes(want)
        mismatches = 0
        last_err: Optional[BaseException] = None
        prunable: set = set()
        for step in steps:
            # each step is read and digest-checked once
            try:
                flat = self._read_flat(step)
            except TornCheckpointError as exc:
                prunable.add(step)
                last_err = exc
                continue
            except Exception as exc:  # noqa: BLE001 — per-step fallback
                last_err = exc
                continue
            if self._shapes(flat) != t_shapes:
                mismatches += 1
                prunable.add(step)
                continue
            for bad in (s for s in steps if s > step and s in prunable):
                self._tombstone_delete(self._step_dir(bad), f".pio-pruned-{bad}")
            return _cast(flat, want), int(step)
        if last_err is None and mismatches > 0:
            raise CheckpointGeometryError(
                f"all {mismatches} checkpoint step(s) under "
                f"{self.directory} have shapes incompatible with the "
                f"requested template")
        raise last_err  # type: ignore[misc]

    def clear(self) -> None:
        """Delete every checkpoint. Only on *confirmed* staleness
        (``CheckpointGeometryError``): never on a transient read error,
        which would destroy valid checkpoints."""
        self._tombstone_delete(self.directory, ".pio-cleared")
        os.makedirs(self.directory, exist_ok=True)

    def _tombstone_delete(self, path: str, tag: str) -> None:
        """Rename ``path`` out of the scanned directory, then delete it,
        so a concurrent reader sees a step whole or gone. The tombstone
        lives beside the checkpoint root; an in-place delete is the
        fallback when the rename fails."""
        if not os.path.exists(path):
            return
        tomb = os.path.join(os.path.dirname(self.directory) or ".",
                            f"{tag}-{os.getpid()}")
        try:
            os.rename(path, tomb)
        except OSError:
            shutil.rmtree(path, ignore_errors=True)
        else:
            shutil.rmtree(tomb, ignore_errors=True)

    def close(self) -> None:
        """Nothing is held open between calls; kept for the JAX API."""

    def __enter__(self) -> "TrainCheckpointer":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
