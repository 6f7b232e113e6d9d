"""The native event-log engine (``eventlog.cc``), built with g++ at first use.

``eventlog.cc`` is a byte-equal copy of the JAX package's engine, so both
packages frame, index and scan a ``.pel`` log identically. It is host
code (no CUDA). At first use it is compiled with ``g++ -O2 -std=c++17
-shared -fPIC`` into ``build/torch_native/eventlog-<sha256[:16]>.so`` at
the root of the checkout (the digest is of the source, so an edited
source is rebuilt and a stale one is never loaded) and loaded with
:mod:`ctypes`. Nothing is built at import. A failed build raises
:class:`NativeBuildError` with g++'s stderr: the EVENTLOG backend has no
fallback to another store.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

_SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_cache: Dict[str, ctypes.CDLL] = {}
#: per library built by this process: {"seconds": g++'s wall time}
BUILD_INFO: Dict[str, dict] = {}


class NativeBuildError(RuntimeError):
    pass


def library_path(name: str) -> Path:
    source = (_SRC_DIR / f"{name}.cc").read_bytes()
    return BUILD_DIR / f"{name}-{hashlib.sha256(source).hexdigest()[:16]}.so"


def load_library(name: str) -> ctypes.CDLL:
    """Compile (if needed) and dlopen ``<name>.cc`` from this package."""
    with _lock:
        if name in _cache:
            return _cache[name]
        so_path = library_path(name)
        if not so_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so_path.with_suffix(f".tmp{os.getpid()}")
            cmd = ["g++", *GXX_FLAGS, str(_SRC_DIR / f"{name}.cc"),
                   "-o", str(tmp)]
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=300)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise NativeBuildError(f"g++ unavailable: {e}") from e
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise NativeBuildError(
                    f"g++ failed for {name}.cc:\n{proc.stderr[-4000:]}")
            BUILD_INFO[name] = {"seconds": time.perf_counter() - t0}
            os.replace(tmp, so_path)  # atomic against concurrent builders
        lib = ctypes.CDLL(str(so_path))
        _cache[name] = lib
        return lib


def eventlog_library() -> ctypes.CDLL:
    """The event-log engine with its ctypes signatures bound (those of
    the JAX package's loader). Raises :class:`NativeBuildError` when it
    cannot be built."""
    lib = load_library("eventlog")
    lib.pel_open.restype = ctypes.c_void_p
    lib.pel_open.argtypes = [ctypes.c_char_p]
    lib.pel_open_ex.restype = ctypes.c_void_p
    lib.pel_open_ex.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.pel_info.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_longlong)]
    lib.pel_close.argtypes = [ctypes.c_void_p]
    lib.pel_append_batch.restype = ctypes.c_int
    lib.pel_append_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong, ctypes.c_int]
    lib.pel_sync.restype = ctypes.c_int
    lib.pel_sync.argtypes = [ctypes.c_void_p]
    lib.pel_delete.restype = ctypes.c_int
    lib.pel_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.pel_wipe.restype = ctypes.c_int
    lib.pel_wipe.argtypes = [ctypes.c_void_p]
    lib.pel_count.restype = ctypes.c_longlong
    lib.pel_count.argtypes = [ctypes.c_void_p]
    lib.pel_live_ids.restype = ctypes.c_longlong
    lib.pel_live_ids.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
    # out-params are void* (payloads contain NUL bytes: read them with
    # ctypes.string_at(ptr, length), never c_char_p auto-conversion)
    lib.pel_get.restype = ctypes.c_longlong
    lib.pel_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                            ctypes.POINTER(ctypes.c_void_p)]
    lib.pel_find.restype = ctypes.c_longlong
    lib.pel_find.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_int, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_void_p)]
    lib.pel_aggregate.restype = ctypes.c_longlong
    lib.pel_aggregate.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.POINTER(ctypes.c_void_p)]
    lib.pel_append_jsonl.restype = ctypes.c_longlong
    lib.pel_append_jsonl.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_ulonglong, ctypes.c_char_p,
        ctypes.c_longlong, ctypes.c_char_p]
    lib.pel_export_jsonl.restype = ctypes.c_longlong
    lib.pel_export_jsonl.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_longlong)]
    lib.pel_scan_columnar.restype = ctypes.c_longlong
    lib.pel_scan_columnar.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_void_p)]
    lib.pel_scan_columnar_ex.restype = ctypes.c_longlong
    lib.pel_scan_columnar_ex.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_void_p)]
    lib.pel_creation_stats.restype = ctypes.c_longlong
    lib.pel_creation_stats.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_longlong)]
    lib.pel_creation_bounds.restype = ctypes.c_longlong
    lib.pel_creation_bounds.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_longlong)]
    lib.pel_free.argtypes = [ctypes.c_void_p]
    return lib
