"""ctypes bindings + on-demand build for the C++ shard store.

The native library (``shardstore.cpp``) memory-maps flat binary column files
and assembles batches with a thread pool + double-buffered prefetch — the
replacement for the reference's multiprocess DataLoader and per-sample .npy
sidecars.  Python owns the metadata (meta.json) and the writer; C++ owns
the hot gather path.  The library is built from ``shardstore.cpp`` with
``g++`` at first use, into ``build/`` beside this file (git-ignored).
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "shardstore.cpp")
_LIB = os.path.join(os.path.dirname(__file__), "build", "_shardstore.so")
_lib = None


def _build_lib() -> str:
    if (not os.path.exists(_LIB)
            or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
        os.makedirs(os.path.dirname(_LIB), exist_ok=True)
        # compile beside the target, then rename: a concurrent loader never
        # maps a half-written library
        tmp = f"{_LIB}.{os.getpid()}.tmp"
        subprocess.check_call(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
             _SRC, "-o", tmp])
        os.replace(tmp, _LIB)
    return _LIB


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(_build_lib())
        lib.ss_open.restype = ctypes.c_void_p
        lib.ss_open.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int64,
            ctypes.c_int]
        lib.ss_gather.restype = ctypes.c_int
        lib.ss_gather.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_int64),
                                  ctypes.c_int64, ctypes.c_void_p]
        lib.ss_prefetch_submit.restype = ctypes.c_int
        lib.ss_prefetch_submit.argtypes = [ctypes.c_void_p,
                                           ctypes.POINTER(ctypes.c_int64),
                                           ctypes.c_int64]
        lib.ss_prefetch_collect.restype = ctypes.c_int
        lib.ss_prefetch_collect.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_void_p, ctypes.c_int64]
        lib.ss_prefetch_done.restype = ctypes.c_int
        lib.ss_prefetch_done.argtypes = [ctypes.c_void_p]
        lib.ss_close.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def write_store(path: str, data: Dict[str, np.ndarray]):
    """Write a dict of stacked arrays as a shard-store directory."""
    os.makedirs(path, exist_ok=True)
    meta = {"n_rows": None, "columns": {}}
    for name, arr in data.items():
        arr = np.ascontiguousarray(arr)
        if meta["n_rows"] is None:
            meta["n_rows"] = int(arr.shape[0])
        assert arr.shape[0] == meta["n_rows"], name
        arr.tofile(os.path.join(path, f"{name}.bin"))
        meta["columns"][name] = {"dtype": str(arr.dtype),
                                 "shape": list(arr.shape[1:])}
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


class ShardStore:
    """Reader with native multithreaded gather + double-buffered prefetch."""

    def __init__(self, path: str, n_threads: int = 8):
        self.path = path
        with open(os.path.join(path, "meta.json")) as f:
            self.meta = json.load(f)
        self.n_rows = self.meta["n_rows"]
        self.columns = list(self.meta["columns"])
        self._dtypes = {}
        self._shapes = {}
        row_bytes = []
        names_c = (ctypes.c_char_p * len(self.columns))()
        for i, name in enumerate(self.columns):
            info = self.meta["columns"][name]
            dt = np.dtype(info["dtype"])
            shape = tuple(info["shape"])
            self._dtypes[name] = dt
            self._shapes[name] = shape
            row_bytes.append(int(np.prod(shape, dtype=np.int64))
                             * dt.itemsize)
            names_c[i] = name.encode()
        rb = (ctypes.c_int64 * len(row_bytes))(*row_bytes)
        self._row_bytes = row_bytes
        lib = _load()
        self._h = lib.ss_open(path.encode(), names_c, rb,
                              len(self.columns), self.n_rows, n_threads)
        if not self._h:
            raise OSError(f"failed to open shard store at {path}")

    def close(self):
        if getattr(self, "_h", None):
            _load().ss_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # ------------------------------------------------------------------
    def _out(self, name: str, n: int) -> np.ndarray:
        return np.empty((n,) + self._shapes[name], self._dtypes[name])

    def gather(self, indices: np.ndarray,
               columns: Optional[Sequence[str]] = None
               ) -> Dict[str, np.ndarray]:
        """Synchronous batch assembly."""
        idx = np.ascontiguousarray(indices, np.int64)
        idx_c = idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        out = {}
        lib = _load()
        for name in (columns or self.columns):
            c = self.columns.index(name)
            buf = self._out(name, len(idx))
            rc = lib.ss_gather(self._h, c, idx_c, len(idx),
                               buf.ctypes.data_as(ctypes.c_void_p))
            if rc != 0:
                raise RuntimeError(f"ss_gather({name}) -> {rc}")
            out[name] = buf
        return out

    # ------------------------------------------------------------------
    def iter_batches(self, indices: np.ndarray, batch_size: int,
                     columns: Optional[Sequence[str]] = None
                     ) -> Iterator[Dict[str, np.ndarray]]:
        """Double-buffered iterator: batch k+1 is assembled by the native
        worker thread while batch k is on its way to the device."""
        lib = _load()
        cols = list(columns or self.columns)
        idx = np.ascontiguousarray(indices, np.int64)
        n = len(idx)
        starts = list(range(0, n - batch_size + 1, batch_size))
        if not starts:
            return

        def submit(s):
            chunk = np.ascontiguousarray(idx[s:s + batch_size])
            rc = lib.ss_prefetch_submit(
                self._h, chunk.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                batch_size)
            if rc != 0:
                raise RuntimeError(f"ss_prefetch_submit -> {rc}")

        submit(starts[0])
        for i, s in enumerate(starts):
            out = {}
            for name in cols:
                c = self.columns.index(name)
                buf = self._out(name, batch_size)
                rc = lib.ss_prefetch_collect(
                    self._h, c, buf.ctypes.data_as(ctypes.c_void_p),
                    buf.nbytes)
                if rc != 0:
                    raise RuntimeError(f"ss_prefetch_collect -> {rc}")
                out[name] = buf
            lib.ss_prefetch_done(self._h)
            if i + 1 < len(starts):
                submit(starts[i + 1])
            yield out
