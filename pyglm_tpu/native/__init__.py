"""Native (C++/OpenMP) host-side PG sampler: build-on-demand + ctypes.

See pg_sampler.cpp for the role of this component. The library is compiled
once per machine with g++ into the package directory (falls back cleanly to
None if no toolchain is present — all callers must gate on
``native_available()``).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "pg_sampler.cpp")
_LIB = os.path.join(_HERE, "libpg.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    # Several processes (test workers) may build at once: each compiles to
    # its own file and renames it into place, so no process ever loads a
    # library another one is still writing.
    tmp = os.path.join(_HERE, f"libpg.{os.getpid()}.tmp.so")
    for flags in (["-fopenmp"], []):          # retry without OpenMP
        try:
            subprocess.run(["g++", "-O3", *flags, "-shared", "-fPIC", _SRC,
                            "-o", tmp],
                           check=True, capture_output=True, timeout=120)
        except Exception:
            continue
        os.replace(tmp, _LIB)
        return True
    if os.path.exists(tmp):
        os.remove(tmp)
    return False


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB) or (os.path.getmtime(_LIB)
                                        < os.path.getmtime(_SRC)):
            if not _build():
                return None
        lib = ctypes.CDLL(_LIB)
        lib.pg_devroye_vec.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64, ctypes.c_uint64, ctypes.c_int]
        lib.pg_int_b_vec.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64, ctypes.c_uint64, ctypes.c_int]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def pg_devroye_native(c, seed: int = 0, n_threads: int = 0) -> np.ndarray:
    """Exact PG(1, c) draws on the host CPU (OpenMP)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native PG library unavailable (no g++?)")
    c = np.ascontiguousarray(np.asarray(c, np.float64))
    out = np.empty_like(c)
    if n_threads <= 0:
        n_threads = os.cpu_count() or 1
    lib.pg_devroye_vec(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        c.size, np.uint64(seed), n_threads)
    return out.reshape(np.shape(c))


def pg_int_b_native(b, c, seed: int = 0, n_threads: int = 0) -> np.ndarray:
    """Exact PG(b, c) draws for integer b (b-fold convolution)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native PG library unavailable (no g++?)")
    b = np.ascontiguousarray(np.asarray(b, np.float64))
    c = np.ascontiguousarray(np.broadcast_to(
        np.asarray(c, np.float64), b.shape))
    out = np.empty_like(c)
    if n_threads <= 0:
        n_threads = os.cpu_count() or 1
    lib.pg_int_b_vec(
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        c.size, np.uint64(seed), n_threads)
    return out.reshape(np.shape(b))
