"""Host loader bindings (ctypes) with a bit-identical numpy fallback.

PyTorch-port counterpart of ``densityflows_tpu/native``. ``csrc/loader.cpp``
provides the hot host-side operations of the streaming input pipeline: a
deterministic splitmix64 Fisher-Yates shuffle and a threaded row gather. The
fallback mirrors the generator's arithmetic exactly, so an epoch produced
without the compiled library is identical to one produced with it — the
native path only changes speed, never results.

The library is compiled at first use with the host C++ compiler into
``build/`` (``_build.load_host_library``); where there is no compiler the
fallback is used silently. This is a host loader, not a device path:
:func:`native_available` tells which one is in use.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

__all__ = ["native_available", "shuffle", "gather_rows", "splitmix64_py"]

_lib = None
_lib_lock = threading.Lock()
_build_failed = False

_MASK64 = (1 << 64) - 1


def _load():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _build_failed:
            return _lib
        from .._build import load_host_library

        try:
            lib = load_host_library("loader")
        except (OSError, RuntimeError):
            _build_failed = True
            return None
        lib.df_shuffle.argtypes = [
            ctypes.c_uint64, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ]
        lib.df_shuffle.restype = None
        for name, dtype in (("df_gather_f32", np.float32),
                            ("df_gather_f64", np.float64)):
            fn = getattr(lib, name)
            fn.argtypes = [
                np.ctypeslib.ndpointer(dtype, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                ctypes.c_int64, ctypes.c_int64,
                np.ctypeslib.ndpointer(dtype, flags=("C_CONTIGUOUS",
                                                     "WRITEABLE")),
                ctypes.c_int,
            ]
            fn.restype = None
        lib.df_version.restype = ctypes.c_int
        _lib = lib
        return _lib


def native_available() -> bool:
    """True when the compiled loader library is in use."""
    return _load() is not None


def splitmix64_py(state: int):
    """One splitmix64 step (pure-Python mirror of ``csrc/loader.cpp``)."""
    state = (state + 0x9E3779B97F4A7C15) & _MASK64
    z = state
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return state, z ^ (z >> 31)


def _shuffle_py(seed: int, n: int) -> np.ndarray:
    out = np.arange(n, dtype=np.int64)
    state = seed & _MASK64
    for i in range(n - 1, 0, -1):
        state, r = splitmix64_py(state)
        j = r % (i + 1)
        out[i], out[j] = out[j], out[i]
    return out


def shuffle(seed: int, n: int) -> np.ndarray:
    """Deterministic permutation of [0, n): identical on both paths."""
    lib = _load()
    if lib is None:
        return _shuffle_py(seed, n)
    out = np.empty(n, np.int64)
    lib.df_shuffle(ctypes.c_uint64(seed & _MASK64), n, out)
    return out


def gather_rows(src: np.ndarray, idx: np.ndarray, *,
                out: np.ndarray | None = None,
                n_threads: int | None = None) -> np.ndarray:
    """``out[i, :] = src[idx[i], :]`` — threaded memcpy for 2-D float arrays,
    numpy fancy indexing otherwise. ``src`` may be a memmap; ``out`` may be a
    view of a pinned staging buffer."""
    idx = np.ascontiguousarray(idx, np.int64)
    lib = _load()
    flat_ok = (
        lib is not None
        and isinstance(src, np.ndarray)
        and src.ndim == 2
        and src.dtype in (np.float32, np.float64)
        and src.flags["C_CONTIGUOUS"]
        and (out is None or (out.flags["C_CONTIGUOUS"]
                             and out.dtype == src.dtype
                             and out.shape == (idx.shape[0], src.shape[1])))
        # the library copies without looking: an index outside [0, rows) is
        # left to numpy, which wraps a negative one and raises on the rest
        and idx.ndim == 1
        and (idx.size == 0 or (idx.min() >= 0 and idx.max() < src.shape[0]))
    )
    if not flat_ok:
        result = np.ascontiguousarray(src[idx])
        if out is not None:
            out[...] = result
            return out
        return result
    if out is None:
        out = np.empty((idx.shape[0], src.shape[1]), src.dtype)
    if n_threads is None:
        # a thread costs tens of microseconds to start: fan out only when
        # every thread gets enough rows to pay for it
        n_threads = min(8, os.cpu_count() or 1,
                        max(1, idx.shape[0] * src.shape[1] // 262144))
    fn = lib.df_gather_f32 if src.dtype == np.float32 else lib.df_gather_f64
    fn(src, idx, idx.shape[0], src.shape[1], out, n_threads)
    return out
