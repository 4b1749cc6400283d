"""ctypes bindings for the native wire decoders (wire.cpp).

The port of the wire half of the JAX package's
`denseflow_tpu/native/__init__.py`. The decoders are a library of their
own, built with g++ and -lpthread alone on first use into
`build/denseflow_tpu_torch/` (kernels/_build.py, recipe "wire"), so they
build on a host without the libjpeg and libpng headers the emitter needs.
Where the library does not build, `wire_available()` is False,
`wire_build_error()` says why, and `denseflow_tpu_torch.wire` decodes with
NumPy. A decode that fails in the library raises.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from denseflow_tpu_torch.kernels import _build
from denseflow_tpu_torch.native import DEFAULT_THREADS

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None

_U8P = ctypes.POINTER(ctypes.c_uint8)


def _load() -> Optional[ctypes.CDLL]:
    """The decoder library, built and bound on the first call; None, with
    the reason kept in `_error`, when it cannot be built or loaded."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                lib = _build.load("wire")
            except (RuntimeError, OSError) as e:
                _error = str(e).strip() or type(e).__name__
                return None
            i, sz = ctypes.c_int, ctypes.c_size_t
            for fn in (lib.df_wire_unpack, lib.df_wire_unpack_v3):
                fn.argtypes = [_U8P, sz, i, i, i, i, i, _U8P, _U8P, i]
                fn.restype = i
            lib.df_wire_unpack_v4.argtypes = [
                _U8P, sz, i, i, i, ctypes.POINTER(ctypes.c_float), i]
            lib.df_wire_unpack_v4.restype = i
            _lib = lib
        return _lib


def wire_available() -> bool:
    """True when the decoders are built and loaded (building them if
    needed)."""
    return _load() is not None


def wire_build_error() -> Optional[str]:
    """The compiler's or the loader's message when the decoders are not
    available, else None."""
    _load()
    return _error


def _lib_or_raise() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native wire decoder is not available: {_error}")
    return lib


def _check(rc: int, what: str, n: int) -> None:
    if rc != 0:
        raise RuntimeError(f"native {what} failed (rc {rc}) on a buffer of {n} bytes")


def _unpack_u8(fn, what, buf, m, c, h, w, exc_cap, n_threads):
    buf = np.ascontiguousarray(buf, dtype=np.uint8).reshape(-1)
    flags = np.zeros(m, np.uint8)
    q = np.empty((m, c, h, w), np.uint8)
    rc = fn(buf.ctypes.data_as(_U8P), buf.size, m, c, h, w, exc_cap,
            flags.ctypes.data_as(_U8P), q.ctypes.data_as(_U8P),
            n_threads or DEFAULT_THREADS)
    _check(rc, what, buf.size)
    return flags.astype(bool), q


def wire_unpack(
    buf: np.ndarray, m: int, c: int, h: int, w: int, exc_cap: int,
    n_threads: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode a v2 buffer: (flags (M,) bool, q (M, C, H, W) uint8). Pairs
    with flag False are left unwritten in q (raw fallback)."""
    return _unpack_u8(_lib_or_raise().df_wire_unpack, "wire unpack",
                      buf, m, c, h, w, exc_cap, n_threads)


def wire_unpack_v3(
    buf: np.ndarray, m: int, c: int, h: int, w: int, exc_cap: int,
    n_threads: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode a v3 buffer (at least its used prefix): (flags (M,) bool,
    q (M, C, H, W) uint8). Pairs with flag False are left unwritten."""
    return _unpack_u8(_lib_or_raise().df_wire_unpack_v3, "wire v3 unpack",
                      buf, m, c, h, w, exc_cap, n_threads)


def wire_unpack_v4(
    buf: np.ndarray, m: int, h: int, w: int, n_threads: int = 0
) -> np.ndarray:
    """Decode a v4 buffer (at least its used prefix) -> (M, H, W, 2)
    float32."""
    lib = _lib_or_raise()
    buf = np.ascontiguousarray(buf, dtype=np.uint8).reshape(-1)
    out = np.empty((m, h, w, 2), np.float32)
    rc = lib.df_wire_unpack_v4(
        buf.ctypes.data_as(_U8P), buf.size, m, h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_threads or DEFAULT_THREADS)
    _check(rc, "wire v4 unpack", buf.size)
    return out
