"""ctypes bindings for the native emitter (emitter.cpp): a worker pool of
libjpeg/libpng encoders that write a batch of uint8 planes to files.

The port of the jpg/png half of the JAX package's
`denseflow_tpu/native/__init__.py`. The library is built with g++ on first
use into `build/denseflow_tpu_torch/` (kernels/_build.py); it needs the
libjpeg and libpng headers. Where it does not build, `available()` is False,
`build_error()` says why, and the callers encode with cv2, which writes the
same file names. A batch that fails in the library raises.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Sequence

import numpy as np

from denseflow_tpu_torch.kernels import _build

# OpenCV's imencode('.jpg') default quality — the reference's effective
# setting (SURVEY.md §2.2 C21/N6).
JPEG_QUALITY = 95
DEFAULT_THREADS = max(2, (os.cpu_count() or 4) // 2)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def _load() -> Optional[ctypes.CDLL]:
    """The emitter library, built and bound on the first call; None, with
    the reason kept in `_error`, when it cannot be built or loaded."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                lib = _build.load("emitter")
            except (RuntimeError, OSError) as e:
                _error = str(e).strip() or type(e).__name__
                return None
            u8p = ctypes.POINTER(ctypes.c_uint8)
            for fn in (lib.df_write_jpg_batch, lib.df_write_jpg_color_batch):
                fn.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
                fn.restype = ctypes.c_int
            lib.df_write_png_batch.argtypes = [
                u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_char_p, ctypes.c_int,
            ]
            lib.df_write_png_batch.restype = ctypes.c_int
            _lib = lib
        return _lib


def available() -> bool:
    """True when the emitter is built and loaded (building it if needed)."""
    return _load() is not None


def build_error() -> Optional[str]:
    """The compiler's or the loader's message when the emitter is not
    available, else None."""
    _load()
    return _error


def first_error_line(error: Optional[str]) -> str:
    """The line of a failed build's message that says what failed."""
    lines = [ln.strip() for ln in (error or "").splitlines() if ln.strip()]
    return next((ln for ln in lines[1:] if "error" in ln), lines[0] if lines else "")


def describe() -> str:
    """The jpg/png writer that runs: "native, k threads", or "cv2: <the
    first error line of the failed build>"."""
    if available():
        return f"native, {DEFAULT_THREADS} threads"
    return f"cv2: emitter not built ({first_error_line(_error)})"


def _paths_blob(paths: Sequence[str], n: int) -> bytes:
    if len(paths) != n:
        raise ValueError(f"{n} images but {len(paths)} paths")
    return b"".join(os.fsencode(p) + b"\0" for p in paths)


def _call(fn, images: np.ndarray, paths: Sequence[str], *args) -> None:
    n, h, w = images.shape[:3]
    rc = fn(images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, h, w,
            _paths_blob(paths, n), *args)
    if rc != n:
        raise RuntimeError(f"native {fn.__name__} failed for a batch of {n}")


def _lib_or_raise() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native emitter is not available: {_error}")
    return lib


def write_jpg_batch(
    planes: np.ndarray, paths: Sequence[str], n_threads: int = 0
) -> None:
    """planes: (N, H, W) uint8 gray. Encodes + writes in parallel."""
    lib = _lib_or_raise()
    planes = np.ascontiguousarray(planes, dtype=np.uint8)
    if planes.ndim != 3:
        raise ValueError(f"gray planes must be (N, H, W), not {planes.shape}")
    _call(lib.df_write_jpg_batch, planes, paths, JPEG_QUALITY,
          n_threads or DEFAULT_THREADS)


def _check_bgr(frames: np.ndarray) -> np.ndarray:
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    if frames.ndim != 4 or frames.shape[3] != 3:
        raise ValueError(f"BGR frames must be (N, H, W, 3), not {frames.shape}")
    return frames


def write_jpg_color_batch(
    frames: np.ndarray, paths: Sequence[str], n_threads: int = 0
) -> None:
    """frames: (N, H, W, 3) uint8 BGR."""
    lib = _lib_or_raise()
    _call(lib.df_write_jpg_color_batch, _check_bgr(frames), paths,
          JPEG_QUALITY, n_threads or DEFAULT_THREADS)


def write_png_batch(
    frames: np.ndarray, paths: Sequence[str], n_threads: int = 0
) -> None:
    """frames: (N, H, W, 3) uint8 BGR."""
    lib = _lib_or_raise()
    _call(lib.df_write_png_batch, _check_bgr(frames), paths,
          n_threads or DEFAULT_THREADS)
