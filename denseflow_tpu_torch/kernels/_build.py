"""Build and load the package's native libraries.

Each CUDA kernel `csrc/<name>.cu` has a plain C interface and is compiled
with `nvcc` for sm_90a; the host emitter `native/emitter.cpp` is compiled
with `g++` against libjpeg and libpng, and the wire decoders
`native/wire.cpp` with `g++` and -lpthread alone. Each goes into a shared
library under `build/denseflow_tpu_torch/` beside the package (the file
name carries a hash of the source, the headers it may include, the flags
and the libraries, so an edit rebuilds), then is loaded with ctypes. A build writes
a temporary file and moves it in with `os.replace`, so processes that build
the same library at once do not see a half-written one. Nothing is compiled
when the package is imported: the first call that needs a library builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Iterable, Tuple

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG.parent / "build" / "denseflow_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    # every product and sum rounded on its own, as in the plain versions
    "--fmad=false",
    "-Xptxas", "-v",
)
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-Wall")
EMITTER_LIBS = ("-ljpeg", "-lpng", "-lz", "-lpthread")
WIRE_LIBS = ("-lpthread",)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# compiler output (registers, shared memory, spills) of each build
BUILD_LOGS: Dict[str, str] = {}


def _find(tool: str, *more: str) -> str:
    for cand in (shutil.which(tool), *more):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"{tool} not found")


def _nvcc() -> str:
    try:
        return _find("nvcc", "/usr/local/cuda/bin/nvcc")
    except RuntimeError:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the package's kernels") from None


def _gxx() -> str:
    return _find("g++")


@dataclass(frozen=True)
class Recipe:
    """How one library is built: `compiler` (found when the build runs)
    compiles `source`, which may include `headers`, with `flags`, and links
    `libs`."""

    compiler: Callable[[], str]
    flags: Tuple[str, ...]
    source: Path
    headers: Tuple[Path, ...] = ()
    libs: Tuple[str, ...] = ()


def recipe(name: str) -> Recipe:
    """The recipe of library `name`: "emitter", "wire" (a library of its
    own, so that the decoders build where libjpeg and libpng do not), or
    the kernel csrc/<name>.cu (with the shared csrc/*.cuh headers)."""
    if name == "emitter":
        return Recipe(_gxx, GXX_FLAGS, PKG / "native" / "emitter.cpp",
                      libs=EMITTER_LIBS)
    if name == "wire":
        return Recipe(_gxx, GXX_FLAGS, PKG / "native" / "wire.cpp", libs=WIRE_LIBS)
    return Recipe(_nvcc, NVCC_FLAGS, CSRC / f"{name}.cu",
                  tuple(sorted(CSRC.glob("*.cuh"))))


def _target(name: str, r: Recipe) -> Path:
    text = r.source.read_bytes() + b"".join(p.read_bytes() for p in r.headers)
    text += " ".join(r.flags + r.libs).encode()
    tag = hashlib.sha256(text).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build(names: Iterable[str]) -> None:
    """Compile every library in `names` that is not built yet, one compiler
    per source, all started together."""
    with _lock:
        jobs = {}
        for n in names:
            r = recipe(n)
            out = _target(n, r)
            if n in _libs or out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [r.compiler(), *r.flags, "-o", str(tmp), str(r.source), *r.libs]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs[n] = (proc, tmp, out, f"{Path(cmd[0]).name} failed for "
                       f"{r.source.relative_to(PKG.parent)}")
        for n, (proc, tmp, out, failed) in jobs.items():
            BUILD_LOGS[n], _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"{failed}:\n{BUILD_LOGS[n]}")
            os.replace(tmp, out)


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name` (see `recipe`), built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_target(name, recipe(name))))
        return _libs[name]
