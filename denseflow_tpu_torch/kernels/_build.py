"""Build and load the package's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface. It is compiled with `nvcc`
for sm_90a into a shared library under `build/denseflow_tpu_torch/` beside
the package (the file name carries a hash of the source, the shared
`csrc/*.cuh` headers and the flags, so an edit rebuilds), then loaded with
ctypes. Nothing is compiled when the
package is imported: the first call that launches a kernel builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "denseflow_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    # every product and sum rounded on its own, as in the plain versions
    "--fmad=false",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# compiler output (registers, shared memory, spills) of each build
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the package's kernels")


def _target(name: str) -> Path:
    # the source, the shared headers it may include, and the flags
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build(names: Iterable[str]) -> None:
    """Compile every kernel in `names` that is not built yet, one nvcc per
    source, all started together."""
    with _lock:
        jobs = {}
        for n in names:
            out = _target(n)
            if n in _libs or out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs[n] = (proc, tmp, out)
        for n, (proc, tmp, out) in jobs.items():
            BUILD_LOGS[n], _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for csrc/{n}.cu:\n{BUILD_LOGS[n]}")
            os.replace(tmp, out)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return _libs[name]
