"""denseflow_tpu_torch and its benchmark (bench_cuda/) stand alone: they
import neither jax nor the JAX package, and refuse to run on a card that is
not there."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "denseflow_tpu_torch"
BENCH = ROOT / "bench_cuda"


def _modules():
    mods = []
    for p in sorted(PKG.rglob("*.py")) + sorted(BENCH.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def test_every_module_imports_without_jax():
    """A fresh interpreter (tests/conftest.py imports jax, so not this one)."""
    mods = _modules()
    assert "denseflow_tpu_torch.kernels.tvl1_fused" in mods
    assert "denseflow_tpu_torch.kernels.farneback_fused" in mods
    assert "denseflow_tpu_torch.algorithms.farneback" in mods
    assert "denseflow_tpu_torch.kernels.brox_fused" in mods
    assert "denseflow_tpu_torch.kernels._cluster" in mods
    assert "denseflow_tpu_torch.algorithms.brox" in mods
    assert "denseflow_tpu_torch.native" in mods
    assert "denseflow_tpu_torch.parallel" in mods
    assert "denseflow_tpu_torch.parallel.distributed" in mods
    assert "denseflow_tpu_torch.wire" in mods
    assert "denseflow_tpu_torch.native.wire" in mods
    for m in ("bench_cuda", "bench_cuda.bench", "bench_cuda.check", "bench_cuda.content",
              "bench_cuda.reference", "bench_cuda.sensitivity", "bench_cuda.spread",
              "bench_cuda.trace"):
        assert m in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'denseflow_tpu' or k.startswith('denseflow_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


_IMPORT = re.compile(
    r"^\s*(?:from|import)\s+(?:jax|jaxlib|denseflow_tpu(?!_torch))\b"
    r"|import_module\(\s*['\"](?:jax|denseflow_tpu(?!_torch))",
    re.M,
)


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in [*PKG.rglob("*.py"), *BENCH.rglob("*.py")])
    + ["chip_smoke.py", "encode_pool_timing.py", "executor_timing.py"],
)
def test_source_imports_no_jax(path):
    text = (ROOT / path).read_text()
    assert not _IMPORT.findall(text), f"{path} imports jax or denseflow_tpu"


@pytest.mark.parametrize("name", ["emitter", "wire", "tvl1_scale", "farneback_polyexp",
                                  "farneback_level", "brox_scale"])
def test_native_sources_lie_inside_the_port(name):
    """Every library the port builds, the emitter and the wire decoders
    included, compiles a source (and headers) of the port's own, never one of denseflow_tpu/,
    into build/denseflow_tpu_torch/."""
    from denseflow_tpu_torch.kernels import _build

    r = _build.recipe(name)
    for p in (r.source, *r.headers):
        assert p.is_file() and p.resolve().is_relative_to(PKG), p
    assert _build.BUILD_DIR == ROOT / "build" / "denseflow_tpu_torch"
    assert _build._target(name, r).parent == _build.BUILD_DIR


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")


def test_resolve_device_refuses_missing_card():
    _no_card()
    from denseflow_tpu_torch.utils import resolve_device

    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")


def test_entry_points_refuse_missing_card(tmp_path):
    _no_card()
    from denseflow_tpu_torch.algorithms import make_solver
    from denseflow_tpu_torch.cli import main
    from denseflow_tpu_torch.config import FlowConfig
    from denseflow_tpu_torch.executor import DeviceExecutor

    for alg in ("tvl1", "farn", "brox"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_solver(alg, 32, 40)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceExecutor("tvl1", 32, 40, 1, 20, 4)
    video = tmp_path / "v.avi"
    video.write_bytes(b"x")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from denseflow_tpu_torch.cli import run

        run(FlowConfig(input=str(video), output_dir=str(tmp_path), step=1))
    # the CLI reports it and fails; nothing was written
    assert main([str(video), f"-o={tmp_path / 'o'}", "-s=1"]) == 1
    assert main([str(video), f"-o={tmp_path / 'o'}", "-s=1", "-a=farn"]) == 1
    assert main([str(video), f"-o={tmp_path / 'o'}", "-s=1", "-a=brox"]) == 1
    assert not (tmp_path / "o").exists()


def test_kernel_wrapper_refuses_other_devices():
    from denseflow_tpu_torch.kernels.tvl1_fused import tvl1_scale

    z = torch.zeros((1, 8, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tvl1_scale(z, z, z, z, z, z, l_t=0.045, theta=0.3, taut=0.8,
                   epsilon=0.01, iterations=4, warps=1, max_disp=4.0,
                   check_every=2)
    c = torch.from_numpy(np.zeros((1, 8, 8), np.float32))
    with pytest.raises(ValueError, match="contiguous"):
        tvl1_scale(c, c, c, c, c, c.transpose(1, 2), l_t=0.045, theta=0.3,
                   taut=0.8, epsilon=0.01, iterations=4, warps=1,
                   max_disp=4.0, check_every=2)
    with pytest.raises(ValueError, match="float32"):
        tvl1_scale(c.double(), c, c, c, c, c, l_t=0.045, theta=0.3, taut=0.8,
                   epsilon=0.01, iterations=4, warps=1, max_disp=4.0,
                   check_every=2)
