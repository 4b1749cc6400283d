"""The port's multi-device executor (--devices) on eight patched CPU
devices, the counterpart of tests/test_sharding.py on conftest's eight
virtual JAX devices: each slab splits into equal sub-slabs, one a device,
and the files are those of one device.

Measured on the CPU (1 and 8 threads): every payload of 1 vs 2, 4 and 8
shards is bit-equal, h5 included, for tvl1, farn and brox. The JAX
package allows 1e-2 px on h5 (tests/test_sharding.py:77-91) because its
batch-1 and batch-8 XLA programs reduce in other orders; the port's plain
versions reduce each pair's stop sum alone, so the h5 case asserts
equality.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import denseflow_tpu.executor as jex
import denseflow_tpu_torch.executor as tex
from conftest import make_translating_video
from denseflow_tpu_torch.cli import main, parse_args, run
from denseflow_tpu_torch.config import FlowConfig
from denseflow_tpu_torch.executor import DeviceExecutor
from denseflow_tpu_torch.io.reader import VideoSource
from denseflow_tpu_torch.utils import local_devices
from test_torch_emission import _fused_solver

torch.set_num_threads(1)

CPU = "--device=cpu"


@pytest.fixture
def eight_cpus(monkeypatch):
    """local_devices("cpu") as eight CPU devices; executors built before
    (cached by device count, not by devices) are dropped on both sides."""
    monkeypatch.setattr(tex, "local_devices", lambda name: [torch.device("cpu")] * 8)
    tex._get_executor_locked.cache_clear()
    yield
    tex._get_executor_locked.cache_clear()


def _frames(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    base = ndi.gaussian_filter(rng.uniform(0, 255, (n, h + 8, w + 8)), (0, 2, 2))
    return np.clip(base[:, 4:4 + h, 4:4 + w], 0, 255).astype(np.uint8)


def _ex(alg, h, w, step, st, pair_batch, n_dev, **kw):
    return DeviceExecutor(alg, h, w, step, 20, pair_batch, device="cpu",
                          save_type=st, n_devices=n_dev, **kw)


def _files(d: Path):
    return {f.name: f.read_bytes() for f in sorted(d.iterdir())}


# ---------------- the cases of tests/test_sharding.py ----------------

def test_jpg_payload_byte_identical(eight_cpus):
    frames = _frames(20, 64, 80)
    ex1 = _ex("tvl1", 64, 80, 1, "jpg", 16, 1)
    ex8 = _ex("tvl1", 64, 80, 1, "jpg", 16, 8)
    assert (ex1.n_dev, ex8.n_dev, ex8.b_loc) == (1, 8, 2)
    qx1, qy1 = ex1.run_chunk(frames.copy(), 20)
    qx8, qy8 = ex8.run_chunk(frames.copy(), 20)
    assert qx1.shape == (19, 64, 80)
    assert np.array_equal(qx1, qx8) and np.array_equal(qy1, qy8)


def test_png_and_batch_rounding(eight_cpus):
    frames = _frames(11, 48, 64)
    # pair_batch=6 over 4 devices -> global B rounded up to 8
    ex4 = _ex("tvl1", 48, 64, 1, "png", 6, 4)
    assert ex4.B == 8 and ex4.b_loc == 2
    p4 = ex4.run_chunk(frames.copy(), 11)
    p1 = _ex("tvl1", 48, 64, 1, "png", 6, 1).run_chunk(frames.copy(), 11)
    assert p4.shape == (10, 48, 64, 3)
    assert np.array_equal(p1, p4)


def test_negative_step_h5(eight_cpus):
    """Raw float32 flow at step -2: bit-equal (JAX's own test allows 1e-2 px;
    see the module docstring)."""
    frames = _frames(10, 48, 64)
    f1 = _ex("tvl1", 48, 64, -2, "h5", 8, 1).run_chunk(frames.copy(), 10)
    f8 = _ex("tvl1", 48, 64, -2, "h5", 8, 8).run_chunk(frames.copy(), 10)
    assert f8.shape == (8, 48, 64, 2) and f8.dtype == np.float32
    np.testing.assert_array_equal(f1, f8)


def test_cli_devices_flag_byte_identity(eight_cpus, tmp_path):
    path, _ = make_translating_video(tmp_path / "v.avi", h=48, w=64, n=10, dx=1)

    def go(out, ndev):
        stats = {}
        cfg = parse_args([path, f"-o={out}", "-s=1", "-b=8", "--pairBatch=4",
                          f"--devices={ndev}", CPU])
        assert run(cfg, stats_out=stats) == 0
        assert stats["devices"] == ["cpu"] * ndev
        return _files(Path(out) / "v")

    single = go(tmp_path / "d1", 1)
    assert len(single) == 18  # 9 pairs x 2 planes
    assert go(tmp_path / "d8", 8) == single


# ---------------- beyond tests/test_sharding.py ----------------

@pytest.mark.parametrize("alg,h,w,n", [("farn", 48, 64, 10), ("brox", 24, 32, 5)])
@pytest.mark.parametrize("n_dev", [2, 4])
def test_farn_and_brox_jpg_byte_identical(eight_cpus, alg, h, w, n, n_dev):
    frames = _frames(n, h, w, seed=2)
    q1 = _ex(alg, h, w, 1, "jpg", 4, 1, preset="fast").run_chunk(frames.copy(), n)
    qn = _ex(alg, h, w, 1, "jpg", 4, n_dev, preset="fast").run_chunk(frames.copy(), n)
    assert q1[0].shape == (n - 1, h, w)
    assert np.array_equal(q1[0], qn[0]) and np.array_equal(q1[1], qn[1])


@pytest.mark.parametrize("pair_batch,n_dev", [
    (16, 1), (16, 8), (6, 4), (5, 3), (1, 8), (20, 6), (3, 2), (7, 7)])
def test_slab_rounding_matches_jax(eight_cpus, pair_batch, n_dev):
    """B = ceil(pair_batch / n) * n, B / n pairs a device, and the chunk
    buckets B * 2^k, as the JAX executor computes them
    (executor.py:193, 215)."""
    t = _ex("nv", 16, 20, 1, "jpg", pair_batch, n_dev)
    j = jex.DeviceExecutor("nv", 16, 20, 1, 20, "jpg", pair_batch, 64, None, n_dev)
    assert (t.n_dev, t.B, t.b_loc) == (j.n_dev, j.B, j.B // j.n_dev)
    assert t.B % n_dev == 0 and t.B >= pair_batch > t.B - n_dev
    for n in (2, 5, 17, 40, 129):
        assert t._padded_len(n) == j._padded_len(n)


@pytest.mark.parametrize("flag,want", [(0, 8), (16, 8), (3, 3)])
def test_devices_flag_takes_what_exists(eight_cpus, tmp_path, capsys, flag, want):
    """--devices=0 takes every local device, as in JAX; more than exist
    takes what exists; -v and stats_out["devices"] say which ran."""
    path, _ = make_translating_video(tmp_path / "v.avi", h=32, w=40, n=4, dx=1)
    stats = {}
    cfg = parse_args([path, f"-o={tmp_path}", "-s=1", "-a=nv", "--pairBatch=4", "-v",
                      f"--devices={flag}", CPU])
    assert run(cfg, stats_out=stats) == 0
    assert stats["devices"] == ["cpu"] * want
    assert f"devices: {', '.join(['cpu'] * want)} (--devices={flag})" in capsys.readouterr().out
    assert len(list((tmp_path / "v").glob("flow_x_*.jpg"))) == 3


def test_local_devices():
    """Unpatched: "cpu" is one device; "cuda" without a card raises."""
    assert local_devices("cpu") == [torch.device("cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            local_devices("cuda")
        assert main(["x.avi", "-s=1", "--devices=2"]) == 1


def test_eight_shards_within_gate_of_jax_eight_devices(eight_cpus, tmp_path):
    """The port's 8-shard jpg planes against the JAX executor on its eight
    virtual devices (shard_map, its fused solver in interpret mode), on the
    decoded video of tests/test_torch_cli.py's one-device gate (<= 1 LSB on
    < 1%): measured 1 LSB on 0.015%. (On `_frames(9, 64, 80, seed=4)`
    JAX's own 1 and 8 devices differ by up to 6 LSB on 0.78%, the port's
    1 and 8 shards not at all.)"""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual JAX devices")
    path, _ = make_translating_video(tmp_path / "v.avi", h=64, w=80, n=9, dx=2)
    frames = next(iter(VideoSource(path, FlowConfig(input=path, step=1)).chunks(1))).frames
    tx, ty = _ex("tvl1", 64, 80, 1, "jpg", 8, 8).run_chunk(frames.copy(), 9)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jex, "make_solver", _fused_solver)
        j8 = jex.DeviceExecutor("tvl1", 64, 80, 1, 20, "jpg", 8, 64, None, 8)
        jx, jy = j8.run_chunk(frames.copy(), 9)
    assert j8.n_dev == 8 and tx.shape == jx.shape == (8, 64, 80)
    for a, b in ((tx, jx), (ty, jy)):
        d = np.abs(a.astype(np.int16) - b.astype(np.int16))
        assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())
