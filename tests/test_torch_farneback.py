"""The port's Farneback against the JAX package's: the filters and level
operators it is built from, the solver on its fused-kernel path run through
the Pallas interpreter, the repo's gates (analytic goldens, cv2), the
preset registry, batch invariance, and the executor and CLI with -a=farn.

Tolerances:
* filters, `_level_geometry`, `_level_matrices`: equal bit for bit;
* the level image: max |d| < 2e-3 on values of scale 50, the JAX package's
  own matmul-vs-filter gate (tests/test_ops.py:229-248); the port's
  products run in float64, JAX's in float32;
* `farneback_flow`: mean |d flow| < 1e-3 px and max < 1e-2 px against the
  JAX fused path (measured mean 3.8e-7 px, max 3.6e-6 px);
* jpg planes: at most 1 LSB, on fewer than 1% of the pixels (measured:
  identical).
"""

import dataclasses
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from conftest import make_translating_video
from denseflow_tpu.algorithms import solver_params as j_solver_params
from denseflow_tpu.algorithms import farneback as jfb
from denseflow_tpu.cli import main as j_main
from denseflow_tpu.ops import filters as jfilters
from denseflow_tpu.quantize import quantize_flow_pair as j_quantize
from denseflow_tpu_torch.algorithms import farneback as tfb
from denseflow_tpu_torch.algorithms import make_solver, solver_params
from denseflow_tpu_torch.cli import main
from denseflow_tpu_torch.config import FlowConfig
from denseflow_tpu_torch.executor import DeviceExecutor
from denseflow_tpu_torch.io.reader import VideoSource
from denseflow_tpu_torch.ops import filters as tfilters

torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden"
GATE = 0.5  # px, tests/test_fidelity.py
P = tfb.FarnebackParams()


def _translated_pair(h=96, w=128, dx=2.3, dy=-1.6, seed=1):
    """tests/test_solvers.py::_translated_pair."""
    rng = np.random.default_rng(seed)
    base = ndi.gaussian_filter(rng.uniform(0, 255, (h + 20, w + 20)), 2.0).astype(np.float32)
    ys, xs = np.mgrid[0:h, 0:w]
    I0 = np.clip(base[10:10 + h, 10:10 + w], 0, 255).astype(np.uint8)
    I1 = np.clip(
        ndi.map_coordinates(base, [ys + 10 - dy, xs + 10 - dx], order=3), 0, 255
    ).astype(np.uint8)
    return I0, I1


def _np(t):
    return np.asarray(t)


# ---------------- filters ----------------

@pytest.mark.parametrize("ksize,sigma", [(3, 0.0), (5, 1.1), (9, 1.5), (17, 3.5), (39, 7.5), (77, 15.5)])
def test_gaussian_kernel_matches(ksize, sigma):
    np.testing.assert_array_equal(tfilters.gaussian_kernel_1d(ksize, sigma),
                                  jfilters.gaussian_kernel_1d(ksize, sigma))


@pytest.mark.parametrize("border", ["reflect101", "replicate"])
@pytest.mark.parametrize("ksize", [3, 5, 11, 13])
def test_conv1d_and_sep_filter_match(border, ksize):
    rng = np.random.default_rng(ksize)
    x = rng.normal(0, 50, (2, 19, 27)).astype(np.float32)
    k = rng.normal(0, 1, ksize).astype(np.float32)
    for dim in (1, 2):
        np.testing.assert_array_equal(
            tfilters.conv1d(torch.from_numpy(x), k, dim, border).numpy(),
            _np(jfilters.conv1d(jnp.asarray(x), k, dim, border)))
    k2 = rng.normal(0, 1, ksize).astype(np.float32)
    np.testing.assert_array_equal(
        tfilters.sep_filter2d(torch.from_numpy(x), k, k2, border).numpy(),
        _np(jfilters.sep_filter2d(jnp.asarray(x), k, k2, border)))
    np.testing.assert_array_equal(
        tfilters.box_filter(torch.from_numpy(x), ksize, border).numpy(),
        _np(jfilters.box_filter(jnp.asarray(x), ksize, border)))


def test_pad_refuses_unknown_border():
    with pytest.raises(ValueError):
        tfilters.conv1d(torch.zeros(4, 5), np.ones(3, np.float32), 1, "wrap")


# ---------------- level operators ----------------

@pytest.mark.parametrize("hw", [(256, 341), (96, 128), (64, 80), (37, 53), (8, 8), (20, 9)])
@pytest.mark.parametrize("preset", ["default", "fast", "quality"])
def test_level_geometry_matches(hw, preset):
    jp = j_solver_params("farn", preset)
    assert tfb._level_geometry(*hw, solver_params("farn", preset)) == jfb._level_geometry(*hw, jp)


def test_main_path_geometry():
    """At 256x341: six levels, 170.5 rounding half to even."""
    sizes = [(lh, lw) for _, lh, lw, _, _ in tfb._level_geometry(256, 341, P)]
    assert sizes == [(8, 11), (16, 21), (32, 43), (64, 85), (128, 170), (256, 341)]


@pytest.mark.parametrize("h,w", [(256, 341), (48, 64)])
def test_level_matrices_match(h, w):
    for _, lh, lw, ksize, sigma in tfb._level_geometry(h, w, P):
        got = tfb._level_matrices(h, w, lh, lw, ksize, sigma)
        want = jfb._level_matrices(h, w, lh, lw, ksize, sigma)
        for a, b in zip(got, want):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("lh,lw,ksize,sigma", [(24, 32, 9, 1.5), (12, 16, 17, 3.5), (48, 64, 3, 0.0)])
def test_level_image_matches_jax(lh, lw, ksize, sigma):
    x = np.random.default_rng(0).normal(0, 50, (2, 48, 64)).astype(np.float32)
    got = tfb._level_image(torch.from_numpy(x), lh, lw, ksize, sigma).numpy()
    want = _np(jfb._level_image_matmul(jnp.asarray(x), lh, lw, ksize, sigma))
    assert np.abs(got - want).max() < 2e-3


def test_level_image_ignores_the_callers_matmul_precision():
    x = torch.from_numpy(np.random.default_rng(2).normal(0, 50, (3, 48, 64)).astype(np.float32))
    want = tfb._level_image(x, 24, 32, 9, 1.5)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        got = tfb._level_image(x, 24, 32, 9, 1.5)
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert got.dtype == torch.float32 and torch.equal(got, want)


# ---------------- the solver ----------------

def test_params_match_jax():
    jd = dataclasses.asdict(jfb.FarnebackParams())
    assert "use_pallas" in jd
    assert tfb.farneback_params_from_reference(jd) == tfb.FarnebackParams()
    assert dataclasses.asdict(tfb.FarnebackParams()) == \
        {k: v for k, v in jd.items() if k != "use_pallas"}


@pytest.mark.parametrize("preset", [None, "default", "fast", "quality"])
def test_presets_resolve_like_jax(preset):
    want = tfb.farneback_params_from_reference(
        dataclasses.asdict(j_solver_params("farn", preset)))
    assert solver_params("farn", preset) == want


def test_matches_jax_fused_path():
    I0, I1 = _translated_pair()
    ref = _np(jfb.farneback_flow(jnp.asarray(I0[None], jnp.float32),
                                 jnp.asarray(I1[None], jnp.float32),
                                 jfb.FarnebackParams(), interpret=True))[0]
    got = tfb.farneback_flow(torch.from_numpy(I0[None]).float(),
                             torch.from_numpy(I1[None]).float(), P)[0].numpy()
    d = np.abs(got - ref)
    assert d.mean() < 1e-3 and d.max() < 1e-2, (d.mean(), d.max())


def test_matches_cv2_oracle():
    """tests/test_solvers.py:91-98."""
    I0, I1 = _translated_pair()
    ref = cv2.calcOpticalFlowFarneback(I0, I1, None, 0.5, 5, 13, 10, 5, 1.1, 0)
    solver = make_solver("farn", 96, 128, device="cpu")
    ours = solver(torch.from_numpy(I0[None]), torch.from_numpy(I1[None]))[0].numpy()
    epe = np.linalg.norm(ours - ref, axis=-1)
    assert epe[10:-10, 10:-10].mean() < 0.02
    assert epe.mean() < 0.05


@pytest.mark.parametrize("name", ["translation", "rotation", "diag"])
def test_golden_gate(name):
    """tests/test_fidelity.py:52-64: mean EPE against the analytic flow."""
    d = np.load(GOLDEN / f"tvl1_{name}.npz")
    solver = tfb.make_farneback_solver(*d["I0"].shape, P, device="cpu")
    flow = solver(torch.from_numpy(d["I0"][None]), torch.from_numpy(d["I1"][None]))[0].numpy()
    assert float(np.linalg.norm(flow - d["gt"], axis=-1).mean()) < GATE


def test_batch_invariance_byte_for_byte():
    """A pair's flow depends neither on its batch-mates nor on B."""
    pairs = [_translated_pair(h=48, w=64, seed=s, dx=1.0 + s * 0.3, dy=-0.5) for s in range(3)]
    I0 = np.stack([p[0] for p in pairs])
    I1 = np.stack([p[1] for p in pairs])
    I1[1] = I0[1]  # a batch-mate that stops at once
    solver = make_solver("farn", 48, 64, device="cpu")
    batched = solver(torch.from_numpy(I0), torch.from_numpy(I1)).numpy()
    for i in range(3):
        single = solver(torch.from_numpy(I0[i:i + 1]), torch.from_numpy(I1[i:i + 1])).numpy()[0]
        assert np.array_equal(batched[i].view(np.uint32), single.view(np.uint32))


def test_max_disp_override_and_even_window():
    I0, I1 = _translated_pair(h=48, w=64, dx=2.0, dy=0.0)
    s = make_solver("farn", 48, 64, preset="fast", max_disp=80, device="cpu")
    flow = s(torch.from_numpy(I0[None]), torch.from_numpy(I1[None]))[0].numpy()
    assert float(np.linalg.norm(flow[10:-10, 10:-10] - [2.0, 0.0], axis=-1).mean()) < 0.4
    even = tfb.make_farneback_solver(48, 64, dataclasses.replace(P, win_size=12), "cpu")
    with pytest.raises(ValueError, match="odd"):
        even(torch.from_numpy(I0[None]), torch.from_numpy(I1[None]))


# ---------------- executor and CLI ----------------

def test_run_chunk_matches_jax_solver_and_quantizer(tmp_path):
    path, _ = make_translating_video(tmp_path / "v.avi", h=48, w=64, n=5, dx=2)
    frames = next(iter(VideoSource(path, FlowConfig(input=path, step=1)).chunks(1))).frames
    ex = DeviceExecutor("farn", 48, 64, 1, 8, 4, device="cpu")
    qx, qy = ex.run_chunk(frames, len(frames))
    assert qx.shape == qy.shape == (4, 48, 64) and qx.dtype == np.uint8
    flow = jfb.farneback_flow(jnp.asarray(frames[:-1], jnp.float32),
                              jnp.asarray(frames[1:], jnp.float32),
                              jfb.FarnebackParams(), interpret=True)
    jx, jy = (_np(a) for a in j_quantize(flow, 8.0))
    for a, b in ((qx, jx), (qy, jy)):
        d = np.abs(a.astype(np.int16) - b.astype(np.int16))
        assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("step", [-1, 1, 2])
def test_cli_file_set_matches_jax_and_values(tmp_path, step):
    path, (fx, fy) = make_translating_video(tmp_path / "v.avi", h=64, w=80, n=9, dx=2)
    args = [path, "-a=farn", f"-s={step}", "-b=8", "--pairBatch=4"]
    assert main(args + [f"-o={tmp_path / 't'}", "--device=cpu"]) == 0
    assert j_main(args + [f"-o={tmp_path / 'j'}"]) == 0
    t_files = sorted(p.name for p in (tmp_path / "t" / "v").iterdir())
    assert t_files == sorted(p.name for p in (tmp_path / "j" / "v").iterdir())
    assert len(t_files) == 2 * (9 - abs(step))
    sign = 1 if step > 0 else -1
    want_x = round(255.0 * (sign * abs(step) * fx + 8) / 16.0)
    want_y = round(255.0 * (fy + 8) / 16.0)
    mid = sorted((tmp_path / "t" / "v").glob("flow_x*.jpg"))[3]
    img = cv2.imread(str(mid), cv2.IMREAD_GRAYSCALE)[16:-16, 16:-16]
    assert abs(img.mean() - want_x) <= 3
    img = cv2.imread(str(mid).replace("flow_x", "flow_y"), cv2.IMREAD_GRAYSCALE)[16:-16, 16:-16]
    assert abs(img.mean() - want_y) <= 3
