"""The port's Brox against the JAX package's: the parameters and presets,
the pyramid, the solver on its fused-kernel path run through the Pallas
interpreter, batch invariance, and the executor and CLI with -a=brox.

Tolerances:
* `brox_flow`: mean |d flow| < 5e-3 px and max < 5e-2 px against JAX
  `brox_flow(interpret=True)`, the JAX package's own fused-vs-XLA gate
  (tests/test_brox_fused.py:72-73); measured mean <= 2.5e-7 px, max
  1.6e-6 px;
* jpg planes: at most 1 LSB, on fewer than 1% of the pixels (measured:
  identical);
* the CLI's jpgs: the same file set as the JAX CLI, values within +-3 of
  the translation's quantized flow.
"""

import dataclasses

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from conftest import make_translating_video
from denseflow_tpu.algorithms import brox as jbx
from denseflow_tpu.algorithms import solver_params as j_solver_params
from denseflow_tpu.cli import main as j_main
from denseflow_tpu.ops.pyramid import pyramid_shapes as j_pyramid_shapes
from denseflow_tpu.quantize import quantize_flow_pair as j_quantize
from denseflow_tpu_torch.algorithms import brox as tbx
from denseflow_tpu_torch.algorithms import make_solver, solver_params
from denseflow_tpu_torch.cli import main
from denseflow_tpu_torch.config import FlowConfig
from denseflow_tpu_torch.executor import DeviceExecutor
from denseflow_tpu_torch.io.reader import VideoSource
from denseflow_tpu_torch.ops.pyramid import pyramid_shapes

torch.set_num_threads(1)

P = tbx.BroxParams()
# tests/test_brox_fused.py:25-28
FAST = dict(inner_iterations=3, outer_iterations=4, solver_iterations=4)


def _translated_pair(h, w, dx=1.7, dy=-0.8, seed=3):
    """tests/test_brox_fused.py::TestFullFlow: smooth noise in [0, 1] and its
    copy moved by (dx, dy)."""
    rng = np.random.default_rng(seed)
    base = ndi.gaussian_filter(rng.uniform(0, 1, (h + 16, w + 16)), 1.5).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    I0 = base[8:8 + h, 8:8 + w]
    I1 = ndi.map_coordinates(base, [yy + 8 - dy, xx + 8 - dx], order=3,
                             mode="nearest").astype(np.float32)
    return I0, I1


# ---------------- parameters ----------------

def test_params_match_jax():
    jd = dataclasses.asdict(jbx.BroxParams())
    assert "use_pallas" in jd
    assert tbx.brox_params_from_reference(jd) == P
    assert dataclasses.asdict(P) == {k: v for k, v in jd.items() if k != "use_pallas"}


@pytest.mark.parametrize("preset", [None, "default", "fast", "quality"])
def test_presets_resolve_like_jax(preset):
    want = tbx.brox_params_from_reference(dataclasses.asdict(j_solver_params("brox", preset)))
    assert solver_params("brox", preset) == want


@pytest.mark.parametrize("hw,n", [((256, 341), 13), ((96, 128), 9), ((64, 80), 7)])
def test_pyramid_geometry(hw, n):
    shapes = pyramid_shapes(*hw, P.scale_step, nscales=100, min_size=P.min_size)
    assert shapes == j_pyramid_shapes(*hw, P.scale_step, nscales=100, min_size=P.min_size)
    assert len(shapes) == n and shapes[0] == hw
    if hw == (256, 341):
        assert shapes[-1] == (18, 23)


# ---------------- the solver ----------------

@pytest.mark.parametrize("hw,budget", [((32, 40), FAST), ((48, 64), {})],
                         ids=["32x40-reduced", "48x64-full"])
def test_matches_jax_fused_path(hw, budget):
    I0, I1 = _translated_pair(*hw)
    jp = jbx.BroxParams(**budget)
    ref = np.asarray(jbx.brox_flow(jnp.asarray(I0[None]), jnp.asarray(I1[None]), jp,
                                   interpret=True))[0]
    tp = tbx.brox_params_from_reference(dataclasses.asdict(jp))
    got = tbx.brox_flow(torch.from_numpy(I0[None]), torch.from_numpy(I1[None]), tp)[0].numpy()
    d = np.abs(got - ref)
    assert d.mean() < 5e-3 and d.max() < 5e-2, (d.mean(), d.max())
    if not budget:
        # the whole budget tracks the translation (tests/test_brox_fused.py:164-167)
        core = got[10:-10, 10:-10]
        assert float(np.hypot(core[..., 0] - 1.7, core[..., 1] + 0.8).mean()) < 0.25


def test_batch_invariance_byte_for_byte():
    """A pair's flow depends neither on its batch-mates nor on B."""
    pairs = [_translated_pair(32, 40, dx=1.0 + s * 0.3, dy=-0.5, seed=s) for s in range(3)]
    I0 = np.stack([(p[0] * 255).astype(np.uint8) for p in pairs])
    I1 = np.stack([(p[1] * 255).astype(np.uint8) for p in pairs])
    I1[1] = I0[1]  # a batch-mate that stops at once
    solver = tbx.make_brox_solver(32, 40, tbx.BroxParams(**FAST), "cpu")
    batched = solver(torch.from_numpy(I0), torch.from_numpy(I1)).numpy()
    for i in range(3):
        single = solver(torch.from_numpy(I0[i:i + 1]), torch.from_numpy(I1[i:i + 1])).numpy()[0]
        assert np.array_equal(batched[i].view(np.uint32), single.view(np.uint32))


def test_solver_scales_by_a_multiply():
    """uint8 frames reach the solve as u8 * f32(1/255), as in the JAX
    solver (denseflow_tpu/algorithms/brox.py:313-318)."""
    seen = []
    real = tbx.brox_flow
    tbx.brox_flow = lambda a, b, p: seen.append(a) or real(a, b, p)
    try:
        s = make_solver("brox", 16, 20, preset="fast", device="cpu")
        x = torch.arange(320, dtype=torch.int64).reshape(1, 16, 20).remainder(256).to(torch.uint8)
        flow = s(x, x)
    finally:
        tbx.brox_flow = real
    want = x.to(torch.float32) * np.float32(1.0 / 255.0)
    assert torch.equal(seen[0], want) and flow.shape == (1, 16, 20, 2)
    with pytest.raises(ValueError, match="built for 16x20"):
        s(x[:, :8], x[:, :8])


# ---------------- executor and CLI ----------------

def test_run_chunk_matches_jax_solver_and_quantizer(tmp_path):
    path, _ = make_translating_video(tmp_path / "v.avi", h=48, w=64, n=4, dx=2)
    frames = next(iter(VideoSource(path, FlowConfig(input=path, step=1)).chunks(1))).frames
    ex = DeviceExecutor("brox", 48, 64, 1, 8, 4, device="cpu")
    qx, qy = ex.run_chunk(frames, len(frames))
    assert qx.shape == qy.shape == (3, 48, 64) and qx.dtype == np.uint8
    scale = np.float32(1.0 / 255.0)
    flow = jbx.brox_flow(jnp.asarray(frames[:-1], jnp.float32) * scale,
                         jnp.asarray(frames[1:], jnp.float32) * scale,
                         jbx.BroxParams(), interpret=True)
    jx, jy = (np.asarray(a) for a in j_quantize(flow, 8.0))
    for a, b in ((qx, jx), (qy, jy)):
        d = np.abs(a.astype(np.int16) - b.astype(np.int16))
        assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())


def test_cli_file_set_matches_jax_and_values(tmp_path):
    """The default (reference) budget on both sides; the JAX CLI takes its
    XLA path on the CPU."""
    path, (fx, fy) = make_translating_video(tmp_path / "v.avi", h=64, w=80, n=9, dx=2)
    args = [path, "-a=brox", "-s=1", "-b=8", "--pairBatch=4"]
    assert main(args + [f"-o={tmp_path / 't'}", "--device=cpu"]) == 0
    assert j_main(args + [f"-o={tmp_path / 'j'}"]) == 0
    t_files = sorted(p.name for p in (tmp_path / "t" / "v").iterdir())
    assert t_files == sorted(p.name for p in (tmp_path / "j" / "v").iterdir())
    assert len(t_files) == 2 * 8
    want_x = round(255.0 * (fx + 8) / 16.0)
    want_y = round(255.0 * (fy + 8) / 16.0)
    mid = sorted((tmp_path / "t" / "v").glob("flow_x*.jpg"))[3]
    img = cv2.imread(str(mid), cv2.IMREAD_GRAYSCALE)[16:-16, 16:-16]
    assert abs(img.mean() - want_x) <= 3
    img = cv2.imread(str(mid).replace("flow_x", "flow_y"), cv2.IMREAD_GRAYSCALE)[16:-16, 16:-16]
    assert abs(img.mean() - want_y) <= 3
