"""The plain PyTorch version of the Brox level kernel, and the plane ops it
adds (`shift`, `conv_taps`, the cubic `resample`), against the JAX
package's Pallas kernel and helpers run through the Pallas interpreter
(interpret=True) on the same numpy inputs.

Tolerances:
* `shift` and `conv_taps` with `_D5`: equal to the Pallas helpers bit for
  bit;
* cubic `resample`: within 1e-3 of the Pallas helper on values of scale
  50. XLA's CPU backend fuses the sweep's `acc + c * tap` into one FMA,
  where the port rounds the product first, as the CUDA kernels (built with
  --fmad=false) do; measured max 1.4e-4, on ~43% of the pixels;
* `brox_scale_reference`: mean |du| <= 1e-3 px, max <= 1e-2 px, as for the
  TVL1 and Farneback kernels: the FMAs, and XLA's rsqrt against the port's
  1/sqrt, move results by ulps (measured mean <= 1.3e-6 px, max 9.1e-6 px
  over the cases below, the clamp case the largest), and a stop that lands
  on the other side of its threshold moves a pair by one step.

The CUDA kernel's plan (`_plan`: CTAs a pair, row bands, placement, shared
memory) is plain Python and is tested here too; the kernel
itself runs only on a card (`chip_smoke.py` phase 10).
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from denseflow_tpu.algorithms.brox import _dx as j_dx
from denseflow_tpu.algorithms.brox import _dy as j_dy
from denseflow_tpu.kernels.brox_fused import _D5 as J_D5
from denseflow_tpu.kernels.brox_fused import brox_scale_fused
from denseflow_tpu.kernels.common import cubic_kernel, make_plane_ops
from denseflow_tpu_torch.kernels import brox_fused as _bf
from denseflow_tpu_torch.kernels.brox_fused import (
    D5,
    brox_scale,
    brox_scale_reference,
)
from denseflow_tpu_torch.kernels.plane_ops import (
    conv_taps,
    cubic_weight,
    resample_cubic,
    shift,
)
from denseflow_tpu_torch.kernels._cluster import SMEM_STATIC
from denseflow_tpu_torch.ops.pyramid import pyramid_shapes

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _padded(h, w, rng):
    """A real (h, w) plane inside a Pallas-padded one whose band holds
    garbage, as the kernels' planes may."""
    hp, wp = ((h + 7) // 8) * 8, ((w + 127) // 128) * 128
    full = rng.normal(0, 50, (hp, wp)).astype(np.float32)
    return full, full[:h, :w].copy()


# ---------------- plane ops ----------------

@pytest.mark.parametrize("k", [-2, -1, 1, 2, 40])
@pytest.mark.parametrize("axis", [0, 1])
def test_shift_matches_pallas_helper(k, axis):
    h, w = 23, 37
    full, real = _padded(h, w, np.random.default_rng(k + 10 * axis + 50))
    ops = make_plane_ops(h, w, *full.shape, interpret=True)
    want = np.asarray(ops.shift(jnp.asarray(full), k, axis))[:h, :w]
    np.testing.assert_array_equal(shift(_t(real), k, axis).numpy(), want)


@pytest.mark.parametrize("hw", [(23, 37), (3, 4)])
@pytest.mark.parametrize("axis", [0, 1])
def test_conv_taps_d5_matches_pallas_helper(hw, axis):
    h, w = hw
    full, real = _padded(h, w, np.random.default_rng(h + axis))
    ops = make_plane_ops(h, w, *full.shape, interpret=True)
    assert [float(np.float32(c)) for c in D5] == [float(np.float32(c)) for c in J_D5]
    want = np.asarray(ops.conv_taps(jnp.asarray(full), J_D5, axis, 2))[:h, :w]
    got = conv_taps(_t(real), D5, axis, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    # and the XLA path's replicate-border stencil, which also adds the
    # zero tap: the same up to rounding
    xla = np.asarray((j_dy if axis == 0 else j_dx)(jnp.asarray(real)))
    np.testing.assert_allclose(got.numpy(), xla, rtol=0, atol=1e-4)


def test_cubic_weight_matches_jax():
    x = np.linspace(-2.5, 2.5, 2001, dtype=np.float32)
    np.testing.assert_array_equal(cubic_weight(_t(x)).numpy(), np.asarray(cubic_kernel(jnp.asarray(x))))


@pytest.mark.parametrize("max_disp", [4.0, 40.0])
@pytest.mark.parametrize("axis", [0, 1])
def test_resample_cubic_matches_pallas_helper(axis, max_disp):
    h, w = 29, 41
    rng = np.random.default_rng(11 + axis)
    full, real = _padded(h, w, rng)
    planes = [full, rng.normal(0, 50, full.shape).astype(np.float32)]
    dfull = rng.uniform(-6.0, 6.0, full.shape).astype(np.float32)  # past +-4
    ops = make_plane_ops(h, w, *full.shape, interpret=True)
    want = ops.resample(tuple(jnp.asarray(p) for p in planes), jnp.asarray(dfull),
                        axis, max_disp, "cubic")
    got = resample_cubic([_t(p[:h, :w]) for p in planes], _t(dfull[:h, :w]), axis, max_disp)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt)[:h, :w], rtol=0, atol=1e-3)


# ---------------- one level ----------------

def _smooth_pair(b, h, w, seed=5):
    """tests/test_brox_fused.py::_smooth_pair: smooth noise in [0, 1] and
    its copy moved by an integer offset."""
    rng = np.random.default_rng(seed)
    base = ndi.gaussian_filter(rng.uniform(0.0, 1.0, (b, h + 8, w + 8)), (0, 2.0, 2.0)).astype(np.float32)
    return base[:, 4:4 + h, 4:4 + w].copy(), base[:, 3:3 + h, 5:5 + w].copy()


def _smooth_flow(b, h, w, seed=9):
    rng = np.random.default_rng(seed)
    f = [ndi.gaussian_filter(rng.normal(0, 0.5, (b, h, w)), (0, 3, 3)).astype(np.float32)
         for _ in range(2)]
    return f[0], f[1]


# tests/test_brox_fused.py:25-28: the kernel's control flow is the same at
# any budget
FAST = dict(alpha=0.197, gamma=50.0, inner_iterations=3, outer_iterations=4,
            solver_iterations=4, max_disp=8.0, stop_eps=1e-3)
FULL = dict(FAST, inner_iterations=10, outer_iterations=77, solver_iterations=10)
# (id, B, h, w, kw, initial flow offset)
LEVEL_CASES = [
    (f"{name}-{h}x{w}", 2, h, w, dict(FAST, **kw), 0.0)
    for h, w in [(40, 56), (30, 45)]
    for name, kw in [("stop", {}), ("no-stop", dict(stop_eps=0.0))]
] + [
    # an incoming flow far past the clamp: every warp tap sits at +-max_disp
    ("clamp-24x40", 2, 24, 40, dict(FAST, max_disp=3.0), 7.5),
    # more pairs than the JAX slab of 16: its lax.map path
    ("batch18-16x24", 18, 16, 24, dict(FAST, inner_iterations=2, outer_iterations=2,
                                       solver_iterations=3, max_disp=6.0), 0.0),
    # the reference's whole budget at one size
    ("full-32x40", 2, 32, 40, FULL, 0.0),
]


@pytest.mark.parametrize("case", LEVEL_CASES, ids=[c[0] for c in LEVEL_CASES])
def test_level_reference_matches_pallas_interpret(case):
    name, b, h, w, kw, off = case
    I0, I1 = _smooth_pair(b, h, w)
    u, v = _smooth_flow(b, h, w)
    u, v = u + off, v - off
    ju, jv = brox_scale_fused(*(jnp.asarray(a) for a in (I0, I1, u, v)),
                              interpret=True, **kw)
    tu, tv, counts = brox_scale_reference(*(_t(a) for a in (I0, I1, u, v)), **kw)
    d = np.abs(np.concatenate([tu.numpy() - np.asarray(ju), tv.numpy() - np.asarray(jv)]))
    assert d.mean() <= 1e-3 and d.max() <= 1e-2, (d.mean(), d.max())
    c = counts.numpy()
    assert c.shape == (b, 3) and c.dtype == np.int32
    assert np.all((c[:, 0] >= 1) & (c[:, 0] <= kw["outer_iterations"]))
    assert np.all(c[:, 1] <= c[:, 0] * kw["inner_iterations"])
    assert np.array_equal(c[:, 2], c[:, 1] * kw["solver_iterations"])
    if kw["stop_eps"] == 0:
        budget = [kw["outer_iterations"], kw["outer_iterations"] * kw["inner_iterations"]]
        assert c[:, :2].tolist() == [budget] * b
    if name.startswith("clamp"):
        free = brox_scale_reference(*(_t(a) for a in (I0, I1, u, v)),
                                    **dict(kw, max_disp=20.0))[0]
        # the clamp changes the answer (measured max 0.057 px)
        assert (free - tu).abs().max() > 0.02


def test_level_pairs_are_independent_of_batch_mates():
    I0, I1 = _smooth_pair(3, 24, 40, seed=4)
    u, v = _smooth_flow(3, 24, 40)
    # a batch-mate that stops at once: no motion, no flow
    I1[2], u[2], v[2] = I0[2], 0.0, 0.0
    args = (I0, I1, u, v)
    kw = dict(FAST, outer_iterations=6)
    full = brox_scale_reference(*(_t(a) for a in args), **kw)
    c = full[2].tolist()
    assert c[2] == [1, 1, kw["solver_iterations"]] and c[0][0] > 1
    for i in range(3):
        one = brox_scale_reference(*(_t(a[i:i + 1]) for a in args), **kw)
        for x, y in zip(full, one):
            assert torch.equal(x[i:i + 1], y)


def test_level_wrapper_takes_plain_path_on_cpu_and_checks_args():
    I0, I1 = _smooth_pair(2, 16, 21)
    u, v = _smooth_flow(2, 16, 21)
    args = [_t(a) for a in (I0, I1, u, v)]
    before = brox_scale.launches
    got = brox_scale(*args, **FAST)
    assert brox_scale.launches == before
    for x, y in zip(got, brox_scale_reference(*args, **FAST)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="shape"):
        brox_scale(args[0], args[1], args[2][:, :8], args[3], **FAST)
    with pytest.raises(ValueError, match="contiguous"):
        brox_scale(args[0], args[1], args[2].transpose(1, 2).contiguous().transpose(1, 2),
                   args[3], **FAST)
    with pytest.raises(ValueError, match="float32"):
        brox_scale(args[0].double(), *args[1:], **FAST)
    with pytest.raises(ValueError, match="B, H, W"):
        brox_scale(*(a[0] for a in args), **FAST)
    with pytest.raises(ValueError, match="solver_iterations"):
        brox_scale(*args, **dict(FAST, solver_iterations=-1))
    z = torch.zeros((1, 8, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        brox_scale(z, z, z, z, **FAST)
    # no warps: the flow comes back as it went in
    u0, v0, c = brox_scale(*args, **dict(FAST, outer_iterations=0))
    assert torch.equal(u0, args[2]) and torch.equal(v0, args[3])
    assert c.tolist() == [[0, 0, 0]] * 2


# ---- the kernel's plan (kernels/brox_fused.py::_plan), on the CPU ----

MAIN_PATH = pyramid_shapes(256, 341, 0.8, 100, 16)
PLAN_GEOMETRIES = sorted(set(
    MAIN_PATH
    + pyramid_shapes(360, 480, 0.8, 100, 16)[:3]
    + [(1080, 1920), (37, 53), (64, 80), (40, 56), (16, 16), (3, 400)]
))
SMEM_PER_CTA = 232_448  # bytes of shared memory a CTA may use on sm_90


def test_main_path_levels_are_the_thirteen_of_256x341():
    assert MAIN_PATH == [(256, 341), (205, 273), (164, 218), (131, 175), (105, 140),
                         (84, 112), (67, 89), (54, 72), (43, 57), (34, 46), (27, 37),
                         (22, 29), (18, 23)]


@pytest.mark.parametrize("hw", PLAN_GEOMETRIES, ids=[f"{h}x{w}" for h, w in PLAN_GEOMETRIES])
def test_plan_bands_cover_rows_and_fit(hw):
    h, w = hw
    plan = _bf._plan(h, w)
    assert 1 <= plan.n <= 16
    assert len(plan.starts) == plan.n + 1
    assert plan.starts[0] == 0 and plan.starts[-1] == h
    rows = [b - a for a, b in zip(plan.starts, plan.starts[1:])]
    assert max(rows) - min(rows) <= 1
    assert plan.smem_bytes + SMEM_STATIC <= SMEM_PER_CTA
    haloed = (max(rows) + 4) * w  # a band and two halo rows each side
    if plan.placement == "device":
        assert min(rows) >= 1  # every row once
        assert plan.smem_bytes == 0 and plan.scratch_planes == 27
        return
    # a band in shared memory holds the two rows its neighbours read
    assert min(rows) >= (2 if plan.n > 1 else 1)
    if plan.placement == "shared":
        # u, v, two (du, dv) buffers and psi_s with halo rows, five planes without
        assert plan.smem_bytes == 4 * (7 * haloed + 5 * max(rows) * w)
        assert plan.scratch_planes == 17
    else:
        assert plan.placement == "split"
        assert plan.smem_bytes == 4 * 6 * haloed and plan.scratch_planes == 23


@pytest.mark.parametrize("hw", PLAN_GEOMETRIES, ids=[f"{h}x{w}" for h, w in PLAN_GEOMETRIES])
def test_plan_depends_on_h_w_alone(hw):
    # B never reaches the plan: a pair's bytes cannot depend on its batch
    assert list(inspect.signature(_bf._plan).parameters) == ["h", "w"]
    first = _bf._plan(*hw)
    _bf._plan.cache_clear()
    assert _bf._plan(*hw) == first


# (level, CTAs a pair, placement): one CTA under 900 px; one wave of
# 6-CTA clusters from 27x37 to 164x218; 16 CTAs where 6 cannot hold u, v
# and (du, dv); device memory where no cluster holds them
PLANS = [((18, 23), 1, "shared"), ((22, 29), 1, "shared")] + [
    (hw, 6, "shared") for hw in [(27, 37), (34, 46), (43, 57), (54, 72), (67, 89),
                                 (84, 112), (105, 140), (131, 175)]
] + [((164, 218), 6, "split"), ((205, 273), 16, "shared"), ((256, 341), 16, "split"),
     ((360, 480), 6, "device"), ((1080, 1920), 6, "device")]


@pytest.mark.parametrize("hw,n,placement", PLANS, ids=[f"{h}x{w}" for (h, w), _, _ in PLANS])
def test_plan_at_each_level(hw, n, placement):
    plan = _bf._plan(*hw)
    assert (plan.n, plan.placement) == (n, placement)


def test_plans_cover_the_main_path():
    assert sorted(hw for hw, _, _ in PLANS if hw in MAIN_PATH) == sorted(MAIN_PATH)


@pytest.mark.parametrize("h,n,placement", [
    (37, 0, "shared"),    # no CTA
    (37, 17, "shared"),   # over the largest cluster
    (37, 17, "device"),
    (12, 13, "device"),   # more bands than rows
    (12, 13, "shared"),
    (12, 7, "shared"),    # one-row bands: shorter than the two halo rows
    (12, 7, "split"),
    (37, 4, "tiled"),     # no such placement
])
def test_make_plan_refuses_what_the_kernel_does_not_run(h, n, placement):
    with pytest.raises(ValueError):
        _bf._make_plan(h, 53, n, placement)
