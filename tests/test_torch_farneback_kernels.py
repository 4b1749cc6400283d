"""The plain PyTorch versions of Farneback's two kernels, and the plane
ops they share, against the JAX package's Pallas kernels run through the
Pallas interpreter (interpret=True) on the same numpy inputs.

Tolerances:
* `box_sum`: equal to the Pallas helper bit for bit; against the XLA
  filter within 1e-4 relative;
* linear `resample`: within 1e-4 of the Pallas helper on values of scale
  50. XLA's CPU backend fuses the sweep's `acc + c * tap` into one FMA,
  where the port rounds the product first, as the CUDA kernels (built with
  --fmad=false) do; measured max 7.6e-6, on 15% of the pixels;
* `poly_expand_reference`: max |d| < 1e-3, mean < 1e-5, the JAX package's
  own fused-vs-XLA gate (tests/test_farneback_fused.py:177-203); measured
  max 2.6e-5, mean 2.1e-6 against interpret mode (FMAs again), and equal
  to the XLA `poly_expand` above the 272x384 ceiling;
* `farneback_level_reference`: mean |du| <= 1e-3 px, max <= 1e-2 px, as
  for the TVL1 kernel: the FMAs move results by ulps (measured mean
  <= 1.6e-6 px, max 1.3e-5 px over the cases below, with equal iteration
  counts), and a stop that lands on the other side of its threshold
  moves a pair by one iteration.

The level kernel's plan (`_plan`: CTAs a pair, row bands, placement,
shared memory) is host code and is checked here too; the kernel itself
runs only on the card (chip_smoke.py phase 7).
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from denseflow_tpu.algorithms.farneback import _border_scale as j_border_scale
from denseflow_tpu.algorithms.farneback import poly_expand as j_poly_expand
from denseflow_tpu.kernels.common import make_plane_ops
from denseflow_tpu.kernels.farneback_fused import farneback_level_fused, poly_expand_fused
from denseflow_tpu.ops.filters import conv1d as j_conv1d
from denseflow_tpu_torch.algorithms.farneback import FarnebackParams, _level_geometry
from denseflow_tpu_torch.kernels import farneback_fused as _ff
from denseflow_tpu_torch.kernels._cluster import SMEM_STATIC
from denseflow_tpu_torch.kernels.farneback_fused import (
    farneback_level,
    farneback_level_reference,
    poly_expand,
    poly_expand_reference,
)
from denseflow_tpu_torch.kernels.plane_ops import border_scale, box_sum, resample_linear

torch.set_num_threads(1)

N, SIGMA = 5, 1.1  # polyN, polySigma


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------- plane ops ----------------

def _padded(h, w, margin, rng):
    """A real (h, w) plane inside a Pallas-padded one whose band holds
    garbage, as the kernels' planes may."""
    hp = ((h + margin + 7) // 8) * 8
    wp = ((w + margin + 127) // 128) * 128
    full = rng.normal(0, 50, (hp, wp)).astype(np.float32)
    return full, full[:h, :w].copy()


@pytest.mark.parametrize("win", [1, 3, 5, 9, 13, 15])
@pytest.mark.parametrize("axis", [0, 1])
def test_box_sum_matches_pallas_helper(win, axis):
    h, w = 23, 37
    full, real = _padded(h, w, win // 2, np.random.default_rng(win + axis))
    ops = make_plane_ops(h, w, *full.shape, interpret=True)
    want = np.asarray(ops.box_sum(jnp.asarray(full), win, axis, zero_pad=True))[:h, :w]
    got = box_sum(_t(real), win, axis).numpy()
    np.testing.assert_array_equal(got, want)
    # and the replicate-border box filter of the XLA path, up to rounding
    xla = np.asarray(j_conv1d(jnp.asarray(real), np.ones(win, np.float32), axis, "replicate"))
    np.testing.assert_allclose(got, xla, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("win", [0, 2, 12, -3])
def test_box_sum_refuses_even_windows(win):
    with pytest.raises(ValueError, match="odd"):
        box_sum(torch.zeros(4, 9), win, 1)


@pytest.mark.parametrize("axis", [0, 1])
def test_resample_linear_matches_pallas_helper(axis):
    h, w = 29, 41
    rng = np.random.default_rng(11 + axis)
    full, real = _padded(h, w, 0, rng)
    dfull = rng.uniform(-6.0, 6.0, full.shape).astype(np.float32)  # past +-4
    ops = make_plane_ops(h, w, *full.shape, interpret=True)
    (want,) = ops.resample((jnp.asarray(full),), jnp.asarray(dfull), axis, 4.0, "linear")
    got = resample_linear(_t(real), _t(dfull[:h, :w]), axis, 4.0).numpy()
    np.testing.assert_allclose(got, np.asarray(want)[:h, :w], rtol=0, atol=1e-4)


@pytest.mark.parametrize("hw", [(256, 341), (8, 11), (5, 7), (3, 4), (1, 2)])
def test_border_scale_matches_jax(hw):
    """Equal to the XLA path's ramp up to the association of the four band
    factors of a tiny level's corners (at most 1 ulp)."""
    got = border_scale(*hw)
    np.testing.assert_array_max_ulp(got, np.asarray(j_border_scale(*hw)), maxulp=1)
    if min(hw) >= 10:
        np.testing.assert_array_equal(got, np.asarray(j_border_scale(*hw)))


# ---------------- polynomial expansion ----------------

def _poly_gate(got, want):
    d = np.abs(got - want)
    assert d.max() < 1e-3 and d.mean() < 1e-5, (d.max(), d.mean())


@pytest.mark.parametrize("bhw", [(2, 40, 56), (18, 24, 40)])
def test_poly_expand_matches_pallas_interpret(bhw):
    img = np.random.default_rng(7).uniform(0, 255, bhw).astype(np.float32)
    want = np.asarray(poly_expand_fused(jnp.asarray(img), N, SIGMA, interpret=True))
    _poly_gate(poly_expand_reference(_t(img), N, SIGMA).numpy(), want)


def test_poly_expand_above_the_jax_ceiling_matches_xla():
    """270x380 pads past 272x384, where the JAX package takes its XLA
    poly_expand; the port's one code path still agrees."""
    img = np.random.default_rng(8).uniform(0, 255, (1, 270, 380)).astype(np.float32)
    want = np.moveaxis(np.asarray(j_poly_expand(jnp.asarray(img), N, SIGMA)), -1, 1)
    _poly_gate(poly_expand_reference(_t(img), N, SIGMA).numpy(), want)


def test_poly_expand_wrapper_takes_plain_path_on_cpu():
    img = _t(np.random.default_rng(1).uniform(0, 255, (3, 9, 14)).astype(np.float32))
    before = poly_expand.launches
    out = poly_expand(img, N, SIGMA)
    assert poly_expand.launches == before and out.shape == (3, 5, 9, 14)
    assert torch.equal(out, poly_expand_reference(img, N, SIGMA))
    with pytest.raises(ValueError, match="N, H, W"):
        poly_expand(img[0], N, SIGMA)
    with pytest.raises(ValueError, match="float32"):
        poly_expand(img.double(), N, SIGMA)
    with pytest.raises(ValueError, match="cuda or cpu"):
        poly_expand(torch.zeros((1, 8, 8), device="meta"), N, SIGMA)


@pytest.mark.parametrize("shapes", [[(2, 8, 11)], [(3, 9, 14), (3, 17, 29), (3, 40, 56)],
                                    [(1, 5, 7), (0, 4, 4), (2, 33, 31)]],
                         ids=["one", "three-levels", "with-empty"])
def test_poly_expand_list_form_equals_plain_level_by_level(shapes):
    """A list of levels gives the list of their expansions, each equal to
    poly_expand_reference on its level bit for bit; a tensor in the list
    form is the list of one level."""
    rng = np.random.default_rng(len(shapes))
    imgs = [_t(rng.uniform(0, 255, s).astype(np.float32)) for s in shapes]
    before = poly_expand.launches
    outs = poly_expand(imgs, N, SIGMA)
    assert poly_expand.launches == before and isinstance(outs, list)
    assert len(outs) == len(imgs)
    for img, out in zip(imgs, outs):
        assert out.shape == (img.shape[0], 5, *img.shape[1:])
        assert torch.equal(out, poly_expand_reference(img, N, SIGMA))
    assert torch.equal(poly_expand(imgs[:1], N, SIGMA)[0], poly_expand(imgs[0], N, SIGMA))


def test_poly_expand_list_form_checks_every_level():
    good = torch.zeros((1, 8, 8))
    assert poly_expand([], N, SIGMA) == []
    with pytest.raises(ValueError, match="N, H, W"):
        poly_expand([good, torch.zeros((8, 8))], N, SIGMA)
    with pytest.raises(ValueError, match="float32"):
        poly_expand([good, good.double()], N, SIGMA)
    with pytest.raises(ValueError, match="contiguous"):
        poly_expand([good, torch.zeros((1, 8, 8)).transpose(1, 2)], N, SIGMA)


PYRAMID = [(12, 17), (24, 34), (48, 68)]  # a small three-level pyramid


@pytest.mark.parametrize("level", range(len(PYRAMID)), ids=[f"{h}x{w}" for h, w in PYRAMID])
def test_poly_expand_list_form_matches_pallas_interpret(level):
    """Each level of one list call against JAX's poly_expand_fused on that
    level, within the gate above."""
    rng = np.random.default_rng(21)
    imgs = [rng.uniform(0, 255, (2, h, w)).astype(np.float32) for h, w in PYRAMID]
    got = poly_expand([_t(a) for a in imgs], N, SIGMA)[level].numpy()
    want = np.asarray(poly_expand_fused(jnp.asarray(imgs[level]), N, SIGMA, interpret=True))
    _poly_gate(got, want)


# ---------------- one level ----------------

def _translated_R(b, h, w, seed=1):
    """Polynomial planes of translated pairs, as in
    tests/test_farneback_fused.py:51-92, channel-first."""
    rng = np.random.default_rng(seed)
    base = ndi.gaussian_filter(rng.uniform(0, 255, (b, h + 8, w + 8)), (0, 1.5, 1.5))
    I0 = base[:, 4:4 + h, 4:4 + w].astype(np.float32)
    I1 = base[:, 3:3 + h, 6:6 + w].astype(np.float32)
    return tuple(np.moveaxis(np.asarray(j_poly_expand(jnp.asarray(x), N, SIGMA)), -1, 1).copy()
                 for x in (I0, I1))


def _smooth_flow(b, h, w, seed=9):
    rng = np.random.default_rng(seed)
    f = ndi.gaussian_filter(rng.normal(0, 0.3, (b, h, w, 2)), (0, 4, 4, 0)).astype(np.float32)
    return f[..., 0].copy(), f[..., 1].copy()


DEFAULT = dict(win_size=13, num_iters=10, max_disp=8.0, stop_eps=1e-3)
# (id, h, w, kw, initial flow offset)
LEVEL_CASES = [
    (f"{name}-{h}x{w}", h, w, dict(DEFAULT, **kw), 0.0)
    for h, w in [(40, 56), (30, 45)]
    for name, kw in [("stop", {}), ("no-stop", dict(stop_eps=0.0)),
                     ("win9", dict(win_size=9, num_iters=4, max_disp=6.0))]
] + [
    # the coarsest main-path level: the border bands overlap
    ("tiny-8x11", 8, 11, dict(DEFAULT, max_disp=4.0), 0.0),
    # an incoming flow far past the clamp: every warp tap sits at +-max_disp
    ("clamp-24x40", 24, 40, dict(DEFAULT, max_disp=3.0), 7.5),
]


@pytest.mark.parametrize("case", LEVEL_CASES, ids=[c[0] for c in LEVEL_CASES])
def test_level_reference_matches_pallas_interpret(case):
    name, h, w, kw, off = case
    R0, R1 = _translated_R(2, h, w)
    u, v = _smooth_flow(2, h, w)
    u, v = u + off, v - off
    ju, jv = farneback_level_fused(*(jnp.asarray(a) for a in (R0, R1, u, v)),
                                   interpret=True, **kw)
    tu, tv, iters = farneback_level_reference(*(_t(a) for a in (R0, R1, u, v)), **kw)
    d = np.abs(np.concatenate([tu.numpy() - np.asarray(ju), tv.numpy() - np.asarray(jv)]))
    assert d.mean() <= 1e-3 and d.max() <= 1e-2, (d.mean(), d.max())
    its = iters.tolist()
    assert all(1 <= i <= kw["num_iters"] for i in its)
    if kw["stop_eps"] == 0:
        assert its == [kw["num_iters"]] * 2
    if name.startswith("clamp"):
        free = farneback_level_reference(*(_t(a) for a in (R0, R1, u, v)),
                                         **dict(kw, max_disp=20.0))[0]
        assert (free - tu).abs().max() > 0.1


def test_level_pairs_are_independent_of_batch_mates():
    R0, R1 = _translated_R(3, 24, 40, seed=4)
    u, v = _smooth_flow(3, 24, 40)
    # a batch-mate that stops after one iteration: no motion, no flow
    R1[2], u[2], v[2] = R0[2], 0.0, 0.0
    args = (R0, R1, u, v)
    full = farneback_level_reference(*(_t(a) for a in args), **DEFAULT)
    assert full[2].tolist()[2] == 1 < full[2].tolist()[0]
    for i in range(3):
        one = farneback_level_reference(*(_t(a[i:i + 1]) for a in args), **DEFAULT)
        for x, y in zip(full, one):
            assert torch.equal(x[i:i + 1], y)


def test_level_wrapper_takes_plain_path_on_cpu_and_checks_args():
    R0, R1 = _translated_R(2, 16, 21)
    u, v = _smooth_flow(2, 16, 21)
    args = [_t(a) for a in (R0, R1, u, v)]
    before = farneback_level.launches
    a = farneback_level(*args, **DEFAULT)
    assert farneback_level.launches == before
    for x, y in zip(a, farneback_level_reference(*args, **DEFAULT)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="odd"):
        farneback_level(*args, **dict(DEFAULT, win_size=12))
    with pytest.raises(ValueError, match="shape"):
        farneback_level(args[0], args[1], args[2][:, :8], args[3], **DEFAULT)
    with pytest.raises(ValueError, match="contiguous"):
        farneback_level(args[0], args[1], args[2].transpose(1, 2).contiguous().transpose(1, 2),
                        args[3], **DEFAULT)
    with pytest.raises(ValueError, match="5, H, W"):
        farneback_level(args[0][:, :4], args[1], args[2], args[3], **DEFAULT)
    z = torch.zeros((1, 5, 8, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        farneback_level(z, z, z[:, 0], z[:, 0], **DEFAULT)
    # no iterations: the flow comes back as it went in
    u0, v0, it = farneback_level(*args, **dict(DEFAULT, num_iters=0))
    assert torch.equal(u0, args[2]) and torch.equal(v0, args[3]) and it.tolist() == [0, 0]


# ---- the level kernel's plan (kernels/farneback_fused.py::_plan), on the CPU ----

MAIN_PATH = [(lh, lw) for _, lh, lw, _, _ in _level_geometry(256, 341, FarnebackParams())]
PLAN_GEOMETRIES = sorted(set(
    MAIN_PATH
    + [(lh, lw) for _, lh, lw, _, _ in _level_geometry(360, 480, FarnebackParams())]
    + [(1080, 1920), (37, 53), (64, 80), (40, 56), (24, 40), (16, 16), (3, 400), (1, 2)]
))
SMEM_PER_CTA = 232_448  # bytes of shared memory a CTA may use on sm_90
HALO = 6  # halo rows of the normal-equation planes each side of a band


def test_main_path_levels_are_the_six_of_256x341():
    assert MAIN_PATH == [(8, 11), (16, 21), (32, 43), (64, 85), (128, 170), (256, 341)]


@pytest.mark.parametrize("hw", PLAN_GEOMETRIES, ids=[f"{h}x{w}" for h, w in PLAN_GEOMETRIES])
def test_plan_bands_cover_rows_and_fit(hw):
    h, w = hw
    plan = _ff._plan(h, w)
    assert 1 <= plan.n <= 16
    assert len(plan.starts) == plan.n + 1
    assert plan.starts[0] == 0 and plan.starts[-1] == h
    rows = [b - a for a, b in zip(plan.starts, plan.starts[1:])]
    assert max(rows) - min(rows) <= 1 and min(rows) >= 1  # every row once
    # a band of a cluster holds the halo rows its neighbours read
    assert min(rows) >= (HALO if plan.n > 1 else 1)
    assert plan.smem_bytes + SMEM_STATIC <= SMEM_PER_CTA
    # M with its halo rows, each row with its zero columns
    haloed = 5 * (max(rows) + 2 * HALO) * (w + 2 * HALO)
    edges = 10 * w  # rows 0 and h-1 of M
    if plan.placement == "device":
        assert plan.smem_bytes == 4 * edges
        assert plan.scratch_planes * h * w >= plan.n * haloed
        assert (plan.scratch_planes - 1) * h * w < plan.n * haloed
    elif plan.placement == "shared":
        assert plan.smem_bytes == 4 * (edges + 2 * max(rows) * w + haloed)
        assert plan.scratch_planes == 0
    else:
        assert plan.placement == "split"
        assert plan.smem_bytes == 4 * (edges + haloed) and plan.scratch_planes == 0


@pytest.mark.parametrize("hw", PLAN_GEOMETRIES, ids=[f"{h}x{w}" for h, w in PLAN_GEOMETRIES])
def test_plan_depends_on_h_w_alone(hw):
    # B never reaches the plan: a pair's bytes cannot depend on its batch
    assert list(inspect.signature(_ff._plan).parameters) == ["h", "w"]
    first = _ff._plan(*hw)
    _ff._plan.cache_clear()
    assert _ff._plan(*hw) == first


# (level, CTAs a pair, placement): one CTA under 1,000 px; one wave of
# clusters of up to 6 where u, v and M fit (5 at 32x43, whose bands must
# hold the six halo rows); M alone in 16 CTAs at 256x341; device memory
# where no cluster holds M
PLANS = [((8, 11), 1, "shared"), ((16, 21), 1, "shared"), ((32, 43), 5, "shared"),
         ((64, 85), 6, "shared"), ((128, 170), 6, "shared"), ((256, 341), 16, "split"),
         ((360, 480), 6, "device"), ((1080, 1920), 6, "device")]


@pytest.mark.parametrize("hw,n,placement", PLANS, ids=[f"{h}x{w}" for (h, w), _, _ in PLANS])
def test_plan_at_each_level(hw, n, placement):
    plan = _ff._plan(*hw)
    assert (plan.n, plan.placement) == (n, placement)


def test_plans_cover_the_main_path():
    assert sorted(hw for hw, _, _ in PLANS if hw in MAIN_PATH) == sorted(MAIN_PATH)


@pytest.mark.parametrize("h,n,placement", [
    (37, 0, "shared"),    # no CTA
    (37, 17, "shared"),   # over the largest cluster
    (37, 17, "device"),
    (12, 13, "device"),   # more bands than rows
    (12, 13, "shared"),
    (12, 3, "shared"),    # four-row bands: shorter than the six halo rows
    (12, 3, "split"),
    (12, 3, "device"),
    (37, 4, "tiled"),     # no such placement
])
def test_make_plan_refuses_what_the_kernel_does_not_run(h, n, placement):
    with pytest.raises(ValueError):
        _ff._make_plan(h, 53, n, placement)


def test_max_window_is_the_halo_reach():
    assert _ff.MAX_WIN == 2 * HALO + 1 == FarnebackParams().win_size
