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
"""

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
