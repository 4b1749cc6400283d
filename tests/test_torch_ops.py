"""The port's device ops against the JAX package's, bit for bit, on the same
numpy inputs: bilinear resize, pyramid geometry and levels, the three
derivative stencils, and the CAST quantizer (with exact .5 ties)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseflow_tpu import quantize as jq
from denseflow_tpu.ops import derivatives as jd
from denseflow_tpu.ops import pyramid as jp
from denseflow_tpu.ops import resize as jr
from denseflow_tpu_torch import quantize as tq
from denseflow_tpu_torch.ops import derivatives as td
from denseflow_tpu_torch.ops import filters as tf
from denseflow_tpu_torch.ops import pyramid as tp
from denseflow_tpu_torch.ops import resize as tr

torch.set_num_threads(1)

BENCH_LEVELS = jp.pyramid_shapes(256, 341, 0.8, 5)


def _img(shape, seed, lo=0.0, hi=255.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _same(t, j):
    """Bit-identical float32 (NaN-free inputs)."""
    a = t.numpy()
    b = np.asarray(j)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), \
        f"max |d| {np.abs(a - b).max()}"


def test_bench_level_shapes():
    assert BENCH_LEVELS == [(256, 341), (205, 273), (164, 218), (131, 175), (105, 140)]


@pytest.mark.parametrize("h,w,scale,n,min_size", [
    (256, 341, 0.8, 5, 16), (64, 80, 0.8, 5, 16), (96, 128, 0.8, 5, 16),
    (37, 53, 0.8, 5, 16), (20, 300, 0.8, 5, 16), (1080, 1920, 0.8, 5, 16),
    (256, 341, 0.5, 100, 16), (33, 47, 0.7, 6, 8), (25, 25, 0.9, 12, 16),
])
def test_pyramid_shapes_match(h, w, scale, n, min_size):
    assert tp.pyramid_shapes(h, w, scale, n, min_size) == \
        jp.pyramid_shapes(h, w, scale, n, min_size)


@pytest.mark.parametrize("src,dst", list(zip(BENCH_LEVELS[:-1], BENCH_LEVELS[1:]))
                         + [((BENCH_LEVELS[i + 1]), BENCH_LEVELS[i]) for i in range(4)]
                         + [((64, 80), (51, 64)), ((37, 53), (60, 17)), ((5, 7), (5, 7)),
                            ((360, 480), (256, 341))])
def test_resize_bilinear_matches(src, dst):
    x = _img((2,) + src, seed=src[0] * 7 + dst[1])
    _same(tr.resize_bilinear(torch.from_numpy(x), dst),
          jr.resize_bilinear(jnp.asarray(x), dst))


def test_resize_of_flow_scaled_matches():
    """The between-scales upsample: resize then times 1/0.8."""
    u = _img((3, 105, 140), seed=1, lo=-9, hi=9)
    _same(tr.resize_bilinear(torch.from_numpy(u), (131, 175)) * (1.0 / 0.8),
          jr.resize_bilinear(jnp.asarray(u), (131, 175)) * (1.0 / 0.8))


@pytest.mark.parametrize("helper,args", [
    (tr._axis_coords, (131, 105)),
    (tf._pad_index, (37, 2, "reflect101")),
    (tf._pad_index, (37, 5, "replicate")),
])
def test_index_tensors_are_built_once_per_geometry(helper, args):
    """The resize and border-pad index tensors are built once per geometry
    and device: a fresh host-to-card copy at every call waits for all the
    work queued before it, which held the solvers' host thread to the card."""
    dev = torch.device("cpu")
    first = helper(*args, dev)
    again = helper(*args, dev)
    assert all(a is b for a, b in zip(first, again))
    assert all(a.device == dev for a in first)


@pytest.mark.parametrize("shape", [(2, 256, 341), (1, 37, 53), (3, 64, 80)])
def test_build_pyramid_matches(shape):
    x = np.random.default_rng(5).integers(0, 256, shape).astype(np.uint8)
    shapes = jp.pyramid_shapes(shape[1], shape[2], 0.8, 5)
    tl = tp.build_pyramid(torch.from_numpy(x), shapes)
    jl = jp.build_pyramid(jnp.asarray(x), shapes)
    assert len(tl) == len(jl) == len(shapes)
    for a, b in zip(tl, jl):
        _same(a, b)


@pytest.mark.parametrize("shape", BENCH_LEVELS + [(37, 53), (1, 9), (8, 1)])
def test_gradients_and_divergence_match(shape):
    x = _img((2,) + shape, seed=shape[0], lo=-50, hi=300)
    y = _img((2,) + shape, seed=shape[1], lo=-3, hi=3)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for a, b in zip(td.centered_gradient(tx), jd.centered_gradient(jnp.asarray(x))):
        _same(a, b)
    for a, b in zip(td.forward_gradient(tx), jd.forward_gradient(jnp.asarray(x))):
        _same(a, b)
    _same(td.divergence(tx, ty), jd.divergence(jnp.asarray(x), jnp.asarray(y)))


@pytest.mark.parametrize("bound", [20, 32, 8, 3])
def test_quantize_cast_matches(bound):
    rng = np.random.default_rng(bound)
    v = rng.uniform(-1.5 * bound, 1.5 * bound, (4, 31, 37)).astype(np.float32)
    flat = np.concatenate([v.ravel(), [bound, -bound, 0.0, bound + 1e-3]])
    flat = flat.astype(np.float32)
    got = tq.quantize_cast(torch.from_numpy(flat), -bound, bound).numpy()
    want = np.asarray(jq.quantize_cast(jnp.asarray(flat), -bound, bound))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.uint8
    flow = np.stack([v, -v], axis=-1)
    for a, b in zip(tq.quantize_flow_pair(torch.from_numpy(flow), bound),
                    jq.quantize_flow_pair(jnp.asarray(flow), bound)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_quantize_ties_round_half_to_even():
    # with bound 127.5, 255*(v+127.5)/255 = v + 127.5 exactly in f32: every
    # integer v lands on a .5 tie
    v = np.arange(-127, 128, dtype=np.float32)
    got = tq.quantize_cast(torch.from_numpy(v), -127.5, 127.5).numpy()
    want = np.asarray(jq.quantize_cast(jnp.asarray(v), -127.5, 127.5))
    np.testing.assert_array_equal(got, want)
    k = v + 127.5
    np.testing.assert_array_equal(got, np.round(k).astype(np.uint8))  # half to even
    assert got[:4].tolist() == [0, 2, 2, 4]
