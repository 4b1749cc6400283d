"""The plain PyTorch version of the TVL1 scale kernel against the Pallas
kernel run through the Pallas interpreter (interpret=True) on the same
numpy inputs.

Tolerance: mean |du| <= 1e-3 px, max |du| <= 1e-2 px. The two compute the
same operations in float32, but XLA's CPU fusion and the order of the
full-plane epsilon sum differ from PyTorch's, so results agree to ~1e-5 px
on average (measured) rather than bit for bit; the bound leaves room for a
stop test that lands on the other side of its threshold in one block.

The CUDA kernel's plan (`_plan`: CTAs a pair, row bands, placement, shared
memory) is plain Python and is tested here too; the kernel itself runs only
on a card (`chip_smoke.py` phase 3).
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from denseflow_tpu.kernels.tvl1_fused import tvl1_scale_fused
from denseflow_tpu.ops.derivatives import centered_gradient
from denseflow_tpu_torch.kernels import tvl1_fused as _tf
from denseflow_tpu_torch.kernels._cluster import SMEM_STATIC
from denseflow_tpu_torch.kernels.tvl1_fused import tvl1_scale, tvl1_scale_reference
from denseflow_tpu_torch.ops.pyramid import pyramid_shapes

torch.set_num_threads(1)

KW = dict(l_t=0.15 * 0.3, theta=0.3, taut=0.25 / 0.3)


def _pairs(b, h, w, shift, seed, same=False):
    rng = np.random.default_rng(seed)
    m = 12
    base = ndi.gaussian_filter(rng.uniform(0, 255, (b, h + 2 * m, w + 2 * m)), (0, 2, 2))
    dx, dy = shift
    I0 = np.round(base[:, m:m + h, m:m + w])
    I1 = I0 if same else np.round(base[:, m + dy:m + dy + h, m + dx:m + dx + w])
    I0, I1 = I0.astype(np.float32), I1.astype(np.float32)
    I1x, I1y = (np.array(a) for a in centered_gradient(jnp.asarray(I1)))
    return I0, I1, I1x, I1y


# (id, B, h, w, shift, same frames, u0, kw)
CASES = [
    # I1 == I0 and u0 = 0: the first check block converges, so the first
    # warp ends the pair's warp loop
    ("first-block-exit", 2, 64, 80, (0, 0), True, 0.0,
     dict(epsilon=0.01, iterations=300, warps=5, max_disp=8.0, check_every=24)),
    # epsilon = 0 disables the stop: every warp runs to the cap, rounded
    # up to whole check blocks (30 -> 48)
    ("iteration-cap", 2, 37, 53, (1, -1), False, 0.0,
     dict(epsilon=0.0, iterations=30, warps=2, max_disp=4.0, check_every=24)),
    # flow far beyond the clamp: every warp tap sits at +-max_disp
    ("max-disp-clamp", 2, 37, 53, (2, 1), False, 6.0,
     dict(epsilon=0.01, iterations=60, warps=3, max_disp=2.0, check_every=24)),
    # check_every = 1: the epsilon test after every iteration (OpenCV-exact)
    ("check-every-1", 2, 64, 80, (2, -1), False, 0.0,
     dict(epsilon=0.01, iterations=40, warps=3, max_disp=8.0, check_every=1)),
    # the defaults on translated content
    ("defaults", 3, 64, 80, (-2, 1), False, 0.0,
     dict(epsilon=0.01, iterations=300, warps=5, max_disp=8.0, check_every=24)),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_reference_matches_pallas_interpret(case):
    name, b, h, w, shift, same, u0, kw = case
    I0, I1, I1x, I1y = _pairs(b, h, w, shift, seed=h + b, same=same)
    u1 = np.full((b, h, w), u0, np.float32)
    u2 = np.full((b, h, w), -u0, np.float32)
    j1, j2 = tvl1_scale_fused(
        *(jnp.asarray(a) for a in (I0, I1, I1x, I1y, u1, u2)),
        interpret=True, **KW, **kw)
    t1, t2, counts = tvl1_scale_reference(
        *(torch.from_numpy(a) for a in (I0, I1, I1x, I1y, u1, u2)), **KW, **kw)
    d = np.abs(np.concatenate([t1.numpy() - np.asarray(j1), t2.numpy() - np.asarray(j2)]))
    assert d.mean() <= 1e-3 and d.max() <= 1e-2, (d.mean(), d.max())
    its, warps = counts[:, 0].tolist(), counts[:, 1].tolist()
    if name == "first-block-exit":
        assert its == [24] * b and warps == [1] * b
    if name == "iteration-cap":
        assert its == [96] * b and warps == [2] * b
    if name == "check-every-1":
        assert all(0 < i <= 3 * 40 for i in its)
    if name == "max-disp-clamp":
        # the clamp must bind: the solve is not the unclamped one
        free = tvl1_scale_reference(
            *(torch.from_numpy(a) for a in (I0, I1, I1x, I1y, u1, u2)),
            **KW, **dict(kw, max_disp=20.0))[0]
        assert (free - t1).abs().max() > 0.1


def test_wrapper_takes_plain_path_on_cpu():
    I0, I1, I1x, I1y = _pairs(2, 37, 53, (1, 0), seed=9)
    u = np.zeros_like(I0)
    args = [torch.from_numpy(a) for a in (I0, I1, I1x, I1y, u, u.copy())]
    kw = dict(KW, epsilon=0.01, iterations=48, warps=2, max_disp=4.0, check_every=24)
    before = tvl1_scale.launches
    a = tvl1_scale(*args, **kw)
    b = tvl1_scale_reference(*args, **kw)
    assert tvl1_scale.launches == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_pairs_are_independent_of_batch_mates():
    I0, I1, I1x, I1y = _pairs(3, 37, 53, (2, -1), seed=4)
    I0[2] = I1[2]  # a batch-mate that stops at once
    u = np.zeros_like(I0)
    kw = dict(KW, epsilon=0.01, iterations=300, warps=5, max_disp=4.0, check_every=24)
    full = tvl1_scale_reference(*(torch.from_numpy(a) for a in (I0, I1, I1x, I1y, u, u)), **kw)
    for i in range(3):
        one = tvl1_scale_reference(
            *(torch.from_numpy(np.ascontiguousarray(a[i:i + 1])) for a in (I0, I1, I1x, I1y, u, u)),
            **kw)
        for x, y in zip(full, one):
            assert torch.equal(x[i:i + 1], y)


# ---- the kernel's plan (kernels/tvl1_fused.py::_plan), on the CPU ----

MAIN_PATH = pyramid_shapes(256, 341, 0.8, 5, 16)
PLAN_GEOMETRIES = sorted(set(
    MAIN_PATH
    + pyramid_shapes(360, 480, 0.8, 5, 16)
    + pyramid_shapes(1080, 1920, 0.8, 5, 16)
    + [(37, 53), (16, 22), (16, 26), (16, 16)]  # odd; 16-row coarsest scales
))
SMEM_PER_CTA = 232_448  # bytes of shared memory a CTA may use on sm_90


def test_main_path_scales_are_the_five_of_256x341():
    assert MAIN_PATH == [(256, 341), (205, 273), (164, 218), (131, 175), (105, 140)]


@pytest.mark.parametrize("hw", PLAN_GEOMETRIES, ids=[f"{h}x{w}" for h, w in PLAN_GEOMETRIES])
def test_plan_bands_cover_rows_and_fit(hw):
    h, w = hw
    plan = _tf._plan(h, w)
    assert 1 <= plan.n <= 16
    assert len(plan.starts) == plan.n + 1
    assert plan.starts[0] == 0 and plan.starts[-1] == h
    rows = [b - a for a, b in zip(plan.starts, plan.starts[1:])]
    assert min(rows) >= 1  # every row once, each band at least one row
    assert max(rows) - min(rows) <= 1
    assert plan.smem_bytes + SMEM_STATIC <= SMEM_PER_CTA
    if plan.placement == "shared":
        # the nine loop planes of the longest band and the four halo rows
        assert plan.smem_bytes == 4 * (9 * max(rows) * w + 4 * w)
        assert plan.scratch_planes == 3
    else:
        assert plan.placement == "device"
        assert plan.smem_bytes == 0 and plan.scratch_planes == 10


@pytest.mark.parametrize("hw", PLAN_GEOMETRIES, ids=[f"{h}x{w}" for h, w in PLAN_GEOMETRIES])
def test_plan_depends_on_h_w_alone(hw):
    # B never reaches the plan: a pair's bytes cannot depend on its batch
    assert list(inspect.signature(_tf._plan).parameters) == ["h", "w"]
    first = _tf._plan(*hw)
    _tf._plan.cache_clear()
    assert _tf._plan(*hw) == first


PLACEMENTS = [(s, "shared") for s in MAIN_PATH] + [((360, 480), "device"),
                                                  ((1080, 1920), "device")]


@pytest.mark.parametrize("hw,placement", PLACEMENTS,
                         ids=[f"{h}x{w}" for (h, w), _ in PLACEMENTS])
def test_plan_placement(hw, placement):
    plan = _tf._plan(*hw)
    assert plan.placement == placement
    if placement == "shared":
        # the band state of every main-path scale in shared memory: one
        # wave of clusters of up to 6 where they hold it, else 16
        assert plan.n in (6, 16)


@pytest.mark.parametrize("n,placement", [(0, "shared"), (17, "shared"), (40, "device"),
                                         (4, "split")])
def test_make_plan_refuses_what_the_kernel_does_not_run(n, placement):
    with pytest.raises(ValueError):
        _tf._make_plan(37, 53, n, placement)
