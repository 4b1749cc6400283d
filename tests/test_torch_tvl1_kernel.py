"""The plain PyTorch version of the TVL1 scale kernel against the Pallas
kernel run through the Pallas interpreter (interpret=True) on the same
numpy inputs.

Tolerance: mean |du| <= 1e-3 px, max |du| <= 1e-2 px. The two compute the
same operations in float32, but XLA's CPU fusion and the order of the
full-plane epsilon sum differ from PyTorch's, so results agree to ~1e-5 px
on average (measured) rather than bit for bit; the bound leaves room for a
stop test that lands on the other side of its threshold in one block.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from denseflow_tpu.kernels.tvl1_fused import tvl1_scale_fused
from denseflow_tpu.ops.derivatives import centered_gradient
from denseflow_tpu_torch.kernels.tvl1_fused import tvl1_scale, tvl1_scale_reference

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
