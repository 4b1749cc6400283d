"""The port's TVL1 solver against the JAX package's: the fused-kernel path
run through the Pallas interpreter, the repo's golden EPE gate, the preset
registry, and batch invariance."""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from denseflow_tpu.algorithms import solver_params as j_solver_params
from denseflow_tpu.algorithms.tvl1 import TVL1Params as JParams
from denseflow_tpu.algorithms.tvl1 import tvl1_flow as j_tvl1_flow
from denseflow_tpu_torch.algorithms import make_solver, solver_params
from denseflow_tpu_torch.algorithms.tvl1 import (
    TVL1Params,
    make_tvl1_solver,
    tvl1_flow,
    tvl1_params_from_reference,
)

torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden"
GATE = 0.5  # px, tests/test_fidelity.py


def _translated_pair(h=64, w=80, dx=1.7, dy=-0.8, seed=1):
    rng = np.random.default_rng(seed)
    base = ndi.gaussian_filter(rng.uniform(0, 255, (h + 20, w + 20)), 2.0).astype(np.float32)
    ys, xs = np.mgrid[0:h, 0:w]
    I0 = np.clip(base[10:10 + h, 10:10 + w], 0, 255).astype(np.uint8)
    I1 = np.clip(
        ndi.map_coordinates(base, [ys + 10 - dy, xs + 10 - dx], order=3), 0, 255
    ).astype(np.uint8)
    return I0, I1


def _epe(a, b):
    return float(np.linalg.norm(a - b, axis=-1).mean())


def test_matches_jax_fused_path():
    """Within the repo's fused-vs-XLA gate (tests/test_solvers.py:64-81):
    mean |d flow| < 0.03 px; measured ~1e-5 px."""
    I0, I1 = _translated_pair()
    jp = JParams()
    p = tvl1_params_from_reference(dataclasses.asdict(jp))
    ref = np.asarray(j_tvl1_flow(jnp.asarray(I0[None], jnp.float32),
                                 jnp.asarray(I1[None], jnp.float32), jp, interpret=True))[0]
    got = tvl1_flow(torch.from_numpy(I0[None]).float(),
                    torch.from_numpy(I1[None]).float(), p)[0].numpy()
    d = np.abs(got - ref)
    assert d.mean() < 0.03, d.mean()
    c = got[10:-10, 10:-10]
    assert float(np.linalg.norm(c - np.array([1.7, -0.8]), axis=-1).mean()) < 0.2


@pytest.mark.parametrize("name", ["translation", "rotation", "zoom", "diag"])
def test_golden_gate(name):
    d = np.load(GOLDEN / f"tvl1_{name}.npz")
    solver = make_tvl1_solver(*d["I0"].shape, TVL1Params(), device="cpu")
    flow = solver(torch.from_numpy(d["I0"][None]), torch.from_numpy(d["I1"][None]))[0].numpy()
    assert _epe(flow, d["oracle"]) < GATE
    assert _epe(flow, d["gt"]) < GATE


@pytest.mark.parametrize("alg", ["tvl1", "nv"])
@pytest.mark.parametrize("preset", [None, "default", "fast", "quality"])
def test_presets_resolve_like_jax(alg, preset):
    want = tvl1_params_from_reference(dataclasses.asdict(j_solver_params(alg, preset)))
    assert solver_params(alg, preset) == want


def test_params_defaults_match_jax():
    jd = dataclasses.asdict(JParams())
    assert "use_pallas" in jd
    assert dataclasses.asdict(tvl1_params_from_reference(jd)) == \
        {k: v for k, v in jd.items() if k != "use_pallas"}
    assert tvl1_params_from_reference(jd) == TVL1Params()


def test_unported_algorithms_raise():
    # brox is ported (ROADMAP.md A9): its preset resolves; an unknown name
    # still raises the reference's error
    from denseflow_tpu_torch.algorithms.brox import BroxParams

    assert solver_params("brox") == BroxParams()
    with pytest.raises(ValueError, match="not supported"):
        solver_params("dis")


def test_batch_invariance_byte_for_byte():
    """A pair's flow does not depend on its batch-mates or on B."""
    pairs = [_translated_pair(seed=s, dx=1.0 + s * 0.3, dy=-0.5) for s in range(3)]
    I0 = np.stack([p[0] for p in pairs])
    I1 = np.stack([p[1] for p in pairs])
    I1[1] = I0[1]  # a batch-mate that converges at once
    solver = make_solver("tvl1", 64, 80, device="cpu")
    batched = solver(torch.from_numpy(I0), torch.from_numpy(I1)).numpy()
    for i in range(3):
        single = solver(torch.from_numpy(I0[i:i + 1]), torch.from_numpy(I1[i:i + 1])).numpy()[0]
        assert np.array_equal(batched[i].view(np.uint32), single.view(np.uint32))


def test_max_disp_override():
    s = make_solver("nv", 64, 80, max_disp=80, device="cpu")
    I0, I1 = _translated_pair(dx=2.0, dy=0.0)
    flow = s(torch.from_numpy(I0[None]), torch.from_numpy(I1[None]))[0].numpy()
    assert float(np.linalg.norm(flow[10:-10, 10:-10] - [2.0, 0.0], axis=-1).mean()) < 0.4
