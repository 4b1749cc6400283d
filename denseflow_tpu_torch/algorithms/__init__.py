"""Flow algorithm registry.

Maps the reference's algorithm names (reference tools/denseflow.cpp:11,
src/denseflow_gpu.cpp:285-304) to batched solvers:

* ``tvl1`` — Zach/Pock/Bischof TV-L1 primal-dual (default)
* ``farn`` — Farneback polynomial expansion
* ``brox`` — Brox 2004 variational (inputs scaled to [0,1])
* ``nv``   — hardware-ASIC flow in the reference; here a fast approximate
  TVL1 preset (fewer scales/iterations), the same kernel with other
  parameters.

The presets are those of the JAX package's `denseflow_tpu/algorithms`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from denseflow_tpu_torch.algorithms.brox import BroxParams, make_brox_solver
from denseflow_tpu_torch.algorithms.farneback import (
    FarnebackParams,
    make_farneback_solver,
)
from denseflow_tpu_torch.algorithms.tvl1 import TVL1Params, make_tvl1_solver

#   default  — reference-exact hyperparameters
#   fast     — fewer warps/iterations/levels, small EPE cost
#   quality  — tighter convergence than the reference
_PRESETS = {
    "tvl1": {
        "default": TVL1Params(),
        "fast": TVL1Params(warps=3, iterations=120, nscales=4),
        "quality": TVL1Params(epsilon=0.005, iterations=500),
    },
    "nv": {
        "default": TVL1Params(warps=2, iterations=60, nscales=4),
        "fast": TVL1Params(warps=1, iterations=30, nscales=3),
        "quality": TVL1Params(warps=3, iterations=120, nscales=4),
    },
    "farn": {
        "default": FarnebackParams(),
        "fast": FarnebackParams(num_iters=5, num_levels=4),
        "quality": FarnebackParams(num_iters=15),
    },
    "brox": {
        "default": BroxParams(),
        "fast": BroxParams(outer_iterations=30),
        "quality": BroxParams(outer_iterations=120),
    },
}


def solver_params(algorithm: str, preset: str | None = None):
    """Resolve (algorithm, preset) -> the solver's parameter dataclass."""
    if algorithm not in _PRESETS:
        raise ValueError(f"{algorithm} not supported!")
    table = _PRESETS[algorithm]
    key = preset or "default"
    if key not in table:
        raise ValueError(
            f"unknown preset {preset!r} (choose from {sorted(table)})"
        )
    return table[key]


def make_solver(
    algorithm: str,
    height: int,
    width: int,
    preset: str | None = None,
    max_disp: int = 0,
    device: str = "cuda",
) -> Callable:
    """Batched solver f(I0_u8, I1_u8) -> (B, H, W, 2) float32 on `device`.
    TVL1 and Farneback work in 0..255, Brox in [0,1] (reference
    src/denseflow_gpu.cpp:331-333). max_disp > 0 overrides the
    finest-level displacement clamp (40 px)."""
    params = solver_params(algorithm, preset)
    if max_disp > 0:
        params = dataclasses.replace(params, max_disp=int(max_disp))
    if algorithm == "farn":
        return make_farneback_solver(height, width, params, device)
    if algorithm == "brox":
        return make_brox_solver(height, width, params, device)
    return make_tvl1_solver(height, width, params, device)
