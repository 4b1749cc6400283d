"""Batched Brox et al. 2004 variational optical flow in PyTorch.

Semantics follow the reference's creation call (reference
src/denseflow_gpu.cpp:303): alpha=0.197 (smoothness), gamma=50 (gradient
constancy), pyramid scale=0.8, inner_iterations=10, outer_iterations=77,
solver_iterations=10, with inputs as float32 in [0,1] (the reference
converts gray frames with 1/255, reference src/denseflow_gpu.cpp:331-333).
This is the JAX package's `denseflow_tpu/algorithms/brox.py` on its fused
path: the inputs presmoothed with a 5-tap Gaussian (sigma 0.8, reflect101),
a scale-0.8 pyramid down to 16 px, then, coarse to fine, one `brox_scale`
call per level for all warps, fixed-point steps and Jacobi sweeps of every
pair (the CUDA kernel on the card, its plain version on the CPU), and
between levels the flow upsampled bilinearly times 1/0.8.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from denseflow_tpu_torch.kernels.brox_fused import brox_scale
from denseflow_tpu_torch.ops.filters import gaussian_kernel_1d, sep_filter2d
from denseflow_tpu_torch.ops.pyramid import build_pyramid, pyramid_shapes
from denseflow_tpu_torch.ops.resize import resize_bilinear
from denseflow_tpu_torch.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class BroxParams:
    alpha: float = 0.197
    gamma: float = 50.0
    scale_step: float = 0.8
    inner_iterations: int = 10
    outer_iterations: int = 77
    solver_iterations: int = 10
    min_size: int = 16
    # a pair stops a level once a warp's RMS flow update is below stop_eps
    # px, and an inner step once its RMS change is below stop_eps/4 (the
    # reference runs all 77 warps); 0 disables both
    stop_eps: float = 1e-3
    # presmoothing of the input images
    presmooth_sigma: float = 0.8
    # finest-level displacement clamp of the warp, in px; scaled per level
    max_disp: int = 40


def brox_params_from_reference(d: dict) -> BroxParams:
    """BroxParams from `dataclasses.asdict` of the JAX package's BroxParams,
    so both sides run identical hyper-parameters. `use_pallas` (its kernel
    selector) has no counterpart here and is dropped."""
    fields = {f.name for f in dataclasses.fields(BroxParams)}
    return BroxParams(**{k: v for k, v in d.items() if k in fields})


def brox_flow(I0: torch.Tensor, I1: torch.Tensor, p: BroxParams) -> torch.Tensor:
    """I0, I1: (B, H, W) float32 in [0,1] on one device -> flow (B, H, W, 2)."""
    h, w = I0.shape[-2], I0.shape[-1]
    gk = gaussian_kernel_1d(5, p.presmooth_sigma)
    I0s = sep_filter2d(I0, gk, gk)
    I1s = sep_filter2d(I1, gk, gk)
    shapes = pyramid_shapes(h, w, p.scale_step, nscales=100, min_size=p.min_size)
    pyr0 = build_pyramid(I0s, shapes)
    pyr1 = build_pyramid(I1s, shapes)
    inv = 1.0 / p.scale_step
    u = torch.zeros(I0.shape[:-2] + shapes[-1], dtype=torch.float32, device=I0.device)
    v = torch.zeros_like(u)
    for lvl in range(len(shapes) - 1, -1, -1):
        d_lvl = max(4, int(round(p.max_disp * shapes[lvl][1] / shapes[0][1])))
        u, v, _ = brox_scale(
            pyr0[lvl].contiguous(), pyr1[lvl].contiguous(), u, v,
            alpha=p.alpha, gamma=p.gamma,
            inner_iterations=p.inner_iterations,
            outer_iterations=p.outer_iterations,
            solver_iterations=p.solver_iterations,
            max_disp=float(d_lvl), stop_eps=p.stop_eps,
        )
        if lvl > 0:
            nh, nw = shapes[lvl - 1]
            u = resize_bilinear(u, (nh, nw)) * inv
            v = resize_bilinear(v, (nh, nw)) * inv
    return torch.stack([u, v], dim=-1)


def make_brox_solver(
    height: int, width: int, params: BroxParams, device: str = "cuda"
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """uint8-in solver for one frame geometry on `device`:
    f(I0_u8, I1_u8) (B, H, W) -> flow (B, H, W, 2) float32 on that device.
    The frames are scaled to [0,1] by a multiply with f32(1/255), as the
    JAX solver scales them."""
    dev = resolve_device(device)
    scale = float(np.float32(1.0 / 255.0))

    def solver(I0_u8: torch.Tensor, I1_u8: torch.Tensor) -> torch.Tensor:
        if tuple(I0_u8.shape[-2:]) != (height, width):
            raise ValueError(
                f"solver built for {height}x{width}, got {tuple(I0_u8.shape[-2:])}"
            )
        I0 = I0_u8.to(dev, torch.float32) * scale
        I1 = I1_u8.to(dev, torch.float32) * scale
        return brox_flow(I0, I1, params)

    return solver
