"""Batched TV-L1 optical flow (Zach, Pock, Bischof 2007) in PyTorch.

Semantics match OpenCV's `cuda::OpticalFlowDual_TVL1` as invoked by the
reference (reference src/denseflow_gpu.cpp:299,327) with its default
hyper-parameters: tau=0.25, lambda=0.15, theta=0.3, nscales=5, warps=5,
epsilon=0.01, iterations=300, scaleStep=0.8. Per scale, coarse to fine:
centered gradients of I1, then one `tvl1_scale` call (the CUDA kernel on the
card, its plain PyTorch version on the CPU) for all warps and iterations of
every pair, then a bilinear upsample of the flow times 1/scaleStep. This is
the JAX package's `denseflow_tpu/algorithms/tvl1.py` on its fused-kernel
path.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from denseflow_tpu_torch.kernels.tvl1_fused import tvl1_scale
from denseflow_tpu_torch.ops.derivatives import centered_gradient
from denseflow_tpu_torch.ops.pyramid import build_pyramid, pyramid_shapes
from denseflow_tpu_torch.ops.resize import resize_bilinear
from denseflow_tpu_torch.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class TVL1Params:
    tau: float = 0.25
    lambda_: float = 0.15
    theta: float = 0.3
    nscales: int = 5
    warps: int = 5
    epsilon: float = 0.01
    iterations: int = 300
    scale_step: float = 0.8
    # the epsilon stop is tested every N iterations (1 = OpenCV-exact; N
    # runs at most N-1 extra iterations past convergence); the JAX
    # package's default
    check_every: int = 24
    min_size: int = 16
    # finest-level displacement clamp of the warp, in px
    max_disp: int = 40


def tvl1_params_from_reference(d: dict) -> TVL1Params:
    """TVL1Params from `dataclasses.asdict` of the JAX package's TVL1Params,
    so both sides run identical hyper-parameters. `use_pallas` (its kernel
    selector) has no counterpart here and is dropped."""
    fields = {f.name for f in dataclasses.fields(TVL1Params)}
    return TVL1Params(**{k: v for k, v in d.items() if k in fields})


def tvl1_flow(I0: torch.Tensor, I1: torch.Tensor, params: TVL1Params) -> torch.Tensor:
    """I0, I1: (B, H, W) float32 in 0..255 on one device -> flow (B, H, W, 2)."""
    h, w = I0.shape[-2], I0.shape[-1]
    shapes = pyramid_shapes(h, w, params.scale_step, params.nscales, params.min_size)
    pyr0 = build_pyramid(I0, shapes)
    pyr1 = build_pyramid(I1, shapes)
    l_t = params.lambda_ * params.theta
    taut = params.tau / params.theta
    inv = 1.0 / params.scale_step
    u1 = torch.zeros(I0.shape[:-2] + shapes[-1], dtype=torch.float32, device=I0.device)
    u2 = torch.zeros_like(u1)
    for lvl in range(len(shapes) - 1, -1, -1):
        # motion of max_disp px at the finest level is max_disp*(w_lvl/w_0)
        # px here (denseflow_tpu/algorithms/tvl1.py:228)
        d_lvl = max(4, int(round(params.max_disp * shapes[lvl][1] / shapes[0][1])))
        I1x, I1y = centered_gradient(pyr1[lvl])
        u1, u2, _ = tvl1_scale(
            pyr0[lvl], pyr1[lvl], I1x, I1y, u1, u2,
            l_t=l_t, theta=params.theta, taut=taut, epsilon=params.epsilon,
            iterations=params.iterations, warps=params.warps,
            max_disp=float(d_lvl), check_every=params.check_every,
        )
        if lvl > 0:
            nh, nw = shapes[lvl - 1]
            u1 = resize_bilinear(u1, (nh, nw)) * inv
            u2 = resize_bilinear(u2, (nh, nw)) * inv
    return torch.stack([u1, u2], dim=-1)


def make_tvl1_solver(
    height: int, width: int, params: TVL1Params, device: str = "cuda"
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """uint8-in solver for one frame geometry on `device`:
    f(I0_u8, I1_u8) (B, H, W) -> flow (B, H, W, 2) float32 on that device."""
    dev = resolve_device(device)

    def solver(I0_u8: torch.Tensor, I1_u8: torch.Tensor) -> torch.Tensor:
        if tuple(I0_u8.shape[-2:]) != (height, width):
            raise ValueError(
                f"solver built for {height}x{width}, got {tuple(I0_u8.shape[-2:])}"
            )
        I0 = I0_u8.to(dev, torch.float32)
        I1 = I1_u8.to(dev, torch.float32)
        return tvl1_flow(I0, I1, params)

    return solver
