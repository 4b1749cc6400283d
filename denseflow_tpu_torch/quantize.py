"""Flow -> uint8 quantization on the device, before the payload crosses to
the host: the reference's jpg-path CAST formula (reference
src/common.cpp:6): v>H -> 255, v<L -> 0, else round(255*(v-L)/(H-L)) with
L=-bound, H=+bound, rounding half to even like cvRound. Same f32 operation
order as the JAX package's `denseflow_tpu/quantize.py:27-39`;
`torch.round` and `jnp.round` both round half to even.

The adaptive png scheme is not ported yet (ROADMAP.md A6).
"""

from __future__ import annotations

from typing import Tuple

import torch


def quantize_cast(v: torch.Tensor, lower: float, upper: float) -> torch.Tensor:
    """The CAST macro, vectorized. Returns uint8."""
    scaled = torch.round(255.0 * (v - lower) / (upper - lower))
    out = torch.where(v > upper, 255.0, torch.where(v < lower, 0.0, scaled))
    return out.to(torch.uint8)


def quantize_flow_pair(
    flow: torch.Tensor, bound: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., H, W, 2) float flow -> (img_x, img_y) uint8 (..., H, W)."""
    return (
        quantize_cast(flow[..., 0], -bound, bound),
        quantize_cast(flow[..., 1], -bound, bound),
    )
