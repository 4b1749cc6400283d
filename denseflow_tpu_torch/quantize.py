"""Flow -> uint8 quantization on the device, before the payload crosses to
the host. Same f32 operation order as the JAX package's
`denseflow_tpu/quantize.py`; `torch.round` and `jnp.round` both round half
to even, like cvRound.

* `quantize_flow_pair`: the jpg-path CAST formula (reference
  src/common.cpp:6): v>H -> 255, v<L -> 0, else round(255*(v-L)/(H-L))
  with L=-bound, H=+bound.
* `quantize_flow_png`: the adaptive-bound 3-channel png scheme (reference
  src/common.cpp:18-46): per-frame dynamic bounds snapped to a 4-multiple
  (never an 8-multiple), x/y stored as v*128/bound + 128, and bound/4
  encoded into channel 2 (top half = bound_x, bottom half = bound_y).
  The product and the sum of v*128/bound + 128 are rounded one at a time;
  XLA's CPU backend fuses them into one FMA, which can move a value that
  sits on a .5 tie by one level (ROADMAP.md C).
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


def _adaptive_bound(comp: torch.Tensor, axis_len: int) -> torch.Tensor:
    """Per-frame png bound for one flow component (reference src/common.cpp:24-32).

    comp: (..., H, W) one component. axis_len: w for x, h for y.
    bound = min(1020, ceil(min(axis_len, max|comp|) * 128/127 / 4) * 4),
    then += 4 if divisible by 8. Returns float (...,) per-frame bound.
    """
    mag = torch.maximum(comp.amin(dim=(-2, -1)).abs(), comp.amax(dim=(-2, -1)).abs())
    b = torch.ceil((torch.clamp(mag, max=float(axis_len)) * 128.0 / 127.0) / 4.0) * 4.0
    b = torch.clamp(b, max=255.0 * 4.0)
    return torch.where(b.to(torch.int32) % 8 == 0, b + 4.0, b)


def quantize_flow_png(flow: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 2) float flow -> (..., H, W, 3) uint8 BGR png payload.

    Channel 0: quantized x, channel 1: quantized y, channel 2: bounds/4
    (rows [0, h//2] = bound_x/4, rows [h//2+1, h) = bound_y/4 — the
    reference's two filled rectangles, reference src/common.cpp:40-42).
    """
    h, w = flow.shape[-3], flow.shape[-2]
    fx = flow[..., 0]
    fy = flow[..., 1]
    bound_x = _adaptive_bound(fx, w)[..., None, None]
    bound_y = _adaptive_bound(fy, h)[..., None, None]
    # cv2 convertTo: saturate_cast<uchar>(round(v * alpha + beta))
    qx = torch.clamp(torch.round(fx * (128.0 / bound_x) + 128.0), 0, 255)
    qy = torch.clamp(torch.round(fy * (128.0 / bound_y) + 128.0), 0, 255)
    row = torch.arange(h, device=flow.device).reshape(h, 1)
    bchan = torch.where(
        row <= h // 2, torch.round(bound_x / 4.0), torch.round(bound_y / 4.0)
    )
    bchan = torch.broadcast_to(bchan, qx.shape)
    return torch.stack([qx, qy, bchan], dim=-1).to(torch.uint8)


def dequantize_flow_png(img: torch.Tensor) -> torch.Tensor:
    """Inverse of the png scheme (for tests / consumers): uint8 (..,H,W,3)
    -> float flow (..,H,W,2)."""
    h = img.shape[-3]
    bx = img[..., 0:1, 0:1, 2].to(torch.float32) * 4.0
    by = img[..., h - 1:h, 0:1, 2].to(torch.float32) * 4.0
    fx = (img[..., 0].to(torch.float32) - 128.0) * (bx / 128.0)
    fy = (img[..., 1].to(torch.float32) - 128.0) * (by / 128.0)
    return torch.stack([fx, fy], dim=-1)
