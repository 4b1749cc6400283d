"""Bilinear resize matching cv2.resize INTER_LINEAR (half-pixel centers,
no antialiasing) — the interpolation the reference uses for ingest resize
(reference src/denseflow_gpu.cpp:169) and, inside OpenCV's CUDA TVL1, for
pyramid down/up-sampling.

The take-based form of the JAX package's `denseflow_tpu/ops/resize.py`
(`resize_bilinear`), in the same f32 operation order so the two agree bit
for bit. Its dense-matmul variant is not ported: the pyramid keeps the
two-tap form on purpose (`denseflow_tpu/ops/pyramid.py:44-50`).
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch


@functools.lru_cache(maxsize=None)
def _axis_coords(dst_n: int, src_n: int, device: torch.device):
    """(i0, i1, frac) for one axis: clipped integer neighbours and the blend
    weight under cv2's rule src = (dst + 0.5) * scale - 0.5, where the
    *coordinate* is clamped (x < 0 collapses to pixel 0). Computed on the
    CPU once per geometry and device: a copy to the card made at every call
    would wait for all the work queued before it."""
    scale = torch.tensor(src_n / dst_n, dtype=torch.float32)
    x = (torch.arange(dst_n, dtype=torch.float32) + 0.5) * scale - 0.5
    i0 = torch.floor(x)
    frac = x - i0
    i0i = torch.clamp(i0.to(torch.int64), 0, src_n - 1)
    i1i = torch.clamp(i0i + 1, 0, src_n - 1)
    frac = torch.where(x < 0, 0.0, frac)
    frac = torch.where(x > src_n - 1, 1.0, frac)
    return i0i.to(device), i1i.to(device), frac.to(device)


def resize_bilinear(img: torch.Tensor, new_hw: Tuple[int, int]) -> torch.Tensor:
    """Resize (..., H, W) to (..., new_h, new_w) float32, cv2-compatible.
    Leading batch axes pass through."""
    new_h, new_w = new_hw
    src_h, src_w = img.shape[-2], img.shape[-1]
    x = img.to(torch.float32)
    if (src_h, src_w) == (new_h, new_w):
        return x
    y0, y1, fy = _axis_coords(new_h, src_h, x.device)
    x0, x1, fx = _axis_coords(new_w, src_w, x.device)
    top = torch.index_select(x, -2, y0)
    bot = torch.index_select(x, -2, y1)
    fy = fy.reshape(-1, 1)
    rows = top * (1.0 - fy) + bot * fy
    left = torch.index_select(rows, -1, x0)
    right = torch.index_select(rows, -1, x1)
    return left * (1.0 - fx) + right * fx
