"""Image pyramids for the coarse-to-fine TVL1 solver: geometry computed on
the host from (H, W, scale, nscales), levels made by successive
cv2-compatible bilinear resizes — OpenCV TVL1's scheme (scaleStep=0.8
multiplicative per level, INTER_LINEAR). A copy of the JAX package's
`denseflow_tpu/ops/pyramid.py`."""

from __future__ import annotations

from typing import List, Tuple

import torch

from denseflow_tpu_torch.ops.resize import resize_bilinear


def pyramid_shapes(
    h: int, w: int, scale: float, nscales: int, min_size: int = 16
) -> List[Tuple[int, int]]:
    """Static (h, w) per level, level 0 = finest. Truncates when a side
    would drop below `min_size` (OpenCV TVL1 stops there too). Python's
    `round` (half to even) on purpose: it is what the JAX package uses."""
    shapes = [(h, w)]
    ch, cw = float(h), float(w)
    for _ in range(1, nscales):
        ch *= scale
        cw *= scale
        nh, nw = int(round(ch)), int(round(cw))
        if min(nh, nw) < min_size:
            break
        shapes.append((nh, nw))
    return shapes


def build_pyramid(img: torch.Tensor, shapes: List[Tuple[int, int]]) -> List[torch.Tensor]:
    """Image (..., H, W) -> per-level float32 images, finest first. Each
    level is resized from the *previous level*, as OpenCV builds it."""
    levels = [img.to(torch.float32)]
    for hw in shapes[1:]:
        levels.append(resize_bilinear(levels[-1], hw))
    return levels
