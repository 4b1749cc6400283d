"""Discrete derivatives of OpenCV TVL1's discretization, on the trailing
(H, W) axes (a copy of the JAX package's `denseflow_tpu/ops/derivatives.py`):

* centered gradient with half-step one-sided differences at the borders,
* forward gradient (zero at the far border),
* backward divergence (adjoint of the forward gradient).
"""

from __future__ import annotations

from typing import Tuple

import torch


def centered_gradient(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dy): 0.5*(I[x+1]-I[x-1]) inside, 0.5*(I[1]-I[0]) style at edges."""
    right = torch.cat([img[..., :, 1:], img[..., :, -1:]], dim=-1)
    left = torch.cat([img[..., :, :1], img[..., :, :-1]], dim=-1)
    dx = 0.5 * (right - left)
    down = torch.cat([img[..., 1:, :], img[..., -1:, :]], dim=-2)
    up = torch.cat([img[..., :1, :], img[..., :-1, :]], dim=-2)
    dy = 0.5 * (down - up)
    return dx, dy


def forward_gradient(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dy): I[x+1]-I[x] with 0 at the last column/row."""
    dx = torch.cat(
        [img[..., :, 1:] - img[..., :, :-1], torch.zeros_like(img[..., :, :1])],
        dim=-1,
    )
    dy = torch.cat(
        [img[..., 1:, :] - img[..., :-1, :], torch.zeros_like(img[..., :1, :])],
        dim=-2,
    )
    return dx, dy


def divergence(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Backward divergence: div(p)(i,j) = p1(i,j)-p1(i,j-1) + p2(i,j)-p2(i-1,j),
    with the subtracted term dropped at j=0 / i=0 (adjoint of forward_gradient)."""
    dpx = torch.cat([p1[..., :, :1], p1[..., :, 1:] - p1[..., :, :-1]], dim=-1)
    dpy = torch.cat([p2[..., :1, :], p2[..., 1:, :] - p2[..., :-1, :]], dim=-2)
    return dpx + dpy
