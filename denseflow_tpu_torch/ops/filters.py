"""Separable filters (Gaussian / box) on the trailing (H, W) axes.

The port of the JAX package's `denseflow_tpu/ops/filters.py`: the same
OpenCV-compatible Gaussian, the same two border modes, and the taps summed
in the same order (ascending, starting from the first term), so the two
agree bit for bit. Farneback's level operators and its kernels' plain
versions use them.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    """OpenCV-compatible normalized 1-D Gaussian (cv2.getGaussianKernel)."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    half = (ksize - 1) / 2.0
    xs = np.arange(ksize, dtype=np.float64) - half
    k = np.exp(-(xs * xs) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _pad1d(x: torch.Tensor, pad: int, dim: int, border: str) -> torch.Tensor:
    """Pad one dim with an OpenCV border mode: 'reflect101'
    (gfedcb|abcdefgh|gfedcb) or 'replicate' (aaaaaa|abcdefgh|hhhhhh)."""
    if pad == 0:
        return x
    idx_lo, idx_hi = _pad_index(x.shape[dim], pad, border, x.device)
    lo = torch.index_select(x, dim, idx_lo)
    hi = torch.index_select(x, dim, idx_hi)
    return torch.cat([lo, x, hi], dim=dim)


@functools.lru_cache(maxsize=None)
def _pad_index(n: int, pad: int, border: str,
               device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The source indices of the `pad` elements before and after an axis
    of n, on `device`. Built once per geometry and device: a copy to the
    card made at every call would wait for all the work queued before it."""
    if border == "reflect101":
        idx_lo = np.arange(pad, 0, -1) % n
        idx_hi = (n - 2 - np.arange(pad)) % n
    elif border == "replicate":
        idx_lo = np.zeros(pad, dtype=np.int64)
        idx_hi = np.full(pad, n - 1, dtype=np.int64)
    else:
        raise ValueError(border)
    return torch.from_numpy(idx_lo).to(device), torch.from_numpy(idx_hi).to(device)


def conv1d(
    x: torch.Tensor, kernel: np.ndarray, dim: int, border: str = "reflect101"
) -> torch.Tensor:
    """Correlate x with a short odd-length 1-D kernel along `dim`."""
    k = np.asarray(kernel, dtype=np.float32)
    pad = (len(k) - 1) // 2
    xp = _pad1d(x.to(torch.float32), pad, dim, border)
    n = x.shape[dim]
    out = None
    for i, ki in enumerate(k):
        term = xp.narrow(dim, i, n) * float(ki)
        out = term if out is None else out + term
    return out


def sep_filter2d(
    x: torch.Tensor, kx: np.ndarray, ky: np.ndarray, border: str = "reflect101"
) -> torch.Tensor:
    """Separable 2-D correlation on the trailing (H, W) axes."""
    out = conv1d(x, ky, dim=x.dim() - 2, border=border)
    return conv1d(out, kx, dim=x.dim() - 1, border=border)


def box_filter(x: torch.Tensor, ksize: int, border: str = "replicate") -> torch.Tensor:
    """Normalized box filter (mean over a ksize x ksize window)."""
    k = np.full((ksize,), 1.0 / ksize, dtype=np.float32)
    return sep_filter2d(x, k, k, border=border)
