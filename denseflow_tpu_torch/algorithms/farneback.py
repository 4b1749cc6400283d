"""Batched Farneback optical flow (polynomial expansion) in PyTorch.

Matches OpenCV's `calcOpticalFlowFarneback` as the reference creates it
(reference src/denseflow_gpu.cpp:301,329) with its defaults: numLevels=5,
pyrScale=0.5, winSize=13, numIters=10, polyN=5, polySigma=1.1, flags=0.
This is the JAX package's `denseflow_tpu/algorithms/farneback.py` on its
fused path. Per level, coarse to fine:

* the level image: the full-resolution input Gaussian-blurred (reflect101)
  and bilinearly resized to the level, as two dense per-axis operators
  (`_level_matrices`) applied with `torch.bmm` in float64 and rounded once
  to float32, so no TF32 or reduced-precision setting of the caller's can
  reach them (JAX runs them at Precision.HIGHEST);
* the polynomial expansion of both images at every level in one
  `poly_expand` call (one CUDA launch on the card, its plain version on
  the CPU), before the first level runs;
* one `farneback_level` call for all iterations of every pair;
* between levels, the flow upsampled bilinearly times 1/pyrScale.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from denseflow_tpu_torch.kernels.farneback_fused import farneback_level, poly_expand
from denseflow_tpu_torch.ops.filters import gaussian_kernel_1d
from denseflow_tpu_torch.ops.resize import resize_bilinear
from denseflow_tpu_torch.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class FarnebackParams:
    num_levels: int = 5
    pyr_scale: float = 0.5
    win_size: int = 13
    num_iters: int = 10
    poly_n: int = 5
    poly_sigma: float = 1.1
    min_size: int = 8  # stop adding levels below this side length
    # a pair stops iterating a level once an iteration's RMS flow update is
    # below stop_eps px (OpenCV runs all numIters); 0 disables
    stop_eps: float = 1e-3
    # finest-level displacement clamp of the coefficient warp, in px;
    # scaled per pyramid level
    max_disp: int = 40


def farneback_params_from_reference(d: dict) -> FarnebackParams:
    """FarnebackParams from `dataclasses.asdict` of the JAX package's
    FarnebackParams, so both sides run identical hyper-parameters.
    `use_pallas` (its kernel selector) has no counterpart here and is
    dropped."""
    fields = {f.name for f in dataclasses.fields(FarnebackParams)}
    return FarnebackParams(**{k: v for k, v in d.items() if k in fields})


def _poly_exp_setup(n: int, sigma: float):
    """Precompute the Gaussian window and the inverse normal matrix for the
    quadratic fit over basis (1, x, y, x², y², xy)."""
    xs = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(xs * xs) / (2.0 * sigma * sigma))
    g /= g.sum()
    # separable projection kernels
    xg = xs * g
    xxg = xs * xs * g
    # normal matrix G = sum w(x,y) * basis basis^T, separable moments
    m0 = g.sum()  # = 1
    m2 = (xs * xs * g).sum()
    m4 = (xs ** 4 * g).sum()
    G = np.zeros((6, 6))
    G[0, 0] = m0 * m0
    G[1, 1] = m2 * m0
    G[2, 2] = m0 * m2
    G[3, 3] = m4 * m0
    G[4, 4] = m0 * m4
    G[5, 5] = m2 * m2
    G[0, 3] = G[3, 0] = m2 * m0
    G[0, 4] = G[4, 0] = m0 * m2
    G[3, 4] = G[4, 3] = m2 * m2
    invG = np.linalg.inv(G)
    return (
        g.astype(np.float32),
        xg.astype(np.float32),
        xxg.astype(np.float32),
        invG.astype(np.float32),
    )


def _level_geometry(h: int, w: int, p: FarnebackParams):
    """Static per-level (scale, h, w, smooth_ksize, smooth_sigma), coarse
    level last — mirrors OpenCV's level-count clamp."""
    levels = 0
    scale = 1.0
    for k in range(p.num_levels):
        scale *= p.pyr_scale
        if w * scale < p.min_size or h * scale < p.min_size:
            break
        levels = k + 1
    out = []
    for k in range(levels, -1, -1):
        s = p.pyr_scale ** k
        sigma = (1.0 / s - 1.0) * 0.5
        ksize = max(int(round(sigma * 5)) | 1, 3)
        out.append((s, int(round(h * s)), int(round(w * s)), ksize, sigma))
    return out  # coarse first


_LEVEL_MATS: dict = {}


def _level_matrices(src_h: int, src_w: int, lh: int, lw: int,
                    ksize: int, sigma: float):
    """Dense (lh, src_h) / (lw, src_w) float32 operators for one pyramid
    level's `gaussian blur (reflect101) + bilinear resize`, built once per
    geometry on the host (numpy, float64, then rounded)."""
    key = (src_h, src_w, lh, lw, ksize, round(float(sigma), 6))
    hit = _LEVEL_MATS.get(key)
    if hit is not None:
        return hit
    g = gaussian_kernel_1d(ksize, sigma).astype(np.float64)
    c = (ksize - 1) // 2

    def blur_mat(n):
        Bm = np.zeros((n, n), np.float64)
        for j, kv in enumerate(g):
            off = j - c
            for r in range(n):
                t = r + off
                while not 0 <= t <= n - 1:  # reflect101 fold
                    t = -t if t < 0 else 2 * (n - 1) - t
                Bm[r, t] += kv
        return Bm

    def resize_mat(n_out, n_in):
        if n_out == n_in:
            return np.eye(n_in)
        R = np.zeros((n_out, n_in), np.float64)
        scale = n_in / n_out
        for o in range(n_out):
            x = (o + 0.5) * scale - 0.5
            i0 = int(np.floor(x))
            frac = x - i0
            i0c = min(max(i0, 0), n_in - 1)
            i1c = min(i0c + 1, n_in - 1)
            if x < 0:
                frac = 0.0
            if x > n_in - 1:
                frac = 1.0
            R[o, i0c] += 1.0 - frac
            R[o, i1c] += frac
        return R

    Mv = (resize_mat(lh, src_h) @ blur_mat(src_h)).astype(np.float32)
    Mh = (resize_mat(lw, src_w) @ blur_mat(src_w)).astype(np.float32)
    _LEVEL_MATS[key] = (Mv, Mh)
    return Mv, Mh


@functools.lru_cache(maxsize=64)
def _level_operators(h: int, w: int, lh: int, lw: int, ksize: int,
                     sigma: float, device: torch.device):
    """`_level_matrices` on `device` in float64: Mv and Mh transposed."""
    Mv, Mh = _level_matrices(h, w, lh, lw, ksize, sigma)
    return (torch.from_numpy(Mv).to(device, torch.float64),
            torch.from_numpy(Mh.T).to(device, torch.float64).contiguous())


def _level_image(I: torch.Tensor, lh: int, lw: int, ksize: int,
                 sigma: float) -> torch.Tensor:
    """blur+resize of (N, H, W) float32 or float64 via the dense per-axis
    operators. The products run in float64, which no TF32 setting
    touches, and are rounded once to float32. The operators are expanded
    over the batch and applied with `bmm`, so each image's product has the
    same shape whatever N is."""
    n, h, w = I.shape
    Mv, MhT = _level_operators(h, w, lh, lw, ksize, sigma, I.device)
    hi = torch.bmm(Mv.expand(n, lh, h), I.to(torch.float64))
    return torch.bmm(hi, MhT.expand(n, w, lw)).to(torch.float32)


def farneback_flow(I0: torch.Tensor, I1: torch.Tensor, p: FarnebackParams) -> torch.Tensor:
    """I0, I1: (B, H, W) float32 in 0..255 on one device -> flow (B, H, W, 2)."""
    b, h, w = I0.shape
    # both images, in float64 once for every level's products
    both = torch.cat([I0, I1]).to(torch.float64)
    geometry = _level_geometry(h, w, p)
    # the level images depend only on the frames: every level of both
    # images through one poly_expand launch
    Rs = poly_expand([_level_image(both, lh, lw, ksize, sigma)
                      for _, lh, lw, ksize, sigma in geometry], p.poly_n, p.poly_sigma)
    u = v = None
    for (scale, lh, lw, _, _), R in zip(geometry, Rs):
        if u is None:
            u = torch.zeros((b, lh, lw), dtype=torch.float32, device=I0.device)
            v = torch.zeros_like(u)
        else:
            # u and v through one resize
            u, v = resize_bilinear(torch.stack([u, v]), (lh, lw)) * (1.0 / p.pyr_scale)
        d_lvl = max(4, int(round(p.max_disp * scale)))
        u, v, _ = farneback_level(
            R[:b], R[b:], u, v, win_size=int(p.win_size),
            num_iters=int(p.num_iters), max_disp=float(d_lvl),
            stop_eps=float(p.stop_eps),
        )
    return torch.stack([u, v], dim=-1)


def make_farneback_solver(
    height: int, width: int, params: FarnebackParams, device: str = "cuda"
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
        return farneback_flow(I0, I1, params)

    return solver
