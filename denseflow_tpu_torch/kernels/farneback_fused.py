"""Farneback's two kernels: the hand-written CUDA kernels
(`csrc/farneback_polyexp.cu`, `csrc/farneback_level.cu`) and their plain
PyTorch versions.

* `poly_expand` replaces the JAX package's Pallas kernel
  `denseflow_tpu/kernels/farneback_fused.py::poly_expand_fused`: the
  quadratic fit of each pixel's neighbourhood, (N, H, W) -> channel-first
  (N, 5, H, W) = (bx, by, cxx, cyy, cxy). The JAX package falls back to its
  XLA `poly_expand` above a padded plane of 272x384 (`polyexp_fused_fits`);
  this port has one code path for every size and ports no fallback.
* `farneback_level` replaces `farneback_level_fused` (with
  `farneback_level_fused_tiled`): one pyramid level's iterations of warp,
  normal equations, box blur and 2x2 solve for each pair. The JAX tiler
  exists only to fit VMEM; this port computes the untiled answer at every
  geometry and ports no tiling.

Both plain versions compute what the Pallas kernels compute, in their
order of float operations (kernels/plane_ops.py), not what the JAX XLA
path does. On a CUDA tensor a wrapper launches its kernel and counts the
call in `.launches`; on a CPU tensor it runs the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from denseflow_tpu_torch.kernels.plane_ops import (
    border_scale,
    box_sum,
    check_window,
    resample_linear,
)
from denseflow_tpu_torch.kernels.tvl1_fused import _f32, _threshold
from denseflow_tpu_torch.ops.filters import _pad1d


@functools.lru_cache(maxsize=None)
def _polyexp_consts(n: int, sigma: float):
    """(g, xg, xxg, invG) as float32 numpy arrays, and all of them packed
    into one array for the kernel."""
    from denseflow_tpu_torch.algorithms.farneback import _poly_exp_setup

    g, xg, xxg, invG = _poly_exp_setup(n, sigma)
    packed = np.concatenate([g, xg, xxg, invG.ravel()]).astype(np.float32)
    return (g, xg, xxg, invG), packed


def _check(name: str, tensors, shapes) -> None:
    dev = tensors[0].device
    for t, shape in zip(tensors, shapes):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} takes float32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: tensors lie on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.lru_cache(maxsize=None)
def _polyexp_lib() -> ctypes.CDLL:
    from denseflow_tpu_torch.kernels import _build

    lib = _build.load("farneback_polyexp")
    lib.farneback_polyexp_launch.argtypes = [_P, _P, _I, _I, _I, _I, _P, _P]
    lib.farneback_polyexp_launch.restype = _I
    lib.farneback_polyexp_max_n.argtypes = []
    lib.farneback_polyexp_max_n.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _level_lib() -> ctypes.CDLL:
    from denseflow_tpu_torch.kernels import _build

    lib = _build.load("farneback_level")
    lib.farneback_level_launch.argtypes = [_P] * 10 + [_I] * 5 + [_F] * 3 + [_P]
    lib.farneback_level_launch.restype = _I
    lib.farneback_level_scratch_planes.argtypes = []
    lib.farneback_level_scratch_planes.restype = _I
    lib.farneback_level_partials.argtypes = [_I, _I]
    lib.farneback_level_partials.restype = _I
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------- polynomial expansion ----------------

def poly_expand_reference(img: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """Plain PyTorch version: (N, H, W) float32 -> (N, 5, H, W). Replicate
    border; one vertical pass for (g, x*g, x^2*g), horizontal passes for
    S1, Sx, Sy, Sxx, Syy, Sxy, each over the 2n+1 taps in ascending order
    from the first term; the sparse inverse normal matrix last."""
    (g, xg, xxg, ig), _ = _polyexp_consts(n, float(sigma))
    _, h, w = img.shape
    ipad = _pad1d(_pad1d(img, n, 1, "replicate"), n, 2, "replicate")

    def pass_(src, dim, length, kernels):
        outs = [None] * len(kernels)
        for j in range(2 * n + 1):
            s = src.narrow(dim, j, length)
            for q, k in enumerate(kernels):
                t = float(k[j]) * s
                outs[q] = t if outs[q] is None else outs[q] + t
        return outs

    vg, vxg, vxxg = pass_(ipad, 1, h, (g, xg, xxg))
    S1, Sx, Sxx = pass_(vg, 2, w, (g, xg, xxg))
    Sy, Sxy = pass_(vxg, 2, w, (g, xg))
    (Syy,) = pass_(vxxg, 2, w, (g,))
    c = lambda i, j: float(ig[i, j])  # noqa: E731
    return torch.stack([
        c(1, 1) * Sx,
        c(2, 2) * Sy,
        (c(3, 0) * S1 + c(3, 3) * Sxx) + c(3, 4) * Syy,
        (c(4, 0) * S1 + c(4, 3) * Sxx) + c(4, 4) * Syy,
        c(5, 5) * Sxy,
    ], dim=1)


def poly_expand(img: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """(N, H, W) float32 -> (N, 5, H, W) polynomial-expansion coefficients
    (bx, by, cxx, cyy, cxy), channel-first for `farneback_level`. On a CUDA
    tensor this launches `csrc/farneback_polyexp.cu` (counted in
    `poly_expand.launches`); on the CPU it runs `poly_expand_reference`."""
    if img.dim() != 3:
        raise ValueError(f"poly_expand takes (N, H, W), got {tuple(img.shape)}")
    _check("poly_expand", [img], [tuple(img.shape)])
    if img.device.type == "cpu":
        return poly_expand_reference(img, n, sigma)
    lib = _polyexp_lib()
    if not 0 <= n <= lib.farneback_polyexp_max_n():
        raise ValueError(f"poly_expand: poly_n {n} outside "
                         f"[0, {lib.farneback_polyexp_max_n()}]")
    nb, h, w = img.shape
    out = torch.empty((nb, 5, h, w), dtype=torch.float32, device=img.device)
    if nb == 0:
        return out
    _, packed = _polyexp_consts(n, float(sigma))
    rc = lib.farneback_polyexp_launch(
        img.data_ptr(), out.data_ptr(), nb, h, w, n,
        packed.ctypes.data, _stream(img))
    if rc != 0:
        raise RuntimeError(f"poly_expand kernel launch failed: CUDA error {rc}")
    poly_expand.launches += 1
    return out


poly_expand.launches = 0


# ---------------- one pyramid level ----------------

def farneback_level_reference(
    R0: torch.Tensor,
    R1: torch.Tensor,
    u: torch.Tensor,
    v: torch.Tensor,
    *,
    win_size: int,
    num_iters: int,
    max_disp: float,
    stop_eps: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the level kernel. Pairs advance in
    lockstep and a pair that has stopped is held with a mask, so each
    pair's result is what it would be alone. Returns (u, v, iters), iters
    (B,) int32 = the iterations each pair ran."""
    b, _, h, w = R0.shape
    md = _f32(max_disp)
    inv_win = _f32(1.0 / win_size)
    stop = _threshold(stop_eps, h, w)
    bscale = torch.from_numpy(border_scale(h, w)).to(u.device)
    active = torch.ones(b, dtype=torch.bool, device=u.device)
    iters = torch.zeros(b, dtype=torch.int32, device=u.device)
    for _ in range(num_iters):
        if not bool(active.any()):
            break
        # warp R1: rows at v, then columns at u
        R1s = resample_linear(resample_linear(R1, v[:, None], -2, md),
                              u[:, None], -1, md)
        a11 = (R0[:, 2] + R1s[:, 2]) * 0.5
        a22 = (R0[:, 3] + R1s[:, 3]) * 0.5
        a12 = (R0[:, 4] + R1s[:, 4]) * 0.25
        db1 = (R0[:, 0] - R1s[:, 0]) * 0.5
        db2 = (R0[:, 1] - R1s[:, 1]) * 0.5
        b1 = (db1 + a11 * u) + a12 * v
        b2 = (db2 + a12 * u) + a22 * v
        a11, a22, a12 = a11 * bscale, a22 * bscale, a12 * bscale
        b1, b2 = b1 * bscale, b2 * bscale
        M = torch.stack([
            a11 * a11 + a12 * a12,
            (a11 + a22) * a12,
            a22 * a22 + a12 * a12,
            a11 * b1 + a12 * b2,
            a12 * b1 + a22 * b2,
        ], dim=1)
        M = box_sum(box_sum(M, win_size, -2) * inv_win, win_size, -1) * inv_win
        g11, g12, g22, h1, h2 = M.unbind(1)
        idet = 1.0 / ((g11 * g22 - g12 * g12) + 1e-3)
        un = (g22 * h1 - g12 * h2) * idet
        vn = (g11 * h2 - g12 * h1) * idet
        du, dv = un - u, vn - v
        err = (du * du + dv * dv).sum(dim=(1, 2))
        keep = active[:, None, None]
        u = torch.where(keep, un, u)
        v = torch.where(keep, vn, v)
        iters += active.to(torch.int32)
        active = active & ~(err <= stop)
    return u, v, iters


def farneback_level(
    R0: torch.Tensor,
    R1: torch.Tensor,
    u: torch.Tensor,
    v: torch.Tensor,
    *,
    win_size: int,
    num_iters: int,
    max_disp: float,
    stop_eps: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Up to num_iters iterations of one pyramid level for each pair.

    R0, R1: (B, 5, H, W) float32 polynomial planes; u, v: (B, H, W)
    float32 incoming flow. A pair stops after the iteration whose
    sum(du^2 + dv^2) is <= f32(stop_eps^2*H*W) (stop_eps = 0: never). On a
    CUDA tensor this launches `csrc/farneback_level.cu` (one call counted in
    `farneback_level.launches`; it enqueues 1 + 4 * num_iters CUDA
    kernels); on the CPU it runs `farneback_level_reference`. Returns
    (u, v, iters), iters (B,) int32."""
    if R0.dim() != 4 or R0.shape[1] != 5:
        raise ValueError(f"farneback_level takes (B, 5, H, W) planes, got {tuple(R0.shape)}")
    b, _, h, w = R0.shape
    _check("farneback_level", [R0, R1, u, v], [(b, 5, h, w)] * 2 + [(b, h, w)] * 2)
    check_window(win_size)
    if num_iters < 0:
        raise ValueError("num_iters must be >= 0")
    kw = dict(win_size=win_size, num_iters=num_iters, max_disp=max_disp,
              stop_eps=stop_eps)
    if u.device.type == "cpu":
        return farneback_level_reference(R0, R1, u, v, **kw)
    lib = _level_lib()
    uo, vo = torch.empty_like(u), torch.empty_like(v)
    iters = torch.empty(b, dtype=torch.int32, device=u.device)
    if b == 0:
        return uo, vo, iters
    scratch = torch.empty((b, lib.farneback_level_scratch_planes(), h, w),
                          dtype=torch.float32, device=u.device)
    partials = torch.empty((b, lib.farneback_level_partials(h, w)),
                           dtype=torch.float32, device=u.device)
    active = torch.empty(b, dtype=torch.int32, device=u.device)
    rc = lib.farneback_level_launch(
        R0.data_ptr(), R1.data_ptr(), u.data_ptr(), v.data_ptr(),
        uo.data_ptr(), vo.data_ptr(), scratch.data_ptr(), partials.data_ptr(),
        active.data_ptr(), iters.data_ptr(), b, h, w, int(win_size),
        int(num_iters), _f32(max_disp), _f32(1.0 / win_size),
        _threshold(stop_eps, h, w), _stream(u))
    if rc != 0:
        raise RuntimeError(f"farneback_level kernel launch failed: CUDA error {rc}")
    farneback_level.launches += 1
    return uo, vo, iters


farneback_level.launches = 0
