"""One TVL1 pyramid scale per frame pair: the hand-written CUDA kernel
(`csrc/tvl1_scale.cu`), its plan, and its plain PyTorch version.

Both compute what the JAX package's Pallas kernel
`denseflow_tpu/kernels/tvl1_fused.py::tvl1_scale_fused` computes (its body
`_make_kernel`), not what its XLA path does: the warp is two separable 1-D
bicubic passes (rows at u2, then columns at u1), the epsilon stop is tested
every `check_every` iterations, and a warp that converges in its first
check block ends the pair's warp loop.

The kernel runs a thread-block cluster of n CTAs per pair; CTA k owns a
band of full-width rows. Inside an iteration the only reads that leave a
band are p12, p22 of the row above it and u1, u2 of the row below, so the
pair needs one cluster barrier after each of the two steps, and the halo
rows go between neighbouring CTAs through distributed shared memory.
`_plan(h, w)` picks n, the bands and where the state lives, from (h, w)
alone, so a pair's bytes never depend on its batch-mates or on B:

- "shared": the nine planes of the loop (36 B a pixel) in the CTAs' shared
  memory. Every main-path scale (256x341 and its pyramid) fits a cluster of
  at most 16 CTAs of 227 KB each, and takes this placement: 6 CTAs at
  105x140 to 164x218, 16 at 205x273 and 256x341.
- "device": every plane in band-owned device memory, halo rows read through
  L2. Geometries whose state no cluster holds (360x480, 1080x1920 without
  `-ns`) take it, so the kernel computes the untiled answer there too.

What bounds the kernel on an H100, as measured, is in PERF.md and in the
header of `csrc/tvl1_scale.cu`: not bytes, nor the f32 rate, but the
per-iteration cost of a band on one SM and the two cluster barriers, and at
205x273 and 256x341 the three waves of 16-CTA clusters a 16-pair slab needs.

The JAX package tiles planes whose working set exceeds VMEM
(`tvl1_scale_fused_tiled`, `plan_tiles`); its 256x341 bench geometry takes
the untiled branch. Hopper has no VMEM limit to fit, so this port computes
the untiled answer at every geometry and ports no tiling.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from denseflow_tpu_torch.kernels._cluster import (
    MAX_CTAS,
    ONE_WAVE_CTAS,
    Plan,
    active_clusters,
    even_starts,
    fits,
)
from denseflow_tpu_torch.kernels.plane_ops import resample_cubic

_GRAD_EPS = 1.1920929e-07  # numeric_limits<float>::epsilon(), OpenCV's guard


def _f32(x: float) -> float:
    """A Python float rounded to float32, as the kernel receives it."""
    return float(np.float32(x))


def _threshold(epsilon: float, h: int, w: int) -> float:
    """The stop threshold eps^2*h*w in float32; -1 disables the stop."""
    return _f32(epsilon * epsilon * h * w) if epsilon > 0 else -1.0


def _div(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Backward divergence (adjoint of the forward gradient), (B, H, W)."""
    dpx = torch.cat([p1[:, :, :1], p1[:, :, 1:] - p1[:, :, :-1]], dim=2)
    dpy = torch.cat([p2[:, :1, :], p2[:, 1:, :] - p2[:, :-1, :]], dim=1)
    return dpx + dpy


def _fgx(u: torch.Tensor) -> torch.Tensor:
    return torch.cat([u[:, :, 1:] - u[:, :, :-1], torch.zeros_like(u[:, :, :1])], dim=2)


def _fgy(u: torch.Tensor) -> torch.Tensor:
    return torch.cat([u[:, 1:, :] - u[:, :-1, :], torch.zeros_like(u[:, :1, :])], dim=1)


def tvl1_scale_reference(
    I0: torch.Tensor,
    I1: torch.Tensor,
    I1x: torch.Tensor,
    I1y: torch.Tensor,
    u1: torch.Tensor,
    u2: torch.Tensor,
    *,
    l_t: float,
    theta: float,
    taut: float,
    epsilon: float,
    iterations: int,
    warps: int,
    max_disp: float,
    check_every: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, on (B, H, W) float32 tensors.

    Pairs advance in lockstep, and a pair that has stopped is held
    unchanged with a mask, so each pair's result is what it would be
    alone. Returns (u1, u2, counts): counts is (B, 2) int32 holding the
    iterations and the warps each pair ran."""
    b, h, w = u1.shape
    dev = u1.device
    l_t, theta, taut = _f32(l_t), _f32(theta), _f32(taut)
    max_disp = _f32(max_disp)
    thresh = _threshold(epsilon, h, w)
    p11, p12, p21, p22 = (torch.zeros_like(u1) for _ in range(4))
    counts = torch.zeros((b, 2), dtype=torch.int32, device=dev)
    warp_on = torch.ones(b, dtype=torch.bool, device=dev)
    for _ in range(warps):
        if not bool(warp_on.any()):
            break
        t1, t1x, t1y = resample_cubic((I1, I1x, I1y), u2, 1, max_disp)
        I1w, I1wx, I1wy = resample_cubic((t1, t1x, t1y), u1, 2, max_disp)
        grad = I1wx * I1wx + I1wy * I1wy
        rho_c = I1w - I1wx * u1 - I1wy * u2 - I0
        fi = l_t * grad
        nfi = -fi
        rg = torch.where(
            grad > _GRAD_EPS, 1.0 / torch.clamp(grad, min=_GRAD_EPS), 0.0
        )
        n_run = torch.zeros(b, dtype=torch.int32, device=dev)
        err = torch.full((b,), float("inf"), dtype=torch.float32, device=dev)
        active = warp_on.clone()
        n = 0
        while n < iterations:
            active = active & (err > thresh)
            if not bool(active.any()):
                break
            keep = active[:, None, None]
            for k in range(check_every):
                rho = rho_c + I1wx * u1 + I1wy * u2
                mul = torch.where(
                    rho < nfi, l_t, torch.where(rho > fi, -l_t, -rho * rg)
                )
                v1 = u1 + mul * I1wx
                v2 = u2 + mul * I1wy
                u1n = torch.where(keep, v1 + theta * _div(p11, p12), u1)
                u2n = torch.where(keep, v2 + theta * _div(p21, p22), u2)
                if k == check_every - 1:
                    e = (u1n - u1) ** 2 + (u2n - u2) ** 2
                    err = torch.where(active, e.reshape(b, -1).sum(1), err)
                u1, u2 = u1n, u2n
                g1x, g1y, g2x, g2y = _fgx(u1), _fgy(u1), _fgx(u2), _fgy(u2)
                r1 = 1.0 / (1.0 + taut * torch.sqrt(g1x * g1x + g1y * g1y))
                r2 = 1.0 / (1.0 + taut * torch.sqrt(g2x * g2x + g2y * g2y))
                p11 = torch.where(keep, (p11 + taut * g1x) * r1, p11)
                p12 = torch.where(keep, (p12 + taut * g1y) * r1, p12)
                p21 = torch.where(keep, (p21 + taut * g2x) * r2, p21)
                p22 = torch.where(keep, (p22 + taut * g2y) * r2, p22)
            n += check_every
            n_run += active.to(torch.int32) * check_every
        counts[:, 0] += n_run
        counts[:, 1] += warp_on.to(torch.int32)
        # early exit: the warp converged in its first check block
        converged = (n_run <= check_every) & (err <= thresh)
        warp_on = warp_on & ~converged
    return u1, u2, counts


def _check_args(planes, check_every: int) -> None:
    u1 = planes[4]
    if u1.dim() != 3:
        raise ValueError(f"tvl1_scale takes (B, H, W) planes, got {tuple(u1.shape)}")
    for p in planes:
        if p.shape != u1.shape:
            raise ValueError(f"tvl1_scale: shape {tuple(p.shape)} != {tuple(u1.shape)}")
        if p.dtype != torch.float32:
            raise ValueError(f"tvl1_scale takes float32, got {p.dtype}")
        if p.device != u1.device:
            raise ValueError("tvl1_scale: planes lie on different devices")
        if not p.is_contiguous():
            raise ValueError("tvl1_scale takes contiguous planes")
    if check_every < 1:
        raise ValueError("check_every must be >= 1")


# The kernel's placements, in the order of csrc/tvl1_scale.cu's Placement.
_PLACEMENTS = ("device", "shared")
_LOOP_PLANES = 9  # u1, u2, p11, p12, p21, p22, I1wx, I1wy, rho_c
_HALO_ROWS = 4  # p12, p22 of the row above a band; u1, u2 of the row below
_PX_PER_CTA = 2048  # fewer CTAs below about two pixels a thread


def _make_plan(h: int, w: int, n: int, placement: str) -> Plan:
    """The plan of n bands, as even as rows allow, with `placement`."""
    if placement not in _PLACEMENTS:
        raise ValueError(f"tvl1_scale: no placement {placement!r}")
    if not 1 <= n <= min(MAX_CTAS, h):
        raise ValueError(f"tvl1_scale: {n} bands of {h} rows")
    starts = even_starts(h, n)
    if placement == "shared":
        rows = -(-h // n)
        smem = 4 * (_LOOP_PLANES * rows * w + _HALO_ROWS * w)
        scratch = 3  # t1, t1x, t1y
    else:
        smem = 0
        scratch = 3 + _LOOP_PLANES - 2  # u1, u2 are the outputs
    return Plan(n, starts, placement, smem, scratch)


@functools.lru_cache(maxsize=None)
def _plan(h: int, w: int) -> Plan:
    """The kernel's plan for an (h, w) scale, from (h, w) alone.

    The state in shared memory in a cluster of up to ONE_WAVE_CTAS CTAs of
    about _PX_PER_CTA pixels or more; where that cluster cannot hold it,
    in one of 16 (more waves, but the smallest bands); where 16 cannot
    either, every plane in device memory."""
    n = min(ONE_WAVE_CTAS, h, max(1, -(-h * w // _PX_PER_CTA)))
    for plan in (_make_plan(h, w, n, "shared"),
                 _make_plan(h, w, min(MAX_CTAS, h), "shared")):
        if fits(plan):
            return plan
    return _make_plan(h, w, min(MAX_CTAS, h), "device")


def _c_plan(plan: Plan, h: int, w: int) -> tuple:
    """The plan as the C functions take it, after (h, w)."""
    starts = (ctypes.c_int * len(plan.starts))(*plan.starts)
    return (_PLACEMENTS.index(plan.placement), plan.n, starts,
            plan.smem_bytes, plan.scratch_planes)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from denseflow_tpu_torch.kernels import _build

    lib = _build.load("tvl1_scale")
    plan_args = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                 ctypes.c_int, ctypes.c_int]
    lib.tvl1_scale_launch.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_float] * 5
        + [ctypes.c_int] * 3 + plan_args + [ctypes.c_void_p]
    )
    lib.tvl1_scale_launch.restype = ctypes.c_int
    lib.tvl1_scale_max_active_clusters.argtypes = (
        [ctypes.c_int] * 2 + plan_args + [ctypes.POINTER(ctypes.c_int)])
    lib.tvl1_scale_max_active_clusters.restype = ctypes.c_int
    return lib


def max_active_clusters(plan: Plan, h: int, w: int, device: torch.device) -> int:
    """How many clusters of `plan` fit on `device` at once
    (`_cluster.active_clusters`, which raises for a plan the card cannot
    schedule)."""
    return active_clusters("tvl1_scale", plan, h, w, device, lambda out: (
        _lib().tvl1_scale_max_active_clusters(h, w, *_c_plan(plan, h, w), out)))


def _launch(I0, I1, I1x, I1y, u1, u2, l_t, theta, taut, epsilon,
            iterations, warps, max_disp, check_every, plan=None):
    """Launch the kernel with `plan` (default `_plan(h, w)`)."""
    planes = (I0, I1, I1x, I1y, u1, u2)
    b, h, w = u1.shape
    plan = _plan(h, w) if plan is None else plan
    u1o = torch.empty_like(u1)
    u2o = torch.empty_like(u1)
    counts = torch.empty((b, 2), dtype=torch.int32, device=u1.device)
    if b == 0:
        return u1o, u2o, counts
    max_active_clusters(plan, h, w, u1.device)
    scratch = torch.empty((b, plan.scratch_planes, h, w), dtype=torch.float32,
                          device=u1.device)
    stream = torch.cuda.current_stream(u1.device).cuda_stream
    # the C side sets attributes and launches on the current card
    with torch.cuda.device(u1.device):
        rc = _lib().tvl1_scale_launch(
            *(p.data_ptr() for p in planes), u1o.data_ptr(), u2o.data_ptr(),
            scratch.data_ptr(), counts.data_ptr(), b, h, w,
            _f32(l_t), _f32(theta), _f32(taut), _threshold(epsilon, h, w),
            _f32(max_disp), int(iterations), int(warps), int(check_every),
            *_c_plan(plan, h, w), stream,
        )
    if rc == -1:
        raise ValueError(f"tvl1_scale: the kernel does not take {plan} at {h}x{w}")
    if rc != 0:
        raise RuntimeError(f"tvl1_scale kernel launch failed for {plan} at "
                           f"{h}x{w}: CUDA error {rc}")
    tvl1_scale.launches += 1
    return u1o, u2o, counts


def tvl1_scale(
    I0: torch.Tensor,
    I1: torch.Tensor,
    I1x: torch.Tensor,
    I1y: torch.Tensor,
    u1: torch.Tensor,
    u2: torch.Tensor,
    *,
    l_t: float,
    theta: float,
    taut: float,
    epsilon: float,
    iterations: int,
    warps: int,
    max_disp: float,
    check_every: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All warps x iterations of one pyramid scale for each pair.

    Planes are (B, H, W) float32 on one device. On a CUDA device this
    launches the kernel (and counts the launch in `tvl1_scale.launches`);
    on the CPU it runs `tvl1_scale_reference`. Returns (u1, u2, counts),
    counts (B, 2) int32 = iterations and warps each pair ran."""
    planes = (I0, I1, I1x, I1y, u1, u2)
    _check_args(planes, check_every)
    kw = dict(l_t=l_t, theta=theta, taut=taut, epsilon=epsilon,
              iterations=iterations, warps=warps, max_disp=max_disp,
              check_every=check_every)
    if u1.device.type == "cpu":
        return tvl1_scale_reference(*planes, **kw)
    if u1.device.type != "cuda":
        raise ValueError(f"tvl1_scale runs on cuda or cpu, not {u1.device}")
    return _launch(*planes, **kw)


tvl1_scale.launches = 0
