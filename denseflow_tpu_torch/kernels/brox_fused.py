"""One Brox pyramid level per frame pair: the hand-written CUDA kernel
(`csrc/brox_scale.cu`), its plan, and its plain PyTorch version.

Both compute what the JAX package's Pallas kernel
`denseflow_tpu/kernels/brox_fused.py::brox_scale_fused` computes (its body
`_make_kernel`), not what its XLA path does: the warp is two separable 1-D
bicubic passes (rows at v, then columns at u), reciprocals are taken once
and multiplied, and each pair stops on its own. Per pair, up to
`outer_iterations` warps, each running up to `inner_iterations`
lagged-diffusivity steps of `solver_iterations` Jacobi sweeps; an inner
step ends the inner loop when sum((du-du0)^2 + (dv-dv0)^2) <= stop/16, a
warp ends the pair when sum(du^2 + dv^2) <= stop, stop = f32(stop_eps^2*h*w)
(stop_eps = 0: the full budget).

Psi' is 1/sqrt(s^2 + 1e-6), an IEEE square root and an IEEE division, in
both versions: it rounds the same on the CPU and on the card, where
rsqrt does not (ROADMAP.md C records the drift against the Pallas
interpreter's rsqrt).

The kernel runs a thread-block cluster of n CTAs per pair; CTA k owns a
band of full-width rows, and a band reads at most two rows of its
neighbours (the _D5 gradients), which go between CTAs through distributed
shared memory. `_plan(h, w)` picks n, the bands and where the state
lives, from (h, w) alone, so a pair's bytes never depend on its
batch-mates or on B:

- "shared": u, v, two ping-pong buffers of (du, dv), psi_s and the step's
  constants a12, b1, b2, ru, rv (48 B a pixel) in the CTAs' shared memory:
  one CTA for levels under 900 px, 6 (a 16-pair slab in one wave) from
  27x37 to 131x175, 16 at 205x273;
- "split": u, v and (du, dv) in shared memory, the rest in device memory:
  164x218 in 6 CTAs, 256x341 in 16;
- "device": every plane in band-owned device memory, for geometries that
  no cluster holds (360x480, 1080x1920 without `-ns`).

PERF.md has the measured times per level, beside the plans not taken.

The JAX package tiles planes whose working set exceeds VMEM
(`brox_scale_fused_tiled`) and slabs batches above 16 through `lax.map`;
both exist only to fit VMEM and give each pair the untiled answer. Hopper
has no VMEM limit to fit, so this port computes the untiled answer at every
geometry and batch and ports neither.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from denseflow_tpu_torch.kernels._cluster import (
    MAX_CTAS,
    ONE_WAVE_CTAS,
    Plan,
    active_clusters,
    even_starts,
    fits,
)
from denseflow_tpu_torch.kernels.farneback_fused import _check
from denseflow_tpu_torch.kernels.plane_ops import conv_taps, resample_cubic, shift
from denseflow_tpu_torch.kernels.tvl1_fused import _f32, _threshold

# 5-point derivative stencil (4th-order central differences), the taps of
# denseflow_tpu/kernels/brox_fused.py::_D5; conv_taps rounds each to float32
D5 = (1.0 / 12.0, -8.0 / 12.0, 0.0, 8.0 / 12.0, -1.0 / 12.0)
PSI_EPS2 = _f32(0.001 * 0.001)


def _dx(p: torch.Tensor) -> torch.Tensor:
    return conv_taps(p, D5, -1, 2)


def _dy(p: torch.Tensor) -> torch.Tensor:
    return conv_taps(p, D5, -2, 2)


def _psi_deriv(s2: torch.Tensor) -> torch.Tensor:
    """1 / sqrt(s^2 + eps^2): Psi'(s^2) with its constant 2 absorbed."""
    return 1.0 / torch.sqrt(s2 + PSI_EPS2)


def brox_scale_reference(
    I0: torch.Tensor,
    I1: torch.Tensor,
    u: torch.Tensor,
    v: torch.Tensor,
    *,
    alpha: float,
    gamma: float,
    inner_iterations: int,
    outer_iterations: int,
    solver_iterations: int,
    max_disp: float,
    stop_eps: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, on (B, H, W) float32 tensors.

    Pairs advance in lockstep, and a pair that has stopped (its inner loop
    or the whole level) is held unchanged with a mask, so each pair's
    result is what it would be alone. Returns (u, v, counts): counts is
    (B, 3) int32 holding the warps, the inner steps and the Jacobi sweeps
    each pair ran."""
    b, h, w = u.shape
    dev = u.device
    a, g, md = _f32(alpha), _f32(gamma), _f32(max_disp)
    stop = _threshold(stop_eps, h, w)
    stop_in = stop * 0.0625
    I1x, I1y = _dx(I1), _dy(I1)
    I0x, I0y = _dx(I0), _dy(I0)
    counts = torch.zeros((b, 3), dtype=torch.int32, device=dev)
    on = torch.ones(b, dtype=torch.bool, device=dev)
    for _ in range(outer_iterations):
        if not bool(on.any()):
            break
        t1 = resample_cubic((I1, I1x, I1y), v, 1, md)
        I1w, Ix, Iy = resample_cubic(t1, u, 2, md)
        Iz = I1w - I0
        Ixx, Ixy, Iyy = _dx(Ix), _dy(Ix), _dy(Iy)
        Ixz, Iyz = Ix - I0x, Iy - I0y
        du = torch.zeros_like(u)
        dv = torch.zeros_like(v)
        inner_on = on.clone()
        for _ in range(inner_iterations):
            if not bool(inner_on.any()):
                break
            du0, dv0 = du, dv
            r_data = Iz + Ix * du + Iy * dv
            r_gx = Ixz + Ixx * du + Ixy * dv
            r_gy = Iyz + Ixy * du + Iyy * dv
            psi_d = _psi_deriv(r_data * r_data + g * (r_gx * r_gx + r_gy * r_gy))
            U, V = u + du, v + dv
            Ux, Uy, Vx, Vy = _dx(U), _dy(U), _dx(V), _dy(V)
            psi_s = _psi_deriv(Ux * Ux + Uy * Uy + Vx * Vx + Vy * Vy)
            wE = 0.5 * (psi_s + shift(psi_s, 1, 2))
            wW = 0.5 * (psi_s + shift(psi_s, -1, 2))
            wS = 0.5 * (psi_s + shift(psi_s, 1, 1))
            wN = 0.5 * (psi_s + shift(psi_s, -1, 1))
            wsum = wE + wW + wS + wN
            a11 = psi_d * (Ix * Ix + g * (Ixx * Ixx + Ixy * Ixy))
            a12 = psi_d * (Ix * Iy + g * (Ixx * Ixy + Ixy * Iyy))
            a22 = psi_d * (Iy * Iy + g * (Ixy * Ixy + Iyy * Iyy))
            b1 = -psi_d * (Iz * Ix + g * (Ixz * Ixx + Iyz * Ixy))
            b2 = -psi_d * (Iz * Iy + g * (Ixz * Ixy + Iyz * Iyy))
            ru = 1.0 / (a11 + a * wsum)
            rv = 1.0 / (a22 + a * wsum)
            for _ in range(solver_iterations):
                U, V = u + du, v + dv
                # the reference's Laplacian subtracts wsum * u, not wsum * U
                lap_u = (wE * shift(U, 1, 2) + wW * shift(U, -1, 2)
                         + wS * shift(U, 1, 1) + wN * shift(U, -1, 1) - wsum * u)
                lap_v = (wE * shift(V, 1, 2) + wW * shift(V, -1, 2)
                         + wS * shift(V, 1, 1) + wN * shift(V, -1, 1) - wsum * v)
                du_new = (b1 - a12 * dv + a * lap_u) * ru
                dv = (b2 - a12 * du_new + a * lap_v) * rv
                du = du_new
            keep = inner_on[:, None, None]
            du = torch.where(keep, du, du0)
            dv = torch.where(keep, dv, dv0)
            counts[:, 1] += inner_on.to(torch.int32)
            ex, ey = du - du0, dv - dv0
            err_i = (ex * ex + ey * ey).sum(dim=(1, 2))
            inner_on = inner_on & ~((stop >= 0) & (err_i <= stop_in))
        err = (du * du + dv * dv).sum(dim=(1, 2))
        keep = on[:, None, None]
        u = torch.where(keep, u + du, u)
        v = torch.where(keep, v + dv, v)
        counts[:, 0] += on.to(torch.int32)
        on = on & ~((stop >= 0) & (err <= stop))
    counts[:, 2] = counts[:, 1] * solver_iterations
    return u, v, counts


# The kernel's placements, in the order of csrc/brox_scale.cu's Placement.
_PLACEMENTS = ("device", "shared", "split")
_HALO = 2  # halo rows each side of a band: the reach of the _D5 stencil
_STATE_PLANES = 6  # u, v; du, dv in two ping-pong buffers
_CONST_PLANES = 6  # psi_s, a12, b1, b2, ru, rv
_DEVICE_PLANES = 17  # the planes a pair always keeps in device memory
_ONE_CTA_PX = 900  # smaller levels take one CTA: __syncthreads, no cluster


def _make_plan(h: int, w: int, n: int, placement: str) -> Plan:
    """The plan of n bands, as even as rows allow, with `placement`."""
    if placement not in _PLACEMENTS:
        raise ValueError(f"brox_scale: no placement {placement!r}")
    if not 1 <= n <= min(MAX_CTAS, h):
        raise ValueError(f"brox_scale: {n} bands of {h} rows")
    rows = -(-h // n)
    if placement != "device" and n > 1 and h // n < _HALO:
        raise ValueError(f"brox_scale: {n} bands of {h} rows are shorter than "
                         f"their {_HALO} halo rows")
    haloed = (rows + 2 * _HALO) * w
    floats, scratch = 0, _DEVICE_PLANES
    if placement == "device":
        scratch += _STATE_PLANES - 2  # u, v are the outputs
    else:
        floats += _STATE_PLANES * haloed
    if placement == "shared":
        floats += haloed + (_CONST_PLANES - 1) * rows * w  # psi_s has halo rows
    else:
        scratch += _CONST_PLANES
    return Plan(n, even_starts(h, n), placement, 4 * floats, scratch)


@functools.lru_cache(maxsize=None)
def _plan(h: int, w: int) -> Plan:
    """The kernel's plan for an (h, w) level, from (h, w) alone.

    One CTA below _ONE_CTA_PX pixels. Else a cluster of ONE_WAVE_CTAS, so
    that a 16-pair slab runs in one wave: with the state in shared memory
    where it holds it, else u, v and (du, dv) there and the step's
    constants in device memory ("split"). Where neither fits, the same in
    16 CTAs (three waves, but bands a third as long); where none fits,
    every plane in device memory in ONE_WAVE_CTAS."""
    if h * w < _ONE_CTA_PX:
        return _make_plan(h, w, 1, "shared")
    for n in (ONE_WAVE_CTAS, MAX_CTAS):
        n = min(n, max(1, h // _HALO))
        for placement in ("shared", "split"):
            plan = _make_plan(h, w, n, placement)
            if fits(plan):
                return plan
    return _make_plan(h, w, min(ONE_WAVE_CTAS, h), "device")


def _c_plan(plan: Plan) -> tuple:
    """The plan as the C functions take it, after (h, w)."""
    starts = (ctypes.c_int * len(plan.starts))(*plan.starts)
    return (_PLACEMENTS.index(plan.placement), plan.n, starts, plan.smem_bytes,
            plan.scratch_planes)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PLAN_ARGS = [_I, _I, ctypes.POINTER(_I), _I, _I]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from denseflow_tpu_torch.kernels import _build

    lib = _build.load("brox_scale")
    lib.brox_scale_launch.argtypes = (
        [_P] * 8 + [_I] * 3 + [_F] * 5 + [_I] * 3 + _PLAN_ARGS + [_P])
    lib.brox_scale_launch.restype = _I
    lib.brox_scale_max_active_clusters.argtypes = (
        [_I] * 2 + _PLAN_ARGS + [ctypes.POINTER(_I)])
    lib.brox_scale_max_active_clusters.restype = _I
    return lib


def max_active_clusters(plan: Plan, h: int, w: int, device: torch.device) -> int:
    """How many clusters of `plan` fit on `device` at once
    (`_cluster.active_clusters`, which raises for a plan the card cannot
    schedule)."""
    return active_clusters("brox_scale", plan, h, w, device, lambda out: (
        _lib().brox_scale_max_active_clusters(h, w, *_c_plan(plan), out)))


def _launch(I0, I1, u, v, *, alpha, gamma, inner_iterations, outer_iterations,
            solver_iterations, max_disp, stop_eps, plan=None):
    """Launch the kernel with `plan` (default `_plan(h, w)`)."""
    b, h, w = u.shape
    plan = _plan(h, w) if plan is None else plan
    uo, vo = torch.empty_like(u), torch.empty_like(v)
    counts = torch.empty((b, 3), dtype=torch.int32, device=u.device)
    if b == 0:
        return uo, vo, counts
    max_active_clusters(plan, h, w, u.device)
    scratch = torch.empty((b, plan.scratch_planes, h, w), dtype=torch.float32,
                          device=u.device)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    # the C side sets attributes and launches on the current card
    with torch.cuda.device(u.device):
        rc = _lib().brox_scale_launch(
            I0.data_ptr(), I1.data_ptr(), u.data_ptr(), v.data_ptr(),
            uo.data_ptr(), vo.data_ptr(), scratch.data_ptr(), counts.data_ptr(),
            b, h, w, _f32(alpha), _f32(gamma), _f32(max_disp),
            _threshold(stop_eps, h, w), PSI_EPS2, int(inner_iterations),
            int(outer_iterations), int(solver_iterations), *_c_plan(plan), stream)
    if rc == -1:
        raise ValueError(f"brox_scale: the kernel does not take {plan} at {h}x{w}")
    if rc != 0:
        raise RuntimeError(f"brox_scale kernel launch failed for {plan} at "
                           f"{h}x{w}: CUDA error {rc}")
    brox_scale.launches += 1
    return uo, vo, counts


def brox_scale(
    I0: torch.Tensor,
    I1: torch.Tensor,
    u: torch.Tensor,
    v: torch.Tensor,
    *,
    alpha: float,
    gamma: float,
    inner_iterations: int,
    outer_iterations: int,
    solver_iterations: int,
    max_disp: float,
    stop_eps: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Up to outer x inner x solver iterations of one pyramid level for each
    pair.

    Planes are (B, H, W) float32 on one device, images in [0, 1]. On a CUDA
    device this launches `csrc/brox_scale.cu` with `_plan(H, W)` (and counts
    the launch in `brox_scale.launches`); on the CPU it runs
    `brox_scale_reference`. Returns (u, v, counts), counts (B, 3) int32 =
    the warps, inner steps and Jacobi sweeps each pair ran."""
    planes = (I0, I1, u, v)
    if u.dim() != 3:
        raise ValueError(f"brox_scale takes (B, H, W) planes, got {tuple(u.shape)}")
    _check("brox_scale", planes, [tuple(u.shape)] * 4)
    for name, n in (("inner_iterations", inner_iterations),
                    ("outer_iterations", outer_iterations),
                    ("solver_iterations", solver_iterations)):
        if n < 0:
            raise ValueError(f"{name} must be >= 0")
    kw = dict(alpha=alpha, gamma=gamma, inner_iterations=inner_iterations,
              outer_iterations=outer_iterations,
              solver_iterations=solver_iterations, max_disp=max_disp,
              stop_eps=stop_eps)
    if u.device.type == "cpu":
        return brox_scale_reference(*planes, **kw)
    return _launch(*planes, **kw)


brox_scale.launches = 0
