"""Farneback's two kernels: the hand-written CUDA kernels
(`csrc/farneback_polyexp.cu`, `csrc/farneback_level.cu`), the level
kernel's plan, and their plain PyTorch versions.

* `poly_expand` replaces the JAX package's Pallas kernel
  `denseflow_tpu/kernels/farneback_fused.py::poly_expand_fused`: the
  quadratic fit of each pixel's neighbourhood, (N, H, W) -> channel-first
  (N, 5, H, W) = (bx, by, cxx, cyy, cxy), for a list of pyramid levels in
  one launch. The JAX package falls back to its XLA `poly_expand` above a
  padded plane of 272x384 (`polyexp_fused_fits`); this port has one code
  path for every size and ports no fallback.
* `farneback_level` replaces `farneback_level_fused` (with
  `farneback_level_fused_tiled`): one pyramid level's iterations of warp,
  normal equations, box blur and 2x2 solve for each pair, in one launch.
  The JAX tiler exists only to fit VMEM; this port computes the untiled
  answer at every geometry and ports no tiling.

The level kernel runs a thread-block cluster of n CTAs per pair; CTA k owns
a band of full-width rows and keeps the five normal-equation planes of its
band with six halo rows each side, which its neighbours write over
distributed shared memory. `_plan(h, w)` picks n, the bands and where the
state lives, from (h, w) alone, so a pair's bytes never depend on its
batch-mates or on B:

- "shared": u, v and the haloed planes in the CTAs' shared memory: one CTA
  under 1,000 pixels (8x11, 16x21), else up to 6 (a 16-pair slab in one
  wave), from 32x43 to 128x170;
- "split": the haloed planes in shared memory, u and v in the outputs:
  256x341 in 16 CTAs;
- "device": every plane in band-owned device memory, for geometries that
  no cluster holds (360x480, 1080x1920 without `-ns`).

PERF.md has the measured times per level, beside the plans not taken.

Both plain versions compute what the Pallas kernels compute, in their
order of float operations (kernels/plane_ops.py), not what the JAX XLA
path does. On a CUDA tensor a wrapper launches its kernel and counts the
launch in `.launches`; on a CPU tensor it runs the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple, Union

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
_IP = ctypes.POINTER(_I)
_PLAN_ARGS = [_I, _I, _IP, _I, _I]


@functools.lru_cache(maxsize=None)
def _polyexp_lib() -> ctypes.CDLL:
    from denseflow_tpu_torch.kernels import _build

    lib = _build.load("farneback_polyexp")
    lib.farneback_polyexp_launch.argtypes = [_P, _P, _IP, _IP, _IP, _I, _I, _P, _P]
    lib.farneback_polyexp_launch.restype = _I
    for fn in (lib.farneback_polyexp_max_n, lib.farneback_polyexp_max_levels):
        fn.argtypes = []
        fn.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _level_lib() -> ctypes.CDLL:
    from denseflow_tpu_torch.kernels import _build

    lib = _build.load("farneback_level")
    lib.farneback_level_launch.argtypes = (
        [_P] * 8 + [_I] * 5 + [_F] * 3 + _PLAN_ARGS + [_P])
    lib.farneback_level_launch.restype = _I
    lib.farneback_level_max_active_clusters.argtypes = [_I] * 3 + _PLAN_ARGS + [_IP]
    lib.farneback_level_max_active_clusters.restype = _I
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


def poly_expand(
    imgs: Union[torch.Tensor, Sequence[torch.Tensor]], n: int, sigma: float
) -> Union[torch.Tensor, List[torch.Tensor]]:
    """Polynomial-expansion coefficients (bx, by, cxx, cyy, cxy),
    channel-first for `farneback_level`: a list of pyramid levels, each
    (N_l, H_l, W_l) float32, gives the list of their (N_l, 5, H_l, W_l); a
    single (N, H, W) tensor is one level and gives one tensor. On CUDA
    tensors this launches `csrc/farneback_polyexp.cu` once for all the
    levels (counted in `poly_expand.launches`); on the CPU it runs
    `poly_expand_reference` level by level."""
    single = isinstance(imgs, torch.Tensor)
    levels = [imgs] if single else list(imgs)
    for img in levels:
        if img.dim() != 3:
            raise ValueError(f"poly_expand takes (N, H, W), got {tuple(img.shape)}")
    if levels:
        _check("poly_expand", levels, [tuple(t.shape) for t in levels])
    if not levels or levels[0].device.type == "cpu":
        outs = [poly_expand_reference(img, n, sigma) for img in levels]
        return outs[0] if single else outs
    lib = _polyexp_lib()
    if not 0 <= n <= lib.farneback_polyexp_max_n():
        raise ValueError(f"poly_expand: poly_n {n} outside "
                         f"[0, {lib.farneback_polyexp_max_n()}]")
    outs = [torch.empty((t.shape[0], 5, *t.shape[1:]), dtype=torch.float32,
                        device=t.device) for t in levels]
    _, packed = _polyexp_consts(n, float(sigma))
    # one launch takes up to max_levels levels: a main-path slab's six in one
    step = lib.farneback_polyexp_max_levels()
    for s in range(0, len(levels), step):
        part = [(i, o) for i, o in zip(levels[s:s + step], outs[s:s + step])
                if i.numel()]
        if not part:
            continue
        k = len(part)
        ints = lambda vals: (_I * k)(*vals)  # noqa: E731
        # the C side launches on the current card
        with torch.cuda.device(levels[0].device):
            rc = lib.farneback_polyexp_launch(
                (_P * k)(*(i.data_ptr() for i, _ in part)),
                (_P * k)(*(o.data_ptr() for _, o in part)),
                ints(i.shape[0] for i, _ in part), ints(i.shape[1] for i, _ in part),
                ints(i.shape[2] for i, _ in part), k, n, packed.ctypes.data,
                _stream(levels[0]))
        if rc != 0:
            raise RuntimeError(f"poly_expand kernel launch failed: CUDA error {rc}")
        poly_expand.launches += 1
    return outs[0] if single else outs


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


# The kernel's placements, in the order of csrc/farneback_level.cu's Placement.
_PLACEMENTS = ("device", "shared", "split")
_HALO = 6  # halo rows of the normal-equation planes each side of a band
MAX_WIN = 2 * _HALO + 1  # the widest box window the kernel takes
_ONE_CTA_PX = 1_000  # smaller levels take one CTA: __syncthreads, no cluster


def _make_plan(h: int, w: int, n: int, placement: str) -> Plan:
    """The plan of n bands, as even as rows allow, with `placement`."""
    if placement not in _PLACEMENTS:
        raise ValueError(f"farneback_level: no placement {placement!r}")
    if not 1 <= n <= min(MAX_CTAS, h):
        raise ValueError(f"farneback_level: {n} bands of {h} rows")
    if n > 1 and h // n < _HALO:
        raise ValueError(f"farneback_level: {n} bands of {h} rows are shorter "
                         f"than their {_HALO} halo rows")
    rows = -(-h // n)
    # the five planes of M with halo rows, each row with _HALO zero columns
    # on each side
    haloed = 5 * (rows + 2 * _HALO) * (w + 2 * _HALO)
    floats = 10 * w  # rows 0 and h-1 of M
    if placement == "shared":
        floats += 2 * rows * w  # u, v
    scratch = 0
    if placement == "device":
        scratch = -(-n * haloed // (h * w))
    else:
        floats += haloed
    return Plan(n, even_starts(h, n), placement, 4 * floats, scratch)


@functools.lru_cache(maxsize=None)
def _plan(h: int, w: int) -> Plan:
    """The kernel's plan for an (h, w) level, from (h, w) alone.

    One CTA below _ONE_CTA_PX pixels. Else a cluster of ONE_WAVE_CTAS, so
    that a 16-pair slab runs in one wave, with u, v and M in shared memory
    where they fit, else M alone ("split"); where neither fits, the same
    in 16 CTAs; where none fits, every plane in device memory in
    ONE_WAVE_CTAS."""
    if h * w < _ONE_CTA_PX:
        return _make_plan(h, w, 1, "shared")
    for n in (ONE_WAVE_CTAS, MAX_CTAS):
        n = min(n, max(1, h // _HALO))
        for placement in ("shared", "split"):
            plan = _make_plan(h, w, n, placement)
            if fits(plan):
                return plan
    return _make_plan(h, w, min(ONE_WAVE_CTAS, max(1, h // _HALO)), "device")


@functools.lru_cache(maxsize=None)
def _c_plan(plan: Plan) -> tuple:
    """The plan as the C functions take it."""
    starts = (_I * len(plan.starts))(*plan.starts)
    return (_PLACEMENTS.index(plan.placement), plan.n, starts, plan.smem_bytes,
            plan.scratch_planes)


def max_active_clusters(plan: Plan, h: int, w: int, device: torch.device,
                        win_size: int = 13) -> int:
    """How many clusters of `plan` fit on `device` at once
    (`_cluster.active_clusters`, which raises for a plan the card cannot
    schedule)."""
    return active_clusters(f"farneback_level(win {win_size})", plan, h, w, device,
                           lambda out: _level_lib().farneback_level_max_active_clusters(
                               h, w, int(win_size), *_c_plan(plan), out))


def _launch(R0, R1, u, v, *, win_size, num_iters, max_disp, stop_eps, plan=None):
    """Launch the kernel with `plan` (default `_plan(h, w)`)."""
    b, _, h, w = R0.shape
    plan = _plan(h, w) if plan is None else plan
    uo, vo = torch.empty_like(u), torch.empty_like(v)
    iters = torch.empty(b, dtype=torch.int32, device=u.device)
    if b == 0:
        return uo, vo, iters
    if win_size > MAX_WIN:
        raise ValueError(f"farneback_level: the CUDA kernel takes box windows up to "
                         f"{MAX_WIN}, got {win_size}")
    max_active_clusters(plan, h, w, u.device, win_size)
    scratch = None
    if plan.scratch_planes:
        scratch = torch.empty((b, plan.scratch_planes, h, w), dtype=torch.float32,
                              device=u.device)
    # the C side sets attributes and launches on the current card
    with torch.cuda.device(u.device):
        rc = _level_lib().farneback_level_launch(
            R0.data_ptr(), R1.data_ptr(), u.data_ptr(), v.data_ptr(),
            uo.data_ptr(), vo.data_ptr(),
            scratch.data_ptr() if scratch is not None else None, iters.data_ptr(),
            b, h, w, int(win_size), int(num_iters), _f32(max_disp),
            _f32(1.0 / win_size), _threshold(stop_eps, h, w), *_c_plan(plan),
            _stream(u))
    if rc == -1:
        raise ValueError(f"farneback_level: the kernel does not take {plan} at "
                         f"{h}x{w} with window {win_size}")
    if rc != 0:
        raise RuntimeError(f"farneback_level kernel launch failed for {plan} at "
                           f"{h}x{w}: CUDA error {rc}")
    farneback_level.launches += 1
    return uo, vo, iters


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
    CUDA tensor this makes one launch of `csrc/farneback_level.cu` with
    `_plan(H, W)`, every iteration on the card (counted in
    `farneback_level.launches`; box windows up to MAX_WIN); on the CPU it
    runs `farneback_level_reference`. Returns (u, v, iters), iters (B,)
    int32."""
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
    return _launch(R0, R1, u, v, **kw)


farneback_level.launches = 0
