"""Plane operations shared by the kernels' plain PyTorch versions.

The counterparts of the JAX package's in-kernel helpers
(`denseflow_tpu/kernels/common.py::make_plane_ops`): `shift`, `conv_taps`,
`box_sum` and `resample`, linear (Farneback) or cubic (TVL1, Brox).
`csrc/plane_ops.cuh` holds the same operations as `__device__` helpers for
the CUDA kernels, in the same order of float operations, so a kernel and its
plain version agree bit for bit.

The Pallas helpers work on a plane padded up to (8, 128) tiles and mask
the padded band; here a plane is exactly its real extent, and an index
that the Pallas roll would wrap into the band is clamped or zeroed
directly. `row_i`, `col_i` and `real` need no counterpart: they are
`torch.arange` and the tensor's own shape.
"""

from __future__ import annotations

import numpy as np
import torch

# OpenCV's border attenuation ramp (denseflow_tpu/algorithms/farneback.py)
BORDER = (0.14, 0.14, 0.4472, 0.4472, 0.4472)


def _coords(n: int, dim: int, ndim: int, device) -> torch.Tensor:
    shape = [1] * ndim
    shape[dim] = n
    return torch.arange(n, dtype=torch.float32, device=device).reshape(shape)


def resample_linear(p: torch.Tensor, disp: torch.Tensor, dim: int,
                    max_disp: float) -> torch.Tensor:
    """Linear 1-D resample of `p` along `dim` at per-pixel displacement
    `disp` (broadcast against `p`): the displacement is clamped to
    +-max_disp (a float32 value) and the position into [0, n-1]. Of the
    Pallas roll sweep only the taps at floor(d) and floor(d)+1 have weight;
    they are added in ascending order to a zero accumulator, as the sweep
    adds them."""
    dim = dim % p.dim()
    n = p.shape[dim]
    coords = _coords(n, dim, p.dim(), p.device)
    d = torch.clamp(disp, -max_disp, max_disp)
    pos = torch.clamp(coords + d, 0.0, float(n - 1))
    d = pos - coords
    fl = torch.floor(d)
    out = torch.zeros(torch.broadcast_shapes(p.shape, d.shape),
                      dtype=torch.float32, device=p.device)
    for m in (0.0, 1.0):
        k = fl + m
        c = torch.clamp(1.0 - torch.abs(d - k), min=0.0)
        idx = torch.clamp(coords + k, 0.0, float(n - 1)).to(torch.int64)
        out = out + c * torch.gather(p, dim, idx.expand(out.shape))
    return out


def shift(p: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """shift(p, k)[y] = p[clamp(y + k, 0, n - 1)] along `dim`, n the
    plane's extent (replicate borders)."""
    if k == 0:
        return p
    dim = dim % p.dim()
    n = p.shape[dim]
    idx = torch.clamp(torch.arange(n, device=p.device) + k, 0, n - 1)
    return torch.index_select(p, dim, idx)


def conv_taps(p: torch.Tensor, taps, dim: int, center: int) -> torch.Tensor:
    """sum_i f32(taps[i]) * shift(p, i - center) along `dim`, in the float
    order of the Pallas helper: zero taps are skipped, the first nonzero
    term starts the sum and the others are added in ascending order (so not
    the order of `ops/filters.conv1d`, which adds the zero taps too)."""
    out = None
    for i, c in enumerate(taps):
        if c == 0.0:
            continue
        term = float(np.float32(c)) * shift(p, i - center, dim)
        out = term if out is None else out + term
    return out


def cubic_weight(x: torch.Tensor) -> torch.Tensor:
    """Cubic-convolution kernel, a=-0.75 (OpenCV INTER_CUBIC), support (-2,2)."""
    a = -0.75
    ax = torch.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    inner = (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0
    outer = a * (ax3 - 5.0 * ax2 + 8.0 * ax - 4.0)
    return torch.where(ax < 1.0, inner, torch.where(ax < 2.0, outer, 0.0))


def resample_cubic(planes, disp: torch.Tensor, dim: int, max_disp: float):
    """Cubic 1-D resample of each plane in `planes` along `dim` at per-pixel
    displacement `disp` (the planes' shape): the displacement is clamped to
    +-max_disp (a float32 value) and the position into [0, n-1]. Of the
    Pallas roll sweep only the taps floor(pos)-1 .. floor(pos)+2 have
    weight; they are added in ascending order to a zero accumulator, as the
    sweep adds them. Returns a list like `planes`."""
    dim = dim % disp.dim()
    n = disp.shape[dim]
    coords = _coords(n, dim, disp.dim(), disp.device)
    d = torch.clamp(disp, -max_disp, max_disp)
    pos = torch.clamp(coords + d, 0.0, float(n - 1))
    d = pos - coords
    fl = torch.floor(pos)
    outs = [torch.zeros_like(disp) for _ in planes]
    for m in range(4):
        t = fl + float(m - 1)
        c = cubic_weight(d - (t - coords))
        idx = torch.clamp(t, 0.0, float(n - 1)).to(torch.int64)
        for k, p in enumerate(planes):
            outs[k] = outs[k] + c * torch.gather(p, dim, idx)
    return outs


def check_window(win: int) -> None:
    """`box_sum` takes odd windows only. The Pallas cascade miscounts the
    replicate correction of an even window by one tap (its window is
    [-(win//2), win//2], win+1 taps), and JAX's `conv1d` pads an even
    kernel by (len-1)//2 on both sides, so there is no even-window answer
    to match."""
    if win < 1 or win % 2 == 0:
        raise ValueError(f"box window must be odd and >= 1, got {win}")


def _tree(pz: torch.Tensor, dim: int, off: int, size: int, n: int) -> torch.Tensor:
    """Pairwise sum of pz[y+off .. y+off+size-1] for y in [0, n): the
    cascaded doubling's partial sums (size a power of two)."""
    if size == 1:
        return pz.narrow(dim, off, n)
    half = size // 2
    return _tree(pz, dim, off, half, n) + _tree(pz, dim, off + half, half, n)


def box_sum(p: torch.Tensor, win: int, dim: int) -> torch.Tensor:
    """Sum of the `win` taps p[clamp(y+k)] for k in [-(win//2), win//2]
    along `dim`, replicate borders at the plane's extent, in the float
    order of the Pallas `box_sum` with zero_pad=True: for win >= 4, the
    zero-padded window summed in power-of-two blocks (the cascaded
    doubling, largest block first), then the clamped taps' edge values
    added as count * edge; for win < 4, the taps in ascending order."""
    check_window(win)
    dim = dim % p.dim()
    n = p.shape[dim]
    ctr = win // 2
    if win < 4:
        acc = torch.zeros_like(p)
        base = torch.arange(n, device=p.device)
        for k in range(-ctr, ctr + 1):
            acc = acc + torch.index_select(p, dim, torch.clamp(base + k, 0, n - 1))
        return acc
    pad = [0, 0] * (p.dim() - 1 - dim) + [ctr, ctr]
    pz = torch.nn.functional.pad(p, pad)
    total, off, m, rem = None, 0, 1, win
    while m * 2 <= win:
        m *= 2
    while rem:
        if rem >= m:
            part = _tree(pz, dim, off, m, n)
            total = part if total is None else total + part
            off += m
            rem -= m
        m //= 2
    y = _coords(n, dim, p.dim(), p.device)
    cnt_lo = torch.clamp(ctr - y, min=0.0)
    cnt_hi = torch.clamp(y + ctr - (n - 1), min=0.0)
    lo = p.narrow(dim, 0, 1)
    hi = p.narrow(dim, n - 1, 1)
    return (total + cnt_lo * lo) + cnt_hi * hi


def border_scale(h: int, w: int) -> np.ndarray:
    """OpenCV's separable border attenuation as an (h, w) float32 plane,
    multiplied factor by factor in the order of the Pallas level kernel
    (rows j = 0.. at the top then the bottom band, then the columns):
    the bands multiply where they overlap on tiny levels."""
    ri = np.arange(h)[:, None]
    ci = np.arange(w)[None, :]
    s = np.ones((h, w), np.float32)
    for idx, n in ((ri, h), (ci, w)):
        for j in range(min(len(BORDER), n)):
            bj = np.float32(BORDER[j])
            s = s * np.where(idx == j, bj, np.float32(1.0))
            s = s * np.where(idx == n - 1 - j, bj, np.float32(1.0))
    return s.astype(np.float32)
