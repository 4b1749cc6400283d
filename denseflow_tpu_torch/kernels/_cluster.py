"""What the cluster kernels' plans share: the H100's limits for one
thread-block cluster per frame pair, the plan record, and the occupancy
query.

`csrc/tvl1_scale.cu`, `csrc/farneback_level.cu` and `csrc/brox_scale.cu`
run a cluster of n CTAs per pair, CTA k owning a band of full-width rows. Each kernel's module picks its
plan from (h, w) alone (`_plan`) under the limits here; how many clusters
of a plan fit on the card at once is asked of the card itself, and a plan
it cannot schedule raises instead of running a smaller one.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Tuple

import torch

SMEM_LIMIT = 232_448  # shared memory one CTA may use on sm_90 (227 KB)
# at least a kernel's own __shared__ arrays (TVL1 144 B, Farneback 64, Brox 256)
SMEM_STATIC = 256
MAX_CTAS = 16  # a non-portable cluster
# The widest cluster of which a main-path slab's 16 pairs fit on an H100 at
# once: 17 clusters of 6 one-CTA-per-SM blocks do, of 7 or 8 only 15, of
# 12 to 16 only 7 (cudaOccupancyMaxActiveClusters; PERF.md).
ONE_WAVE_CTAS = 6


@dataclasses.dataclass(frozen=True)
class Plan:
    """How a kernel lays one pair out: `n` CTAs, one thread-block cluster;
    CTA k owns rows starts[k] .. starts[k+1]-1; `placement` is where the
    state lives; `smem_bytes` is the dynamic shared memory of a CTA,
    `scratch_planes` the (h, w) planes of device memory a pair needs besides
    the outputs."""

    n: int
    starts: Tuple[int, ...]
    placement: str
    smem_bytes: int
    scratch_planes: int


def even_starts(h: int, n: int) -> Tuple[int, ...]:
    """The first rows of n bands of h rows, as even as rows allow (the
    longer bands first), and h."""
    q, extra = divmod(h, n)
    starts = [0]
    for k in range(n):
        starts.append(starts[-1] + q + (k < extra))
    return tuple(starts)


def fits(plan: Plan) -> bool:
    """Whether a CTA of `plan` fits the shared memory of one SM."""
    return plan.smem_bytes + SMEM_STATIC <= SMEM_LIMIT


_active: dict = {}


def active_clusters(name: str, plan: Plan, h: int, w: int, device: torch.device,
                    query: Callable) -> int:
    """How many clusters of kernel `name`'s `plan` fit on `device` at once:
    query(out) calls the kernel's cudaOccupancyMaxActiveClusters export.
    Raises if the kernel does not take the plan, or if not one cluster of
    it fits: no smaller plan is run in its place."""
    key = (name, torch.cuda.current_device() if device.index is None else device.index,
           h, w, plan)
    if key not in _active:
        out = ctypes.c_int(0)
        with torch.cuda.device(key[1]):
            rc = query(ctypes.byref(out))
        if rc == -1:
            raise ValueError(f"{name}: the kernel does not take {plan} at {h}x{w}")
        if rc != 0:
            raise RuntimeError(f"{name}: occupancy query failed for {plan} "
                               f"at {h}x{w}: CUDA error {rc}")
        if out.value < 1:
            raise RuntimeError(f"{name}: the card cannot schedule {plan} at {h}x{w}")
        _active[key] = out.value
    return _active[key]
