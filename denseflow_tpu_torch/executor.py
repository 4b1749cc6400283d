"""Device executor: turns decoded frame chunks into quantized jpg payloads.

The port of the JAX package's `denseflow_tpu/executor.py` for one CUDA
device and the jpg save type:

* the chunk's frames cross to the device **once**, from pinned host memory
  on a copy stream, started by the decode stage so the copy of chunk i+1
  overlaps the solve of chunk i;
* pairs are sliced out of the resident chunk in slabs of `pair_batch`
  (a = step>0 ? i : i-step, b = step>0 ? i+step : i, flow a -> b, reference
  src/denseflow_gpu.cpp:315-316); each slab is solved, checked for clamp
  saturation and CAST-quantized on the device;
* chunk pair counts are bucketed to pair_batch * 2^k, padded pairs repeat
  the last frame and are dropped on the host; widths may be bucketed with
  edge-replicated columns that are cropped back on the host;
* the uint8 payload is copied to pinned host memory on the compute stream
  and an event marks its arrival, so the pipeline dispatches chunk i+1
  before it waits for chunk i.

The payload crosses as raw uint8: the JAX package's wire codecs exist for
a remote-device link and are lossless, so the bytes on disk are the same.
On the CPU (device="cpu") the same steps run synchronously.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from functools import lru_cache
from typing import Iterator, List, Tuple

import numpy as np
import torch

from denseflow_tpu_torch.algorithms import make_solver
from denseflow_tpu_torch.quantize import quantize_flow_pair
from denseflow_tpu_torch.utils import resolve_device


@dataclass
class ResidentChunk:
    """A chunk's frames on the device and the event that marks the end of
    their copy (None on the CPU)."""

    frames: torch.Tensor  # (N', H, W) uint8, padded
    ready: "torch.cuda.Event | None"


@dataclass
class _Dispatched:
    q: torch.Tensor  # (mb, 2, H, W) uint8, host (pinned on CUDA)
    sat: torch.Tensor  # (mb,) float32, host
    done: "torch.cuda.Event | None"
    m: int  # real pairs

    def wait(self) -> None:
        if self.done is not None:
            self.done.synchronize()


class DeviceExecutor:
    """Per-(video geometry, algorithm) solve + quantize step on one device."""

    def __init__(
        self,
        algorithm: str,
        height: int,
        width: int,
        step: int,
        bound: int,
        pair_batch: int,
        preset: "str | None" = None,
        max_disp: int = 0,
        width_bucket: int = 0,
        device: str = "cuda",
    ) -> None:
        self.height = height
        self.w_real = width
        if width_bucket > 0:
            width = -(-width // width_bucket) * width_bucket
        self.width = width
        self.step = step
        self.bound = float(bound)
        self.device = resolve_device(device)
        self.B = pair_batch
        self.astep = abs(step)
        # the solver's effective displacement clamp (for the saturation
        # signal that drives auto-escalation — pipeline.py)
        self.max_disp_eff = max_disp if max_disp > 0 else 40
        self._solver = make_solver(
            algorithm, height, width, preset, max_disp, str(self.device)
        )
        self._off_a = 0 if step > 0 else self.astep
        self._off_b = step if step > 0 else 0
        if self.device.type == "cuda":
            self._copy_stream = torch.cuda.Stream(self.device)
            self._stream = torch.cuda.Stream(self.device)

    def _on(self, stream_name: str):
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        return torch.cuda.stream(getattr(self, stream_name))

    # ---------------- shape bucketing ----------------
    def _bucket(self, n: int) -> int:
        """Smallest B * 2^k >= n."""
        mb = self.B
        while mb < n:
            mb *= 2
        return mb

    def _padded_len(self, n: int) -> int:
        """Frames to upload for a chunk of n real frames."""
        m = max(n - self.astep, 0)
        return self._bucket(max(m, 1)) + self.astep

    # ---------------- host <-> device ----------------
    def upload_chunk(self, frames: np.ndarray) -> "ResidentChunk | np.ndarray":
        """Pad/bucket on the host and start the copy to the device.
        A chunk without pairs is returned as it is."""
        n = frames.shape[0]
        if n - self.astep <= 0:
            return frames
        if self.width > self.w_real:
            # edge-replicate the padded columns: the solver sees a flat
            # extension, so real-region flow matches the exact-W solve
            # away from the right border
            pad = np.repeat(frames[:, :, -1:], self.width - self.w_real, axis=2)
            frames = np.concatenate([frames, pad], axis=2)
        n_pad = self._padded_len(n)
        if n_pad > n:
            pad = np.repeat(frames[-1:], n_pad - n, axis=0)
            frames = np.concatenate([frames, pad], axis=0)
        host = torch.from_numpy(np.ascontiguousarray(frames))
        if self.device.type != "cuda":
            return ResidentChunk(host, None)
        host = host.pin_memory()
        with self._on("_copy_stream"):
            dev = host.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        return ResidentChunk(dev, ready)

    def _solve_q(self, frames: torch.Tensor, s: int, n_pairs: int):
        """Solve pairs [s, s+n_pairs) of the resident chunk into the
        (n, 2, H, W) uint8 jpg payload and the per-pair CLAMP-SATURATION
        fraction: the share of pixels whose flow sits at the warp's
        displacement clamp, the signal behind auto-escalation."""
        I0 = frames[s + self._off_a: s + self._off_a + n_pairs]
        I1 = frames[s + self._off_b: s + self._off_b + n_pairs]
        flow = self._solver(I0, I1)
        thresh = float(np.float32(0.98 * self.max_disp_eff))
        sat = (flow.abs().amax(dim=-1) >= thresh).to(torch.float32).mean(dim=(-2, -1))
        qx, qy = quantize_flow_pair(flow, self.bound)
        return torch.stack([qx, qy], dim=1), sat

    def dispatch_chunk(self, frames, n_frames: int) -> List[_Dispatched]:
        """Queue the whole chunk's solve and the copy of its payload to the
        host; `collect_chunk` waits for it. frames: a `ResidentChunk` from
        `upload_chunk` (a raw np array is uploaded here). n_frames: the
        chunk's REAL frame count incl. halo; padded pairs are dropped."""
        m = n_frames - self.astep
        if m <= 0:
            return []
        if isinstance(frames, np.ndarray):
            frames = self.upload_chunk(frames)
        with self._on("_stream"):
            if frames.ready is not None:
                torch.cuda.current_stream().wait_event(frames.ready)
                frames.frames.record_stream(torch.cuda.current_stream())
            mb = frames.frames.shape[0] - self.astep
            solved = [self._solve_q(frames.frames, s, self.B) for s in range(0, mb, self.B)]
            q = torch.cat([a for a, _ in solved])
            sat = torch.cat([b for _, b in solved])
            if self.device.type != "cuda":
                return [_Dispatched(q, sat, None, m)]
            q_host = torch.empty(q.shape, dtype=q.dtype, pin_memory=True)
            sat_host = torch.empty(sat.shape, dtype=sat.dtype, pin_memory=True)
            q_host.copy_(q, non_blocking=True)
            sat_host.copy_(sat, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        return [_Dispatched(q_host, sat_host, done, m)]

    def collect_chunk(self, outs: List[_Dispatched]) -> Iterator:
        """Yield ((imgs_x, imgs_y), pair_offset, n_pairs) per dispatched
        chunk: uint8 (m, H, W) planes, cropped to the real width."""
        for d in outs:
            d.wait()
            q = d.q.numpy()[: d.m, :, :, : self.w_real]
            yield (q[:, 0], q[:, 1]), 0, d.m

    def saturation_frac(self, outs: List[_Dispatched]) -> float:
        """Max per-pair clamp-saturation fraction across a dispatched
        chunk. The pipeline re-dispatches a chunk through an
        escalated-clamp executor when this crosses its threshold."""
        worst = 0.0
        for d in outs:
            d.wait()
            worst = max(worst, float(d.sat.max()))
        return worst

    def iter_chunk(self, frames, n_frames: int):
        """dispatch_chunk + collect_chunk in one call (single-chunk use)."""
        yield from self.collect_chunk(self.dispatch_chunk(frames, n_frames))

    def run_chunk(self, frames, n_frames: int) -> Tuple[np.ndarray, np.ndarray]:
        """Blocking form of `iter_chunk`: the whole chunk's (imgs_x, imgs_y)."""
        outs = [p for p, _, _ in self.iter_chunk(frames, n_frames)]
        if not outs:
            e = np.empty((0, self.height, self.w_real), np.uint8)
            return e, e
        xs = np.concatenate([o[0] for o in outs], axis=0)
        ys = np.concatenate([o[1] for o in outs], axis=0)
        return xs, ys


# Serializes executor CONSTRUCTION: concurrent decode workers hitting a
# cold key would otherwise build duplicate executors.
_executor_lock = threading.Lock()


@lru_cache(maxsize=64)
def _get_executor_locked(*key) -> DeviceExecutor:
    return DeviceExecutor(*key)


def get_executor(
    algorithm: str,
    height: int,
    width: int,
    step: int,
    bound: int,
    pair_batch: int,
    preset: "str | None" = None,
    max_disp: int = 0,
    width_bucket: int = 0,
    device: str = "cuda",
) -> DeviceExecutor:
    key = (algorithm, height, width, step, bound, pair_batch, preset,
           max_disp, width_bucket, device)
    with _executor_lock:
        return _get_executor_locked(*key)
