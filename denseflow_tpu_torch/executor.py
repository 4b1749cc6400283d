"""Device executor: turns decoded frame chunks into the save type's payload.

The port of the JAX package's `denseflow_tpu/executor.py` for one or more
CUDA devices:

* the chunk's frames cross to each device **once**, from one pinned host
  buffer on the device's copy stream, started by the decode stage so the
  copy of chunk i+1 overlaps the solve of chunk i;
* pairs are sliced out of the resident chunk in slabs of `pair_batch`
  (a = step>0 ? i : i-step, b = step>0 ? i+step : i, flow a -> b, reference
  src/denseflow_gpu.cpp:315-316); each slab is solved, checked for clamp
  saturation and turned into the save type's payload on the device: CAST
  planes for jpg, the adaptive-bound 3-channel planes for png, the raw
  float32 flow for h5 (float16 with `--h5Dtype=f16`, widened back to
  float32 on the host);
* with more than one device, every slab is split into equal contiguous
  sub-slabs, one a device: the JAX package's shard_map split without
  shard_map (the slab rounds up to a multiple of the device count; pairs
  share nothing, reference src/denseflow_gpu.cpp:313-341). Each device
  has its own copy of the chunk, streams and solver; one host thread
  enqueues them all, each under its device, so the kernels' launch counts
  stay single-threaded. The solvers treat each pair alone, so the bytes
  are those of one device;
* chunk pair counts are bucketed to pair_batch * 2^k, padded pairs repeat
  the last frame and are dropped on the host; widths may be bucketed with
  edge-replicated columns that are cropped back on the host;
* each sub-slab's payload is copied to pinned host memory at its global
  pair offset on its device's compute stream, and an event a device marks
  the arrival, so the pipeline dispatches chunk i+1 before it waits for
  chunk i, and the host reads global pair order as it is.

With `wire_pack` (`--wirePack=1`) the payload crosses packed by the
lossless wire codecs (wire.py), as the JAX package's executor does it: v3
for jpg and png while the 3-byte exception index holds the pair's deltas
(n_chan*H*(W-1) < 2^24), v4 for h5 float32 (f16 stays raw). Each shard
keeps its sub-slabs' payload on its device, packs it in shard-local pair
order on its own stream after the chunk's last slab, and copies `used`
to pinned host memory; `collect_chunk` copies `buf[:used]`, decodes it
(the native decoder where g++ built it, else NumPy) and puts the pairs at
their global offsets. A v3 pair over EXC_CAP escapes brings that shard's
raw payload down, kept on the device for it. The bytes on disk are those
of a run without the codec. `WIRE_STATS` counts the bytes that cross.
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
from denseflow_tpu_torch.quantize import quantize_flow_pair, quantize_flow_png
from denseflow_tpu_torch.utils import local_devices
from denseflow_tpu_torch.wire import (
    EXC_CAP,
    pack_chunk_v3,
    pack_chunk_v4,
    unpack_chunk_v3_fast,
    unpack_chunk_v4_fast,
)


class WireStats:
    """Process-wide device-link byte counters, as the JAX package's
    (`denseflow_tpu/executor.py:67-105`), plus the raw fallbacks of the v3
    codec. Counted where the port copies frames up (each device's copy)
    and payloads down (each copy: a sub-slab's raw payload, a shard's
    `used` and `buf[:used]`, a fallback's raw payload); on the CPU, where
    nothing is copied, the same bytes are counted."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.h2d_bytes = 0
            self.h2d_calls = 0
            self.d2h_bytes = 0
            self.d2h_calls = 0
            self.fallbacks = 0

    def add_h2d(self, nbytes: int) -> None:
        with self._lock:
            self.h2d_bytes += int(nbytes)
            self.h2d_calls += 1

    def add_d2h(self, nbytes: int) -> None:
        with self._lock:
            self.d2h_bytes += int(nbytes)
            self.d2h_calls += 1

    def add_fallback(self) -> None:
        with self._lock:
            self.fallbacks += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "h2d_bytes": self.h2d_bytes,
                "h2d_calls": self.h2d_calls,
                "d2h_bytes": self.d2h_bytes,
                "d2h_calls": self.d2h_calls,
                "fallbacks": self.fallbacks,
            }


WIRE_STATS = WireStats()


@dataclass
class ResidentChunk:
    """A chunk's frames on each shard's device and the events that mark the
    end of their copies (None on the CPU)."""

    frames: List[torch.Tensor]  # a shard: (N', H, W) uint8, padded
    ready: List["torch.cuda.Event | None"]


@dataclass
class _Packed:
    """One shard's packed payload."""

    buf: torch.Tensor  # the wire buffer, on the shard's device
    used: torch.Tensor  # () int64, host (pinned on CUDA): buf[:used] matters
    q: torch.Tensor  # the raw payload in shard-local pair order, on the device


@dataclass
class _Dispatched:
    q: "torch.Tensor | None"  # the chunk's raw payload (see _solve_q), host
    # (pinned on CUDA); None when it crosses packed
    sat: torch.Tensor  # (mb,) float32, host
    done: List["torch.cuda.Event"]  # one a shard on CUDA, none on the CPU
    m: int  # real pairs
    packs: List[_Packed]  # one a shard with the codec on, else empty

    def wait(self) -> None:
        for e in self.done:
            e.synchronize()


class _Shard:
    """One device's part of the executor: its solver and, on a card, its
    copy and compute streams."""

    def __init__(self, device: torch.device, solver) -> None:
        self.device = device
        self.solver = solver
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.copy_stream = torch.cuda.Stream(device)
            self.stream = torch.cuda.Stream(device)

    def on(self, stream_name: str):
        """The shard's device and its stream `stream_name` made current."""
        stack = contextlib.ExitStack()
        if self.cuda:
            stack.enter_context(torch.cuda.device(self.device))
            stack.enter_context(torch.cuda.stream(getattr(self, stream_name)))
        return stack


class DeviceExecutor:
    """Per-(video geometry, algorithm, save type) solve + payload step on
    one or more devices."""

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
        save_type: str = "jpg",
        h5_f16: bool = False,
        n_devices: int = 0,
        wire_pack: bool = False,
    ) -> None:
        self.height = height
        self.w_real = width
        if width_bucket > 0:
            width = -(-width // width_bucket) * width_bucket
        self.width = width
        self.step = step
        self.bound = float(bound)
        self.save_type = save_type
        # h5 only: downcast the flow to f16 on the device before the copy
        # (config.h5_dtype); disk datasets stay float32
        self.h5_f16 = bool(h5_f16) and save_type == "h5"
        # the first n_devices local devices, all of them for 0 (fewer where
        # fewer exist, as the JAX package takes them)
        devs = local_devices(device)
        self.devices = devs[:n_devices] if n_devices > 0 else devs
        # channels of the uint8 payload; the wire codecs as the JAX package
        # guards them (denseflow_tpu/executor.py:164-185): v3 addresses an
        # escape by a 3-byte flat index within the pair, so it needs
        # n_chan*H*(W-1) < 2^24 (4K png falls back to raw); v4 takes the h5
        # float32 flow; the f16 copy stays raw (already half size, its low
        # bytes noise)
        self.n_chan = {"jpg": 2, "png": 3}.get(save_type, 0)
        self.wire_pack = (
            bool(wire_pack) and save_type in ("jpg", "png")
            and self.n_chan * height * max(width - 1, 0) < (1 << 24)
        )
        self.wire_f32 = bool(wire_pack) and save_type == "h5" and not self.h5_f16
        self.codec = "v3" if self.wire_pack else "v4" if self.wire_f32 else "raw"
        self.n_dev = len(self.devices)
        # pair-batch slab: a multiple of the device count so every device
        # gets an equal share of every slab
        self.B = -(-pair_batch // self.n_dev) * self.n_dev
        self.b_loc = self.B // self.n_dev
        self.astep = abs(step)
        # the solver's effective displacement clamp (for the saturation
        # signal that drives auto-escalation — pipeline.py)
        self.max_disp_eff = max_disp if max_disp > 0 else 40
        self._shards = [
            _Shard(d, make_solver(algorithm, height, width, preset, max_disp, str(d)))
            for d in self.devices
        ]
        self._cuda = self._shards[0].cuda
        self._off_a = 0 if step > 0 else self.astep
        self._off_b = step if step > 0 else 0

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
        """Pad/bucket on the host and start the copy to every device.
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
        for _ in self._shards:
            WIRE_STATS.add_h2d(host.nbytes)
        if not self._cuda:
            return ResidentChunk([host] * self.n_dev, [None] * self.n_dev)
        host = host.pin_memory()
        resident, ready = [], []
        for sh in self._shards:
            with sh.on("copy_stream"):
                resident.append(host.to(sh.device, non_blocking=True))
                ready.append(torch.cuda.Event())
                ready[-1].record()
        return ResidentChunk(resident, ready)

    def _solve_q(self, sh: _Shard, frames: torch.Tensor, s: int, n_pairs: int):
        """Solve pairs [s, s+n_pairs) of the resident chunk on shard `sh`
        into the save type's payload — jpg (n, 2, H, W) uint8, png (n, 3, H,
        W) uint8, h5 (n, H, W, 2) float32 or float16 — and the per-pair
        CLAMP-SATURATION fraction: the share of pixels whose flow sits at
        the warp's displacement clamp, the signal behind auto-escalation.
        The png bound is taken over the solved width, padded columns
        included, as the JAX package does with --widthBucket."""
        I0 = frames[s + self._off_a: s + self._off_a + n_pairs]
        I1 = frames[s + self._off_b: s + self._off_b + n_pairs]
        flow = sh.solver(I0, I1)
        thresh = float(np.float32(0.98 * self.max_disp_eff))
        sat = (flow.abs().amax(dim=-1) >= thresh).to(torch.float32).mean(dim=(-2, -1))
        if self.save_type == "h5":
            return (flow.to(torch.float16) if self.h5_f16 else flow), sat
        if self.save_type == "jpg":
            qx, qy = quantize_flow_pair(flow, self.bound)
            return torch.stack([qx, qy], dim=1), sat
        return quantize_flow_png(flow).movedim(-1, 1), sat

    def dispatch_chunk(self, frames, n_frames: int) -> List[_Dispatched]:
        """Queue the whole chunk's solve and the copy of its payload (or,
        with the codec, its pack and the copy of `used`) to the host;
        `collect_chunk` waits for it. frames: a `ResidentChunk` from
        `upload_chunk` (a raw np array is uploaded here). n_frames: the
        chunk's REAL frame count incl. halo; padded pairs are dropped."""
        m = n_frames - self.astep
        if m <= 0:
            return []
        if isinstance(frames, np.ndarray):
            frames = self.upload_chunk(frames)
        for sh, f, ready in zip(self._shards, frames.frames, frames.ready):
            if ready is not None:
                with sh.on("stream"):
                    torch.cuda.current_stream().wait_event(ready)
                    f.record_stream(torch.cuda.current_stream())
        mb = frames.frames[0].shape[0] - self.astep
        packing = self.wire_pack or self.wire_f32
        q_host = sat_host = None
        q_loc = [None] * self.n_dev  # with the codec: each shard's payload
        # slab-major, so every device has work queued after the first slab
        for j, s in enumerate(range(0, mb, self.B)):
            for r, (sh, f) in enumerate(zip(self._shards, frames.frames)):
                lo = s + r * self.b_loc  # this shard's pairs of the slab
                with sh.on("stream"):
                    q, sat = self._solve_q(sh, f, lo, self.b_loc)
                    if sat_host is None:
                        sat_host = torch.empty((mb,), dtype=sat.dtype,
                                               pin_memory=self._cuda)
                    sat_host[lo:lo + self.b_loc].copy_(sat, non_blocking=self._cuda)
                    if packing:
                        if q_loc[r] is None:
                            q_loc[r] = torch.empty((mb // self.n_dev,) + q.shape[1:],
                                                   dtype=q.dtype, device=sh.device)
                        q_loc[r][j * self.b_loc:(j + 1) * self.b_loc] = q
                        continue
                    if q_host is None:
                        q_host = torch.empty((mb,) + q.shape[1:], dtype=q.dtype,
                                             pin_memory=self._cuda)
                    q_host[lo:lo + self.b_loc].copy_(q, non_blocking=self._cuda)
                    WIRE_STATS.add_d2h(q.nbytes)
        packs, done = [], []
        for sh, q in zip(self._shards, q_loc):
            with sh.on("stream"):
                if packing:
                    buf, used = (pack_chunk_v4(q) if self.wire_f32
                                 else pack_chunk_v3(q, EXC_CAP))
                    used_host = torch.empty((), dtype=torch.int64, pin_memory=self._cuda)
                    used_host.copy_(used, non_blocking=self._cuda)
                    WIRE_STATS.add_d2h(used_host.nbytes)
                    packs.append(_Packed(buf, used_host, q))
                if self._cuda:
                    done.append(torch.cuda.Event())
                    done[-1].record()
        return [_Dispatched(q_host, sat_host, done, m, packs)]

    def _to_host(self, sh: _Shard, t: torch.Tensor) -> np.ndarray:
        """A blocking copy of shard `sh`'s device tensor `t` to the host,
        counted in WIRE_STATS."""
        WIRE_STATS.add_d2h(t.nbytes)
        if not self._cuda:
            return t.numpy()
        with sh.on("stream"):
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            torch.cuda.current_stream().synchronize()
        return host.numpy()

    def _unpack(self, d: _Dispatched) -> np.ndarray:
        """The chunk's payload in global pair order from its shards' packed
        buffers: each shard's `buf[:used]` copied down and decoded, its
        pairs put at their global offsets; a shard whose real v3 pairs
        overflowed the exception channel brings its raw payload down."""
        out = None
        for r, (sh, p) in enumerate(zip(self._shards, d.packs)):
            arr = self._to_host(sh, p.buf[:int(p.used)])
            m_loc = p.q.shape[0]
            # local pair i of shard r is global pair (i // b_loc) * B +
            # r * b_loc + i % b_loc (dispatch_chunk's slab-major split)
            i = np.arange(m_loc)
            gidx = (i // self.b_loc) * self.B + r * self.b_loc + i % self.b_loc
            if self.wire_f32:
                q = unpack_chunk_v4_fast(arr, m_loc, self.height, self.width)
            else:
                flags, q = unpack_chunk_v3_fast(arr, m_loc, self.n_chan, self.height,
                                                self.width, EXC_CAP)
                if not flags[gidx < d.m].all():
                    q = self._to_host(sh, p.q)
                    WIRE_STATS.add_fallback()
            if self.n_dev == 1:
                return q
            if out is None:
                out = np.empty((len(d.sat),) + q.shape[1:], q.dtype)
            out[gidx] = q
        return out

    def collect_chunk(self, outs: List[_Dispatched]) -> Iterator:
        """Yield (payload, pair_offset, n_pairs) per dispatched chunk,
        cropped to the real width: jpg -> (imgs_x, imgs_y) uint8 (m, H, W);
        png -> (m, H, W, 3) uint8; h5 -> (m, H, W, 2) float32."""
        for d in outs:
            d.wait()
            q = (self._unpack(d) if d.packs else d.q.numpy())[: d.m]
            if self.save_type == "h5":
                yield np.asarray(q[:, :, : self.w_real], np.float32), 0, d.m
            elif self.save_type == "jpg":
                q = q[..., : self.w_real]
                yield (q[:, 0], q[:, 1]), 0, d.m
            else:
                yield np.moveaxis(q[..., : self.w_real], 1, -1), 0, d.m

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

    def run_chunk(
        self, frames, n_frames: int
    ) -> "np.ndarray | Tuple[np.ndarray, np.ndarray]":
        """Blocking form of `iter_chunk`: the whole chunk's payload at once."""
        outs = [p for p, _, _ in self.iter_chunk(frames, n_frames)]
        if not outs:
            if self.save_type == "jpg":
                e = np.empty((0, self.height, self.w_real), np.uint8)
                return e, e
            if self.save_type == "png":
                return np.empty((0, self.height, self.w_real, 3), np.uint8)
            return np.empty((0, self.height, self.w_real, 2), np.float32)
        if isinstance(outs[0], tuple):
            xs = np.concatenate([o[0] for o in outs], axis=0)
            ys = np.concatenate([o[1] for o in outs], axis=0)
            return xs, ys
        return np.concatenate(outs, axis=0)


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
    save_type: str = "jpg",
    h5_f16: bool = False,
    n_devices: int = 0,
    wire_pack: bool = False,
) -> DeviceExecutor:
    key = (algorithm, height, width, step, bound, pair_batch, preset,
           max_disp, width_bucket, device, save_type, h5_f16, n_devices,
           bool(wire_pack))
    with _executor_lock:
        return _get_executor_locked(*key)
