"""The 3-stage extraction pipeline: decode ∥ device compute ∥ encode+write.

Same shape as the reference's thread trio with two bounded queues of depth 3
(reference include/dense_flow.h:35-46, src/denseflow_gpu.cpp:179-477), built
on queue.Queue backpressure instead of hand-rolled mutex/condvar pairs.
Sentinels replace the reference's ready_to_exit1/2/3 cascade. Differences
by design:

* the compute stage runs **batched pairs** through the device executor
  (executor.py) instead of per-pair upload/calc/download;
* per-video errors are isolated (the video is reported and skipped) unless
  cfg.strict, where the first error aborts the run like the reference's
  single try/catch (reference tools/denseflow.cpp:93-96);
* counters and the final summary line are preserved verbatim.

The port of the JAX package's `denseflow_tpu/pipeline.py`. The writer
stage encodes jpg and png through the native emitter (native/, a worker pool
of libjpeg/libpng encoders) when it is built and through cv2 otherwise,
with the same file names either way, and writes h5 through h5py.
"""

from __future__ import annotations

import os
import queue
import threading
import traceback
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

from denseflow_tpu_torch import native
from denseflow_tpu_torch.config import FlowConfig
from denseflow_tpu_torch.executor import get_executor
from denseflow_tpu_torch.io.reader import EmptyFolderError, Job, open_source
from denseflow_tpu_torch.io.writer import (
    create_h5_file,
    encode_jpg,
    encode_png,
    flow_file_name,
    mark_done,
    step_base,
    write_flow_images,
    write_flow_images_png,
    write_hdf5,
)
from denseflow_tpu_torch.utils import Counters, StageTimers, VerboseLog

QUEUE_DEPTH = 3  # the reference's frames_gray_maxsize / flows_maxsize


@dataclass
class _ChunkItem:
    frames: object  # executor.ResidentChunk, or np when the chunk has no pairs
    n_frames: int  # real frame count incl. halo (N' may be padded)
    output_dir: str
    base_start: int
    last_buffer: bool
    height: int
    width: int


@dataclass
class _FlowItem:
    payload: object  # (qx, qy) | png u8 | f32 flow, per save_type
    output_dir: str
    base_start: int
    last_buffer: bool


@dataclass
class _VideoError:
    video_path: str
    error: str


class Pipeline:
    def __init__(self, cfg: FlowConfig, jobs: List[Job], is_record: bool) -> None:
        cfg.validate()
        self.cfg = cfg
        self.jobs = jobs
        self.is_record = is_record
        self.counters = Counters()
        self.timers = StageTimers()
        self.log = VerboseLog(cfg.verbose)
        self.errors: List[_VideoError] = []
        self._frames_q: queue.Queue = queue.Queue(maxsize=QUEUE_DEPTH)
        self._flows_q: queue.Queue = queue.Queue(maxsize=QUEUE_DEPTH)
        self._abort = threading.Event()
        # the jpg/png writer, chosen once: the native emitter where it is
        # built, else cv2 (the same file names either way)
        self._native = native if cfg.save_type != "h5" and native.available() else None
        self.writer = "h5py" if cfg.save_type == "h5" else native.describe()
        self.log(f"writer: {self.writer}")
        # the devices the pairs were split over and the wire codec of the
        # payload ("v3", "v4" or "raw"), read from the first executor the
        # compute stage ran (empty / None until it runs one)
        self.devices: List = []
        self.codec: Optional[str] = None

    # ---------------- stage 1: decode ----------------
    def _decode_pool_size(self) -> int:
        n = self.cfg.decode_workers
        if n <= 0:
            n = min(4, max(1, (os.cpu_count() or 4) // 4))
        return min(n, len(self.jobs)) or 1

    def _load_frames(self) -> None:
        """Stage 1: decode videos into halo-padded chunks.

        Multi-video jobs decode on a worker pool (cfg.decode_workers):
        each worker claims WHOLE videos, so a video's chunks keep their
        order while different videos' chunks interleave in the frames
        queue — stage 2/3 route purely on the chunk's output_dir and
        last_buffer, so cross-video interleaving is safe. The reference
        decodes everything on one thread (src/denseflow_gpu.cpp:219)."""
        n_workers = self._decode_pool_size()
        try:
            if n_workers <= 1:
                for job in self.jobs:
                    if self._abort.is_set():
                        break
                    self._load_one_video(job)
            else:
                it = iter(self.jobs)
                lock = threading.Lock()

                def worker() -> None:
                    while not self._abort.is_set():
                        with lock:
                            job = next(it, None)
                        if job is None:
                            return
                        try:
                            self._load_one_video(job)
                        except Exception as e:
                            # _load_one_video guards its own body; this
                            # backstop keeps the worker alive (and the
                            # error recorded) even if a raise slips out
                            self._video_error(job, e)

                pool = [
                    threading.Thread(target=worker, name=f"decode_{i}")
                    for i in range(n_workers)
                ]
                for t in pool:
                    t.start()
                for t in pool:
                    t.join()
        finally:
            self._frames_q.put(None)
            self.log("load frames exit.")

    def _load_one_video(self, job: Job) -> None:
        cfg = self.cfg
        try:
            if cfg.save_type == "h5":
                create_h5_file(job.output_dir, cfg.step)
            src = open_source(job.video_path, cfg)
            # inside the guard: a corrupt container can make .size raise,
            # and an unguarded raise here would escape the decode worker
            # (losing the video with no error record, shrinking the pool)
            w, h = src.size
        except EmptyFolderError as e:
            self.log(str(e))
            return
        except Exception as e:
            self._video_error(job, e)
            return
        self.log(f"{job.video_path}, frames ≈ {src.approx_frames}")
        n_frames = 0
        try:
            gen = src.chunks(cfg.step)
            while True:
                with self.timers.track("decode"):
                    chunk = next(gen, None)
                if chunk is None:
                    break
                n_frames += len(chunk.frames) - chunk.halo
                # start the copy to the device here so it overlaps the
                # previous chunk's solve; a failure is this video's error
                frames = self._executor(h, w, cfg.max_disp).upload_chunk(
                    chunk.frames
                )
                item = _ChunkItem(
                    frames=frames,
                    n_frames=len(chunk.frames),
                    output_dir=job.output_dir,
                    base_start=chunk.base_start,
                    last_buffer=chunk.last,
                    height=h,
                    width=w,
                )
                self._frames_q.put(item)
                self.log(
                    f"push frames gray, video_flow_idx {chunk.base_start},"
                    f" batch_size {len(chunk.frames) - chunk.halo}"
                )
                if self._abort.is_set():
                    break
        except Exception as e:
            self._video_error(job, e)
        finally:
            src.close()
        self.counters.add_frames(n_frames)
        self.counters.add_videos()
        self.log(f"loaded video {job.video_path}, {n_frames} frames")

    # ---------------- stage 2: device compute ----------------
    def _executor(self, height: int, width: int, max_disp: int):
        cfg = self.cfg
        return get_executor(
            cfg.algorithm, height, width, cfg.step, cfg.bound,
            cfg.pair_batch, cfg.preset, max_disp, cfg.width_bucket,
            cfg.device, cfg.save_type, cfg.h5_dtype == "f16", cfg.devices,
            cfg.wire_pack,
        )

    # Chunks dispatched to the device but not yet collected. 2 keeps the
    # card computing chunk i+1 while chunk i's payload drains to the host;
    # more would only add latency and device residency.
    INFLIGHT_CHUNKS = 2

    # Auto-escalation of the displacement clamp: when this fraction of a chunk's pixels sits AT the clamp, the warp is
    # hiding motion and the chunk re-solves with a doubled clamp. The png
    # path advertises bounds up to 1020 (reference src/common.cpp:24).
    SAT_THRESHOLD = 0.01
    MAX_AUTO_DISP = 1020

    def _escalate_if_saturated(self, item: "_ChunkItem", ex, outs):
        """Re-dispatch a clamp-saturated chunk through executors with an
        escalated max_disp until the saturation signal clears (or the
        cap). Active only when the user left --maxDisp unset — an explicit
        clamp is taken as intent. Small-motion content never saturates, so
        the default path costs one near-free reduction per chunk.

        The ladder is CAPPED at two steps per geometry (as in the JAX
        package's pipeline.py:223-271): one doubling (catches the common "slightly past 40 px"
        band at moderate extra warp-sweep cost), then straight to the 1020
        png bound (reference src/common.cpp:24): at most two extra solves of
        a saturated chunk."""
        cfg = self.cfg
        if cfg.max_disp != 0:
            return ex, outs
        disp = ex.max_disp_eff
        steps = 0
        while (
            disp < self.MAX_AUTO_DISP
            and ex.saturation_frac(outs) > self.SAT_THRESHOLD
        ):
            steps += 1
            disp = (
                min(2 * disp, self.MAX_AUTO_DISP)
                if steps == 1
                else self.MAX_AUTO_DISP
            )
            self.log(
                f"clamp saturation on {item.output_dir}: re-solving chunk "
                f"at maxDisp={disp}"
            )
            ex = self._executor(item.height, item.width, disp)
            outs = ex.dispatch_chunk(item.frames, item.n_frames)
        return ex, outs

    def _collect_chunk(self, entry) -> None:
        """Drain one dispatched chunk into the flows queue (in order)."""
        cfg = self.cfg
        item, ex, outs = entry
        m_total = item.n_frames - abs(cfg.step)
        try:
            pushed = 0
            with self.timers.track("compute"):
                ex, outs = self._escalate_if_saturated(item, ex, outs)
                for payload, off, n in ex.collect_chunk(outs):
                    self.counters.add_flows(n)
                    pushed += n
                    self._flows_q.put(
                        _FlowItem(
                            payload,
                            item.output_dir,
                            item.base_start + off,
                            item.last_buffer and pushed >= m_total,
                        )
                    )
                    self.log(f"flows queue push a item ({n} flows)")
            if item.last_buffer and m_total <= 0:
                # degenerate final chunk (fewer frames than |step|):
                # still forward a marker so .done logic runs
                self._flows_q.put(
                    _FlowItem(None, item.output_dir, item.base_start, True)
                )
        except Exception:
            self.errors.append(
                _VideoError(item.output_dir, traceback.format_exc())
            )
            if cfg.strict:
                self._abort.set()
            if item.last_buffer:
                self._flows_q.put(
                    _FlowItem(None, item.output_dir, item.base_start, True)
                )

    def _calc_flows(self) -> None:
        cfg = self.cfg
        pending: List = []  # dispatched, uncollected chunks (FIFO)
        try:
            while True:
                item: Optional[_ChunkItem] = self._frames_q.get()
                if item is None:
                    break
                try:
                    ex = self._executor(item.height, item.width, cfg.max_disp)
                    if not self.devices:
                        self.devices = list(ex.devices)
                        self.codec = ex.codec
                        self.log(f"devices: {', '.join(map(str, self.devices))} "
                                 f"(--devices={cfg.devices})")
                    with self.timers.track("compute"):
                        outs = ex.dispatch_chunk(item.frames, item.n_frames)
                    pending.append((item, ex, outs))
                except Exception:
                    # flush already-dispatched work first so this video's
                    # .done marker cannot overtake earlier chunks' writes
                    while pending:
                        self._collect_chunk(pending.pop(0))
                    self.errors.append(
                        _VideoError(item.output_dir, traceback.format_exc())
                    )
                    if cfg.strict:
                        self._abort.set()
                    if item.last_buffer:
                        self._flows_q.put(
                            _FlowItem(None, item.output_dir, item.base_start, True)
                        )
                    continue
                while len(pending) >= self.INFLIGHT_CHUNKS:
                    self._collect_chunk(pending.pop(0))
        finally:
            while pending:
                self._collect_chunk(pending.pop(0))
            self._flows_q.put(None)
            self.log("calc optflows exit.")

    # ---------------- stage 3: encode + write ----------------
    def _encode_save(self) -> None:
        cfg = self.cfg
        try:
            while True:
                item: Optional[_FlowItem] = self._flows_q.get()
                if item is None:
                    break
                try:
                    with self.timers.track("encode"):
                        self._write_item(item)
                except Exception:
                    self.errors.append(
                        _VideoError(item.output_dir, traceback.format_exc())
                    )
                    if cfg.strict:
                        self._abort.set()
        finally:
            self.log("post process exit.")

    def _write_item(self, item: _FlowItem) -> None:
        cfg = self.cfg
        if item.payload is not None:
            if cfg.save_type == "jpg":
                for prefix, planes in zip(("flow_x", "flow_y"), item.payload):
                    self._write_images(item, prefix, planes, "jpg")
            elif cfg.save_type == "png":
                self._write_images(item, "flow", item.payload, "png")
            else:
                flow = item.payload
                for c, phase in enumerate(("flow_x", "flow_y")):
                    write_hdf5(
                        [flow[i, :, :, c] for i in range(flow.shape[0])],
                        item.output_dir, phase, cfg.step, item.base_start,
                    )
        if self.is_record and item.last_buffer:
            mark_done(item.output_dir, cfg.has_class)
            out = Path(item.output_dir)
            title = f"{out.parent.name}/{out.name}" if cfg.has_class else out.name
            print(f"done video {title}", flush=True)

    def _write_images(self, item: _FlowItem, prefix: str, images, ext: str) -> None:
        """Encode and write one image per pair: gray jpg planes (m, H, W) or
        BGR png planes (m, H, W, 3), named `<prefix><infix>_%05d.<ext>`."""
        cfg = self.cfg
        if self._native is not None:
            base = item.base_start + step_base(cfg.step)
            paths = [
                f"{item.output_dir}/{flow_file_name(prefix, cfg.step, base + i, ext)}"
                for i in range(images.shape[0])
            ]
            if ext == "jpg":
                self._native.write_jpg_batch(images, paths)
            else:
                self._native.write_png_batch(images, paths)
            return
        encode, write = ((encode_jpg, write_flow_images) if ext == "jpg"
                         else (encode_png, write_flow_images_png))
        write([encode(im) for im in images], f"{item.output_dir}/{prefix}",
              cfg.step, item.base_start)

    # ---------------- run ----------------
    def _video_error(self, job: Job, e: Exception) -> None:
        """Record a decode-side failure. Under --strict it stops every
        stage, and `launch` raises it once the threads have ended."""
        self.errors.append(_VideoError(job.video_path, str(e)))
        if self.cfg.strict:
            self._abort.set()
            return
        print(f"error on {job.video_path}: {e}", flush=True)

    def launch(self) -> None:
        threads = [
            threading.Thread(target=self._load_frames, name="load_frames"),
            threading.Thread(target=self._calc_flows, name="calc_optflows"),
            threading.Thread(target=self._encode_save, name="encode_save"),
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if self.cfg.strict and self.errors:
            raise RuntimeError(self.errors[0].error)
