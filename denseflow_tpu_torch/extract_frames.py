"""The step==0 path: frame extraction (no flow, no pipeline).

Mirrors the reference's extract_frames_only / extract_frames_video
(reference src/denseflow_gpu.cpp:82-144): decode in color, optional resize,
jpg-encode, write `img_%05d.jpg`. Never touches the device. Each batch of
frames is encoded by the native emitter's worker pool where it is built,
else by cv2 on a pool of `native.DEFAULT_THREADS` worker threads.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np

from denseflow_tpu_torch import native
from denseflow_tpu_torch.config import FlowConfig
from denseflow_tpu_torch.io.reader import EmptyFolderError, Job, open_source
from denseflow_tpu_torch.io.writer import write_batch
from denseflow_tpu_torch.utils import Counters


def extract_frames_only(cfg: FlowConfig, jobs: List[Job], counters: Counters) -> None:
    pool = (None if native.available()
            else ThreadPoolExecutor(native.DEFAULT_THREADS, thread_name_prefix="encode"))
    try:
        for job in jobs:
            try:
                src = open_source(job.video_path, cfg)
            except EmptyFolderError as e:
                if cfg.verbose:
                    print(e)
                continue
            if cfg.verbose:
                print(f"{job.video_path}, frames ≈ {src.approx_frames}")
            idx = 0
            while True:
                frames, is_open = src.read_batch(to_gray=False, max_frames=cfg.chunk_frames)
                paths = [f"{job.output_dir}/img_{idx + i:05d}.jpg"
                         for i in range(len(frames))]
                if pool is not None:
                    write_batch(frames, paths, pool)
                elif frames:
                    native.write_jpg_color_batch(np.stack(frames), paths)
                idx += len(frames)
                if not is_open:
                    break
            src.close()
            counters.add_frames(idx)
            counters.add_videos()
            if cfg.verbose:
                print(f"extracted frames of video {job.video_path}, {idx} frames")
    finally:
        if pool is not None:
            pool.shutdown()
