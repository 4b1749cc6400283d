"""The step==0 path: frame extraction (no flow, no pipeline).

Mirrors the reference's extract_frames_only / extract_frames_video
(reference src/denseflow_gpu.cpp:82-144): decode in color, optional resize,
jpg-encode, write `img_%05d.jpg`. Never touches the device. Each batch of
frames is encoded by the native emitter's worker pool where it is built,
else one by one with cv2.
"""

from __future__ import annotations

from typing import List

import numpy as np

from denseflow_tpu_torch import native
from denseflow_tpu_torch.config import FlowConfig
from denseflow_tpu_torch.io.reader import EmptyFolderError, Job, open_source
from denseflow_tpu_torch.io.writer import encode_jpg, write_images
from denseflow_tpu_torch.utils import Counters


def extract_frames_only(cfg: FlowConfig, jobs: List[Job], counters: Counters) -> None:
    native_ok = native.available()
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
            if native_ok and frames:
                paths = [f"{job.output_dir}/img_{idx + i:05d}.jpg"
                         for i in range(len(frames))]
                native.write_jpg_color_batch(np.stack(frames), paths)
            else:
                imgs = [encode_jpg(f) for f in frames]
                write_images(imgs, f"{job.output_dir}/img", idx)
            idx += len(frames)
            if not is_open:
                break
        src.close()
        counters.add_frames(idx)
        counters.add_videos()
        if cfg.verbose:
            print(f"extracted frames of video {job.video_path}, {idx} frames")
