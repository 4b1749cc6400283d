"""Ingest: video / frame-folder sources, chunked batch loading with halo
carry, and job expansion with `.done` resume filtering.

Re-designs the reference's decode thread (reference
src/denseflow_gpu.cpp:146-280) and its CLI job expansion (reference
tools/denseflow.cpp:51-91):

* `VideoSource` / `FrameFolderSource` decode ≤ chunk_frames gray (or color)
  frames per call via cv2 (FFmpeg) — the host-side hot loop;
* `chunks()` carries the last |step| frames of each chunk into the next as
  halo padding (the reference's `frames_gray_padding`,
  src/denseflow_gpu.cpp:182-216) so pairs spanning chunk boundaries are
  computed exactly;
* `expand_jobs` reads a videolist.txt, computes per-video output dirs and
  `.done` markers, and skips completed videos unless forced.

A copy of the JAX package's `denseflow_tpu/io/reader.py`, with the
host-side `compute_new_size` kept here (the JAX package keeps it in
`ops/resize.py`, which imports jax).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import cv2
import numpy as np

from denseflow_tpu_torch.io.writer import done_paths


def compute_new_size(
    width: int,
    height: int,
    new_width: int = 0,
    new_height: int = 0,
    new_short: int = 0,
) -> Optional[Tuple[int, int]]:
    """Return (new_w, new_h) or None for "no resize": the priority table of
    the reference's `get_new_size` (reference src/denseflow_gpu.cpp:44-80):
    (nw,nh) both set > nw-only keep-aspect > nh-only keep-aspect > ns
    short-side (only when min(w,h) > ns — never upscale) > no resize."""
    if new_width > 0 and new_height > 0:
        return new_width, new_height
    if new_width > 0 and new_height == 0:
        return new_width, int(round(height * 1.0 / width * new_width))
    if new_width == 0 and new_height > 0:
        return int(round(width * 1.0 / height * new_height)), new_height
    if new_short > 0 and min(width, height) > new_short:
        if width < height:
            return new_short, int(round(height * 1.0 / width * new_short))
        return int(round(width * 1.0 / height * new_short)), new_short
    return None


@dataclass
class Chunk:
    """One decoded chunk: (N, H, W) gray uint8 (or (N, H, W, 3) color),
    including `halo` leading frames carried from the previous chunk.
    `base_start` is the flow index of the first pair in this chunk."""

    frames: np.ndarray
    base_start: int
    last: bool
    halo: int


class _Source:
    """Common chunked-read logic over an abstract per-frame reader."""

    def __init__(self, do_resize: Optional[Tuple[int, int]], chunk_frames: int):
        self.new_size = do_resize  # (w, h) or None
        self.chunk_frames = chunk_frames

    # subclasses: _read_frame() -> Optional[np.ndarray (H,W,3) BGR]
    def _read_frame(self) -> Optional[np.ndarray]:  # pragma: no cover
        raise NotImplementedError

    def read_batch(self, to_gray: bool, max_frames: int) -> Tuple[List[np.ndarray], bool]:
        """Read up to max_frames; returns (frames, is_open). Matches the
        reference's load_frames_batch contract (src/denseflow_gpu.cpp:146-177):
        is_open=False means the source is exhausted."""
        out: List[np.ndarray] = []
        while len(out) < max_frames:
            frame = self._read_frame()
            if frame is None:
                return out, False
            if to_gray:
                frame = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
            if self.new_size is not None:
                frame = cv2.resize(frame, self.new_size)
            out.append(frame)
        return out, True

    def chunks(self, step: int, to_gray: bool = True) -> Iterator[Chunk]:
        """Yield halo-padded chunks covering every frame pair exactly once."""
        halo_n = abs(step)
        padding: List[np.ndarray] = []
        base_start = 0
        while True:
            frames, is_open = self.read_batch(to_gray, self.chunk_frames)
            padded = padding + frames
            yield Chunk(
                frames=np.stack(padded) if padded else np.empty((0,), np.uint8),
                base_start=base_start,
                last=not is_open,
                halo=len(padding),
            )
            if not is_open:
                return
            padding = padded[len(padded) - halo_n:] if halo_n else []
            base_start += len(padded) - halo_n

    def close(self) -> None:
        pass


class VideoSource(_Source):
    def __init__(self, path: str, cfg) -> None:
        self.cap = cv2.VideoCapture(str(path))
        if not self.cap.isOpened():
            raise RuntimeError(f"cannot open video_path stream:{path}")
        w = int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        h = int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self.approx_frames = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))
        new_size = compute_new_size(w, h, cfg.new_width, cfg.new_height, cfg.new_short)
        super().__init__(new_size, cfg.chunk_frames)
        self.size = new_size or (w, h)

    def _read_frame(self) -> Optional[np.ndarray]:
        ok, frame = self.cap.read()
        return frame if ok else None

    def close(self) -> None:
        self.cap.release()


class FrameFolderSource(_Source):
    """Reads sorted `.jpg` frames from a folder (the `-if` input mode,
    reference src/denseflow_gpu.cpp:246-258)."""

    def __init__(self, path: str, cfg) -> None:
        self.paths = sorted(
            p for p in Path(path).iterdir() if p.is_file() and p.suffix == ".jpg"
        )
        if not self.paths:
            raise EmptyFolderError(f"{path} is empty!")
        self.pos = 0
        self.approx_frames = len(self.paths)
        first = cv2.imread(str(self.paths[0]), cv2.IMREAD_COLOR)
        h, w = first.shape[:2]
        new_size = compute_new_size(w, h, cfg.new_width, cfg.new_height, cfg.new_short)
        super().__init__(new_size, cfg.chunk_frames)
        self.size = new_size or (w, h)

    def _read_frame(self) -> Optional[np.ndarray]:
        if self.pos >= len(self.paths):
            return None
        frame = cv2.imread(str(self.paths[self.pos]), cv2.IMREAD_COLOR)
        self.pos += 1
        return frame


class EmptyFolderError(RuntimeError):
    """Empty frame folder — skipped with a message, not fatal
    (reference src/denseflow_gpu.cpp:253-257)."""


def open_source(path: str, cfg) -> _Source:
    if cfg.use_frames:
        return FrameFolderSource(path, cfg)
    return VideoSource(path, cfg)


@dataclass
class Job:
    video_path: str
    output_dir: str


def expand_jobs(cfg) -> Tuple[List[Job], bool]:
    """Expand the input into per-video jobs.

    Returns (jobs, is_record). is_record=True for list mode, where `.done`
    markers are honored/written (reference tools/denseflow.cpp:51-91).
    Videos are additionally sharded round-robin across hosts when
    cfg.num_hosts > 1 (the reference's manual split-the-list workflow made
    first-class).
    """
    input_path = Path(cfg.input)
    jobs: List[Job] = []
    if input_path.suffix == ".txt":
        with open(input_path) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        for i, line in enumerate(lines):
            # shard on the ORIGINAL list index, BEFORE the resume filter:
            # the partition must be a pure function of the list so that
            # shards racing each other's fresh `.done` markers (or a shard
            # restarted mid-fleet) still agree on who owns which video —
            # filter-dependent sharding can orphan a video or assign it to
            # two hosts at once. Same static-split semantics as the
            # reference's split-the-list workflow (reference README.md:11).
            if i % cfg.num_hosts != cfg.host_id:
                continue
            outdir, donedir, donefile = done_paths(cfg.output_dir, line, cfg.has_class)
            if not cfg.force and os.path.isfile(donefile):
                if cfg.verbose:
                    print(f"skip {Path(line).parent.name}/{Path(line).stem}")
                continue
            os.makedirs(outdir, exist_ok=True)
            os.makedirs(donedir, exist_ok=True)
            jobs.append(Job(line, outdir))
        return jobs, True
    outdir = str(Path(cfg.output_dir) / input_path.stem)
    os.makedirs(outdir, exist_ok=True)
    return [Job(str(input_path), outdir)], False
