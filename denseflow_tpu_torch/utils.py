"""Timing, counters, verbose logging, and device resolution.

The reference's observability surface (reference src/utils.cpp:22-26,
src/denseflow_gpu.cpp:492-496): wall-clock seconds, per-run frame/flow
counters, a final throughput summary, and `-v` queue-event tracing, kept
exactly as the JAX package's `denseflow_tpu/utils.py` has them, plus
per-stage timers.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager

import torch


def current_seconds() -> float:
    return time.time()


def resolve_device(name: str) -> torch.device:
    """The torch device for `name`. Asking for CUDA on a machine without a
    card raises: nothing falls back to the CPU quietly."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but no CUDA device is available; "
            "pass device='cpu' (--device=cpu) to run the plain PyTorch path"
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def local_devices(name: str) -> "list[torch.device]":
    """The devices `name` stands for, in index order: "cuda" every visible
    card, "cuda:k" that card, "cpu" the CPU (raises as `resolve_device`)."""
    dev = resolve_device(name)
    if dev.type == "cuda" and torch.device(name).index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


class Counters:
    """Thread-safe run counters (total_frames / total_flows, like the
    reference's DenseFlow members)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.total_frames = 0
        self.total_flows = 0
        self.total_videos = 0

    def add_frames(self, n: int) -> None:
        with self._lock:
            self.total_frames += n

    def add_flows(self, n: int) -> None:
        with self._lock:
            self.total_flows += n

    def add_videos(self, n: int = 1) -> None:
        with self._lock:
            self.total_videos += n


class StageTimers:
    """Cumulative per-stage wall time (decode / compute / encode), an
    extension over the reference's single end-to-end timer."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.totals: dict[str, float] = defaultdict(float)

    @contextmanager
    def track(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[stage] += dt

    def summary(self) -> str:
        with self._lock:
            return ", ".join(f"{k} {v:.2f}s" for k, v in sorted(self.totals.items()))


class VerboseLog:
    """Gated print, matching the reference's `-v` tracing of queue events."""

    def __init__(self, enabled: bool) -> None:
        self.enabled = enabled
        self._lock = threading.Lock()

    def __call__(self, msg: str) -> None:
        if self.enabled:
            with self._lock:
                print(msg, flush=True)


def format_summary(
    n_videos: int, n_frames: int, n_flows: int, algorithm: str, seconds: float
) -> str:
    """The reference's end-of-run line (src/denseflow_gpu.cpp:494-496)."""
    secs = max(seconds, 1e-9)
    return (
        f"{n_videos} videos ({n_frames} frames, {n_flows} {algorithm} flows) "
        f"processed, using {seconds:.6g}s, decoding speed "
        f"{n_frames / secs:.6g}fps, flow speed {n_flows / secs:.6g}fps"
    )
