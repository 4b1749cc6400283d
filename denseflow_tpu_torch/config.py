"""Job configuration + validation.

Mirrors the reference's flag surface (reference tools/denseflow.cpp:8-21) and
its parameter validation matrix (reference src/denseflow_gpu.cpp:9-42), as a
dataclass instead of an OpenCV CommandLineParser. The fields and error
strings are those of the JAX package's `denseflow_tpu/config.py`; `device`
is new.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

ALGORITHMS = ("nv", "tvl1", "farn", "brox")
SAVE_TYPES = ("jpg", "png", "h5")


@dataclasses.dataclass
class FlowConfig:
    """Everything needed to run one extraction job.

    Defaults are byte-compatible with the reference CLI defaults
    (reference tools/denseflow.cpp:8-21): algorithm=tvl1 (the CLI default
    value of `-a`), step=0, bound=32, saveType=jpg, outputDir=".",
    new sizes all 0.
    """

    input: str = ""
    output_dir: str = "."
    algorithm: str = "tvl1"
    step: int = 0
    bound: int = 32
    new_width: int = 0
    new_height: int = 0
    new_short: int = 0
    has_class: bool = False
    use_frames: bool = False
    save_type: str = "jpg"
    force: bool = False
    verbose: bool = False

    # --- extensions over the reference (all optional, defaults match it) ---
    # Frame pairs solved per kernel launch (the reference solves pairs one
    # at a time, reference src/denseflow_gpu.cpp:313-341). Chunk pair
    # counts are bucketed to pair_batch * 2^k.
    pair_batch: int = 16
    # Max frames decoded per chunk (the reference uses 512,
    # reference include/dense_flow.h:95); smaller chunks let the decode /
    # compute / encode stages overlap on short videos.
    chunk_frames: int = 128
    # Decode worker threads for multi-video jobs (0 = auto, 1 = serial like
    # the reference). Each video stays on one worker.
    decode_workers: int = 0
    # Continue past a broken video instead of aborting the whole list job;
    # `strict=True` restores the reference's abort.
    strict: bool = False
    # Solver-hyperparameter preset: default (reference-exact) / fast /
    # quality — see algorithms.solver_params.
    preset: Optional[str] = None
    # Local devices to spread each pair batch over (0 = all local devices,
    # N = the first N of them; executor.DeviceExecutor).
    devices: int = 0
    # Lossless wire codecs for the device->host payload (wire.py): v3 for
    # jpg/png, v4 for h5 float32; the files are the same either way. Off by
    # default, unlike the JAX package's: the codecs exist for a slow remote
    # device link, and over a card's PCIe they add host decode work to a
    # wall that the host's decode and encode already hold.
    wire_pack: bool = False
    # Capture a torch.profiler trace of the run into this directory.
    profile_dir: Optional[str] = None
    # Host-side sharding (multi-process): assign videos round-robin by index.
    host_id: int = 0
    num_hosts: int = 1
    # Join a torch.distributed (gloo) group: host id and count come from it
    # (parallel.distributed.init_distributed), host 0 prints the global
    # summary; `coordinator` is host 0's HOST:PORT.
    distributed: bool = False
    coordinator: str = ""
    # Finest-level displacement clamp (px) of the solver's warp; 0 = the
    # solver default (40).
    max_disp: int = 0
    # Precision of the h5 flow's copy to the host: "f32", or "f16" (cast on
    # the device, widened back on the host; datasets stay float32).
    h5_dtype: str = "f32"
    # Pad frame WIDTH up to a multiple of this before the device solve and
    # crop the payload back host-side (0 = off, exact geometry).
    width_bucket: int = 0
    # Torch device the solver runs on: "cuda" (the card; raises when there
    # is none) or "cpu" (the kernels' plain PyTorch versions).
    device: str = "cuda"

    def validate(self) -> None:
        """Raise ValueError on any violation of the reference's rules
        (reference src/denseflow_gpu.cpp:9-42)."""
        if self.algorithm not in ALGORITHMS:
            raise ValueError(f"{self.algorithm} not supported!")
        if self.bound <= 0:
            raise ValueError("bound should > 0!")
        if self.new_height < 0 or self.new_width < 0 or self.new_short < 0:
            raise ValueError("height and width cannot < 0!")
        if self.new_short > 0 and self.new_height + self.new_width != 0:
            raise ValueError("do not set height and width when set short!")
        if self.save_type not in SAVE_TYPES:
            raise ValueError(
                f"only jpg/png/h5 are supported (no {self.save_type}) for output"
            )
        if self.pair_batch <= 0:
            raise ValueError("pair_batch should > 0!")
        if self.devices < 0:
            raise ValueError("devices cannot < 0!")
        if self.max_disp < 0:
            raise ValueError("maxDisp cannot < 0!")
        if self.h5_dtype not in ("f32", "f16"):
            raise ValueError("h5Dtype must be f32 or f16!")
        if self.width_bucket < 0:
            raise ValueError("widthBucket cannot < 0!")
        if self.preset:
            from denseflow_tpu_torch.algorithms import solver_params

            solver_params(self.algorithm, self.preset)  # raises on unknown
        if self.chunk_frames <= abs(self.step):
            raise ValueError("chunk_frames must exceed |step|")
        if not (0 <= self.host_id < self.num_hosts):
            raise ValueError("host_id must be in [0, num_hosts)")

    def validate_paths(self, video_paths, output_dirs) -> None:
        """Path checks, mirroring reference src/denseflow_gpu.cpp:10-19."""
        for vp, od in zip(video_paths, output_dirs):
            if not os.path.exists(vp):
                raise ValueError(f"{vp} does not exist!")
            if not os.path.isdir(od):
                raise ValueError(f"{od} is not a valid dir!")
