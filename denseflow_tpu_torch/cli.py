"""Command-line interface.

Flag-compatible with the reference (reference tools/denseflow.cpp:8-21),
including OpenCV CommandLineParser's `-key=value` syntax:

    denseflow <input> [-a=tvl1] [-s=1] [-b=32] [-o=dir] [-nw=0] [-nh=0]
              [-ns=0] [-cf] [-if] [-st=jpg] [-f] [-v]

plus extensions: --pairBatch, --chunkFrames, --strict,
--hostId/--numHosts (video-list sharding across hosts), --preset, --device.
The port of the JAX package's `denseflow_tpu/cli.py`: the same flags and
help; the flags whose features are not ported yet raise (config.UNPORTED).

    python -m denseflow_tpu_torch <video> -a=tvl1 -s=1 -b=20 -st=jpg -ns=256
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional, Tuple

from denseflow_tpu_torch import native
from denseflow_tpu_torch.config import FlowConfig
from denseflow_tpu_torch.extract_frames import extract_frames_only
from denseflow_tpu_torch.io.reader import expand_jobs
from denseflow_tpu_torch.pipeline import Pipeline
from denseflow_tpu_torch.utils import (
    Counters,
    current_seconds,
    format_summary,
    resolve_device,
)

HELP = """GPU optical flow extraction. (PyTorch + CUDA port of denseflow_tpu)
Usage: denseflow [params] input

    -h, --help
        print help message
    -a, --algorithm (value:tvl1)
        optical flow algorithm (nv/tvl1/farn/brox)
    -b, --bound (value:32)
        maximum of optical flow
    -cf, --classFolder
        outputDir/class/video/flow.jpg
    -f, --force
        regardless of the marked .done file
    -if, --inputFrames
        inputs are frames
    -nh, --newHeight (value:0)
        new height
    -ns, --newShort (value:0)
        short side length
    -nw, --newWidth (value:0)
        new width
    -o, --outputDir (value:.)
        root dir of output
    -s, --step (value:0)
        right - left (0 for img, non-0 for flow)
    -st, --saveType (value:jpg)
        save format type (jpg/png/h5)
    -v, --verbose
        verbose

    input
        filename of video or folder of frames or a list.txt of those

Extensions:
    --pairBatch (value:16)     frame pairs solved per kernel launch
    --chunkFrames (value:128)  max frames decoded per chunk
    --decodeWorkers (value:0)  decode threads for multi-video jobs
                               (0 = auto, 1 = serial like the reference)
    --strict                   abort the whole run on the first bad video
    --hostId / --numHosts      shard a videolist across hosts (manual)
    --distributed              not ported yet (ROADMAP.md A10)
    --coordinator=HOST:PORT    with --distributed (not ported yet)
    --preset (value:)          solver preset: default / fast / quality
    --devices (value:0)        GPUs to spread pair batches over; 0 or 1
                               (the first card), more not ported yet
    --profile=DIR              capture a torch.profiler trace into DIR
    --wirePack (value:1)       accepted, no effect: the payload crosses to
                               the host as it is, and the codecs of
                               denseflow_tpu are lossless, so the files are
                               the same
    --maxDisp (value:0)        finest-level displacement clamp in px
                               (0 = solver default 40); raise for very
                               fast motion at high resolution
    --h5Dtype (value:f32)      with -st=h5: f16 halves the flow's copy to
                               the host (lossy ~1e-3); datasets stay f32
    --widthBucket (value:0)    pad frame width up to a multiple of N on
                               device and crop host-side (0 = exact)
    --device (value:cuda)      torch device of the solver: cuda (the card)
                               or cpu (plain PyTorch versions of the
                               kernels)
"""

# short/long aliases -> (config field, type); bool fields are presence flags
_KEYS: Dict[str, Tuple[str, type]] = {
    "o": ("output_dir", str),
    "outputDir": ("output_dir", str),
    "a": ("algorithm", str),
    "algorithm": ("algorithm", str),
    "s": ("step", int),
    "step": ("step", int),
    "b": ("bound", int),
    "bound": ("bound", int),
    "nw": ("new_width", int),
    "newWidth": ("new_width", int),
    "nh": ("new_height", int),
    "newHeight": ("new_height", int),
    "ns": ("new_short", int),
    "newShort": ("new_short", int),
    "cf": ("has_class", bool),
    "classFolder": ("has_class", bool),
    "if": ("use_frames", bool),
    "inputFrames": ("use_frames", bool),
    "st": ("save_type", str),
    "saveType": ("save_type", str),
    "f": ("force", bool),
    "force": ("force", bool),
    "v": ("verbose", bool),
    "verbose": ("verbose", bool),
    "pairBatch": ("pair_batch", int),
    "chunkFrames": ("chunk_frames", int),
    "decodeWorkers": ("decode_workers", int),
    "strict": ("strict", bool),
    "hostId": ("host_id", int),
    "numHosts": ("num_hosts", int),
    "preset": ("preset", str),
    "devices": ("devices", int),
    "profile": ("profile_dir", str),
    "distributed": ("distributed", bool),
    "coordinator": ("coordinator", str),
    "wirePack": ("wire_pack", bool),
    "maxDisp": ("max_disp", int),
    "h5Dtype": ("h5_dtype", str),
    "widthBucket": ("width_bucket", int),
    "device": ("device", str),
}

_TRUE = ("", "true", "1", "yes")


def parse_args(argv: List[str]) -> Optional[FlowConfig]:
    """OpenCV-style parsing: `-key=value`, `--key=value`, bare `-flag`,
    positional input. Returns None if help was requested/needed."""
    cfg = FlowConfig()
    positional: List[str] = []
    for tok in argv:
        if tok in ("-h", "--h", "-help", "--help"):
            return None
        if tok.startswith("-"):
            body = tok.lstrip("-")
            key, _, val = body.partition("=")
            if key not in _KEYS:
                raise ValueError(f"unknown option: {tok}")
            field, typ = _KEYS[key]
            if typ is bool:
                setattr(cfg, field, val.lower() in _TRUE)
            else:
                if val == "" and "=" not in body:
                    raise ValueError(f"option {tok} needs =value")
                setattr(cfg, field, typ(val))
        else:
            positional.append(tok)
    if len(positional) != 1:
        return None
    cfg.input = positional[0]
    return cfg


def run(cfg: FlowConfig, stats_out: "dict | None" = None) -> int:
    """Execute a parsed config. stats_out (optional) receives run
    telemetry: per-stage wall times, counters, wall seconds and the writer
    that ran ("native, k threads", "cv2: <why>" or "h5py"), so a caller
    can attribute the headline number to stages without parsing stdout."""
    cfg.validate()
    if cfg.step != 0:
        resolve_device(cfg.device)  # no card for "cuda": raise before work
    jobs, is_record = expand_jobs(cfg)
    if not jobs:
        return 0
    cfg.validate_paths([j.video_path for j in jobs], [j.output_dir for j in jobs])

    prof = _start_profile(cfg) if cfg.profile_dir else None
    start_t = current_seconds()
    try:
        if cfg.step == 0:
            writer = native.describe()
            if cfg.verbose:
                print(f"writer: {writer}")
            counters = Counters()
            extract_frames_only(cfg, jobs, counters)
            errors: list = []
        else:
            pipe = Pipeline(cfg, jobs, is_record)
            pipe.launch()
            writer = pipe.writer
            counters = pipe.counters
            errors = pipe.errors
            if cfg.verbose and pipe.timers.totals:
                print(f"stage times: {pipe.timers.summary()}")
            if stats_out is not None:
                stats_out["stage_times"] = dict(pipe.timers.totals)
        end_t = current_seconds()
    finally:
        if prof is not None:
            _stop_profile(prof, cfg.profile_dir)
    if stats_out is not None:
        stats_out["counters"] = counters
        stats_out["wall_s"] = end_t - start_t
        stats_out["errors"] = list(errors)
        stats_out["writer"] = writer
    n_videos, n_frames, n_flows = len(jobs), counters.total_frames, counters.total_flows
    print(
        format_summary(
            n_videos, n_frames, n_flows, cfg.algorithm, end_t - start_t
        )
    )
    if errors:
        print(f"{len(errors)} video(s) failed:", file=sys.stderr)
        for e in errors:
            print(f"  {e.video_path}: {e.error.splitlines()[-1]}", file=sys.stderr)
        return 1
    return 0


def _start_profile(cfg: FlowConfig):
    """torch.profiler over the run; CUDA activity when solving on a card."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if cfg.step != 0 and resolve_device(cfg.device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _stop_profile(prof, profile_dir: str) -> None:
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        cfg = parse_args(argv)
        if cfg is None or not cfg.input:
            print(HELP)
            return 0
        return run(cfg)
    except Exception as e:
        print(e)
        return 1


if __name__ == "__main__":
    sys.exit(main())
