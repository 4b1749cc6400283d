"""Command-line interface.

Flag-compatible with the reference (reference tools/denseflow.cpp:8-21),
including OpenCV CommandLineParser's `-key=value` syntax:

    denseflow <input> [-a=tvl1] [-s=1] [-b=32] [-o=dir] [-nw=0] [-nh=0]
              [-ns=0] [-cf] [-if] [-st=jpg] [-f] [-v]

plus extensions: --pairBatch, --chunkFrames, --strict,
--hostId/--numHosts (video-list sharding across hosts), --distributed,
--devices, --preset, --wirePack, --device. The port of the JAX package's
`denseflow_tpu/cli.py`: the same flags and help.

    python -m denseflow_tpu_torch <video> -a=tvl1 -s=1 -b=20 -st=jpg -ns=256
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional, Tuple

from denseflow_tpu_torch import native
from denseflow_tpu_torch.config import FlowConfig
from denseflow_tpu_torch.executor import WIRE_STATS
from denseflow_tpu_torch.extract_frames import extract_frames_only
from denseflow_tpu_torch.io.reader import expand_jobs
from denseflow_tpu_torch.parallel.distributed import (
    allreduce_counters,
    init_distributed,
    shutdown_distributed,
)
from denseflow_tpu_torch.pipeline import Pipeline
from denseflow_tpu_torch.utils import (
    Counters,
    current_seconds,
    format_summary,
    resolve_device,
)
from denseflow_tpu_torch.wire import decoder as wire_decoder

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
    --distributed              join a torch.distributed group (gloo): host
                               id / count come from DENSEFLOW_NUM_PROCESSES
                               and DENSEFLOW_PROCESS_ID with --coordinator,
                               or from torchrun (WORLD_SIZE, RANK,
                               MASTER_ADDR, MASTER_PORT); the videolist is
                               sharded automatically, and host 0 prints the
                               global summary (one counter all-reduce)
    --coordinator=HOST:PORT    host 0's address for --distributed with
                               DENSEFLOW_NUM_PROCESSES
    --preset (value:)          solver preset: default / fast / quality
    --devices (value:0)        local GPUs to split each pair batch over
                               (0 = all local devices); more than one is
                               not faster yet (one host thread enqueues
                               every card's sub-slabs): --devices=1 keeps
                               one card's speed
    --profile=DIR              capture a torch.profiler trace into DIR
    --wirePack (value:0)       lossless packing of the payload on the card
                               before its copy to the host (v3 for jpg/png,
                               v4 for h5 f32; same files). Off by default,
                               unlike denseflow_tpu's 1: the codecs are for
                               a slow remote device link, and over PCIe
                               they add host decode work to a wall the
                               host's decode and encode already hold
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
    telemetry: per-stage wall times, counters, wall seconds, the writer
    that ran ("native, k threads", "cv2: <why>" or "h5py"), the devices
    the pairs were split over and, for a flow run, the wire codec that ran
    (`wire`: codec "v3", "v4" or "raw", its host decoder, and this run's
    bytes and copies up and down and raw fallbacks), so a caller can
    attribute the headline number to stages without parsing stdout."""
    cfg.validate()
    if cfg.step != 0:
        resolve_device(cfg.device)  # no card for "cuda": raise before work
    if not cfg.distributed:
        return _run(cfg, stats_out)
    cfg.host_id, cfg.num_hosts = init_distributed(
        coordinator_address=cfg.coordinator or None
    )
    try:
        return _run(cfg, stats_out)
    finally:
        shutdown_distributed()


def _run(cfg: FlowConfig, stats_out: "dict | None") -> int:
    """`run` after validation and, with --distributed, inside the group."""
    jobs, is_record = expand_jobs(cfg)
    if not jobs and not cfg.distributed:
        return 0
    # distributed: a host with an empty shard must still run to the final
    # counter all-reduce — every host takes part in the collective
    cfg.validate_paths([j.video_path for j in jobs], [j.output_dir for j in jobs])

    prof = _start_profile(cfg) if cfg.profile_dir else None
    start_t = current_seconds()
    wire = None
    try:
        if cfg.step == 0:
            writer = native.describe()
            if cfg.verbose:
                print(f"writer: {writer}")
            counters = Counters()
            extract_frames_only(cfg, jobs, counters)
            errors: list = []
            devices: list = []
        else:
            link0 = WIRE_STATS.snapshot()
            pipe = Pipeline(cfg, jobs, is_record)
            pipe.launch()
            writer = pipe.writer
            devices = [str(d) for d in pipe.devices]
            counters = pipe.counters
            errors = pipe.errors
            wire = _wire_stats(pipe.codec, link0)
            if cfg.verbose and pipe.timers.totals:
                print(f"stage times: {pipe.timers.summary()}")
            if cfg.verbose:
                print(f"wire: {wire['codec']} (decoder {wire['decoder']}), "
                      f"{wire['d2h_bytes']} bytes down in {wire['d2h_calls']} "
                      f"copies, {wire['fallbacks']} raw fallbacks")
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
        stats_out["devices"] = devices
        stats_out["wire"] = wire
    n_videos, n_frames, n_flows = len(jobs), counters.total_frames, counters.total_flows
    print_it = True
    if cfg.distributed:
        n_videos, n_frames, n_flows = allreduce_counters(counters)
        # the global summary once, from host 0 — and like the reference,
        # nothing prints when nothing ran anywhere (all videos .done)
        print_it = cfg.host_id == 0 and (n_videos > 0 or not is_record)
    if print_it:
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


def _wire_stats(codec: "str | None", link0: dict) -> dict:
    """The run's wire record: the codec the executors ran ("v3", "v4",
    "raw"; None when no chunk ran), the host decoder of a packed codec,
    and WIRE_STATS' counts since `link0`."""
    link = WIRE_STATS.snapshot()
    out = {k: link[k] - link0[k] for k in link}
    out["codec"] = codec
    out["decoder"] = wire_decoder() if codec in ("v3", "v4") else "none"
    return out


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
