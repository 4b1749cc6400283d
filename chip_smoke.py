"""Drive denseflow_tpu_torch on one CUDA card and check what comes out.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero):

1. environment: torch / CUDA versions, the card's name and power limit;
2. build every kernel from csrc/ (one nvcc per source, started together)
   and print the build time;
3. each kernel against its plain PyTorch version, on the card: at every
   pyramid scale of one main-path slab (16 pairs of the bench video,
   decoded and resized to 256x341 by the port's reader, through the port's
   `tvl1_flow`), with the kernel's plan (CTAs a pair, placement, shared
   memory, clusters the card holds at once), each pair's iterations and
   warps equal to the plain version's, timed with CUDA events beside its
   bound and beside the plans it did not pick; then at an odd shape, with a
   flow beyond the displacement clamp, and at 360x480 (B=2) and 1080x1920
   (B=1), where the state lies in device memory, each pair alone against
   its batch;
4. full-width fidelity: the port's TVL1 on the repo's goldens
   (tests/golden/*.npz), mean EPE <= 0.5 px against the oracle and the
   analytic flow, the repo's gate (tests/test_fidelity.py);
5. the main path end to end through the CLI's `run`:
   `-a=tvl1 -s=1 -b=20 -st=jpg -ns=256 --strict` on a 500-frame 360x480
   MJPG, with the kernels' launch counts set to 0 before it and read after;
6. auto-escalation: motion past the default 40 px clamp makes the pipeline
   re-solve at maxDisp 80 and 1020 and track it;
7. Farneback's two kernels against their plain versions, as in phase 3:
   one farn slab of the same 16 pairs, bit-equal: `poly_expand`'s one call
   for all six levels, timed beside its bound and beside one
   `torch.nn.functional.conv2d` a level that computes the same function,
   and each of the six `farneback_level` calls with its plan (CTAs a pair,
   placement, shared memory, clusters at once), each pair's iterations
   equal to the plain version's, timed beside its bound and, at 32x43,
   64x85, 128x170 and 256x341, beside the plans it did not take (each
   kernel timed with its launches queued behind a sleep kernel, so that
   the host's enqueue does not pace it, and back to back); one
   `farneback_flow` slab's card work against its kernels alone and
   against the host's time to enqueue it; then an odd shape, the coarsest level
   (8x11), a flow past the clamp, 360x480 (B=2) and 1080x1920 (B=1), each
   image and pair alone against its batch; and the slab run again with
   TF32 switched on by the caller, which must give the same bytes;
8. Farneback fidelity at full width: mean EPE <= 0.5 px on three analytic
   goldens (tests/test_fidelity.py:52-64) and the cv2 gate
   (tests/test_solvers.py:91-98);
9. the farn path end to end, as phase 5:
   `-a=farn -s=1 -b=20 -st=jpg -ns=256 --strict`, with one `poly_expand`
   and six `farneback_level` launches a slab;
10. Brox's level kernel against its plain version, as in phase 3: every
    level call of one brox slab of the same 16 pairs (13 levels, 256x341 down
    to 18x23, the reference's full budget of 77 x 10 x 10 with stop_eps
    1e-3), with the kernel's plan (CTAs a pair, placement, shared memory,
    clusters the card holds at once), each pair's counts (warps, inner
    steps, Jacobi sweeps) equal to the plain version's, timed beside its
    bound and, at 18x23, 54x72, 105x140, 131x175 and 205x273, beside the
    plans it did not take; then an odd shape, the coarsest level, a flow past the
    clamp, a stop_eps=0 case and 360x480 (B=2, device memory) at a reduced
    budget, each pair alone against its batch;
11. Brox fidelity at the full budget: mean EPE <= 0.5 px on the four
    analytic goldens (tests/test_fidelity.py:67-77) and a central EPE under
    0.2 px on the 64x80 translation (tests/test_solvers.py:108-117);
12. the brox path end to end, as phase 5:
    `-a=brox -s=1 -b=20 -st=jpg -ns=256 --strict`;
13. the native emitter on this machine: the g++, libjpeg and libpng
    versions, the CPU count and the emitter's threads; the emitter must
    build where the headers are (where they are not, phases 5, 9, 12 and 14
    print `writer cv2`); 998 textured 256x341 gray planes written by cv2
    one by one, by cv2's `write_batch` on the emitter's thread count (the
    writer where the emitter does not build; byte-equal to one by one) and,
    where the emitter built, by `write_jpg_batch`, each timed, each native
    jpg checked against tests/test_native.py's
    tolerances and against cv2's bytes; 256x341 colour jpgs and lossless
    pngs;
14. the png and h5 save types end to end, as phase 5 with `-st=png`,
    `-st=h5` and `-st=h5 --h5Dtype=f16`: 499 pngs or 998 float32 datasets
    by the JAX package's names, 160 `tvl1_scale` launches each, the centre
    flow (decoded with the port's `dequantize_flow_png`, or read from the
    h5) within 0.3 px of the content's motion, f16 within 2e-2 px of f32;
15. `--devices`: the tvl1, farn and brox executors on a 64-pair chunk of the
    bench video at 256x341, jpg and h5, one device against its slabs split
    over shards: 2 and all cards where there are two or more, else 2 and 4
    shards on the one card (a check of the split, not a multi-GPU run).
    jpg bytes must be identical, the h5 flow bit-equal, and each kernel's
    launches shards x the one-device count; each run's wall time is
    printed. With two cards or more, also the CLI's `--devices=0` against
    `--devices=1` on the 500-frame video, file for file;
16. `--distributed`: two processes of `python -m denseflow_tpu_torch` in
    one gloo group on 127.0.0.1 (DENSEFLOW_NUM_PROCESSES=2), on the card,
    over a list of two 100-frame cuts of the bench video: disjoint shards,
    both `.done` markers, one summary from host 0 with the global counts,
    and files byte-identical to one process running the list;
17. the wire codecs (`--wirePack=1`): the native decoder built with g++
    alone (its build time and the decoder that runs); the main path's
    first chunk (127 pairs bucketed to 128, 256x341) through the tvl1
    executor, jpg and png (v3) and h5 (v4): the card's pack equal to the
    CPU pack of the same payload in bytes and in `used`, the native and
    NumPy decodes equal to the raw payload, pack ms (CUDA events), raw
    bytes against used, decode ms and one chunk's wall with --wirePack 0
    and 1 (perf_counter); v4 on 128 pairs of 1080x1920 float32 noise,
    whose `used` passes 2^31, bit-exact through the native decoder; and
    the CLI with --wirePack=1 on the 500-frame video: the 998 jpgs of
    phase 5 and the 499 pngs of --wirePack=0, file for file, with the
    codec, decoder, bytes down and raw fallbacks of each run.

Phases 5, 9, 12 and 14 print the writer that ran beside the stage times.
Each phase prints its wall time. Every run of the CLI but phase 15's
passes --devices=1, so the launch counts are one card's on any host.

The last three lines are the card's name and power limit, the kernels'
JSON record (each kernel's launches counted on its own path's run) and
{"ok": true, "device": {...}}. Without a CUDA device, or
without the package beside it, the script exits non-zero and prints no
result. It imports neither jax nor denseflow_tpu.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
N_FRAMES = 500  # frames of the main path's video (bench.py:37)
CHUNK_FRAMES = 128  # FlowConfig.chunk_frames, the main path's default
PAIR_BATCH = 16  # FlowConfig.pair_batch, the main path's default
# the CLI's runs stay on the first card, where --devices=0 would split each
# slab over every card there is; phase 15 holds the multi-card split
ONE_CARD = "--devices=1"
GATE = 0.5  # px, mean EPE (tests/test_fidelity.py)
KERNEL_TOL = 1e-3  # px, mean |du| of the kernel vs its plain version
POLY_TOL = 1e-3  # max |d| of the poly_expand coefficients vs the plain version

# Published H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# f32 operations the TVL1 scale does per pixel, counted from
# csrc/tvl1_scale.cu: one primal-dual iteration (23 primal + 30 dual; the
# epsilon sum adds 7 on one iteration in check_every) and one warp (two
# 4-tap bicubic passes of ~110 each plus ~14 for the warp constants).
TVL1_OPS_PER_PX_ITER = 53
TVL1_OPS_PER_PX_WARP = 235

# f32 operations per pixel of the Brox level, counted from
# csrc/brox_scale.cu: one Jacobi sweep (the two weighted Laplacians 13 each,
# the two updates 5 each); one inner step besides its sweeps (psi_s: four
# _D5 gradients of u + du 44, the sum and 1/sqrt 10; psi_d, the weights and
# the 2x2 system 75; the inner stop sum 6); one warp (two 4-tap bicubic
# passes of ~111 each, the derivative planes 23, u += du and the stop 6);
# the level's four _D5 image gradients, once a call. The interface weights,
# which the kernel recomputes each sweep from psi_s, count once a step.
BROX_OPS_PER_PX_SWEEP = 36
BROX_OPS_PER_PX_INNER = 135
BROX_OPS_PER_PX_WARP = 252
BROX_OPS_PER_PX_LEVEL = 28

# f32 operations per pixel of Farneback's kernels, counted from
# csrc/farneback_polyexp.cu (poly_n = 5, 11 taps: the vertical pass 3 x 21,
# the horizontal passes 6 x 21, the combination 13) and csrc/farneback_level.cu
# (one iteration: the M stage 163 = three linear tap setups 66, the
# five-plane warp 60, normal equations 37; the column and row 13-tap box
# sums 85 each, 17 a plane: 12 adds of the cascade, the two edge terms and
# the 1/win; the solve and the stop sum 19).
OPS_PER_PX_POLY = 202
OPS_PER_PX_LEVEL_ITER = 352
CV2_GATE = (0.02, 0.05)  # px, interior and whole mean EPE vs OpenCV


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean time of fn() on the card over `reps` back-to-back runs, after
    one warm-up (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps: int):
    """(card ms, host ms) of one fn() over `reps` runs enqueued behind a
    sleep kernel, after one warm-up: the card's time between CUDA events
    with the launches already queued, so the host's enqueue cannot pace
    it, and the host's time to enqueue one run."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(400_000_000)  # ~0.2 s at the H100's clock
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    host = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host


def tvl1_bound_ms(counts, h: int, w: int):
    """(bytes time, operations time) in ms of one tvl1_scale call: 6 input
    planes read once and 2 output planes written once, and the f32
    operations of the iterations and warps these pairs ran (`counts`)."""
    n_px = h * w
    nbytes = 8 * counts.shape[0] * n_px * 4
    ops = float((counts[:, 0].double() * TVL1_OPS_PER_PX_ITER
                 + counts[:, 1].double() * TVL1_OPS_PER_PX_WARP).sum()) * n_px
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3


def make_bench_video(path: Path, n_frames: int, first: int = 0) -> None:
    """The bench video recipe (bench.py:41-59): 360x480 MJPG whose content
    moves -2 px per frame horizontally; frames first .. first + n_frames - 1
    of its N_FRAMES."""
    import cv2
    import scipy.ndimage as ndi

    h_src, w_src = 360, 480
    rng = np.random.default_rng(0)
    pad = 2 * N_FRAMES + 8
    base = ndi.gaussian_filter(
        rng.uniform(0, 255, (h_src + 16, w_src + pad)), 2.0
    ).astype(np.float32)
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 25, (w_src, h_src))
    if not vw.isOpened():
        raise RuntimeError("cannot open the video writer")
    for t in range(first, first + n_frames):
        fr = np.clip(base[8:8 + h_src, 4 + 2 * t:4 + 2 * t + w_src], 0, 255)
        vw.write(cv2.cvtColor(fr.astype(np.uint8), cv2.COLOR_GRAY2BGR))
    vw.release()


def textured_pairs(b, h, w, shift, seed):
    """b (I0, I1) uint8-valued float pairs: smooth noise, I1 = I0 moved by
    `shift` px (per pair, (dx, dy))."""
    import scipy.ndimage as ndi

    rng = np.random.default_rng(seed)
    m = 8 + int(np.ceil(np.abs(shift).max()))
    I0, I1 = [], []
    for i in range(b):
        base = ndi.gaussian_filter(rng.uniform(0, 255, (h + 2 * m, w + 2 * m)), 2.0)
        dx, dy = shift[i]
        ys, xs = np.mgrid[0:h, 0:w]
        I0.append(base[m:m + h, m:m + w])
        I1.append(ndi.map_coordinates(base, [ys + m - dy, xs + m - dx], order=3))
    clip = lambda a: np.clip(np.round(np.stack(a)), 0, 255).astype(np.float32)
    return clip(I0), clip(I1)


def _compare(name, args, kw, same_counts=False, plain=None):
    """tvl1_scale vs tvl1_scale_reference on the same card tensors; returns
    (kernel out, plain out, max |du|) and fails over KERNEL_TOL, or, with
    `same_counts`, when a pair's iterations or warps differ. `plain` is
    the plain version's output where it was computed already."""
    import torch

    from denseflow_tpu_torch.kernels.tvl1_fused import tvl1_scale, tvl1_scale_reference

    k = tvl1_scale(*args, **kw)
    r = tvl1_scale_reference(*args, **kw) if plain is None else plain
    torch.cuda.synchronize()
    du = torch.cat([(k[0] - r[0]).abs().flatten(), (k[1] - r[1]).abs().flatten()])
    mean_d, max_d = float(du.mean()), float(du.max())
    kc, rc = k[2].cpu(), r[2].cpu()
    log(f"[kernel] tvl1_scale {name}: mean|du| {mean_d:.3g} px, max|du| "
        f"{max_d:.3g} px (limit mean {KERNEL_TOL}); bit-equal "
        f"{torch.equal(k[0], r[0]) and torch.equal(k[1], r[1])}; iterations kernel "
        f"{kc[:, 0].tolist()} plain {rc[:, 0].tolist()}; warps kernel "
        f"{kc[:, 1].tolist()} plain {rc[:, 1].tolist()}")
    if not (mean_d <= KERNEL_TOL):
        raise SystemExit(f"tvl1_scale disagrees with its plain version on {name}")
    if same_counts and not torch.equal(kc, rc):
        raise SystemExit(f"tvl1_scale ran other iterations or warps than its plain "
                         f"version on {name}")
    return k, r, max_d


def first_chunk(video: Path, n_frames: int) -> np.ndarray:
    """The video's first n_frames, decoded and resized to short side 256 by
    the port's reader as the CLI does it."""
    from denseflow_tpu_torch.config import FlowConfig
    from denseflow_tpu_torch.io.reader import VideoSource

    cfg = FlowConfig(input=str(video), new_short=256, chunk_frames=n_frames)
    src = VideoSource(str(video), cfg)
    try:
        return next(src.chunks(1)).frames
    finally:
        src.close()


def main_path_slab(video: Path):
    """The main path's first slab: PAIR_BATCH pairs of step 1."""
    frames = first_chunk(video, PAIR_BATCH + 1)
    return frames[:PAIR_BATCH], frames[1:PAIR_BATCH + 1]


def _plan_line(module, plan, h: int, w: int) -> str:
    """A kernel plan as phases 3, 7 and 10 print it; `module` is the
    kernel's (`tvl1_fused`, `farneback_fused` or `brox_fused`), whose
    max_active_clusters asks the card."""
    import torch

    active = module.max_active_clusters(plan, h, w, torch.device(DEVICE))
    return (f"{plan.n} CTAs a pair, {plan.placement} placement, "
            f"{plan.smem_bytes} B shared memory a CTA, {active} clusters at once")


def _other_plans(h: int, w: int, plan):
    """The plans beside `plan` that phase 3 times at a main-path scale: the
    shared placement with the fewest CTAs whose bands fit and with 4, 6, 8
    and 16 where they fit, and every plane in device memory with 16."""
    from denseflow_tpu_torch.kernels._cluster import fits
    from denseflow_tpu_torch.kernels.tvl1_fused import _make_plan

    shared = [_make_plan(h, w, n, "shared") for n in range(1, min(16, h) + 1)]
    shared = [p for p in shared if fits(p)]
    out = shared[:1] + [p for p in shared if p.n in (4, 6, 8, 16)]
    out.append(_make_plan(h, w, min(16, h), "device"))
    return [p for i, p in enumerate(out) if p != plan and p not in out[:i]]


def phase_kernels(video: Path, card: str) -> list:
    """tvl1_scale (CUDA) vs tvl1_scale_reference (PyTorch) on the card."""
    import torch

    import denseflow_tpu_torch.algorithms.tvl1 as tv
    from denseflow_tpu_torch.kernels import tvl1_fused
    from denseflow_tpu_torch.kernels.tvl1_fused import (
        _launch,
        _plan,
        tvl1_scale,
        tvl1_scale_reference,
    )
    from denseflow_tpu_torch.ops.derivatives import centered_gradient

    dev = torch.device(DEVICE)
    p = tv.TVL1Params()
    # the inputs of each scale's call, captured from one tvl1_flow run
    calls = []

    def capture(*args, **kw):
        calls.append((args, kw))
        return tvl1_scale(*args, **kw)

    I0u, I1u = main_path_slab(video)
    tv.tvl1_scale = capture
    try:
        tv.tvl1_flow(torch.from_numpy(I0u).to(dev, torch.float32),
                     torch.from_numpy(I1u).to(dev, torch.float32), p)
    finally:
        tv.tvl1_scale = tvl1_scale
    totals = dict(ms=0.0, plain_ms=0.0, t_bytes=0.0, t_ops=0.0)
    worst = 0.0
    for args, kw in calls:
        b, h, w = args[0].shape
        plan = _plan(h, w)
        log(f"[kernel] tvl1_scale {h}x{w} plan: {_plan_line(tvl1_fused, plan, h, w)}")
        k, r, max_d = _compare(f"main path {h}x{w} B={b} max_disp "
                               f"{kw['max_disp']:g}", args, kw, same_counts=True)
        worst = max(worst, max_d)
        ms = cuda_ms(lambda: tvl1_scale(*args, **kw), 5)
        plain_ms = cuda_ms(lambda: tvl1_scale_reference(*args, **kw), 2)
        t_bytes, t_ops = tvl1_bound_ms(k[2], h, w)
        for key, v in zip(("ms", "plain_ms", "t_bytes", "t_ops"),
                          (ms, plain_ms, t_bytes, t_ops)):
            totals[key] += v
        log(f"[kernel] tvl1_scale {h}x{w} B={b}: kernel {ms:.6g} ms, plain "
            f"{plain_ms:.6g} ms, bound {max(t_bytes, t_ops):.6g} ms (bytes "
            f"{t_bytes:.6g}, operations {t_ops:.6g}); {card}")
        # the plans _plan did not pick, on the same inputs
        for other in _other_plans(h, w, plan):
            ko = _launch(*args, **kw, plan=other)
            torch.cuda.synchronize()
            d = max(float((ko[i] - r[i]).abs().mean()) for i in (0, 1))
            if not (d <= KERNEL_TOL and torch.equal(ko[2], r[2])):
                raise SystemExit(f"tvl1_scale with {other} disagrees at {h}x{w}")
            o_ms, _ = queued_ms(lambda: _launch(*args, **kw, plan=other), 20)
            log(f"[kernel] tvl1_scale {h}x{w} B={b} not taken: "
                f"{_plan_line(tvl1_fused, other, h, w)}: {o_ms:.6g} ms; {card}")
    log(f"[kernel] tvl1_scale one slab, {len(calls)} scales: kernel "
        f"{totals['ms']:.6g} ms, plain {totals['plain_ms']:.6g} ms; {card}")

    rng = np.random.default_rng(3)
    extra = [
        # (name, B, h, w, max_disp, initial u)
        ("odd 37x53 B=3", 3, 37, 53, 4.0, 0.0),
        ("clamp 64x80 B=4 (u0 beyond max_disp)", 4, 64, 80, 3.0, 7.5),
        # no -ns: no cluster holds the state, every plane in device memory
        ("360x480 B=2", 2, 360, 480, 40.0, 0.0),
        ("1080x1920 B=1", 1, 1080, 1920, 40.0, 0.0),
    ]
    for name, b, h, w, md, u0 in extra:
        I0n, I1n = textured_pairs(b, h, w, rng.uniform(-2.0, 2.0, (b, 2)),
                                  seed=b * 1000 + h)
        I0 = torch.from_numpy(I0n).to(dev)
        I1 = torch.from_numpy(I1n).to(dev)
        I1x, I1y = centered_gradient(I1)
        u1 = torch.full((b, h, w), u0, dtype=torch.float32, device=dev)
        u2 = torch.full((b, h, w), -u0, dtype=torch.float32, device=dev)
        kw = dict(calls[0][1], max_disp=md)
        args = (I0, I1, I1x, I1y, u1, u2)
        plan = _plan(h, w)
        log(f"[kernel] tvl1_scale {name} plan: {_plan_line(tvl1_fused, plan, h, w)}")
        plain, plain_ms = cuda_ms_once(lambda: tvl1_scale_reference(*args, **kw))
        k, _, max_d = _compare(name, args, kw, plain=plain)
        worst = max(worst, max_d)
        ms = cuda_ms(lambda: tvl1_scale(*args, **kw), 3)
        log(f"[kernel] tvl1_scale {name}: kernel {ms:.6g} ms, plain {plain_ms:.6g} ms; {card}")
        # each pair alone gives the bytes it gave in the batch: the stop
        # test of a pair does not depend on its batch-mates
        for i in range(b if b > 1 else 0):
            one = tvl1_scale(*(a[i:i + 1].contiguous() for a in args), **kw)
            if not all(torch.equal(x[i:i + 1], y) for x, y in zip(k, one)):
                raise SystemExit(f"tvl1_scale pair {i} of {name} depends on its batch")
        if b > 1:
            log(f"[kernel] tvl1_scale {name}: each pair alone equals its batched result")
    return [{
        "name": "tvl1_scale", "route": "cuda",
        "source": "denseflow_tpu_torch/csrc/tvl1_scale.cu",
        "replaces": "denseflow_tpu/kernels/tvl1_fused.py:367",
        "launches": None, "max_abs_err": worst,
        # one main-path slab: the scales' launches, timed one by one
        "ms": totals["ms"], "plain_ms": totals["plain_ms"],
        "bound_ms": max(totals["t_bytes"], totals["t_ops"]),
        "bound_by": "operations" if totals["t_ops"] >= totals["t_bytes"] else "bytes",
        "library_ms": None,
    }]


def phase_fidelity() -> None:
    """Port TVL1 on the repo's goldens at full width, on the card."""
    import torch

    from denseflow_tpu_torch.algorithms.tvl1 import TVL1Params, make_tvl1_solver

    files = sorted((ROOT / "tests" / "golden").glob("*.npz"))
    if len(files) < 8:
        raise SystemExit(f"expected 8 goldens under tests/golden, found {len(files)}")
    for f in files:
        d = np.load(f)
        I0, I1, gt, oracle = d["I0"], d["I1"], d["gt"], d["oracle"]
        solver = make_tvl1_solver(*I0.shape, TVL1Params(), DEVICE)
        flow = solver(torch.from_numpy(I0[None]), torch.from_numpy(I1[None]))
        flow = flow[0].cpu().numpy()
        # real decoded content: interior only (occlusion bands at the pan
        # edges), as the repo's hardware gate takes it
        m = 8 if f.name.startswith("real_") else 0
        cut = (slice(m, -m or None), slice(m, -m or None))
        e_o = float(np.linalg.norm((flow - oracle)[cut], axis=-1).mean())
        e_g = float(np.linalg.norm((flow - gt)[cut], axis=-1).mean())
        log(f"[fidelity] {f.stem} {I0.shape[0]}x{I0.shape[1]}: EPE vs oracle "
            f"{e_o:.4f} px, vs analytic {e_g:.4f} px (gate {GATE})")
        if not (e_o <= GATE and e_g <= GATE):
            raise SystemExit(f"{f.name} over the {GATE} px EPE gate")


def main_path_slabs() -> int:
    """Pair slabs of the main path: each chunk's pairs (the first chunk
    has no halo) bucketed to PAIR_BATCH * 2^k (executor.py)."""
    slabs, left, halo = 0, N_FRAMES, 0
    while left > 0:
        new = min(CHUNK_FRAMES, left)
        pairs, mb = halo + new - 1, PAIR_BATCH
        while mb < pairs:
            mb *= 2
        slabs += mb // PAIR_BATCH
        left, halo = left - new, 1
    return slabs


def phase_main_path(video: Path, work: Path, card: str, algorithm: str,
                    kernels: dict, per_slab: dict = None) -> dict:
    """A main path through the CLI's run(), `-a=<algorithm>`; `kernels`
    maps each kernel of that path to its wrapper, `per_slab` the launches
    a slab must make where the path fixes them. Returns launches per
    kernel, counted from 0 over this run."""
    import cv2

    from denseflow_tpu_torch.cli import parse_args, run

    tag = f"[main {algorithm}]"
    out_root = work / f"out_{algorithm}"
    cfg = parse_args([str(video), f"-o={out_root}", f"-a={algorithm}", "-s=1",
                      "-b=20", "-st=jpg", "-ns=256", "--strict",
                      f"--device={DEVICE}", ONE_CARD])
    stats: dict = {}
    for fn in kernels.values():
        fn.launches = 0
    rc = run(cfg, stats_out=stats)
    launches = {name: fn.launches for name, fn in kernels.items()}
    if rc != 0 or stats["errors"]:
        raise SystemExit(f"{algorithm} main path failed: rc {rc}, errors {stats['errors']}")
    out = out_root / video.stem
    fx = sorted(out.glob("flow_x_*.jpg"))
    fy = sorted(out.glob("flow_y_*.jpg"))
    n_flows = stats["counters"].total_flows
    slabs = main_path_slabs()
    log(f"{tag} rc {rc}; {len(fx)} flow_x + {len(fy)} flow_y jpgs; "
        f"{n_flows} flows in {stats['wall_s']:.6g} s = "
        f"{n_flows / stats['wall_s']:.6g} flows/s end to end; stage times "
        + ", ".join(f"{k} {v:.6g} s" for k, v in sorted(stats["stage_times"].items()))
        + f"; writer {stats['writer']}; " + ", ".join(f"{k} launches {v} over {slabs} slabs ({v / slabs:.3g} per slab)"
                           for k, v in launches.items())
        + f"; {card}")
    n_want = N_FRAMES - 1
    if len(fx) != n_want or len(fy) != n_want or n_flows != n_want:
        raise SystemExit(f"{algorithm} main path did not write {n_want} + {n_want} flow jpgs")
    for name, n in launches.items():
        if n <= 0:
            raise SystemExit(f"{algorithm} main path never launched {name}")
        if per_slab and n != per_slab[name] * slabs:
            raise SystemExit(f"{algorithm} main path launched {name} {n} times, not "
                             f"{per_slab[name]} a slab")
    # content moves -2 px/frame at width 480: -2*341/480 px at 341
    want_x = 255.0 * (-2.0 * 341 / 480 + 20) / 40
    want_y = 127.5
    for i in (n_want // 5, n_want // 2, 4 * n_want // 5):
        gx = cv2.imread(str(fx[i]), cv2.IMREAD_GRAYSCALE)[20:-20, 20:-20].mean()
        gy = cv2.imread(str(fy[i]), cv2.IMREAD_GRAYSCALE)[20:-20, 20:-20].mean()
        log(f"{tag} {fx[i].name}: centre flow_x {gx:.2f} (want {want_x:.2f}), "
            f"flow_y {gy:.2f} (want {want_y})")
        if abs(gx - want_x) > 3 or abs(gy - want_y) > 3:
            raise SystemExit("decoded flow does not match the content's motion")
    return launches


def phase_escalation(work: Path) -> None:
    """Motion past the default 40 px clamp, as in the JAX package's
    tests/test_large_motion.py: the pipeline must see the clamp saturate,
    re-solve the chunk at maxDisp 80 and then 1020, and track the motion."""
    import contextlib
    import io

    import cv2
    import scipy.ndimage as ndi

    from denseflow_tpu_torch.cli import parse_args, run

    h, w, dx, n = 180, 240, 48, 4
    rng = np.random.default_rng(5)
    base = ndi.gaussian_filter(rng.uniform(0, 255, (h + 8, w + dx * n + 16)), 20)
    base = (base - base.min()) / (np.ptp(base) + 1e-9) * 255
    video = work / "fast.avi"
    vw = cv2.VideoWriter(str(video), cv2.VideoWriter_fourcc(*"MJPG"), 25, (w, h))
    for t in range(n):
        fr = base[4:4 + h, 8 + dx * t:8 + dx * t + w].astype(np.uint8)
        vw.write(cv2.cvtColor(fr, cv2.COLOR_GRAY2BGR))
    vw.release()
    cfg = parse_args([str(video), f"-o={work / 'fast_out'}", "-s=1", "-b=56",
                      "--strict", "-v", f"--device={DEVICE}", ONE_CARD])
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = run(cfg)
    resolves = [ln.rsplit("=", 1)[1] for ln in text.getvalue().splitlines()
                if "re-solving chunk at maxDisp=" in ln]
    xs = [cv2.imread(str(work / "fast_out" / "fast" / f"flow_x_{i:05d}.jpg"),
                     cv2.IMREAD_GRAYSCALE)[40:-40, 40:-40].mean() for i in range(n - 1)]
    # flow -48 px: CAST(-48, -56, 56) ~ 18.2; a solve held at the 40 px
    # clamp lands near 36.4
    log(f"[escalation] rc {rc}; re-solved at maxDisp {resolves}; centre "
        f"flow_x {float(np.mean(xs)):.2f} (want 18.2 +- 6)")
    if rc != 0 or resolves != ["80", "1020"] or abs(float(np.mean(xs)) - 18.2) >= 6:
        raise SystemExit("auto-escalation did not re-solve and track the motion")


# ---------------- Farneback ----------------

def poly_bound_ms(nb: int, h: int, w: int):
    """(bytes time, operations time) in ms of one poly_expand call: the
    images read once and the five coefficient planes written once."""
    px = nb * h * w
    return (px * 6 * 4 / HBM_BYTES_PER_S * 1e3,
            px * OPS_PER_PX_POLY / F32_FLOPS * 1e3)


def level_bound_ms(iters, h: int, w: int):
    """(bytes time, operations time) in ms of one farneback_level call:
    R0, R1, u, v read once and u, v written once (14 planes a pair), and
    the iterations these pairs ran (`iters`)."""
    nbytes = iters.shape[0] * 14 * h * w * 4
    ops = float(iters.double().sum()) * h * w * OPS_PER_PX_LEVEL_ITER
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3


def poly_conv2d_weight(n: int, sigma: float):
    """The (5, 1, 2n+1, 2n+1) float32 weight of one conv2d that computes
    poly_expand on the replicate-padded image: the expansion is linear, so
    the separable projections and the inverse normal matrix fold into one
    filter per coefficient (rows = the vertical taps)."""
    import torch

    from denseflow_tpu_torch.kernels.farneback_fused import _polyexp_consts

    (g, xg, xxg, ig), _ = _polyexp_consts(n, sigma)
    g, xg, xxg, ig = (a.astype(np.float64) for a in (g, xg, xxg, ig))
    o = np.outer
    wts = np.stack([
        ig[1, 1] * o(g, xg),  # bx  <- Sx
        ig[2, 2] * o(xg, g),  # by  <- Sy
        ig[3, 0] * o(g, g) + ig[3, 3] * o(g, xxg) + ig[3, 4] * o(xxg, g),  # cxx
        ig[4, 0] * o(g, g) + ig[4, 3] * o(g, xxg) + ig[4, 4] * o(xxg, g),  # cyy
        ig[5, 5] * o(xg, xg),  # cxy <- Sxy
    ])[:, None].astype(np.float32)
    return torch.from_numpy(wts).to(DEVICE)


def _compare_poly(name, imgs, n, sigma, exact) -> "tuple":
    """poly_expand vs poly_expand_reference on the same card tensors, one
    call for the list of levels `imgs` against the plain version level by
    level; returns (kernel outs, max |d|) and fails, with `exact`, unless
    every level is bit-equal, else over POLY_TOL."""
    import torch

    from denseflow_tpu_torch.kernels.farneback_fused import poly_expand, poly_expand_reference

    k = poly_expand(imgs, n, sigma)
    r = [poly_expand_reference(img, n, sigma) for img in imgs]
    torch.cuda.synchronize()
    max_d = max(float((a - b).abs().max()) for a, b in zip(k, r))
    equal = all(torch.equal(a, b) for a, b in zip(k, r))
    log(f"[kernel] poly_expand {name}: max|d| {max_d:.3g}; bit-equal {equal}"
        + ("" if exact else f" (limit {POLY_TOL})"))
    if not (equal if exact else max_d <= POLY_TOL):
        raise SystemExit(f"poly_expand disagrees with its plain version on {name}")
    return k, max_d


def _compare_level(name, args, kw, exact, plain=None) -> "tuple":
    """farneback_level vs farneback_level_reference on the same card
    tensors; returns (kernel out, plain out, max |du|) and fails, with
    `exact`, unless the flow is bit-equal and each pair's iterations equal
    the plain version's, else over KERNEL_TOL. `plain` is the plain
    version's output where it was computed already."""
    import torch

    from denseflow_tpu_torch.kernels.farneback_fused import (
        farneback_level,
        farneback_level_reference,
    )

    k = farneback_level(*args, **kw)
    r = farneback_level_reference(*args, **kw) if plain is None else plain
    torch.cuda.synchronize()
    du = torch.cat([(k[0] - r[0]).abs().flatten(), (k[1] - r[1]).abs().flatten()])
    mean_d, max_d = float(du.mean()), float(du.max())
    equal = torch.equal(k[0], r[0]) and torch.equal(k[1], r[1])
    same = torch.equal(k[2], r[2])
    log(f"[kernel] farneback_level {name}: mean|du| {mean_d:.3g} px, max|du| "
        f"{max_d:.3g} px; bit-equal {equal}; iterations equal {same}, kernel "
        f"{k[2].tolist()} plain {r[2].tolist()}"
        + ("" if exact else f" (limit mean {KERNEL_TOL})"))
    if not ((equal and same) if exact else mean_d <= KERNEL_TOL):
        raise SystemExit(f"farneback_level disagrees with its plain version on {name}")
    return k, r, max_d


# The plans phase 7 times beside the one `_plan` takes, at four main-path
# levels: (CTAs a pair, placement).
FARN_OTHER_PLANS = {
    (32, 43): [(1, "shared"), (2, "shared")],
    (64, 85): [(1, "shared"), (2, "shared"), (3, "shared")],
    # fewer and more CTAs in shared memory; the split and device placements
    (128, 170): [(4, "shared"), (8, "shared"), (16, "shared"), (6, "split"),
                 (6, "device")],
    # (the plan: split in 16) the fewest split CTAs that fit; every plane in
    # device memory in one wave and in 16
    (256, 341): [(15, "split"), (6, "device"), (16, "device")],
}


def phase_farn_kernels(video: Path, card: str) -> list:
    """poly_expand and farneback_level (CUDA) vs their plain versions on
    the card, at every call of one farn slab and in the extra cases."""
    import torch
    import torch.nn.functional as F

    import denseflow_tpu_torch.algorithms.farneback as fb
    from denseflow_tpu_torch.kernels import farneback_fused
    from denseflow_tpu_torch.kernels.farneback_fused import (
        _launch,
        _make_plan,
        _plan,
        farneback_level,
        farneback_level_reference,
        poly_expand,
        poly_expand_reference,
    )

    dev = torch.device(DEVICE)
    p = fb.FarnebackParams()
    n, sigma = p.poly_n, p.poly_sigma
    poly_calls, level_calls = [], []

    def cap_poly(*args, **kw):
        poly_calls.append((args, kw))
        return poly_expand(*args, **kw)

    def cap_level(*args, **kw):
        level_calls.append((args, kw))
        return farneback_level(*args, **kw)

    I0u, I1u = main_path_slab(video)
    I0 = torch.from_numpy(I0u).to(dev, torch.float32)
    I1 = torch.from_numpy(I1u).to(dev, torch.float32)
    fb.poly_expand, fb.farneback_level = cap_poly, cap_level
    try:
        flow = fb.farneback_flow(I0, I1, p)
    finally:
        fb.poly_expand, fb.farneback_level = poly_expand, farneback_level
    if len(poly_calls) != 1:
        raise SystemExit(f"farneback_flow called poly_expand {len(poly_calls)} times, not once")
    weight = poly_conv2d_weight(n, sigma)
    tot = {k: dict(ms=0.0, plain_ms=0.0, lib_ms=0.0, t_bytes=0.0, t_ops=0.0)
           for k in ("poly", "level")}
    worst = {"poly": 0.0, "level": 0.0}
    # ---- poly_expand: every level of the slab in one call ----
    (imgs, *rest), kw = poly_calls[0]
    shapes = ", ".join(f"{h}x{w}" for _, h, w in (img.shape for img in imgs))
    R, worst["poly"] = _compare_poly(f"main path, {len(imgs)} levels ({shapes}) "
                                     f"N={imgs[0].shape[0]}", imgs, *rest, exact=True, **kw)
    b2b_ms = cuda_ms(lambda: poly_expand(imgs, *rest, **kw), 5)
    ms, host_ms = queued_ms(lambda: poly_expand(imgs, *rest, **kw), 20)
    for img, k in zip(imgs, R):
        nb, h, w = img.shape
        padded = F.pad(img[:, None], (n, n, n, n), mode="replicate")
        lib = F.conv2d(padded, weight)
        lib_d = float((lib - k).abs().max())
        if not (lib_d <= 1e-2):
            raise SystemExit(f"conv2d does not compute poly_expand at {h}x{w}: max|d| {lib_d}")
        one_ms = cuda_ms(lambda: poly_expand(img, *rest, **kw), 5)
        plain_ms = cuda_ms(lambda: poly_expand_reference(img, *rest, **kw), 2)
        lib_ms = cuda_ms(lambda: F.conv2d(padded, weight), 5)
        t_bytes, t_ops = poly_bound_ms(nb, h, w)
        for key, val in zip(("plain_ms", "lib_ms", "t_bytes", "t_ops"),
                            (plain_ms, lib_ms, t_bytes, t_ops)):
            tot["poly"][key] += val
        log(f"[kernel] poly_expand {h}x{w} N={nb}: this level alone in one launch "
            f"{one_ms:.6g} ms, plain {plain_ms:.6g} ms, conv2d {lib_ms:.6g} ms "
            f"(max|d| vs kernel {lib_d:.3g}), bound {max(t_bytes, t_ops):.6g} ms "
            f"(bytes {t_bytes:.6g}, operations {t_ops:.6g}); {card}")
    tot["poly"]["ms"] = ms
    log(f"[kernel] poly_expand one slab, {len(imgs)} levels in one launch: kernel "
        f"{ms:.6g} ms on the card (queued; back to back {b2b_ms:.6g} ms, the host "
        f"enqueues a call in {host_ms:.6g} ms), plain {tot['poly']['plain_ms']:.6g} ms, conv2d "
        f"{tot['poly']['lib_ms']:.6g} ms, bound {max(tot['poly']['t_bytes'], tot['poly']['t_ops']):.6g} "
        f"ms; {card}")
    # ---- farneback_level: each level's call ----
    for args, kw in level_calls:
        b, _, h, w = args[0].shape
        plan = _plan(h, w)
        log(f"[kernel] farneback_level {h}x{w} plan: "
            f"{_plan_line(farneback_fused, plan, h, w)}")
        k, r, max_d = _compare_level(f"main path {h}x{w} B={b} max_disp "
                                     f"{kw['max_disp']:g}", args, kw, exact=True)
        worst["level"] = max(worst["level"], max_d)
        b2b_ms = cuda_ms(lambda: farneback_level(*args, **kw), 5)
        ms, host_ms = queued_ms(lambda: farneback_level(*args, **kw), 20)
        plain_ms = cuda_ms(lambda: farneback_level_reference(*args, **kw), 2)
        t_bytes, t_ops = level_bound_ms(k[2], h, w)
        for key, val in zip(("ms", "plain_ms", "t_bytes", "t_ops"),
                            (ms, plain_ms, t_bytes, t_ops)):
            tot["level"][key] += val
        log(f"[kernel] farneback_level {h}x{w} B={b}: iterations {int(k[2].sum())} "
            f"(most a pair {int(k[2].max())}); kernel {ms:.6g} ms on the card (queued; "
            f"back to back {b2b_ms:.6g} ms, the host enqueues a call in {host_ms:.6g} ms), "
            f"plain {plain_ms:.6g} ms, bound {max(t_bytes, t_ops):.6g} ms (bytes "
            f"{t_bytes:.6g}, operations {t_ops:.6g}); {card}")
        # the plans _plan did not take, on the same inputs
        for nc, placement in FARN_OTHER_PLANS.get((h, w), []):
            other = _make_plan(h, w, nc, placement)
            ko = _launch(*args, **kw, plan=other)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(ko, r)):
                raise SystemExit(f"farneback_level with {other} disagrees at {h}x{w}")
            o_ms, _ = queued_ms(lambda: _launch(*args, **kw, plan=other), 20)
            log(f"[kernel] farneback_level {h}x{w} B={b} not taken: "
                f"{_plan_line(farneback_fused, other, h, w)}: {o_ms:.6g} ms, bit-equal "
                f"with equal iterations; {card}")
    log(f"[kernel] farn one slab, 1 poly_expand + {len(level_calls)} farneback_level "
        f"calls: poly_expand kernel {tot['poly']['ms']:.6g} ms, plain "
        f"{tot['poly']['plain_ms']:.6g} ms, conv2d {tot['poly']['lib_ms']:.6g} ms; "
        f"farneback_level kernel {tot['level']['ms']:.6g} ms, plain "
        f"{tot['level']['plain_ms']:.6g} ms, bound "
        f"{max(tot['level']['t_bytes'], tot['level']['t_ops']):.6g} ms; {card}")
    # the slab's whole solve (level images, expansion, upsamples and the six
    # level launches) beside its kernels, and how long the host takes to
    # enqueue it
    flow_ms = cuda_ms(lambda: fb.farneback_flow(I0, I1, p), 5)
    card_ms, host_ms = queued_ms(lambda: fb.farneback_flow(I0, I1, p), 5)
    kern_ms = tot["poly"]["ms"] + tot["level"]["ms"]
    log(f"[kernel] farneback_flow one slab: {flow_ms:.6g} ms back to back; "
        f"{card_ms:.6g} ms of card work queued, of which the kernels timed alone "
        f"{kern_ms:.6g} ms (poly_expand {tot['poly']['ms']:.6g}, farneback_level "
        f"{tot['level']['ms']:.6g}); the host enqueues a slab in {host_ms:.6g} ms; {card}")

    rng = np.random.default_rng(4)
    extra = [
        # (name, B, h, w, max_disp, initial u)
        ("odd 37x53 B=3", 3, 37, 53, 4.0, 0.0),
        ("coarsest level 8x11 B=4", 4, 8, 11, 4.0, 0.0),
        ("clamp 64x80 B=4 (u0 beyond max_disp)", 4, 64, 80, 3.0, 7.5),
        # no -ns: no cluster holds the state, every plane in device memory
        ("360x480 B=2", 2, 360, 480, 40.0, 0.0),
        ("1080x1920 B=1", 1, 1080, 1920, 40.0, 0.0),
    ]
    for name, b, h, w, md, u0 in extra:
        I0n, I1n = textured_pairs(b, h, w, rng.uniform(-2.0, 2.0, (b, 2)),
                                  seed=b * 1000 + h)
        imgs = torch.from_numpy(np.concatenate([I0n, I1n])).to(dev)
        (R,), max_d = _compare_poly(name, [imgs], n, sigma, exact=False)
        worst["poly"] = max(worst["poly"], max_d)
        for i in range(2 * b):
            if not torch.equal(poly_expand(imgs[i:i + 1], n, sigma), R[i:i + 1]):
                raise SystemExit(f"poly_expand image {i} of {name} depends on its batch")
        u = torch.full((b, h, w), u0, dtype=torch.float32, device=dev)
        args = (R[:b], R[b:], u, -u)
        kw = dict(level_calls[-1][1], max_disp=md)
        log(f"[kernel] farneback_level {name} plan: "
            f"{_plan_line(farneback_fused, _plan(h, w), h, w)}")
        plain, plain_ms = cuda_ms_once(lambda: farneback_level_reference(*args, **kw))
        k, _, max_d = _compare_level(name, args, kw, exact=False, plain=plain)
        worst["level"] = max(worst["level"], max_d)
        ms = cuda_ms(lambda: farneback_level(*args, **kw), 3)
        log(f"[kernel] farneback_level {name}: kernel {ms:.6g} ms, plain {plain_ms:.6g} ms; "
            f"{card}")
        for i in range(b if b > 1 else 0):
            one = farneback_level(*(a[i:i + 1].contiguous() for a in args), **kw)
            if not all(torch.equal(x[i:i + 1], y) for x, y in zip(k, one)):
                raise SystemExit(f"farneback_level pair {i} of {name} depends on its batch")
        log(f"[kernel] {name}: each image" + (" and each pair" if b > 1 else "")
            + " alone equals its batched result")

    # the level-image products stay in full float32 whatever the caller set
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        flow_tf32 = fb.farneback_flow(I0, I1, p)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    if not torch.equal(flow, flow_tf32):
        raise SystemExit("the farn slab changed when the caller switched TF32 on")
    alone = [torch.equal(fb.farneback_flow(I0[i:i + 1], I1[i:i + 1], p), flow[i:i + 1])
             for i in (0, PAIR_BATCH // 2, PAIR_BATCH - 1)]
    log(f"[kernel] farn slab: same bytes with TF32 switched on by the caller; "
        f"pairs 0, {PAIR_BATCH // 2}, {PAIR_BATCH - 1} of the whole flow solved "
        f"alone equal their batched bytes: {alone}")

    def record(key, name, source, replaces, library_ms):
        t = tot[key]
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": worst[key],
            # one farn slab: poly_expand's one launch, the levels' launches
            # timed one by one, each queued so that the host does not pace it
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": max(t["t_bytes"], t["t_ops"]),
            "bound_by": "operations" if t["t_ops"] >= t["t_bytes"] else "bytes",
            "library_ms": library_ms,
        }

    return [
        record("poly", "poly_expand", "denseflow_tpu_torch/csrc/farneback_polyexp.cu",
               "denseflow_tpu/kernels/farneback_fused.py:341", tot["poly"]["lib_ms"]),
        record("level", "farneback_level", "denseflow_tpu_torch/csrc/farneback_level.cu",
               "denseflow_tpu/kernels/farneback_fused.py:179", None),
    ]


# ---------------- Brox ----------------

def brox_bound_ms(counts, h: int, w: int):
    """(bytes time, operations time) in ms of one brox_scale call: I0, I1,
    u, v read once and u, v written once (6 planes a pair), and the
    operations of the warps, inner steps and sweeps these pairs ran
    (`counts`)."""
    px = h * w
    nbytes = 6 * counts.shape[0] * px * 4
    c = counts.double().sum(0)
    ops = (float(c[0]) * BROX_OPS_PER_PX_WARP + float(c[1]) * BROX_OPS_PER_PX_INNER
           + float(c[2]) * BROX_OPS_PER_PX_SWEEP + counts.shape[0] * BROX_OPS_PER_PX_LEVEL) * px
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3


def cuda_ms_once(fn):
    """(fn(), its time on the card in ms) for one run (CUDA events)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _compare_brox(name, args, kw, same_counts=False):
    """brox_scale vs brox_scale_reference on the same card tensors; returns
    (kernel out, plain out, max |du|, plain ms) and fails over KERNEL_TOL,
    or, with `same_counts`, when a pair's warps, inner steps or sweeps
    differ."""
    import torch

    from denseflow_tpu_torch.kernels.brox_fused import brox_scale, brox_scale_reference

    k = brox_scale(*args, **kw)
    r, plain_ms = cuda_ms_once(lambda: brox_scale_reference(*args, **kw))
    du = torch.cat([(k[0] - r[0]).abs().flatten(), (k[1] - r[1]).abs().flatten()])
    mean_d, max_d = float(du.mean()), float(du.max())
    kc, rc = k[2].cpu(), r[2].cpu()
    log(f"[kernel] brox_scale {name}: mean|du| {mean_d:.3g} px, max|du| {max_d:.3g} px "
        f"(limit mean {KERNEL_TOL}); bit-equal {torch.equal(k[0], r[0]) and torch.equal(k[1], r[1])}; "
        f"counts equal {torch.equal(kc, rc)}; warps {kc[:, 0].tolist()}, inner steps "
        f"{kc[:, 1].tolist()}, sweeps {kc[:, 2].tolist()} (plain warps {rc[:, 0].tolist()}, "
        f"inner {rc[:, 1].tolist()})")
    if not (mean_d <= KERNEL_TOL):
        raise SystemExit(f"brox_scale disagrees with its plain version on {name}")
    if same_counts and not torch.equal(kc, rc):
        raise SystemExit(f"brox_scale ran other warps, inner steps or sweeps than its "
                         f"plain version on {name}")
    return k, r, max_d, plain_ms


# The plans phase 10 times beside the one `_plan` takes, at five main-path
# levels: (CTAs a pair, placement).
BROX_OTHER_PLANS = {
    # a cluster of 6 in place of the one CTA
    (18, 23): [(6, "shared")],
    # 8 CTAs: 15 clusters at once, so the 16th pair waits
    (54, 72): [(8, "shared")],
    # fewer and more CTAs in shared memory; the split and device placements
    (105, 140): [(4, "shared"), (8, "shared"), (16, "shared"), (6, "split"),
                 (6, "device")],
    (131, 175): [(8, "shared"), (16, "shared")],
    # the fewest CTAs that hold the state (14; 7 and 8 for split, 15 of
    # which fit at once); every plane in device memory
    (205, 273): [(14, "shared"), (7, "split"), (8, "split"), (16, "split"),
                 (6, "device"), (16, "device")],
}


def phase_brox_kernels(video: Path, card: str) -> list:
    """brox_scale (CUDA) vs brox_scale_reference (PyTorch) on the card, at
    every level call of one brox slab and in the extra cases."""
    import torch

    import denseflow_tpu_torch.algorithms.brox as bx
    from denseflow_tpu_torch.kernels import brox_fused
    from denseflow_tpu_torch.kernels.brox_fused import _launch, _make_plan, _plan, brox_scale

    dev = torch.device(DEVICE)
    p = bx.BroxParams()
    calls = []

    def capture(*args, **kw):
        calls.append((args, kw))
        return brox_scale(*args, **kw)

    scale = float(np.float32(1.0 / 255.0))
    I0u, I1u = main_path_slab(video)
    bx.brox_scale = capture
    try:
        bx.brox_flow(torch.from_numpy(I0u).to(dev, torch.float32) * scale,
                     torch.from_numpy(I1u).to(dev, torch.float32) * scale, p)
    finally:
        bx.brox_scale = brox_scale
    tot = dict(ms=0.0, plain_ms=0.0, t_bytes=0.0, t_ops=0.0)
    worst = 0.0
    for args, kw in calls:
        b, h, w = args[0].shape
        log(f"[kernel] brox_scale {h}x{w} plan: {_plan_line(brox_fused, _plan(h, w), h, w)}")
        k, r, max_d, plain_ms = _compare_brox(
            f"main path {h}x{w} B={b} max_disp {kw['max_disp']:g}", args, kw,
            same_counts=True)
        worst = max(worst, max_d)
        ms = cuda_ms(lambda: brox_scale(*args, **kw), 3)
        t_bytes, t_ops = brox_bound_ms(k[2], h, w)
        c = k[2].double().sum(0).tolist()
        for key, val in zip(("ms", "plain_ms", "t_bytes", "t_ops"),
                            (ms, plain_ms, t_bytes, t_ops)):
            tot[key] += val
        log(f"[kernel] brox_scale {h}x{w} B={b}: slab totals warps {c[0]:g}, inner steps "
            f"{c[1]:g}, sweeps {c[2]:g} (most a pair {int(k[2][:, 2].max())}); kernel "
            f"{ms:.6g} ms, plain {plain_ms:.6g} ms, bound {max(t_bytes, t_ops):.6g} ms "
            f"(bytes {t_bytes:.6g}, operations {t_ops:.6g}); {card}")
        # the plans _plan did not take, on the same inputs
        for n, placement in BROX_OTHER_PLANS.get((h, w), []):
            other = _make_plan(h, w, n, placement)
            ko = _launch(*args, **kw, plan=other)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(ko, r)):
                raise SystemExit(f"brox_scale with {other} disagrees at {h}x{w}")
            o_ms = cuda_ms(lambda: _launch(*args, **kw, plan=other), 3)
            log(f"[kernel] brox_scale {h}x{w} B={b} not taken: "
                f"{_plan_line(brox_fused, other, h, w)}: {o_ms:.6g} ms, bit-equal with "
                f"equal counts; {card}")
        if (h, w) in BROX_OTHER_PLANS:
            # one Jacobi sweep and its barrier: the slope of the time over
            # the sweep count, at one warp of one inner step and no stop
            one = dict(kw, outer_iterations=1, inner_iterations=1, stop_eps=0.0)
            t_lo, t_hi = (cuda_ms(lambda: brox_scale(*args, **dict(one, solver_iterations=s)), 3)
                          for s in (10, 210))
            band = -(-h // _plan(h, w).n) * w
            log(f"[kernel] brox_scale {h}x{w} B={b}: 200 more sweeps of every pair take "
                f"{t_hi - t_lo:.6g} ms, {(t_hi - t_lo) / 200 * 1e3:.6g} us a sweep of the slab "
                f"(bands of up to {band} px); one warp and one inner step of 10 sweeps "
                f"{t_lo:.6g} ms; {card}")
    log(f"[kernel] brox_scale one slab, {len(calls)} levels: kernel {tot['ms']:.6g} ms, "
        f"plain {tot['plain_ms']:.6g} ms, bound {max(tot['t_bytes'], tot['t_ops']):.6g} ms; "
        f"{card}")
    # the slab's whole solve (presmoothing, pyramids, upsamples and the 13
    # launches) beside its kernels, and how long the host takes to enqueue it
    I0d = torch.from_numpy(I0u).to(dev, torch.float32) * scale
    I1d = torch.from_numpy(I1u).to(dev, torch.float32) * scale
    flow_ms = cuda_ms(lambda: bx.brox_flow(I0d, I1d, p), 3)
    t0 = time.perf_counter()
    bx.brox_flow(I0d, I1d, p)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    log(f"[kernel] brox_flow one slab: {flow_ms:.6g} ms on the card, of which the "
        f"{len(calls)} levels' kernels timed alone {tot['ms']:.6g} ms; one call returns "
        f"to the host after {host_ms:.6g} ms; {card}")

    rng = np.random.default_rng(6)
    reduced = dict(inner_iterations=3, outer_iterations=4, solver_iterations=4)
    extra = [
        # (name, B, h, w, budget and clamp, initial u)
        ("odd 37x53 B=3", 3, 37, 53, dict(max_disp=4.0), 0.0),
        ("coarsest level 18x23 B=4", 4, 18, 23, dict(max_disp=4.0), 0.0),
        ("clamp 64x80 B=4 (u0 beyond max_disp)", 4, 64, 80, dict(max_disp=3.0), 7.5),
        ("stop_eps=0 40x56 B=2, reduced budget", 2, 40, 56,
         dict(reduced, max_disp=8.0, stop_eps=0.0), 0.0),
        # no -ns: no cluster holds the state, every plane in device memory
        ("360x480 B=2, reduced budget", 2, 360, 480, dict(reduced, max_disp=40.0), 0.0),
    ]
    for name, b, h, w, over, u0 in extra:
        I0n, I1n = textured_pairs(b, h, w, rng.uniform(-2.0, 2.0, (b, 2)),
                                  seed=b * 1000 + h)
        I0 = torch.from_numpy(I0n).to(dev) * scale
        I1 = torch.from_numpy(I1n).to(dev) * scale
        u = torch.full((b, h, w), u0, dtype=torch.float32, device=dev)
        args = (I0, I1, u, -u)
        kw = dict(calls[0][1], **over)
        log(f"[kernel] brox_scale {name} plan: {_plan_line(brox_fused, _plan(h, w), h, w)}")
        k, _, max_d, plain_ms = _compare_brox(name, args, kw)
        worst = max(worst, max_d)
        ms = cuda_ms(lambda: brox_scale(*args, **kw), 3)
        log(f"[kernel] brox_scale {name}: kernel {ms:.6g} ms, plain {plain_ms:.6g} ms; {card}")
        if kw["stop_eps"] == 0:
            want = [kw["outer_iterations"], kw["outer_iterations"] * kw["inner_iterations"],
                    kw["outer_iterations"] * kw["inner_iterations"] * kw["solver_iterations"]]
            if k[2].tolist() != [want] * b:
                raise SystemExit(f"brox_scale {name}: counts {k[2].tolist()}, want {want}")
        # each pair alone gives the bytes it gave in the batch
        for i in range(b):
            one = brox_scale(*(a[i:i + 1].contiguous() for a in args), **kw)
            if not all(torch.equal(x[i:i + 1], y) for x, y in zip(k, one)):
                raise SystemExit(f"brox_scale pair {i} of {name} depends on its batch")
        log(f"[kernel] brox_scale {name}: each pair alone equals its batched result")
    return [{
        "name": "brox_scale", "route": "cuda",
        "source": "denseflow_tpu_torch/csrc/brox_scale.cu",
        "replaces": "denseflow_tpu/kernels/brox_fused.py:240",
        "launches": None, "max_abs_err": worst,
        # one brox slab: the levels' launches, timed one by one
        "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": max(tot["t_bytes"], tot["t_ops"]),
        "bound_by": "operations" if tot["t_ops"] >= tot["t_bytes"] else "bytes",
        "library_ms": None,
    }]


def phase_brox_fidelity() -> None:
    """Port Brox at the full budget on the card: the analytic goldens and
    the 64x80 translation."""
    import torch

    from denseflow_tpu_torch.algorithms.brox import BroxParams, make_brox_solver

    for name in ("translation", "rotation", "zoom", "diag"):
        d = np.load(ROOT / "tests" / "golden" / f"tvl1_{name}.npz")
        solver = make_brox_solver(*d["I0"].shape, BroxParams(), DEVICE)
        flow = solver(torch.from_numpy(d["I0"][None]), torch.from_numpy(d["I1"][None]))
        e = float(np.linalg.norm(flow[0].cpu().numpy() - d["gt"], axis=-1).mean())
        log(f"[fidelity] brox tvl1_{name} {d['I0'].shape[0]}x{d['I0'].shape[1]}: "
            f"EPE vs analytic {e:.4f} px (gate {GATE})")
        if not (e <= GATE):
            raise SystemExit(f"brox tvl1_{name} over the {GATE} px EPE gate")
    dx, dy = 1.7, -0.8
    I0, I1 = translated_pair(64, 80, dx, dy)
    solver = make_brox_solver(64, 80, BroxParams(), DEVICE)
    flow = solver(torch.from_numpy(I0[None]), torch.from_numpy(I1[None]))[0].cpu().numpy()
    e = float(np.linalg.norm(flow[10:-10, 10:-10] - np.array([dx, dy]), axis=-1).mean())
    log(f"[fidelity] brox 64x80 translation ({dx}, {dy}): central EPE {e:.4f} px (gate 0.2)")
    if not (e < 0.2):
        raise SystemExit("brox translation over the 0.2 px gate")


def translated_pair(h=96, w=128, dx=2.3, dy=-1.6, seed=1):
    """tests/test_solvers.py::_translated_pair: smooth noise and its copy
    moved by (dx, dy), both uint8."""
    import scipy.ndimage as ndi

    rng = np.random.default_rng(seed)
    base = ndi.gaussian_filter(rng.uniform(0, 255, (h + 20, w + 20)), 2.0).astype(np.float32)
    ys, xs = np.mgrid[0:h, 0:w]
    I0 = np.clip(base[10:10 + h, 10:10 + w], 0, 255).astype(np.uint8)
    I1 = np.clip(ndi.map_coordinates(base, [ys + 10 - dy, xs + 10 - dx], order=3),
                 0, 255).astype(np.uint8)
    return I0, I1


def phase_farn_fidelity() -> None:
    """Port Farneback at full width on the card: the analytic goldens and
    OpenCV's own Farneback."""
    import cv2
    import torch

    from denseflow_tpu_torch.algorithms.farneback import FarnebackParams, make_farneback_solver

    for name in ("translation", "rotation", "diag"):
        d = np.load(ROOT / "tests" / "golden" / f"tvl1_{name}.npz")
        solver = make_farneback_solver(*d["I0"].shape, FarnebackParams(), DEVICE)
        flow = solver(torch.from_numpy(d["I0"][None]), torch.from_numpy(d["I1"][None]))
        e = float(np.linalg.norm(flow[0].cpu().numpy() - d["gt"], axis=-1).mean())
        log(f"[fidelity] farn tvl1_{name} {d['I0'].shape[0]}x{d['I0'].shape[1]}: "
            f"EPE vs analytic {e:.4f} px (gate {GATE})")
        if not (e <= GATE):
            raise SystemExit(f"farn tvl1_{name} over the {GATE} px EPE gate")
    I0, I1 = translated_pair()
    ref = cv2.calcOpticalFlowFarneback(I0, I1, None, 0.5, 5, 13, 10, 5, 1.1, 0)
    solver = make_farneback_solver(96, 128, FarnebackParams(), DEVICE)
    ours = solver(torch.from_numpy(I0[None]), torch.from_numpy(I1[None]))[0].cpu().numpy()
    epe = np.linalg.norm(ours - ref, axis=-1)
    inner, whole = float(epe[10:-10, 10:-10].mean()), float(epe.mean())
    log(f"[fidelity] farn vs cv2.calcOpticalFlowFarneback 96x128: interior EPE "
        f"{inner:.4g} px, whole {whole:.4g} px (gates {CV2_GATE[0]}, {CV2_GATE[1]})")
    if not (inner < CV2_GATE[0] and whole < CV2_GATE[1]):
        raise SystemExit("farn over the cv2 gate")


# ---------------- emission ----------------

# Prints the versions of the headers the emitter compiles against and of
# the libraries it links.
_EMITTER_PROBE = r"""
#include <cstdio>
#include <jpeglib.h>
#include <png.h>
#define STR2(x) #x
#define STR(x) STR2(x)
int main() {
#ifdef LIBJPEG_TURBO_VERSION
    std::printf("libjpeg-turbo %s, ", STR(LIBJPEG_TURBO_VERSION));
#endif
    std::printf("JPEG_LIB_VERSION %d; libpng %s (header %s)\n", JPEG_LIB_VERSION,
                png_get_libpng_ver(nullptr), PNG_LIBPNG_VER_STRING);
    return 0;
}
"""


def probe_emitter_headers(work: Path):
    """(the probe's version line, None), or (None, why) when g++ or the
    libjpeg / libpng headers are missing."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None, "g++ not found"
    log(f"[emitter] {subprocess.run([gxx, '--version'], capture_output=True, text=True).stdout.splitlines()[0]}")
    src, exe = work / "probe.cpp", work / "probe"
    src.write_text(_EMITTER_PROBE)
    cc = subprocess.run([gxx, str(src), "-o", str(exe), "-ljpeg", "-lpng"],
                        capture_output=True, text=True, timeout=120)
    if cc.returncode != 0:
        missing = [ln for ln in cc.stderr.splitlines() if "No such file" in ln]
        if missing:
            return None, missing[0].strip()
        raise SystemExit(f"the emitter's header probe did not build:\n{cc.stderr}")
    return subprocess.run([str(exe)], capture_output=True, text=True,
                          check=True).stdout.strip(), None


def textured(n: int, h: int, w: int, seed: int, channels: int = 0) -> np.ndarray:
    """n smooth-noise uint8 planes (h, w), or (h, w, channels): windows of
    one smooth field, one row apart, like consecutive flow planes."""
    import scipy.ndimage as ndi

    rng = np.random.default_rng(seed)
    shape = (h + n, w) + ((channels,) if channels else ())
    sigma = (3.0, 3.0) + ((0.0,) if channels else ())
    base = ndi.gaussian_filter(rng.uniform(0, 255, shape), sigma)
    base = (base - base.min()) / (np.ptp(base) + 1e-9) * 255
    base = np.round(base).astype(np.uint8)
    return np.stack([base[i:i + h] for i in range(n)])


def phase_emitter(work: Path, card: str) -> None:
    """The native emitter on this machine, and cv2's pool, against cv2 on
    one thread in the same call."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    import cv2

    from denseflow_tpu_torch import native
    from denseflow_tpu_torch.io.writer import encode_jpg, write_batch, write_flow_images

    versions, missing = probe_emitter_headers(work)
    log(f"[emitter] os.cpu_count() {os.cpu_count()}; the emitter's threads "
        f"{native.DEFAULT_THREADS}")
    h, w, n = 256, 341, 2 * (N_FRAMES - 1)
    planes = textured(n, h, w, seed=13)
    ref = work / "emit_cv2"
    ref.mkdir()
    t0 = time.perf_counter()
    write_flow_images([encode_jpg(p) for p in planes], str(ref / "flow_x"), 1, 0)
    t_cv2 = time.perf_counter() - t0
    log(f"[emitter] {n} gray {h}x{w} jpgs through cv2 encode_jpg + "
        f"write_flow_images, one thread: {t_cv2:.6g} s ({n / t_cv2:.6g} files/s); {card}")
    pooled = work / "emit_pool"
    pooled.mkdir()
    paths = [str(pooled / f"flow_x_{i:05d}.jpg") for i in range(n)]
    with ThreadPoolExecutor(native.DEFAULT_THREADS) as pool:
        t0 = time.perf_counter()
        write_batch(planes, paths, pool)
        t_pool = time.perf_counter() - t0
    same = sum(Path(p).read_bytes() == (ref / Path(p).name).read_bytes() for p in paths)
    log(f"[emitter] the same jpgs through cv2 write_batch on {native.DEFAULT_THREADS} "
        f"threads: {t_pool:.6g} s ({n / t_pool:.6g} files/s), {t_cv2 / t_pool:.4g}x one "
        f"thread's; byte-equal to encode_jpg's {same} of {n}; {card}")
    if same != n:
        raise SystemExit("cv2 write_batch's jpgs differ from encode_jpg's")
    shutil.rmtree(pooled)
    if missing is not None:
        log(f"[emitter] headers missing ({missing}): the writer is cv2")
        if native.available():
            raise SystemExit("the emitter built though its headers are missing")
        log(f"[emitter] writer {native.describe()}")
        return
    log(f"[emitter] {versions}")
    if not native.available():
        raise SystemExit(f"the headers are here but the emitter did not build:\n"
                         f"{native.build_error()}")
    log(f"[emitter] writer {native.describe()}")
    nat = work / "emit_native"
    nat.mkdir()
    paths = [str(nat / f"flow_x_{i:05d}.jpg") for i in range(n)]
    t0 = time.perf_counter()
    native.write_jpg_batch(planes, paths)
    t_nat = time.perf_counter() - t0
    same = worst = worst_cv2 = 0.0
    for i, p in enumerate(paths):
        a = Path(p).read_bytes()
        b = (ref / Path(p).name).read_bytes()
        same += a == b
        img = cv2.imdecode(np.frombuffer(a, np.uint8), cv2.IMREAD_GRAYSCALE).astype(int)
        worst = max(worst, float(np.abs(img - planes[i]).mean()))
        other = cv2.imdecode(np.frombuffer(b, np.uint8), cv2.IMREAD_GRAYSCALE)
        worst_cv2 = max(worst_cv2, float(np.abs(img - other).mean()))
    log(f"[emitter] {n} gray {h}x{w} jpgs: write_jpg_batch {t_nat:.6g} s "
        f"({n / t_nat:.6g} files/s, {native.DEFAULT_THREADS} threads), {t_cv2 / t_nat:.4g}x "
        f"cv2's; byte-equal to cv2's {int(same)} of {n}; worst mean |decoded - plane| "
        f"{worst:.4g} (limit 4), worst mean |native - cv2| decoded {worst_cv2:.4g} "
        f"(limit 2); {card}")
    if not (worst < 4 and worst_cv2 < 2):
        raise SystemExit("native jpgs outside tests/test_native.py's tolerances")
    shutil.rmtree(nat)
    shutil.rmtree(ref)
    colour = textured(16, h, w, seed=14, channels=3)
    paths = [str(work / f"img_{i:05d}.jpg") for i in range(16)]
    native.write_jpg_color_batch(colour, paths)
    errs = [float(np.abs(cv2.imread(p).astype(int) - colour[i]).mean())
            for i, p in enumerate(paths)]
    same = sum(Path(p).read_bytes() == encode_jpg(colour[i]) for i, p in enumerate(paths))
    pngs = [str(work / f"flow_{i:05d}.png") for i in range(16)]
    native.write_png_batch(colour, pngs)
    lossless = all(np.array_equal(cv2.imread(p, cv2.IMREAD_UNCHANGED), colour[i])
                   for i, p in enumerate(pngs))
    log(f"[emitter] 16 colour {h}x{w} jpgs: worst mean |decoded - frame| "
        f"{max(errs):.4g} (limit 4), byte-equal to cv2's {same} of 16; 16 pngs "
        f"pixel-equal to their input: {lossless}")
    if not (max(errs) < 4 and lossless):
        raise SystemExit("native colour jpgs or pngs do not decode to their input")


def phase_save_types(video: Path, work: Path, card: str, tvl1_scale) -> None:
    """The tvl1 path through cli.run with -st=png, -st=h5 and -st=h5
    --h5Dtype=f16, each with the kernel's launch count set to 0 before it."""
    import cv2
    import torch

    from denseflow_tpu_torch.cli import parse_args, run
    from denseflow_tpu_torch.io import writer
    from denseflow_tpu_torch.quantize import dequantize_flow_png

    n_want = N_FRAMES - 1
    want = -2.0 * 341 / 480  # content moves -2 px/frame at width 480
    runs = [("png", []), ("h5", []), ("h5", ["--h5Dtype=f16"])]
    h5_x = {}
    for st, extra in runs:
        tag = f"[save {st}{' f16' if extra else ''}]"
        out_root = work / f"out_{st}{len(extra)}"
        cfg = parse_args([str(video), f"-o={out_root}", "-a=tvl1", "-s=1", "-b=20",
                          f"-st={st}", "-ns=256", "--strict", f"--device={DEVICE}",
                          ONE_CARD, *extra])
        stats: dict = {}
        tvl1_scale.launches = 0
        if st == "h5" and not writer.HAVE_H5:
            log(f"{tag} h5py is not installed here")
            try:
                run(cfg, stats_out=stats)
            except RuntimeError as e:
                if "HDF5 support is not available" in str(e):
                    log(f"{tag} fails as the JAX package does: {e}")
                    continue
                raise
            raise SystemExit("-st=h5 ran without h5py")
        rc = run(cfg, stats_out=stats)
        launches = tvl1_scale.launches
        n_flows = stats["counters"].total_flows
        if rc != 0 or stats["errors"]:
            raise SystemExit(f"{tag} failed: rc {rc}, errors {stats['errors']}")
        out = out_root / video.stem
        centre = []
        if st == "png":
            files = sorted(out.glob("*.png"))
            names = [f"flow_{i:05d}.png" for i in range(n_want)]
            ok_names = [p.name for p in files] == names
            for i in (n_want // 5, n_want // 2, 4 * n_want // 5):
                img = torch.from_numpy(cv2.imread(str(files[i]), cv2.IMREAD_UNCHANGED))
                f = dequantize_flow_png(img).numpy()[20:-20, 20:-20]
                centre.append((files[i].name, float(f[..., 0].mean()), float(f[..., 1].mean())))
            what = f"{len(files)} pngs"
        else:
            import h5py

            names = sorted(f"flow_{c}_{i:05d}" for c in "xy" for i in range(n_want))
            with h5py.File(out_root / f"{video.stem}.h5") as f:
                ok_names = sorted(f) == names and all(
                    f[k].dtype == np.float32 and f[k].shape == (256, 341) for k in f)
                for i in (n_want // 5, n_want // 2, 4 * n_want // 5):
                    k = f"{i:05d}"
                    centre.append((k, float(f[f"flow_x_{k}"][20:-20, 20:-20].mean()),
                                   float(f[f"flow_y_{k}"][20:-20, 20:-20].mean())))
                x = np.stack([f[f"flow_x_{i:05d}"][:] for i in range(0, n_want, 7)])
            if extra:
                d = float(np.abs(x - h5_x["f32"]).max())
                log(f"{tag} max |f16 - f32| over {len(x)} flow_x datasets {d:.4g} px "
                    f"(limit 2e-2)")
                if not d <= 2e-2:
                    raise SystemExit("the f16 h5 strays from the f32 h5")
            else:
                h5_x["f32"] = x
            what = f"{len(names)} float32 datasets"
        log(f"{tag} rc {rc}; {what}, names as the JAX package's: {ok_names}; {n_flows} "
            f"flows in {stats['wall_s']:.6g} s = {n_flows / stats['wall_s']:.6g} flows/s end "
            f"to end; stage times "
            + ", ".join(f"{k} {v:.6g} s" for k, v in sorted(stats["stage_times"].items()))
            + f"; writer {stats['writer']}; tvl1_scale launches {launches}; {card}")
        for name, cx, cy in centre:
            log(f"{tag} {name}: centre flow ({cx:.4f}, {cy:.4f}) px (want ({want:.4f}, 0) "
                f"within 0.3)")
        if not ok_names or n_flows != n_want:
            raise SystemExit(f"{tag} did not write {n_want} flows by the JAX package's names")
        if launches != 5 * main_path_slabs():
            raise SystemExit(f"{tag} launched tvl1_scale {launches} times")
        if any(abs(cx - want) > 0.3 or abs(cy) > 0.3 for _, cx, cy in centre):
            raise SystemExit(f"{tag} decoded flow does not match the content's motion")
        shutil.rmtree(out_root)

# ---------------- devices and hosts ----------------

SHARD_PAIRS = 64  # pairs of phase 15's chunk: four main-path slabs
# each kernel's launches a slab of PAIR_BATCH pairs, by path
PER_SLAB = {"tvl1": {"tvl1_scale": 5},
            "farn": {"poly_expand": 1, "farneback_level": 6},
            "brox": {"brox_scale": 13}}
SUBPROCESS_TIMEOUT = 300  # s, phase 16's two hosts


def phase_devices(video: Path, work: Path, card: str, kernels: dict) -> None:
    """--devices: each path's executor on a SHARD_PAIRS-pair chunk of the
    bench video at 256x341, one device against its slabs split over shards:
    the cards there are (2 and all) or, on one card, 2 and 4 shards on that
    card. jpg bytes and the h5 flow must equal one device's, and each
    kernel's launches shards x its count a slab. With two cards or more,
    also the CLI with --devices=0 against --devices=1 on the 500-frame
    video."""
    import torch

    import denseflow_tpu_torch.executor as tex
    from denseflow_tpu_torch.cli import parse_args, run
    from denseflow_tpu_torch.io.writer import encode_jpg

    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        layouts = [(n, None, f"{n} cards") for n in sorted({2, n_cards})]
    else:
        # shards on one card: a check of the split, not a multi-GPU run
        layouts = [(n, [torch.device(DEVICE, 0)] * n, f"{n} shards on one card")
                   for n in (2, 4)]
    frames = first_chunk(video, SHARD_PAIRS + 1)
    h, w = frames.shape[1:]
    slabs = SHARD_PAIRS // PAIR_BATCH
    local = tex.local_devices

    def go(alg, st, n, devs):
        """(payload, launches, wall s, devices) of a warmed-up run_chunk."""
        if devs is not None:
            tex.local_devices = lambda name: devs
        try:
            ex = tex.DeviceExecutor(alg, h, w, 1, 20, PAIR_BATCH, device=DEVICE,
                                    save_type=st, n_devices=n)
        finally:
            tex.local_devices = local
        ex.run_chunk(frames, len(frames))
        for k in PER_SLAB[alg]:
            kernels[k].launches = 0
        t0 = time.perf_counter()
        out = ex.run_chunk(frames, len(frames))
        wall = time.perf_counter() - t0
        return out, {k: kernels[k].launches for k in PER_SLAB[alg]}, wall, ex.devices

    for alg, per_slab in PER_SLAB.items():
        for st in ("jpg", "h5"):
            base, base_n, wall, devs = go(alg, st, 1, None)
            tag = f"[devices {alg} {st}]"
            log(f"{tag} 1 device ({devs[0]}): {SHARD_PAIRS} pairs at {h}x{w} in "
                f"{wall:.6g} s; launches {base_n}; {card}")
            if base_n != {k: v * slabs for k, v in per_slab.items()}:
                raise SystemExit(f"{tag} one device launched {base_n}")
            if st == "jpg":
                base_jpg = [encode_jpg(p) for planes in base for p in planes]
            for n, devs_in, label in layouts:
                out, n_l, wall, devs = go(alg, st, n if devs_in is None else 0, devs_in)
                if st == "jpg":
                    same = [encode_jpg(p) for planes in out for p in planes] == base_jpg
                    what = f"{len(base_jpg)} jpgs byte-identical"
                else:
                    same = bool(np.array_equal(out, base))
                    d = float(np.abs(out - base).max())
                    what = f"flow bit-equal (max |d| {d:.3g} px)"
                log(f"{tag} {label} ({', '.join(map(str, devs))}): {wall:.6g} s; "
                    f"{what}: {same}; launches {n_l}; {card}")
                if not same:
                    raise SystemExit(f"{tag} {label} differ from one device")
                if n_l != {k: n * v for k, v in base_n.items()}:
                    raise SystemExit(f"{tag} {label} launched {n_l}, not {n} x {base_n}")
    if n_cards < 2:
        log("[devices] one card: no multi-GPU run here; the CLI's --devices=0 "
            "against --devices=1 needs two")
        return
    files = {}
    for flag in (1, 0):
        out_root = work / f"out_devices{flag}"
        cfg = parse_args([str(video), f"-o={out_root}", "-a=tvl1", "-s=1", "-b=20",
                          "-st=jpg", "-ns=256", "--strict", f"--device={DEVICE}",
                          f"--devices={flag}"])
        stats: dict = {}
        if run(cfg, stats_out=stats) != 0 or stats["errors"]:
            raise SystemExit(f"--devices={flag} failed: {stats.get('errors')}")
        n_flows = stats["counters"].total_flows
        log(f"[devices cli] --devices={flag} on {stats['devices']}: {n_flows} flows in "
            f"{stats['wall_s']:.6g} s = {n_flows / stats['wall_s']:.6g} flows/s; stage "
            f"times " + ", ".join(f"{k} {v:.6g} s" for k, v in sorted(stats["stage_times"].items()))
            + f"; {card}")
        files[flag] = {p.name: p.read_bytes() for p in sorted((out_root / video.stem).iterdir())}
        shutil.rmtree(out_root)
    log(f"[devices cli] --devices=0 wrote {len(files[0])} files, byte-identical to "
        f"--devices=1: {files[0] == files[1]}")
    if len(files[1]) != 2 * (N_FRAMES - 1) or files[0] != files[1]:
        raise SystemExit("--devices=0 wrote other files than --devices=1")


def phase_distributed(work: Path, card: str) -> None:
    """--distributed: two processes of `python -m denseflow_tpu_torch` in one
    gloo group on 127.0.0.1 (DENSEFLOW_NUM_PROCESSES=2), on the card, over a
    list of two 100-frame cuts of the bench video: disjoint shards, both
    .done markers, one summary from host 0 with the global counts, and the
    files of one process running the whole list."""
    import socket

    from denseflow_tpu_torch.cli import parse_args, run

    cuts = [work / f"cut{i}.avi" for i in range(2)]
    for i, cut in enumerate(cuts):
        make_bench_video(cut, 100, first=100 * i)
    lst = work / "cuts.txt"
    lst.write_text("".join(f"{c}\n" for c in cuts))
    flags = ["-s=1", "-b=20", "-st=jpg", "-ns=256", f"--device={DEVICE}", ONE_CARD]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    topology = ("DENSEFLOW_NUM_PROCESSES", "DENSEFLOW_PROCESS_ID", "WORLD_SIZE",
                "RANK", "MASTER_ADDR", "MASTER_PORT")
    # gloo's sockets on the loopback too, beside the coordinator
    env = dict({k: v for k, v in os.environ.items() if k not in topology},
               GLOO_SOCKET_IFNAME="lo")
    cmd = [sys.executable, "-m", "denseflow_tpu_torch", str(lst), f"-o={work / 'dist'}",
           *flags, "-v", "--distributed", f"--coordinator=127.0.0.1:{port}"]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=dict(env, DENSEFLOW_NUM_PROCESSES="2",
                                                  DENSEFLOW_PROCESS_ID=str(r)))
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=SUBPROCESS_TIMEOUT) for p in procs]
    except subprocess.TimeoutExpired:
        raise SystemExit(f"--distributed hosts ran past {SUBPROCESS_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise SystemExit(f"--distributed host {r} failed: rc {p.returncode}\n"
                             f"{out[-1500:]}\n{err[-1500:]}")
    summaries = [[ln for ln in out.splitlines() if "flows) processed" in ln]
                 for out, _ in outs]
    owns = [[c.stem for c in cuts if f"{c}, frames" in out] for out, _ in outs]
    log(f"[distributed] 2 hosts in {wall:.6g} s (process start included): host 0 "
        f"took {owns[0]}, host 1 {owns[1]}; host 0: {summaries[0]}; host 1 printed "
        f"{len(summaries[1])} summaries; {card}")
    stats: dict = {}
    rc = run(parse_args([str(lst), f"-o={work / 'single'}", *flags]), stats_out=stats)
    one = {str(f.relative_to(work / "single")): f.read_bytes()
           for f in sorted((work / "single").rglob("*.jpg"))}
    two = {str(f.relative_to(work / "dist")): f.read_bytes()
           for f in sorted((work / "dist").rglob("*.jpg"))}
    done = [(work / "dist" / ".done" / c.stem).is_file() for c in cuts]
    log(f"[distributed] one process: rc {rc}, {len(one)} jpgs in {stats['wall_s']:.6g} s; "
        f"the two hosts' {len(two)} jpgs byte-identical: {two == one}; .done {done}")
    if owns != [["cut0"], ["cut1"]]:
        raise SystemExit("the hosts' shards are not cut0 / cut1")
    if not (len(summaries[0]) == 1 and "2 videos (200 frames, 198 tvl1 flows)"
            in summaries[0][0] and not summaries[1]):
        raise SystemExit("the global summary is not host 0's alone")
    if rc != 0 or not all(done) or len(one) != 4 * 99 or two != one:
        raise SystemExit("two hosts wrote other files than one process")


# ---------------- the wire codecs ----------------

WIRE_REPS = 5  # timed runs of each pack, decode and chunk wall


def _median_s(fn, reps: int) -> float:
    """Median wall seconds of fn() over `reps` runs after one warm-up, the
    card synchronised after each (perf_counter)."""
    import torch

    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _wire_chunk(frames: np.ndarray, st: str, card: str) -> None:
    """The main path's first chunk (127 pairs bucketed to 128) through the
    tvl1 executor with -st=st and --wirePack=1 on the card: the shard's pack
    against the CPU pack of the same payload (bytes of buf[:used], used),
    both decoders against the payload, the times, and one chunk's wall with
    --wirePack 0 and 1."""
    import torch

    import denseflow_tpu_torch.wire as W
    from denseflow_tpu_torch.executor import DeviceExecutor
    from denseflow_tpu_torch.native import wire as native_wire

    tag = f"[wire {st}]"
    n = len(frames)
    ex = {pack: DeviceExecutor("tvl1", *frames.shape[1:], 1, 20, PAIR_BATCH, device=DEVICE,
                               save_type=st, n_devices=1, wire_pack=pack)
          for pack in (False, True)}
    d = ex[True].dispatch_chunk(frames, n)[0]
    d.wait()
    p = d.packs[0]
    q = p.q
    m, c, h, w = q.shape if st != "h5" else (q.shape[0], 2, *q.shape[1:3])
    if st == "h5":
        pack = lambda t: W.pack_chunk_v4(t)
        dec = {"native": lambda b: native_wire.wire_unpack_v4(b, m, h, w),
               "numpy": lambda b: W.unpack_chunk_v4(b, m, h, w)}
        same_q = lambda out: np.array_equal(out.view(np.uint32), q_cpu.numpy().view(np.uint32))
    else:
        pack = lambda t: W.pack_chunk_v3(t, W.EXC_CAP)
        dec = {"native": lambda b: native_wire.wire_unpack_v3(b, m, c, h, w, W.EXC_CAP),
               "numpy": lambda b: W.unpack_chunk_v3(b, m, c, h, w, W.EXC_CAP)}
        same_q = lambda out: bool(out[0].all()) and np.array_equal(out[1], q_cpu.numpy())
    buf, used = pack(q)
    q_cpu = q.cpu()
    cbuf, cused = pack(q_cpu)
    used, cused = int(used), int(cused)
    card_bytes = buf[:used].cpu().numpy()
    same = (used == cused == int(p.used)
            and np.array_equal(card_bytes, cbuf[:cused].numpy())
            and np.array_equal(card_bytes, p.buf[:used].cpu().numpy()))
    pack_ms = cuda_ms(lambda: pack(q), WIRE_REPS)
    raw = q.nbytes
    log(f"{tag} {m} pairs at {h}x{w} ({tuple(q.shape)} {str(q.dtype).split('.')[-1]}): the "
        f"card's pack equals the CPU pack: {same} (used {used} / {cused} bytes); "
        f"pack {pack_ms:.6g} ms on the card; raw {raw} bytes against used {used} "
        f"({raw / used:.4g}x); {card}")
    if not same:
        raise SystemExit(f"{tag} the card's pack differs from the CPU pack")
    for name, fn in dec.items():
        t = _median_s(lambda: fn(card_bytes), WIRE_REPS)
        ok = same_q(fn(card_bytes))
        log(f"{tag} {name} decode of buf[:used] {t * 1e3:.6g} ms (median of {WIRE_REPS}); "
            f"equal to the raw payload: {ok}")
        if not ok:
            raise SystemExit(f"{tag} the {name} decode differs from the raw payload")
    walls = {}
    for pk, e in ex.items():
        want = e.run_chunk(frames, n)
        walls[pk] = _median_s(lambda: e.run_chunk(frames, n), WIRE_REPS)
        walls[f"out{int(pk)}"] = want
    a, b = walls["out0"], walls["out1"]
    equal = all(np.array_equal(x, y) for x, y in zip(a, b)) if st == "jpg" else \
        np.array_equal(np.asarray(a).view(np.uint32 if st == "h5" else np.uint8),
                       np.asarray(b).view(np.uint32 if st == "h5" else np.uint8))
    log(f"{tag} one {n}-frame chunk through run_chunk (median of {WIRE_REPS}): "
        f"--wirePack=0 {walls[False]:.6g} s, --wirePack=1 {walls[True]:.6g} s "
        f"(decoder {W.decoder()}); payloads equal: {equal}; {card}")
    if not equal:
        raise SystemExit(f"{tag} the packed chunk's payload differs from the raw one")


def phase_wire(video: Path, work: Path, card: str) -> None:
    """The wire codecs on the card: the decoder's build with g++ alone, the
    main path's first chunk (jpg and png; h5 too) packed on the card against
    the CPU, decoded by both decoders, timed; a 128-pair 1080x1920 float32
    noise chunk whose v4 `used` passes 2^31; and the CLI with --wirePack=1
    on the 500-frame video against --wirePack=0, file for file."""
    import torch

    import denseflow_tpu_torch.wire as W
    from denseflow_tpu_torch.cli import parse_args, run
    from denseflow_tpu_torch.kernels import _build
    from denseflow_tpu_torch.native import wire as native_wire

    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True)
    t0 = time.perf_counter()
    ok = native_wire.wire_available()
    log(f"[wire] {gxx.stdout.splitlines()[0] if gxx.returncode == 0 else 'no g++'}; "
        f"native/wire.cpp with {' '.join(_build.GXX_FLAGS + _build.WIRE_LIBS)} built "
        f"in {time.perf_counter() - t0:.3g} s: {ok}; decoder {W.decoder()}")
    if not ok:
        raise SystemExit(f"the wire decoder did not build:\n{native_wire.wire_build_error()}")
    frames = first_chunk(video, CHUNK_FRAMES)
    for st in ("jpg", "png", "h5"):
        _wire_chunk(frames, st, card)

    # v4 past 2^31: 128 pairs of 1080x1920 float32 noise
    m, h, w = 128, 1080, 1920
    gen = torch.Generator(device=DEVICE).manual_seed(17)
    flow = torch.randn((m, h, w, 2), device=DEVICE, generator=gen)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    buf, used = W.pack_chunk_v4(flow)
    end.record()
    torch.cuda.synchronize()
    pack_ms = start.elapsed_time(end)
    used = int(used)
    host = buf[:used].cpu().numpy()
    del buf
    t0 = time.perf_counter()
    out = native_wire.wire_unpack_v4(host, m, h, w)
    dec_s = time.perf_counter() - t0
    exact = np.array_equal(out.view(np.uint32), flow.cpu().numpy().view(np.uint32))
    log(f"[wire v4 1080p] {m} pairs at {h}x{w} float32 noise: used {used} bytes "
        f"(> 2^31: {used > 2 ** 31}; max {W.v4_max_size(m, h, w)}, raw {flow.nbytes}); "
        f"pack {pack_ms:.6g} ms on the card (one run, the first at this shape); native "
        f"decode {dec_s:.6g} s; bit-exact: {exact}; {card}")
    del flow, out, host
    torch.cuda.empty_cache()
    if not (exact and used > 2 ** 31):
        raise SystemExit("v4 did not round-trip a chunk past 2^31 bytes bit-exact")

    # the CLI, file for file; phase 5 wrote the --wirePack=0 jpgs
    files = {("jpg", 0): {p.name: p.read_bytes()
                          for p in sorted((work / "out_tvl1" / video.stem).iterdir())}}
    for st, pk in (("jpg", 1), ("png", 0), ("png", 1)):
        out_root = work / f"out_wire_{st}{pk}"
        cfg = parse_args([str(video), f"-o={out_root}", "-a=tvl1", "-s=1", "-b=20",
                          f"-st={st}", "-ns=256", "--strict", f"--device={DEVICE}",
                          ONE_CARD, f"--wirePack={pk}"])
        stats: dict = {}
        if run(cfg, stats_out=stats) != 0 or stats["errors"]:
            raise SystemExit(f"--wirePack={pk} -st={st} failed: {stats.get('errors')}")
        wire = stats["wire"]
        n_flows = stats["counters"].total_flows
        log(f"[wire cli] -st={st} --wirePack={pk}: {n_flows} flows in {stats['wall_s']:.6g} s "
            f"= {n_flows / stats['wall_s']:.6g} flows/s; stage times "
            + ", ".join(f"{k} {v:.6g} s" for k, v in sorted(stats["stage_times"].items()))
            + f"; writer {stats['writer']}; wire {wire['codec']} (decoder {wire['decoder']}), "
            f"{wire['d2h_bytes']} bytes down in {wire['d2h_calls']} copies, "
            f"{wire['fallbacks']} raw fallbacks; {card}")
        if wire["codec"] != ("v3" if pk else "raw"):
            raise SystemExit(f"--wirePack={pk} -st={st} ran the codec {wire['codec']}")
        files[(st, pk)] = {p.name: p.read_bytes()
                           for p in sorted((out_root / video.stem).iterdir())}
        shutil.rmtree(out_root)
    for st, n_want in (("jpg", 2 * (N_FRAMES - 1)), ("png", N_FRAMES - 1)):
        same = files[(st, 1)] == files[(st, 0)]
        log(f"[wire cli] -st={st}: --wirePack=1 wrote {len(files[(st, 1)])} files, "
            f"byte-identical to --wirePack=0's {len(files[(st, 0)])}: {same}")
        if len(files[(st, 0)]) != n_want or not same:
            raise SystemExit(f"--wirePack=1 wrote other {st} files than --wirePack=0")


def timed(n: int, fn, *args):
    """fn(*args), then phase n's wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[phase {n}] {fn.__name__} took {time.perf_counter() - t0:.4g} s")
    return out


def main() -> int:
    if not (ROOT / "denseflow_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: the denseflow_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from denseflow_tpu_torch.kernels import _build
    from denseflow_tpu_torch.kernels.brox_fused import brox_scale
    from denseflow_tpu_torch.kernels.farneback_fused import farneback_level, poly_expand
    from denseflow_tpu_torch.kernels.tvl1_fused import tvl1_scale

    card = nvidia_smi_line()
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s); {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.build(["tvl1_scale", "farneback_polyexp", "farneback_level", "brox_scale"])
    log(f"[build] tvl1_scale.cu, farneback_polyexp.cu, farneback_level.cu, "
        f"brox_scale.cu built in {time.perf_counter() - t0:.3g} s")
    for name, text in _build.BUILD_LOGS.items():
        for ln in text.splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"[build] {name}: {ln.strip()}")

    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        video = work / "bench.avi"
        t0 = time.perf_counter()
        make_bench_video(video, N_FRAMES)
        log(f"[video] made {N_FRAMES}-frame 360x480 MJPG in "
            f"{time.perf_counter() - t0:.3g} s")
        kernels = {"tvl1_scale": tvl1_scale, "poly_expand": poly_expand,
                   "farneback_level": farneback_level, "brox_scale": brox_scale}
        records, launches = [], {}
        records += timed(3, phase_kernels, video, card)
        timed(4, phase_fidelity)
        launches.update(timed(5, phase_main_path, video, work, card, "tvl1",
                              {"tvl1_scale": tvl1_scale}))
        timed(6, phase_escalation, work)
        records += timed(7, phase_farn_kernels, video, card)
        timed(8, phase_farn_fidelity)
        launches.update(timed(
            9, phase_main_path, video, work, card, "farn",
            {"poly_expand": poly_expand, "farneback_level": farneback_level},
            # every level's expansion in one launch, one launch a level
            {"poly_expand": 1, "farneback_level": 6}))
        records += timed(10, phase_brox_kernels, video, card)
        timed(11, phase_brox_fidelity)
        launches.update(timed(12, phase_main_path, video, work, card, "brox",
                              {"brox_scale": brox_scale}))
        timed(13, phase_emitter, work, card)
        timed(14, phase_save_types, video, work, card, tvl1_scale)
        timed(15, phase_devices, video, work, card, kernels)
        timed(16, phase_distributed, work, card)
        timed(17, phase_wire, video, work, card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for r in records:
        r["launches"] = launches[r["name"]]
    log(card)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
