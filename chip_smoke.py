"""Drive denseflow_tpu_torch on one CUDA card and check what comes out.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero):

1. environment: torch / CUDA versions, the card's name and power limit;
2. build every kernel of the main path from csrc/ (one nvcc per source,
   started together) and print the build time;
3. each kernel against its plain PyTorch version, on the card: at every
   pyramid scale of one main-path slab (16 pairs of the bench video,
   decoded and resized to 256x341 by the port's reader, through the port's
   `tvl1_flow`), timed with CUDA events beside its bound; then at an odd
   shape and with a flow beyond the displacement clamp;
4. full-width fidelity: the port's TVL1 on the repo's goldens
   (tests/golden/*.npz), mean EPE <= 0.5 px against the oracle and the
   analytic flow, the repo's gate (tests/test_fidelity.py);
5. the main path end to end through the CLI's `run`:
   `-a=tvl1 -s=1 -b=20 -st=jpg -ns=256 --strict` on a 500-frame 360x480
   MJPG, with the kernels' launch counts set to 0 before it and read after;
6. auto-escalation: motion past the default 40 px clamp makes the pipeline
   re-solve at maxDisp 80 and 1020 and track it.

The last three lines are the card's name and power limit, the kernels'
JSON record and {"ok": true, "device": {...}}. Without a CUDA device, or
without the package beside it, the script exits non-zero and prints no
result. It imports neither jax nor denseflow_tpu.
"""

from __future__ import annotations

import json
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
GATE = 0.5  # px, mean EPE (tests/test_fidelity.py)
KERNEL_TOL = 1e-3  # px, mean |du| of the kernel vs its plain version

# Published H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# f32 operations the TVL1 scale does per pixel, counted from
# csrc/tvl1_scale.cu: one primal-dual iteration (23 primal + 30 dual; the
# epsilon sum adds 7 on one iteration in check_every) and one warp (two
# 4-tap bicubic passes of ~110 each plus ~14 for the warp constants).
OPS_PER_PX_ITER = 53
OPS_PER_PX_WARP = 235


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


def tvl1_bound_ms(counts, h: int, w: int):
    """(bytes time, operations time) in ms of one tvl1_scale call: 6 input
    planes read once and 2 output planes written once, and the f32
    operations of the iterations and warps these pairs ran (`counts`)."""
    n_px = h * w
    nbytes = 8 * counts.shape[0] * n_px * 4
    ops = float((counts[:, 0].double() * OPS_PER_PX_ITER
                 + counts[:, 1].double() * OPS_PER_PX_WARP).sum()) * n_px
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3


def make_bench_video(path: Path, n_frames: int) -> None:
    """The bench video recipe (bench.py:41-59): 360x480 MJPG whose content
    moves -2 px per frame horizontally."""
    import cv2
    import scipy.ndimage as ndi

    h_src, w_src = 360, 480
    rng = np.random.default_rng(0)
    pad = 2 * n_frames + 8
    base = ndi.gaussian_filter(
        rng.uniform(0, 255, (h_src + 16, w_src + pad)), 2.0
    ).astype(np.float32)
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 25, (w_src, h_src))
    if not vw.isOpened():
        raise RuntimeError("cannot open the video writer")
    for t in range(n_frames):
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


def _compare(name, args, kw):
    """tvl1_scale vs tvl1_scale_reference on the same card tensors; returns
    (kernel out, max |du|) and fails over KERNEL_TOL."""
    import torch

    from denseflow_tpu_torch.kernels.tvl1_fused import tvl1_scale, tvl1_scale_reference

    k = tvl1_scale(*args, **kw)
    r = tvl1_scale_reference(*args, **kw)
    torch.cuda.synchronize()
    du = torch.cat([(k[0] - r[0]).abs().flatten(), (k[1] - r[1]).abs().flatten()])
    mean_d, max_d = float(du.mean()), float(du.max())
    log(f"[kernel] tvl1_scale {name}: mean|du| {mean_d:.3g} px, max|du| "
        f"{max_d:.3g} px (limit mean {KERNEL_TOL}); iterations kernel "
        f"{k[2][:, 0].tolist()} plain {r[2][:, 0].tolist()}; warps kernel "
        f"{k[2][:, 1].tolist()} plain {r[2][:, 1].tolist()}")
    if not (mean_d <= KERNEL_TOL):
        raise SystemExit(f"tvl1_scale disagrees with its plain version on {name}")
    return k, max_d


def main_path_slab(video: Path):
    """The main path's first slab: PAIR_BATCH pairs of step 1, decoded and
    resized to short side 256 by the port's reader as the CLI does it."""
    from denseflow_tpu_torch.config import FlowConfig
    from denseflow_tpu_torch.io.reader import VideoSource

    cfg = FlowConfig(input=str(video), new_short=256, chunk_frames=PAIR_BATCH + 1)
    src = VideoSource(str(video), cfg)
    try:
        frames = next(src.chunks(1)).frames
    finally:
        src.close()
    return frames[:PAIR_BATCH], frames[1:PAIR_BATCH + 1]


def phase_kernels(video: Path, card: str) -> list:
    """tvl1_scale (CUDA) vs tvl1_scale_reference (PyTorch) on the card."""
    import torch

    import denseflow_tpu_torch.algorithms.tvl1 as tv
    from denseflow_tpu_torch.kernels.tvl1_fused import tvl1_scale, tvl1_scale_reference
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
        k, max_d = _compare(f"main path {h}x{w} B={b} max_disp "
                            f"{kw['max_disp']:g}", args, kw)
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
    log(f"[kernel] tvl1_scale one slab, {len(calls)} scales: kernel "
        f"{totals['ms']:.6g} ms, plain {totals['plain_ms']:.6g} ms; {card}")

    rng = np.random.default_rng(3)
    extra = [
        # (name, B, h, w, max_disp, initial u)
        ("odd 37x53 B=3", 3, 37, 53, 4.0, 0.0),
        ("clamp 64x80 B=4 (u0 beyond max_disp)", 4, 64, 80, 3.0, 7.5),
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
        k, max_d = _compare(name, args, kw)
        worst = max(worst, max_d)
        # each pair alone gives the bytes it gave in the batch: the stop
        # test of a pair does not depend on its batch-mates
        for i in range(b):
            one = tvl1_scale(*(a[i:i + 1].contiguous() for a in args), **kw)
            if not all(torch.equal(x[i:i + 1], y) for x, y in zip(k, one)):
                raise SystemExit(f"tvl1_scale pair {i} of {name} depends on its batch")
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


def phase_main_path(video: Path, work: Path, card: str) -> dict:
    """The main path through the CLI's run(); returns launches per kernel."""
    import cv2

    from denseflow_tpu_torch.cli import parse_args, run
    from denseflow_tpu_torch.kernels.tvl1_fused import tvl1_scale

    cfg = parse_args([str(video), f"-o={work / 'out'}", "-a=tvl1", "-s=1",
                      "-b=20", "-st=jpg", "-ns=256", "--strict",
                      f"--device={DEVICE}"])
    stats: dict = {}
    tvl1_scale.launches = 0
    rc = run(cfg, stats_out=stats)
    launches = {"tvl1_scale": tvl1_scale.launches}
    if rc != 0 or stats["errors"]:
        raise SystemExit(f"main path failed: rc {rc}, errors {stats['errors']}")
    out = work / "out" / video.stem
    fx = sorted(out.glob("flow_x_*.jpg"))
    fy = sorted(out.glob("flow_y_*.jpg"))
    n_flows = stats["counters"].total_flows
    slabs = main_path_slabs()
    log(f"[main] rc {rc}; {len(fx)} flow_x + {len(fy)} flow_y jpgs; "
        f"{n_flows} flows in {stats['wall_s']:.6g} s = "
        f"{n_flows / stats['wall_s']:.6g} flows/s end to end; stage times "
        + ", ".join(f"{k} {v:.6g} s" for k, v in sorted(stats["stage_times"].items()))
        + f"; tvl1_scale launches {launches['tvl1_scale']} over {slabs} slabs "
        f"({launches['tvl1_scale'] / slabs:.3g} per slab); {card}")
    n_want = N_FRAMES - 1
    if len(fx) != n_want or len(fy) != n_want or n_flows != n_want:
        raise SystemExit(f"main path did not write {n_want} + {n_want} flow jpgs")
    if launches["tvl1_scale"] <= 0:
        raise SystemExit("main path never launched tvl1_scale")
    # content moves -2 px/frame at width 480: -2*341/480 px at 341
    want_x = 255.0 * (-2.0 * 341 / 480 + 20) / 40
    want_y = 127.5
    for i in (n_want // 5, n_want // 2, 4 * n_want // 5):
        gx = cv2.imread(str(fx[i]), cv2.IMREAD_GRAYSCALE)[20:-20, 20:-20].mean()
        gy = cv2.imread(str(fy[i]), cv2.IMREAD_GRAYSCALE)[20:-20, 20:-20].mean()
        log(f"[main] {fx[i].name}: centre flow_x {gx:.2f} (want {want_x:.2f}), "
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
                      "--strict", "-v", f"--device={DEVICE}"])
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

    card = nvidia_smi_line()
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s); {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.build(["tvl1_scale"])
    log(f"[build] tvl1_scale.cu built in {time.perf_counter() - t0:.3g} s")
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
        records = phase_kernels(video, card)
        phase_fidelity()
        launches = phase_main_path(video, work, card)
        phase_escalation(work)
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
