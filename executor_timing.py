"""Time the port's executor on one card, tree against tree.

    python3 executor_timing.py ROOT [ROOT ...]

Each ROOT is a directory holding denseflow_tpu_torch/: this repo's root, or
an unpacked `git archive` of another commit. For each ROOT, in the order
given, a fresh process imports that tree's package, builds its kernels and
runs `DeviceExecutor` on one card over one chunk of the main path's size
(CHUNK_FRAMES frames of a panning texture at 256x341, `-s=1 -b=20 -st=jpg`,
16-pair slabs) for tvl1, farn and brox: WARM runs, then REPS timed runs.
A run's wall is the chunk's upload to its last byte on the host; its
enqueue is `dispatch_chunk`'s time, the host's part of the pipeline's
compute stage. Prints, a line a tree and algorithm, the median, min and
max of both and a sha256 of the payload, then the card's name and power
limit; exits non-zero unless every tree wrote the same bytes. Needs a CUDA
card; imports neither jax nor denseflow_tpu.
"""

from __future__ import annotations

import hashlib
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ALGORITHMS = ("tvl1", "farn", "brox")
H, W = 256, 341  # the main path's -ns=256 of a 360x480 video
CHUNK_FRAMES = 128  # FlowConfig.chunk_frames
PAIR_BATCH = 16  # FlowConfig.pair_batch
WARM, REPS = 2, 9
SEED = 7
CHILD_TIMEOUT = 600  # s, one tree's build and runs


def make_frames() -> np.ndarray:
    """(CHUNK_FRAMES, H, W) uint8: smoothed noise panning -2 px a frame."""
    import scipy.ndimage as ndi

    rng = np.random.default_rng(SEED)
    base = ndi.gaussian_filter(rng.uniform(0, 255, (H, W + 2 * CHUNK_FRAMES)), 2.0)
    base = (base - base.min()) / np.ptp(base) * 255
    return np.stack([base[:, 2 * t:2 * t + W] for t in range(CHUNK_FRAMES)]).astype(np.uint8)


def child(root: Path) -> None:
    """Time this tree's executor; print one JSON line of results."""
    sys.path.insert(0, str(root.resolve()))
    import torch

    from denseflow_tpu_torch.executor import DeviceExecutor

    if not torch.cuda.is_available():
        raise SystemExit("executor_timing: no CUDA device")
    kw = {"device": "cuda", "save_type": "jpg"}
    if "n_devices" in inspect.signature(DeviceExecutor).parameters:
        kw["n_devices"] = 1  # one card, as a tree without --devices runs
    frames = make_frames()
    out = {}
    for alg in ALGORITHMS:
        ex = DeviceExecutor(alg, H, W, 1, 20, PAIR_BATCH, **kw)
        walls, enqueues = [], []
        for i in range(WARM + REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            resident = ex.upload_chunk(frames)
            t1 = time.perf_counter()
            outs = ex.dispatch_chunk(resident, len(frames))
            t2 = time.perf_counter()
            payload = [p for p, _, _ in ex.collect_chunk(outs)]
            t3 = time.perf_counter()
            if i >= WARM:
                walls.append(t3 - t0)
                enqueues.append(t2 - t1)
        digest = hashlib.sha256()
        for planes in payload:
            for a in planes:
                digest.update(np.ascontiguousarray(a).tobytes())
        out[alg] = {"wall": walls, "enqueue": enqueues, "sha256": digest.hexdigest()[:16]}
    print(json.dumps(out), flush=True)


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        child(Path(argv[1]))
        return 0
    roots = argv or ["."]
    digests = {alg: set() for alg in ALGORITHMS}
    for root in roots:
        p = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child", root],
                           capture_output=True, text=True, timeout=CHILD_TIMEOUT)
        if p.returncode != 0:
            print(f"{root}: rc {p.returncode}\n{p.stdout[-2000:]}\n{p.stderr[-2000:]}",
                  file=sys.stderr)
            return 1
        res = json.loads(p.stdout.splitlines()[-1])
        for alg in ALGORITHMS:
            r = res[alg]
            digests[alg].add(r["sha256"])
            w, e = np.array(r["wall"]), np.array(r["enqueue"])
            print(f"{root} {alg}: wall median {np.median(w):.6g} min {w.min():.6g} max "
                  f"{w.max():.6g} s | enqueue median {np.median(e):.6g} min {e.min():.6g} "
                  f"max {e.max():.6g} s | {REPS} runs, {CHUNK_FRAMES - 1} pairs at {H}x{W} "
                  f"| sha256 {r['sha256']}", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip().splitlines()[0] if card.returncode == 0 else "nvidia-smi failed")
    same = all(len(d) == 1 for d in digests.values())
    print(f"payloads equal across trees: {same}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
