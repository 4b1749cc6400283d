"""What the cv2 writer's pool buys a cell, from trials interleaved in one
process: `bench_cuda.spread` with the writer's variants, where runs of one
tree in sequence differ by up to 21.7% in one call (PERF.md §4).

    python3 encode_pool_timing.py --cell=tvl1-jpg-ns256-multimotion --rounds=12 \\
        [--variants=A,serial,threads-2,threads-8] [--json-out=FILE]

* `A`: the cell as it runs: each item's jpgs or pngs on the pool of
  `native.DEFAULT_THREADS` worker threads (`io.writer.write_batch`).
* `serial`: the writer before it had a pool: on the encode thread, every
  image of the batch through `encode_jpg` / `encode_png`, then each file
  written in path order (the same bytes).
* `threads-<n>`: `A` with a pool of n threads.

The variants' order turns every round, so `--rounds=12` gives twelve
pairs of two variants, six in each order. After each trial it prints how
long a file took, median and 90th percentile: from the call into cv2 to
the return into Python on a worker (`A`, `threads-<n>`: the interpreter
lock's return included), or encode plus write (`serial`). Only the cv2
writer differs between the variants: where the native emitter is built,
the command refuses (exit 2), since no variant would reach that writer.
Prints what `bench_cuda.spread` prints besides.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import numpy as np

from bench_cuda import spread

_spread_variant = spread.variant


@contextlib.contextmanager
def variant(name: str):
    if name != "A" and name != "serial" and not name.startswith("threads-"):
        with _spread_variant(name):
            yield
        return
    import denseflow_tpu_torch.pipeline as pl
    from denseflow_tpu_torch import native
    from denseflow_tpu_torch.io import writer

    file_s = []
    imwrite = writer._imwrite

    def timed_imwrite(path, img):
        t0 = time.perf_counter()
        imwrite(path, img)
        file_s.append(time.perf_counter() - t0)

    def one_by_one(images, paths, pool):
        encode = {".jpg": writer.encode_jpg, ".png": writer.encode_png}
        t0 = time.perf_counter()
        blobs = [encode[os.path.splitext(p)[1]](im) for im, p in zip(images, paths)]
        for p, data in zip(paths, blobs):
            with open(p, "wb") as f:
                f.write(data)
        file_s.extend([(time.perf_counter() - t0) / max(len(paths), 1)] * len(paths))

    threads = native.DEFAULT_THREADS
    writer._imwrite = timed_imwrite
    if name == "serial":
        pl.write_batch = one_by_one
    elif name != "A":
        native.DEFAULT_THREADS = int(name[len("threads-"):])
    try:
        yield
    finally:
        writer._imwrite, pl.write_batch, native.DEFAULT_THREADS = imwrite, writer.write_batch, threads
        ms = np.array(file_s) * 1e3
        if len(ms):
            print(f"[encode_pool_timing] {name}: {len(ms)} files, {np.median(ms):.4g} ms a file "
                  f"(p90 {np.percentile(ms, 90):.4g})", flush=True)


def main(argv=None) -> int:
    from denseflow_tpu_torch import native

    if native.available():
        print("encode_pool_timing: the native emitter is built here, so no run "
              "reaches the cv2 writer", file=sys.stderr)
        return 2
    argv = sys.argv[1:] if argv is None else argv
    if not any(a.startswith("--variants=") for a in argv):
        argv = [*argv, "--variants=A,serial"]
    spread.variant = variant
    return spread.main(argv)


if __name__ == "__main__":
    sys.exit(main())
