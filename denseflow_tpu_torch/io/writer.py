"""Emission layer: file naming grammar, jpg/png/h5 writers, .done markers.

Byte-compatible with the reference's output contract, as the JAX package's
`denseflow_tpu/io/writer.py` implements it:

* frame files `img_%05d.jpg` starting at `start`
  (reference src/common.cpp:73-82);
* flow files `<prefix>_p{step}_%05d.{ext}` for step>1, `_m{-step}_` for
  step<0, plain `_%05d` for step==1, with index offset
  `base = step>0 ? 0 : -step` so backward flow is named by its *right*
  frame (reference src/common.cpp:84-118);
* per-video h5 file `<outdir>[_p{s}|_m{s}].h5` holding float32 datasets
  `/flow_x_%05d` / `/flow_y_%05d` with the same infix
  (reference src/common.cpp:120-150, src/denseflow_gpu.cpp:223-242);
* `.done/<class?>/<stem>` resume markers
  (reference src/denseflow_gpu.cpp:456-470, tools/denseflow.cpp:63-76).

cv2 encodes here: one image at a time (`encode_jpg`, `encode_png`), or a
batch on a pool of worker threads (`write_batch`), the same bytes either
way; the native emitter (native/) writes the same names from its own
worker pool where it is built.
"""

from __future__ import annotations

from concurrent.futures import Executor, wait
from pathlib import Path
from typing import Sequence, Tuple

import cv2
import numpy as np

try:
    import h5py

    HAVE_H5 = True
except ImportError:  # pragma: no cover
    HAVE_H5 = False


def _step_infix(step: int) -> str:
    if step > 1:
        return f"_p{step}"
    if step < 0:
        return f"_m{-step}"
    return ""


def flow_file_name(prefix: str, step: int, index: int, ext: str = "jpg") -> str:
    """`flow_x` + step/index grammar -> `flow_x_p2_00007.jpg` etc.

    `index` is the final frame index (caller applies the `base` offset)."""
    return f"{prefix}{_step_infix(step)}_{index:05d}.{ext}"


def h5_file_name(output_dir: str, step: int) -> str:
    """Per-video h5 path: `<outdir>[_p{s}|_m{s}].h5` (sibling of outdir)."""
    return str(output_dir) + _step_infix(step) + ".h5"


def step_base(step: int) -> int:
    """Index offset: backward flow at pair i is named by the right frame."""
    return 0 if step > 0 else -step


def write_images(
    images: Sequence[bytes], name_prefix: str, start: int, ext: str = "jpg"
) -> None:
    """`img_%05d.jpg` writer (frame-extraction path)."""
    for i, data in enumerate(images):
        with open(f"{name_prefix}_{start + i:05d}.{ext}", "wb") as f:
            f.write(data)


def write_flow_images(
    images: Sequence[bytes], name_prefix: str, step: int, start: int, ext: str = "jpg"
) -> None:
    base = step_base(step)
    infix = _step_infix(step)
    for i, data in enumerate(images):
        with open(f"{name_prefix}{infix}_{start + i + base:05d}.{ext}", "wb") as f:
            f.write(data)


def write_flow_images_png(
    images: Sequence[bytes], name_prefix: str, step: int, start: int
) -> None:
    write_flow_images(images, name_prefix, step, start, ext="png")


def encode_jpg(img: np.ndarray) -> bytes:
    ok, buf = cv2.imencode(".jpg", img)
    if not ok:
        raise RuntimeError("jpg encode failed")
    return buf.tobytes()


def encode_png(img: np.ndarray) -> bytes:
    ok, buf = cv2.imencode(".png", img)
    if not ok:
        raise RuntimeError("png encode failed")
    return buf.tobytes()


def _imwrite(path: str, img: np.ndarray) -> None:
    if not cv2.imwrite(path, img):
        raise RuntimeError(f"cv2 could not write {path}")


def write_batch(
    images: Sequence[np.ndarray], paths: Sequence[str], pool: Executor
) -> None:
    """Encode and write images[i] to paths[i], one task a file on `pool`'s
    workers; cv2 picks jpg or png from the path and writes the bytes of
    `encode_jpg` / `encode_png`. Each task is one cv2 call, which releases
    the interpreter lock while it encodes and writes. Returns once every
    task has ended; the first failure in path order raises here."""
    if len(images) != len(paths):
        raise ValueError(f"{len(images)} images but {len(paths)} paths")
    futures = [pool.submit(_imwrite, p, im) for im, p in zip(images, paths)]
    wait(futures)
    for f in futures:
        f.result()


def create_h5_file(output_dir: str, step: int) -> str:
    """Create (truncate) the per-video h5 upfront, as the reference does
    (reference src/denseflow_gpu.cpp:223-242) — makes partial files
    self-healing on rerun."""
    if not HAVE_H5:
        raise RuntimeError("HDF5 support is not available")
    path = h5_file_name(output_dir, step)
    with h5py.File(path, "w"):
        pass
    return path


def write_hdf5(
    planes: Sequence[np.ndarray], output_dir: str, phase: str, step: int, start: int
) -> None:
    """Append float32 2-D datasets `/<phase><infix>_%05d` to the video's h5;
    a name already there is deleted first."""
    if not HAVE_H5:
        raise RuntimeError("HDF5 support is not available")
    path = h5_file_name(output_dir, step)
    base = step_base(step)
    infix = _step_infix(step)
    with h5py.File(path, "a") as f:
        for i, plane in enumerate(planes):
            name = f"{phase}{infix}_{start + i + base:05d}"
            if name in f:
                del f[name]
            f.create_dataset(name, data=np.asarray(plane, dtype=np.float32))


def done_paths(
    output_root: str, video_path: str, has_class: bool
) -> Tuple[str, str, str]:
    """(outdir, donedir, donefile) for one video, mirroring the reference's
    layout (reference tools/denseflow.cpp:63-70)."""
    vid = Path(video_path)
    out_root = Path(output_root)
    if has_class:
        cls = vid.parent.name
        outdir = out_root / cls / vid.stem
        donedir = out_root / ".done" / cls
    else:
        outdir = out_root / vid.stem
        donedir = out_root / ".done"
    return str(outdir), str(donedir), str(donedir / vid.stem)


def mark_done(output_dir: str, has_class: bool) -> str:
    """Create the empty `.done` marker for a finished video, deriving paths
    from the video's output dir (reference src/denseflow_gpu.cpp:456-470)."""
    out = Path(output_dir)
    if has_class:
        donedir = out.parent.parent / ".done" / out.parent.name
    else:
        donedir = out.parent / ".done"
    donedir.mkdir(parents=True, exist_ok=True)
    donefile = donedir / out.stem
    donefile.touch()
    return str(donefile)
