"""Emission layer: file naming grammar, jpg encoding, .done markers.

Byte-compatible with the reference's output contract, as the JAX package's
`denseflow_tpu/io/writer.py` implements it:

* frame files `img_%05d.jpg` starting at `start`
  (reference src/common.cpp:73-82);
* flow files `<prefix>_p{step}_%05d.{ext}` for step>1, `_m{-step}_` for
  step<0, plain `_%05d` for step==1, with index offset
  `base = step>0 ? 0 : -step` so backward flow is named by its *right*
  frame (reference src/common.cpp:84-118);
* `.done/<class?>/<stem>` resume markers
  (reference src/denseflow_gpu.cpp:456-470, tools/denseflow.cpp:63-76).

The png and h5 writers are not ported yet (ROADMAP.md A6).
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence, Tuple

import cv2
import numpy as np


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


def encode_jpg(img: np.ndarray) -> bytes:
    ok, buf = cv2.imencode(".jpg", img)
    if not ok:
        raise RuntimeError("jpg encode failed")
    return buf.tobytes()


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
