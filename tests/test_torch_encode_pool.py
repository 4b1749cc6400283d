"""The cv2 writer of hosts where the native emitter does not build: each
chunk's jpgs or pngs, and step=0's frames, encoded and written on a pool
of `native.DEFAULT_THREADS` worker threads (`io.writer.write_batch`).

Every case breaks the emitter's build as a host without libjpeg does
(`_break_emitter`, as in tests/test_torch_emission.py) and holds the pooled
files byte for byte against the serial path they replace: `encode_jpg` /
`encode_png` one image at a time, then `write_flow_images` /
`write_images`, on the payloads the pipeline handed its writer.
"""

import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import make_translating_video
import denseflow_tpu_torch.extract_frames as xf
import denseflow_tpu_torch.pipeline as pl
from denseflow_tpu_torch import native
from denseflow_tpu_torch.cli import parse_args, run
from denseflow_tpu_torch.io import writer as twriter

torch.set_num_threads(1)

CPU = "--device=cpu"


def _break_emitter(m, message="g++ not found"):
    """Make the emitter's build fail with `message` (`m`: a monkeypatch)."""
    def fail(name):
        raise RuntimeError(message)

    m.setattr(native._build, "load", fail)
    m.setattr(native, "_lib", None)
    m.setattr(native, "_error", None)


def _tree(root):
    """Every file under `root`, `.done` markers included, by relative path."""
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(Path(root).rglob("*")) if p.is_file()}


def _video_list(tmp_path, count=2):
    vids = [make_translating_video(tmp_path / f"v{i}.avi", h=64, w=80, n=9, dx=2,
                                   seed=i)[0] for i in range(count)]
    lst = tmp_path / "list.txt"
    lst.write_text("\n".join(vids) + "\n")
    return lst


def _recording(m, cls, name, seen):
    """Wrap cls.name so that each call's arguments are kept in `seen`."""
    orig = getattr(cls, name)

    def rec(*args, _o=orig):
        seen.append(args)
        return _o(*args)

    m.setattr(cls, name, rec)


@pytest.mark.parametrize("step", [1, -1])
@pytest.mark.parametrize("st", ["jpg", "png"])
def test_pooled_tree_byte_identical_to_serial(tmp_path, monkeypatch, st, step):
    """Two videos, three writer items each: the same names, bytes and
    `.done` markers as the serial encode-then-write path, and each marker
    made after every file of its video was written."""
    lst = _video_list(tmp_path)
    items, written_at_done = [], []

    def mark_done(output_dir, has_class, _done=pl.mark_done):
        written_at_done.append(len(list(Path(output_dir).iterdir())))
        return _done(output_dir, has_class)

    with monkeypatch.context() as m:
        _break_emitter(m)
        _recording(m, pl.Pipeline, "_write_item", items)
        m.setattr(pl, "mark_done", mark_done)
        stats = {}
        assert run(parse_args([str(lst), f"-o={tmp_path / 'pool'}", "-a=farn", f"-s={step}",
                               "-b=8", f"-st={st}", "--chunkFrames=4", CPU]),
                   stats_out=stats) == 0
    assert stats["writer"] == "cv2: emitter not built (g++ not found)"
    assert len(items) == 6
    assert written_at_done == [8 * (2 if st == "jpg" else 1)] * 2
    serial = tmp_path / "serial"
    for _, it in items:
        out = serial / Path(it.output_dir).relative_to(tmp_path / "pool")
        out.mkdir(parents=True, exist_ok=True)
        if st == "jpg":
            for prefix, planes in zip(("flow_x", "flow_y"), it.payload):
                twriter.write_flow_images([twriter.encode_jpg(p) for p in planes],
                                          f"{out}/{prefix}", step, it.base_start)
        else:
            twriter.write_flow_images_png([twriter.encode_png(p) for p in it.payload],
                                          f"{out}/flow", step, it.base_start)
        if it.last_buffer:
            twriter.mark_done(str(out), False)
    pooled = _tree(tmp_path / "pool")
    assert pooled == _tree(serial)
    assert len(pooled) == 2 * (8 * (2 if st == "jpg" else 1) + 1)
    assert {k for k in pooled if k.startswith(".done")} == {".done/v0", ".done/v1"}


@pytest.mark.parametrize("ext", ["jpg", "png"])
@pytest.mark.parametrize("channels", [0, 3])
def test_write_batch_bytes_equal_encoders(tmp_path, ext, channels):
    """Gray and BGR, noise, a ramp and a flat image, strided views too."""
    rng = np.random.default_rng(5)
    shape = (37, 53) + ((channels,) if channels else ())
    imgs = [rng.integers(0, 256, shape, dtype=np.uint8),
            np.broadcast_to(np.linspace(0, 255, 53).astype(np.uint8)[:, None]
                            if channels else np.linspace(0, 255, 53).astype(np.uint8),
                            shape).copy(),
            np.full(shape, 128, np.uint8),
            rng.integers(0, 256, (74,) + shape[1:], dtype=np.uint8)[::2]]
    paths = [str(tmp_path / f"{i}.{ext}") for i in range(len(imgs))]
    with ThreadPoolExecutor(native.DEFAULT_THREADS) as pool:
        twriter.write_batch(imgs, paths, pool)
    encode = twriter.encode_jpg if ext == "jpg" else twriter.encode_png
    for img, p in zip(imgs, paths):
        assert Path(p).read_bytes() == encode(img)


def test_write_batch_raises_the_first_failure_after_every_task(tmp_path):
    imgs = [np.zeros((8, 8), np.uint8)] * 4
    paths = [str(tmp_path / "a.jpg"), str(tmp_path / "no_dir" / "b.jpg"),
             str(tmp_path / "c.jpg"), str(tmp_path / "no_dir" / "d.jpg")]
    with ThreadPoolExecutor(2) as pool:
        with pytest.raises(RuntimeError, match=r"could not write .*/no_dir/b\.jpg"):
            twriter.write_batch(imgs, paths, pool)
        with pytest.raises(ValueError, match="4 images but 3 paths"):
            twriter.write_batch(imgs, paths[:3], pool)
    assert sorted(p.name for p in tmp_path.glob("*.jpg")) == ["a.jpg", "c.jpg"]


@pytest.mark.parametrize("strict", [False, True])
def test_failed_encode_is_the_videos_error(tmp_path, monkeypatch, strict):
    """A worker that cannot write v1's last flow_y file (a directory holds
    its name): v1 is reported and gets no `.done` marker, v0 completes;
    under --strict `cli.run` raises."""
    lst = _video_list(tmp_path)
    out = tmp_path / "out"
    (out / "v1" / "flow_y_00007.jpg").mkdir(parents=True)
    _break_emitter(monkeypatch)
    args = [str(lst), f"-o={out}", "-a=farn", "-s=1", "-b=8", "--chunkFrames=4", CPU]
    if strict:
        with pytest.raises(RuntimeError, match=r"could not write .*/v1/flow_y_00007\.jpg"):
            run(parse_args(args + ["--strict"]))
    else:
        stats = {}
        assert run(parse_args(args), stats_out=stats) == 1
        assert [e.video_path for e in stats["errors"]] == [str(out / "v1")]
        assert "could not write" in stats["errors"][0].error
        assert (out / ".done" / "v0").is_file()
        assert len(list((out / "v0").iterdir())) == 16
    assert not (out / ".done" / "v1").exists()


def test_pool_is_shut_down_after_launch(tmp_path, monkeypatch):
    """The pipeline's one pool: every worker thread has ended when the run
    returns."""
    path, _ = make_translating_video(tmp_path / "v.avi", h=64, w=80, n=9, dx=2)
    _break_emitter(monkeypatch)
    pools = []
    _recording(monkeypatch, pl, "write_batch", pools)
    assert run(parse_args([path, f"-o={tmp_path / 'o'}", "-a=farn", "-s=1", "-b=8",
                           "--chunkFrames=4", CPU])) == 0
    assert len(pools) == 3 and all(b[2] is pools[0][2] for b in pools)
    assert not [t for t in threading.enumerate() if t.name.startswith("encode")]
    with pytest.raises(RuntimeError):
        pools[0][2].submit(print)


def test_step0_frames_byte_identical_to_serial(tmp_path, monkeypatch):
    """step=0 extraction through the pool: the `img_%05d.jpg` tree of
    `encode_jpg` + `write_images`, over chunks of 4 frames."""
    path, _ = make_translating_video(tmp_path / "v.avi", h=64, w=80, n=9, dx=2)
    batches = []
    with monkeypatch.context() as m:
        _break_emitter(m)
        _recording(m, xf, "write_batch", batches)
        assert run(parse_args([path, f"-o={tmp_path / 'pool'}", "-s=0",
                               "--chunkFrames=4", CPU])) == 0
    assert [len(b[0]) for b in batches] == [4, 4, 1]
    serial = tmp_path / "serial" / "v"
    serial.mkdir(parents=True)
    idx = 0
    for frames, _, _ in batches:
        assert frames[0].shape == (64, 80, 3)
        twriter.write_images([twriter.encode_jpg(f) for f in frames], f"{serial}/img", idx)
        idx += len(frames)
    pooled = _tree(tmp_path / "pool")
    assert pooled == _tree(tmp_path / "serial") and len(pooled) == 9
