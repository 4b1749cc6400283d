"""The port's pipeline held to the JAX package's end-to-end contracts
(tests/test_pipeline_e2e.py), each run with --device=cpu: class folders,
pooled decode, a hard kill and rerun, --preset, frame-folder input,
randomized stage delays; and the tvl1 png and h5 files against the JAX
CLI's (its fused path through the Pallas interpreter).

TVL1 tolerances (the port's plain kernel against the Pallas interpreter;
ROADMAP.md C): png at most 1 level on fewer than 1% of the values, h5 max
|d| <= 1e-2 px and mean <= 1e-3 px (measured: 1 level on 0.034%, max
4.9e-4 px, mean 1.3e-5 px).
"""

import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from conftest import make_translating_video
from denseflow_tpu.cli import main as j_main
from denseflow_tpu_torch.cli import main
from test_torch_emission import assert_h5_close, assert_png_close, j_main_fused, read_h5

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CPU = "--device=cpu"


def _expected_quant(val, bound):
    return round(255.0 * (val + bound) / (2.0 * bound))


def _tree(out, skip_done=False):
    """Every file under `out` (h5 files by their datasets) by relative path."""
    files = {}
    for p in sorted(Path(out).rglob("*")):
        if not p.is_file() or (skip_done and ".done" in p.parts):
            continue
        key = p.relative_to(out).as_posix()
        files[key] = ({k: v.tobytes() for k, v in read_h5(p).items()}
                      if p.suffix == ".h5" else p.read_bytes())
    return files


@pytest.fixture
def vid(tmp_path):
    # content flow is (-2, 0): the crop window moves right 2 px/frame
    return make_translating_video(tmp_path / "v.avi", h=64, w=80, n=9, dx=2)


def _video_list(tmp_path, count, **kw):
    vids = [make_translating_video(tmp_path / f"v{i}.avi", seed=i, **kw)[0]
            for i in range(count)]
    lst = tmp_path / "list.txt"
    lst.write_text("\n".join(vids) + "\n")
    return lst


# ---------------- A13: the pipeline's contracts ----------------

@pytest.mark.parametrize("st", ["jpg", "png"])
def test_class_folder_output(tmp_path, st):
    """tests/test_pipeline_e2e.py:228."""
    d = tmp_path / "Jump"
    d.mkdir()
    p, _ = make_translating_video(d / "a.avi", h=48, w=64, n=4, dx=1)
    lst = tmp_path / "list.txt"
    lst.write_text(p + "\n")
    out = tmp_path / "out"
    assert main([str(lst), f"-o={out}", "-s=1", "-cf", "-a=nv", f"-st={st}",
                 "--pairBatch=4", CPU]) == 0
    first = "flow_x_00000.jpg" if st == "jpg" else "flow_00000.png"
    assert (out / "Jump" / "a" / first).is_file()
    assert (out / ".done" / "Jump" / "a").is_file()


def test_class_folder_h5(tmp_path):
    d = tmp_path / "Jump"
    d.mkdir()
    p, _ = make_translating_video(d / "a.avi", h=48, w=64, n=4, dx=1)
    lst = tmp_path / "list.txt"
    lst.write_text(p + "\n")
    out = tmp_path / "out"
    args = [str(lst), "-s=-1", "-cf", "-a=nv", "-st=h5", "--pairBatch=4"]
    assert main(args + [f"-o={out}", CPU]) == 0
    assert j_main(args + [f"-o={tmp_path / 'j'}"]) == 0
    assert sorted(read_h5(out / "Jump" / "a_m1.h5")) == \
        sorted(read_h5(tmp_path / "j" / "Jump" / "a_m1.h5"))
    assert (out / ".done" / "Jump" / "a").is_file()


def test_pooled_decode_byte_identical_to_serial(tmp_path):
    """tests/test_pipeline_e2e.py:241: 5 videos of different sizes decoded
    by 3 workers interleave their chunks; every file equals the serial
    run's."""
    vids = []
    for i in range(5):
        p, _ = make_translating_video(
            tmp_path / f"v{i}.avi", h=40 + 8 * (i % 2), w=56, n=6 + i, dx=1, seed=10 + i)
        vids.append(p)
    lst = tmp_path / "list.txt"
    lst.write_text("\n".join(vids) + "\n")

    def run(out, workers):
        assert main([str(lst), f"-o={out}", "-a=nv", "-s=1", "-b=8", "--pairBatch=4",
                     "--chunkFrames=4", f"--decodeWorkers={workers}", "-f", CPU]) == 0
        return _tree(out)

    serial = run(tmp_path / "o1", 1)
    assert len([k for k in serial if k.endswith(".jpg")]) == 2 * sum(5 + i for i in range(5))
    assert run(tmp_path / "o3", 3) == serial


_CRASH = """
import os, sys
import denseflow_tpu_torch.pipeline as pl
real = pl.mark_done
def dying_mark_done(*a, **kw):
    real(*a, **kw)
    os._exit(9)
pl.mark_done = dying_mark_done
from denseflow_tpu_torch.cli import main
main(sys.argv[1:])
"""


@pytest.mark.parametrize("st", ["jpg", "h5"])
def test_kill_midlist_rerun_matches_clean(tmp_path, st):
    """tests/test_pipeline_e2e.py:280: os._exit right after the first
    video's .done marker (no queue drain, no atexit), then a rerun: the
    done video is skipped, the rest redone (an h5 file is truncated when
    its video opens), and the tree equals an uninterrupted run's."""
    lst = _video_list(tmp_path, 3, h=48, w=64, n=5, dx=1)
    args = [str(lst), "-s=1", "-a=nv", f"-st={st}", "--pairBatch=4", CPU]
    clean = tmp_path / "clean"
    assert main(args + [f"-o={clean}"]) == 0
    crash = tmp_path / "crash"
    proc = subprocess.run([sys.executable, "-c", _CRASH, *args, f"-o={crash}"],
                          cwd=ROOT, capture_output=True, timeout=300)
    assert proc.returncode == 9, proc.stderr.decode()[-500:]
    assert len(list((crash / ".done").iterdir())) == 1
    assert main(args + [f"-o={crash}"]) == 0
    assert _tree(crash, skip_done=True) == _tree(clean, skip_done=True)
    assert len(list((crash / ".done").iterdir())) == 3


def test_fast_preset_changes_output_but_stays_accurate(vid, tmp_path):
    """tests/test_pipeline_e2e.py:347."""
    path, (fx, _) = vid

    def run(out, *preset):
        assert main([path, f"-o={out}", "-s=1", "-b=8", "--pairBatch=4", *preset, CPU]) == 0
        return _tree(Path(out) / "v")

    default = run(tmp_path / "default")
    fast = run(tmp_path / "fast", "--preset=fast")
    assert fast.keys() == default.keys() and len(fast) == 16
    assert fast != default  # fewer warps/iterations -> different bytes
    img = cv2.imread(str(tmp_path / "fast" / "v" / "flow_x_00004.jpg"), cv2.IMREAD_GRAYSCALE)
    assert abs(img[16:-16, 16:-16].mean() - _expected_quant(fx, 8)) < 6


@pytest.mark.parametrize("st", ["jpg", "png"])
def test_frame_folder_input(vid, tmp_path, st):
    """tests/test_pipeline_e2e.py:375: -s=0 extracts colour frames (through
    the emitter), -if reads them back as the input of a flow run."""
    path, (fx, _) = vid
    assert main([path, f"-o={tmp_path / 'frames'}", "-s=0"]) == 0
    folder = tmp_path / "frames" / "v"
    assert len(list(folder.glob("img_*.jpg"))) == 9
    out = tmp_path / "flow"
    assert main([str(folder), f"-o={out}", "-s=1", "-if", "-b=8", f"-st={st}",
                 "--pairBatch=4", CPU]) == 0
    if st == "jpg":
        files = sorted((out / "v").glob("flow_x_*.jpg"))
        img = cv2.imread(str(files[4]), cv2.IMREAD_GRAYSCALE)
        assert len(files) == 8 and abs(img[16:-16, 16:-16].mean() - _expected_quant(fx, 8)) < 5
    else:
        files = sorted((out / "v").glob("flow_*.png"))
        img = cv2.imread(str(files[4]), cv2.IMREAD_UNCHANGED)
        bx = float(img[0, 0, 2]) * 4
        rec = (img[16:-16, 16:-16, 0].astype(np.float32) - 128.0) * bx / 128.0
        assert len(files) == 8 and abs(rec.mean() - fx) < 0.3


@pytest.mark.parametrize("st", ["jpg", "png", "h5"])
def test_randomized_stage_delays(tmp_path, monkeypatch, st):
    """tests/test_pipeline_e2e.py:405: random delays in the compute stage's
    collect and in the writer; chunked and jittered runs equal the clean
    one."""
    import random
    import time

    import denseflow_tpu_torch.executor as ex_mod
    import denseflow_tpu_torch.pipeline as pl_mod

    path, _ = make_translating_video(tmp_path / "v.avi", h=48, w=64, n=12, dx=1)

    def run(out, chunk):
        assert main([path, f"-o={out}", "-a=nv", "-s=1", "-b=8", f"-st={st}",
                     f"--chunkFrames={chunk}", "--pairBatch=2", CPU]) == 0
        files = _tree(out)
        assert files, "no output emitted"
        return files

    clean = run(tmp_path / "clean", 64)
    assert run(tmp_path / "chunked", 5) == clean
    for seed in (1, 2):
        rnd = random.Random(seed)
        orig_collect = ex_mod.DeviceExecutor.collect_chunk
        orig_write = pl_mod.Pipeline._write_item

        def slow_collect(self, outs, _o=orig_collect, _r=rnd):
            for item in _o(self, outs):
                time.sleep(_r.uniform(0, 0.04))
                yield item

        def slow_write(self, item, _o=orig_write, _r=rnd):
            time.sleep(_r.uniform(0, 0.02))
            _o(self, item)

        with monkeypatch.context() as m:
            m.setattr(ex_mod.DeviceExecutor, "collect_chunk", slow_collect)
            m.setattr(pl_mod.Pipeline, "_write_item", slow_write)
            assert run(tmp_path / f"jitter{seed}", 5) == clean


# ---------------- tvl1 png and h5 against the JAX CLI ----------------

def test_tvl1_png_matches_jax(vid, tmp_path, monkeypatch):
    path, _ = vid
    args = [path, "-a=tvl1", "-s=1", "-st=png", "--pairBatch=4"]
    assert main(args + [f"-o={tmp_path / 't'}", CPU]) == 0
    assert j_main_fused(monkeypatch, args + [f"-o={tmp_path / 'j'}"]) == 0
    assert_png_close(tmp_path / "t" / "v", tmp_path / "j" / "v", 0.01)


@pytest.mark.parametrize("dtype", ["f32", "f16"])
def test_tvl1_h5_matches_jax(vid, tmp_path, monkeypatch, dtype):
    path, (fx, _) = vid
    args = [path, "-a=tvl1", "-s=1", "-st=h5", "--pairBatch=4", f"--h5Dtype={dtype}"]
    assert main(args + [f"-o={tmp_path / 't'}", CPU]) == 0
    assert j_main_fused(monkeypatch, args + [f"-o={tmp_path / 'j'}"]) == 0
    t, _ = assert_h5_close(tmp_path / "t" / "v.h5", tmp_path / "j" / "v.h5", 1e-2, 1e-3)
    assert len(t) == 16 and abs(t["flow_x_00004"][16:-16, 16:-16].mean() - fx) < 0.3


def test_h5_f16_stays_within_f16_of_f32(vid, tmp_path):
    """tests/test_pipeline_e2e.py:151: --h5Dtype=f16 writes float32
    datasets within f16 rounding of the exact run."""
    path, _ = vid
    out = {}
    for dtype in ("f32", "f16"):
        assert main([path, f"-o={tmp_path / dtype}", "-s=1", "-st=h5", "--pairBatch=4",
                     f"--h5Dtype={dtype}", CPU]) == 0
        out[dtype] = read_h5(tmp_path / dtype / "v.h5")
    assert out["f16"].keys() == out["f32"].keys()
    for k, exact in out["f32"].items():
        half = out["f16"][k]
        assert half.dtype == np.float32
        np.testing.assert_array_equal(half, exact.astype(np.float16).astype(np.float32))
    assert main(["x.avi", "-st=h5", "--h5Dtype=f64", CPU]) == 1


@pytest.mark.parametrize("step", [-2, 3])
def test_h5_dataset_names_match_jax(vid, tmp_path, step):
    """The counterpart of tests/test_sharding.py:77: -s=-2 writes
    v_m2.h5 with flow_x_m2_%05d named by the right frame."""
    path, _ = vid
    args = [path, f"-s={step}", "-a=nv", "-st=h5", "--pairBatch=8"]
    assert main(args + [f"-o={tmp_path / 't'}", CPU]) == 0
    assert j_main(args + [f"-o={tmp_path / 'j'}"]) == 0
    name = f"v_m{-step}.h5" if step < 0 else f"v_p{step}.h5"
    t, j = read_h5(tmp_path / "t" / name), read_h5(tmp_path / "j" / name)
    base = -step if step < 0 else 0
    infix = f"_m{-step}" if step < 0 else f"_p{step}"
    want = sorted(f"flow_{c}{infix}_{i + base:05d}" for c in "xy" for i in range(9 - abs(step)))
    assert sorted(t) == sorted(j) == want
    assert all(v.dtype == np.float32 and v.shape == (64, 80) for v in t.values())
