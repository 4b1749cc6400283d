"""The port's executor, pipeline and CLI on the CPU, against the JAX
package on the same decoded video."""

from pathlib import Path
from types import SimpleNamespace

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_translating_video
from denseflow_tpu.algorithms.tvl1 import TVL1Params as JParams
from denseflow_tpu.algorithms.tvl1 import tvl1_flow as j_tvl1_flow
from denseflow_tpu.cli import main as j_main
from denseflow_tpu.quantize import quantize_flow_pair as j_quantize
from denseflow_tpu_torch.cli import main, parse_args
from denseflow_tpu_torch.config import FlowConfig
from denseflow_tpu_torch.executor import DeviceExecutor
from denseflow_tpu_torch.io.reader import VideoSource

torch.set_num_threads(1)

CPU = "--device=cpu"


def _expected_quant(val, bound):
    return round(255.0 * (val + bound) / (2.0 * bound))


@pytest.fixture
def vid(tmp_path):
    # content flow is (-2, 0): the crop window moves right 2 px/frame
    return make_translating_video(tmp_path / "v.avi", h=64, w=80, n=9, dx=2)


def _files(d: Path):
    return {f.name: f.read_bytes() for f in sorted(d.iterdir())}


def test_run_chunk_matches_jax_solver_and_quantizer(vid):
    """Same decoded pairs through the port's executor and through JAX
    tvl1_flow(interpret=True) + quantize_flow_pair. The flows agree to
    ~1e-5 px, so the uint8 planes differ by at most 1 LSB, where a value
    sits on a rounding boundary."""
    path, _ = vid
    frames = next(iter(VideoSource(path, FlowConfig(input=path, step=1)).chunks(1))).frames
    ex = DeviceExecutor("tvl1", 64, 80, 1, 8, 4, device="cpu")
    qx, qy = ex.run_chunk(frames, len(frames))
    assert qx.shape == qy.shape == (8, 64, 80) and qx.dtype == np.uint8
    flow = j_tvl1_flow(jnp.asarray(frames[:-1], jnp.float32),
                       jnp.asarray(frames[1:], jnp.float32), JParams(), interpret=True)
    jx, jy = (np.asarray(a) for a in j_quantize(flow, 8.0))
    for a, b in ((qx, jx), (qy, jy)):
        d = np.abs(a.astype(np.int16) - b.astype(np.int16))
        assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())


def test_executor_buckets_and_width_padding(vid):
    path, _ = vid
    frames = next(iter(VideoSource(path, FlowConfig(input=path, step=1)).chunks(1))).frames
    ex = DeviceExecutor("nv", 64, 80, -2, 8, 3, width_bucket=32, device="cpu")
    assert ex.width == 96 and ex._padded_len(9) == 12 + 2
    up = ex.upload_chunk(frames)
    assert len(up.frames) == 1 and tuple(up.frames[0].shape) == (14, 64, 96)
    qx, qy = ex.run_chunk(up, len(frames))
    assert qx.shape == (7, 64, 80)
    assert ex.saturation_frac(ex.dispatch_chunk(up, len(frames))) == 0.0
    # a chunk with no pairs yields nothing
    e = ex.run_chunk(frames[:2], 2)
    assert e[0].shape == (0, 64, 80)


@pytest.mark.parametrize("step", [-2, -1, 1, 2])
def test_cli_file_set_matches_jax_and_values(vid, tmp_path, step):
    path, (fx, fy) = vid
    args = [path, f"-s={step}", "-b=8", "--pairBatch=4"]
    assert main(args + [f"-o={tmp_path / 't'}", CPU]) == 0
    assert j_main(args + [f"-o={tmp_path / 'j'}", "-a=nv"]) == 0
    t_files = sorted(p.name for p in (tmp_path / "t" / "v").iterdir())
    assert t_files == sorted(p.name for p in (tmp_path / "j" / "v").iterdir())
    assert len(t_files) == 2 * (9 - abs(step))
    sign = 1 if step > 0 else -1
    mid = sorted((tmp_path / "t" / "v").glob("flow_x*.jpg"))[3]
    img = cv2.imread(str(mid), cv2.IMREAD_GRAYSCALE)[16:-16, 16:-16]
    assert abs(img.mean() - _expected_quant(sign * abs(step) * fx, 8)) <= 3
    img = cv2.imread(str(mid).replace("flow_x", "flow_y"), cv2.IMREAD_GRAYSCALE)[16:-16, 16:-16]
    assert abs(img.mean() - _expected_quant(fy, 8)) <= 3


def test_chunked_output_equals_unchunked(tmp_path):
    path, _ = make_translating_video(tmp_path / "v.avi", h=48, w=64, n=12, dx=1)

    def run(out, chunk):
        assert main([path, f"-o={out}", "-a=nv", "-s=1", "-b=8",
                     f"--chunkFrames={chunk}", "--pairBatch=2", CPU]) == 0
        return _files(Path(out) / "v")

    clean = run(tmp_path / "clean", 64)
    assert len(clean) == 22
    assert run(tmp_path / "chunked", 5) == clean


def test_done_resume_and_force(vid, tmp_path, capsys):
    path, _ = vid
    lst = tmp_path / "list.txt"
    lst.write_text(path + "\n")
    out = tmp_path / "out"
    args = [str(lst), f"-o={out}", "-s=1", "-a=nv", "--pairBatch=4", CPU]
    assert main(args) == 0
    assert (out / ".done" / "v").is_file()
    assert "done video v" in capsys.readouterr().out
    assert main(args + ["-v"]) == 0
    assert "skip" in capsys.readouterr().out
    (out / "v" / "flow_x_00000.jpg").unlink()
    assert main(args + ["-f"]) == 0
    assert (out / "v" / "flow_x_00000.jpg").is_file()


def test_step0_extracts_frames_like_jax(vid, tmp_path, capsys):
    path, _ = vid
    assert main([path, f"-o={tmp_path / 't'}", "-s=0", "-ns=32"]) == 0
    assert "9 frames, 0 tvl1 flows" in capsys.readouterr().out
    assert j_main([path, f"-o={tmp_path / 'j'}", "-s=0", "-ns=32"]) == 0
    t, j = _files(tmp_path / "t" / "v"), _files(tmp_path / "j" / "v")
    assert list(t) == list(j) and len(t) == 9
    for name in t:
        a = cv2.imdecode(np.frombuffer(t[name], np.uint8), cv2.IMREAD_COLOR)
        b = cv2.imdecode(np.frombuffer(j[name], np.uint8), cv2.IMREAD_COLOR)
        assert a.shape == (32, 40, 3) and np.array_equal(a, b)


@pytest.mark.parametrize("flag,shards", [
    ("--devices=4", 4), ("--devices=3", 3), ("--devices=2", 2), ("--distributed", 8),
])
def test_multi_device_flags_run(vid, tmp_path, capsys, monkeypatch, request, flag,
                                shards):
    """The flags that raised before A10 was ported now run: over eight
    patched CPU devices, --devices=N splits each slab into N sub-slabs and
    writes the files of one device; --distributed with one process
    (DENSEFLOW_NUM_PROCESSES=1) runs single-host, summary included."""
    import denseflow_tpu_torch.executor as tex

    path, _ = vid
    args = [path, "-s=1", "-a=nv", "--pairBatch=4", CPU]
    assert main(args + [f"-o={tmp_path / 'one'}", "--devices=1"]) == 0
    capsys.readouterr()
    monkeypatch.setattr(tex, "local_devices", lambda name: [torch.device("cpu")] * 8)
    # executors are cached by device count, not by devices: drop those built
    # before the patch, and those built under it when the test ends
    tex._get_executor_locked.cache_clear()
    request.addfinalizer(tex._get_executor_locked.cache_clear)
    monkeypatch.setenv("DENSEFLOW_NUM_PROCESSES", "1")
    stats = {}
    from denseflow_tpu_torch.cli import run

    assert run(parse_args(args + [f"-o={tmp_path / 'many'}", flag]), stats_out=stats) == 0
    assert "1 videos (9 frames, 8 nv flows)" in capsys.readouterr().out
    assert stats["devices"] == ["cpu"] * shards
    one = _files(tmp_path / "one" / "v")
    assert len(one) == 16 and _files(tmp_path / "many" / "v") == one


@pytest.mark.parametrize("flag", ["-st=png", "-st=h5"])
def test_png_and_h5_flags_run(vid, tmp_path, flag):
    """The flags that raised before their save types were ported now write
    the JAX package's files: 8 flow_%05d.png, or v.h5 with 16 datasets."""
    import h5py

    path, _ = vid
    assert main([path, f"-o={tmp_path}", "-s=1", "-a=nv", flag, CPU]) == 0
    if flag == "-st=png":
        assert sorted(p.name for p in (tmp_path / "v").iterdir()) == \
            [f"flow_{i:05d}.png" for i in range(8)]
    else:
        assert list((tmp_path / "v").iterdir()) == []
        with h5py.File(tmp_path / "v.h5") as f:
            assert sorted(f) == sorted(f"flow_{c}_{i:05d}" for c in "xy" for i in range(8))


def test_parse_flags_and_help():
    cfg = parse_args(["in.avi", "-a=nv", "-s=-2", "-b=20", "-o=/o", "-ns=256",
                      "--wirePack=0", "--preset=fast", "--maxDisp=80", "--device=cpu"])
    assert (cfg.algorithm, cfg.step, cfg.bound, cfg.output_dir, cfg.new_short) == \
        ("nv", -2, 20, "/o", 256)
    assert not cfg.wire_pack and cfg.preset == "fast" and cfg.max_disp == 80
    assert cfg.device == "cpu"
    assert parse_args(["--help"]) is None and parse_args([]) is None
    with pytest.raises(ValueError, match="unknown option"):
        parse_args(["x", "--nope=1"])


def test_escalation_ladder_matches_jax(monkeypatch):
    """A chunk that stays clamp-saturated re-solves at most twice, at 80
    and then 1020 px, in both packages (pipeline.py:223-271)."""
    import denseflow_tpu.pipeline as jpipe
    import denseflow_tpu_torch.pipeline as tpipe

    class FakeEx:
        def __init__(self, disp):
            self.max_disp_eff = disp

        def saturation_frac(self, outs):
            return 1.0  # never clears

        def dispatch_chunk(self, frames, n):
            return ["outs"]

    ladders = []
    for mod in (jpipe, tpipe):
        built = []
        monkeypatch.setattr(mod, "get_executor",
                            lambda *key, b=built: b.append(key) or FakeEx(None))
        pipe = mod.Pipeline.__new__(mod.Pipeline)
        pipe.cfg = FlowConfig(max_disp=0, step=1, bound=20, pair_batch=4)
        pipe.log = lambda *a: None
        item = SimpleNamespace(output_dir="x", height=64, width=80,
                               frames=None, n_frames=5)
        pipe._escalate_if_saturated(item, FakeEx(40), ["outs"])
        # max_disp's place in each package's executor key
        ladders.append([k[11] if mod is jpipe else k[7] for k in built])
    assert ladders[0] == ladders[1] == [80, 1020]


def test_small_motion_never_escalates(vid, tmp_path, capsys):
    path, _ = vid
    assert main([path, f"-o={tmp_path / 'out'}", "-s=1", "-v", CPU]) == 0
    out = capsys.readouterr().out
    assert "re-solving" not in out and "calc optflows exit." in out


def test_error_isolation_and_strict(tmp_path, vid):
    path, _ = vid
    bad = tmp_path / "bad.avi"
    bad.write_bytes(b"not a video")
    lst = tmp_path / "list.txt"
    lst.write_text(f"{bad}\n{path}\n")
    out = tmp_path / "out"
    assert main([str(lst), f"-o={out}", "-s=1", "-a=nv", "--pairBatch=4", CPU]) == 1
    assert len(list((out / "v").glob("flow_x_*.jpg"))) == 8  # good video done
    assert main([str(lst), f"-o={tmp_path / 'o2'}", "-s=1", "-a=nv",
                 "--strict", "-f", CPU]) == 1
