"""The port's emission layer against the JAX package's: the png quantizer,
the native emitter, the png and h5 writers, and the CLI's jpg, png and h5
files on the CPU.

The JAX CLI runs here on its fused-kernel path through the Pallas
interpreter (`j_main_fused`): on the CPU it would otherwise take its XLA
path, which is not the port's target (ROADMAP.md). Tolerances, each from a
measurement on the 64x80 translating video:
* png quantizer, dequantizer, `_adaptive_bound`: equal bit for bit on the
  same flow, but for values on a .5 tie where jitted JAX's FMA moves 1
  level (`test_png_quantizer_ties`; none of 357,195 random values moved);
* farn and brox jpg files: byte-identical (both emitters use the system
  libjpeg at q95);
* farn and brox png: at most 1 level, on fewer than 1e-4 of the values
  (measured: brox identical, farn 1 level on 1.6e-5: the solvers' float
  drift, max 4.8e-6 px, sits on a png rounding edge);
* farn and brox h5: the same dataset names, max |d| <= 1e-5 px and mean
  <= 1e-6 px (measured max 4.8e-6 / 3.1e-6, mean 3.4e-7 / 4.0e-7;
  ROADMAP.md C); with --h5Dtype=f16, within 1e-5 px and one float16 step.
"""

import dataclasses
from pathlib import Path

import cv2
import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_translating_video
import denseflow_tpu.executor as jex
from denseflow_tpu.algorithms import solver_params as j_solver_params
from denseflow_tpu.algorithms.brox import brox_flow as j_brox_flow
from denseflow_tpu.algorithms.farneback import farneback_flow as j_farneback_flow
from denseflow_tpu.algorithms.tvl1 import tvl1_flow as j_tvl1_flow
from denseflow_tpu.cli import main as j_main
from denseflow_tpu import quantize as jq
from denseflow_tpu.io import writer as jwriter
from denseflow_tpu_torch import native, quantize as tq
from denseflow_tpu_torch.cli import main, parse_args, run
from denseflow_tpu_torch.executor import DeviceExecutor
from denseflow_tpu_torch.io import writer as twriter

torch.set_num_threads(1)

CPU = "--device=cpu"


# ---------------- the JAX CLI on its fused-kernel path ----------------

def _fused_solver(algorithm, height, width, preset=None, max_disp=0):
    """denseflow_tpu.algorithms.make_solver with interpret=True."""
    p = j_solver_params(algorithm, preset)
    if max_disp > 0:
        p = dataclasses.replace(p, max_disp=int(max_disp))
    flow_fn = {"tvl1": j_tvl1_flow, "nv": j_tvl1_flow, "farn": j_farneback_flow,
               "brox": j_brox_flow}[algorithm]

    @jax.jit
    def solver(I0_u8, I1_u8):
        I0, I1 = I0_u8.astype(jnp.float32), I1_u8.astype(jnp.float32)
        if algorithm == "brox":
            I0, I1 = I0 * jnp.float32(1.0 / 255.0), I1 * jnp.float32(1.0 / 255.0)
        return flow_fn(I0, I1, p, interpret=True)

    return solver


def j_main_fused(monkeypatch, args):
    """The JAX CLI with its solvers on the fused path, in interpret mode."""
    with monkeypatch.context() as m:
        m.setattr(jex, "make_solver", _fused_solver)
        jex._get_executor_locked.cache_clear()
        try:
            return j_main(args)
        finally:
            jex._get_executor_locked.cache_clear()


def read_h5(path):
    with h5py.File(path) as f:
        return {k: f[k][:] for k in f}


def assert_png_close(t_dir, j_dir, frac):
    """Same png names; pixels within 1 level, on at most `frac` of them."""
    t, j = sorted(Path(t_dir).glob("*.png")), sorted(Path(j_dir).glob("*.png"))
    assert [p.name for p in t] == [p.name for p in j] and t
    d = np.stack([np.abs(cv2.imread(str(a), cv2.IMREAD_UNCHANGED).astype(np.int16)
                         - cv2.imread(str(b), cv2.IMREAD_UNCHANGED)) for a, b in zip(t, j)])
    assert d.max() <= 1 and (d > 0).mean() <= frac, (d.max(), (d > 0).mean())


def assert_h5_close(t_file, j_file, max_tol, mean_tol):
    t, j = read_h5(t_file), read_h5(j_file)
    assert sorted(t) == sorted(j) and t
    for k in t:
        assert t[k].dtype == j[k].dtype == np.float32 and t[k].shape == j[k].shape
        d = np.abs(t[k] - j[k])
        assert d.max() <= max_tol and d.mean() <= mean_tol, (k, d.max(), d.mean())
    return t, j


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    # content flow is (-2, 0): the crop window moves right 2 px/frame
    return make_translating_video(tmp_path_factory.mktemp("v") / "v.avi", h=64, w=80, n=9, dx=2)


# ---------------- png quantizer ----------------

def _png_bound_scalar(comp, axis_len):
    """reference src/common.cpp:24-32 (tests/test_quantize.py)."""
    mag = max(abs(comp.min()), abs(comp.max()))
    b = min(255.0 * 4, np.ceil((min(axis_len, mag) * 128.0 / 127.0) / 4) * 4)
    if int(b) % 8 == 0:
        b += 4
    return b


@pytest.mark.parametrize("shape", [(24, 30), (2, 24, 30), (3, 17, 23), (1, 9, 1)])
@pytest.mark.parametrize("scale", [0.5, 3.0, 40.0, 2000.0])
def test_png_quantizer_matches_jax_and_reference_scalar(shape, scale):
    flow = np.random.default_rng(int(scale * 10)).normal(0, scale, shape + (2,)).astype(np.float32)
    ours = tq.quantize_flow_png(torch.from_numpy(flow)).numpy()
    assert ours.dtype == np.uint8 and ours.shape == shape + (3,)
    np.testing.assert_array_equal(ours, np.asarray(jq.quantize_flow_png(jnp.asarray(flow))))
    np.testing.assert_array_equal(ours, np.asarray(jax.jit(jq.quantize_flow_png)(jnp.asarray(flow))))
    h, w = shape[-2:]
    for comp, n in ((flow[..., 0], w), (flow[..., 1], h)):
        np.testing.assert_array_equal(
            tq._adaptive_bound(torch.from_numpy(np.ascontiguousarray(comp)), n).numpy(),
            np.asarray(jq._adaptive_bound(jnp.asarray(comp), n)))
    one = ours.reshape((-1, h, w, 3))[0]
    f0 = flow.reshape((-1, h, w, 2))[0]
    bx, by = _png_bound_scalar(f0[..., 0], w), _png_bound_scalar(f0[..., 1], h)
    # channel 2 holds bound/4: rows [0, h//2] bound_x, the rest bound_y
    assert (one[: h // 2 + 1, :, 2] == round(bx / 4)).all()
    assert (one[h // 2 + 1:, :, 2] == round(by / 4)).all()
    ref_x = np.clip(np.round(f0[..., 0] * (128.0 / bx) + 128.0), 0, 255)
    np.testing.assert_array_equal(one[..., 0], ref_x.astype(np.uint8))


@pytest.mark.parametrize("bound", [4, 12, 20, 100, 1020])
def test_png_quantizer_ties(bound):
    """762 values whose v * 128/bound + 128 lies at or next to a .5 tie.
    The port rounds the product and the sum one at a time, as JAX does op
    by op and as NumPy does; jitted JAX fuses them into an FMA, which moves
    1 level on 32-42 of them where 128/bound is inexact (measured; ROADMAP.md
    C) and none where it is a power of two."""
    k = np.arange(-127, 127, dtype=np.float64) + 0.5
    v = (k * bound / 128.0).astype(np.float32)
    v = np.concatenate([v, np.nextafter(v, np.float32(np.inf)),
                        np.nextafter(v, np.float32(-np.inf))])
    flow = np.zeros((1, 2, 1024, 2), np.float32)
    flow[0, :, :, 0].flat[: v.size] = v
    flow[0, 1, -1, 0] = bound * 127.0 / 128.0 - 1e-3  # makes bound_x `bound`
    ours = tq.quantize_flow_png(torch.from_numpy(flow)).numpy()
    assert ours[0, 0, 0, 2] == bound // 4
    np.testing.assert_array_equal(ours, np.asarray(jq.quantize_flow_png(jnp.asarray(flow))))
    sep = np.round(flow[..., 0] * (np.float32(128.0) / np.float32(bound)) + np.float32(128.0))
    np.testing.assert_array_equal(ours[..., 0], np.clip(sep, 0, 255).astype(np.uint8))
    fused = np.asarray(jax.jit(jq.quantize_flow_png)(jnp.asarray(flow)))
    d = np.abs(ours.astype(np.int16) - fused)
    assert d.max() <= 1 and (d > 0).sum() <= 0.06 * v.size, (d > 0).sum()
    assert (d > 0).sum() == 0 or bound & (bound - 1)  # exact for powers of two


def test_png_bound_never_multiple_of_8():
    rng = np.random.default_rng(1)
    for scale in (1.0, 7.9, 16.0, 31.8, 100.0):
        img = tq.quantize_flow_png(torch.from_numpy(
            rng.normal(0, scale, (16, 16, 2)).astype(np.float32))).numpy()
        assert (int(img[0, 0, 2]) * 4) % 8 != 0 and (int(img[15, 0, 2]) * 4) % 8 != 0


@pytest.mark.parametrize("shape", [(2, 24, 30), (3, 17, 23)])
def test_png_roundtrip_matches_jax(shape):
    flow = np.random.default_rng(2).normal(0, 5, shape + (2,)).astype(np.float32)
    img = tq.quantize_flow_png(torch.from_numpy(flow))
    rec = tq.dequantize_flow_png(img).numpy()
    # quantization step is bound/128 ≈ 8/128; allow one step
    assert np.abs(rec - flow).max() < 0.15
    np.testing.assert_array_equal(rec, np.asarray(jq.dequantize_flow_png(jnp.asarray(img.numpy()))))


# ---------------- the writers ----------------

@pytest.mark.parametrize("step", [-2, 1, 3])
def test_h5_writer_matches_jax(tmp_path, step):
    planes = np.random.default_rng(3).normal(0, 2, (3, 6, 7)).astype(np.float32)
    for mod, sub in ((jwriter, "j"), (twriter, "t")):
        out = tmp_path / sub / "v"
        out.mkdir(parents=True)
        assert mod.create_h5_file(str(out), step) == mod.h5_file_name(str(out), step)
        mod.write_hdf5(planes, str(out), "flow_x", step, start=4)
        mod.write_hdf5(planes[:1] * 2, str(out), "flow_x", step, start=4)  # rewrite
        mod.write_flow_images_png([b"p"], str(out / "flow"), step, start=2)
    assert twriter.h5_file_name("/o/v", step) == jwriter.h5_file_name("/o/v", step)
    t = read_h5(twriter.h5_file_name(str(tmp_path / "t" / "v"), step))
    j = read_h5(jwriter.h5_file_name(str(tmp_path / "j" / "v"), step))
    assert sorted(t) == sorted(j) and len(t) == 3
    for k in t:
        assert t[k].dtype == np.float32 and np.array_equal(t[k], j[k])
    assert _names(tmp_path / "t" / "v") == _names(tmp_path / "j" / "v")
    img = np.random.default_rng(4).integers(0, 256, (9, 11, 3), dtype=np.uint8)
    assert twriter.encode_png(img) == jwriter.encode_png(img)


def _names(d):
    return sorted(p.name for p in Path(d).iterdir())


def test_h5_writer_refuses_without_h5py(tmp_path, monkeypatch):
    monkeypatch.setattr(twriter, "HAVE_H5", False)
    for call in (lambda: twriter.create_h5_file(str(tmp_path), 1),
                 lambda: twriter.write_hdf5([], str(tmp_path), "flow_x", 1, 0)):
        with pytest.raises(RuntimeError, match="HDF5 support is not available"):
            call()


# ---------------- the native emitter (tests/test_native.py) ----------------

def test_emitter_builds_here():
    """This container has g++, libjpeg and libpng: the emitter must build."""
    assert native.available(), native.build_error()
    assert native.build_error() is None
    assert native.describe() == f"native, {native.DEFAULT_THREADS} threads"


def test_jpg_batch_decodable(tmp_path, rng):
    planes = rng.integers(0, 256, (6, 48, 64), dtype=np.uint8)
    paths = [str(tmp_path / f"f_{i:05d}.jpg") for i in range(6)]
    native.write_jpg_batch(planes, paths)
    for i, p in enumerate(paths):
        img = cv2.imread(p, cv2.IMREAD_GRAYSCALE)
        assert img.shape == (48, 64)
        # same content through lossy jpg (quality 95): tight on smooth data
        assert np.abs(img.astype(int) - planes[i].astype(int)).mean() < 4


def test_jpg_matches_cv2_quality(tmp_path):
    # smooth gradient compresses almost losslessly at q95 in both encoders
    ys, xs = np.mgrid[0:64, 0:80]
    img = ((ys * 2 + xs) % 256).astype(np.uint8)
    p_native = str(tmp_path / "n.jpg")
    native.write_jpg_batch(img[None], [p_native])
    ok, buf = cv2.imencode(".jpg", img)
    a = cv2.imread(p_native, cv2.IMREAD_GRAYSCALE).astype(int)
    b = cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE).astype(int)
    assert np.abs(a - b).mean() < 2


def test_png_batch_lossless(tmp_path, rng):
    frames = rng.integers(0, 256, (4, 32, 40, 3), dtype=np.uint8)
    paths = [str(tmp_path / f"p_{i}.png") for i in range(4)]
    native.write_png_batch(frames, paths)
    for i, p in enumerate(paths):
        back = cv2.imread(p, cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(back, frames[i])


def test_color_jpg_batch(tmp_path):
    frames = np.full((3, 32, 40, 3), 0, np.uint8)
    frames[:, :, :, 0] = 200  # blue-ish BGR
    paths = [str(tmp_path / f"c_{i}.jpg") for i in range(3)]
    native.write_jpg_color_batch(frames, paths)
    back = cv2.imread(paths[0])
    assert back[:, :, 0].mean() > 150  # blue channel dominant
    assert back[:, :, 2].mean() < 80


@pytest.mark.parametrize("kind", ["gray", "color"])
@pytest.mark.parametrize("hw", [(256, 341), (37, 53)])
def test_jpg_bytes_equal_cv2(tmp_path, rng, kind, hw):
    """Both encode with the system libjpeg at q95: the same bytes."""
    shape = hw if kind == "gray" else hw + (3,)
    imgs = [rng.integers(0, 256, shape, dtype=np.uint8),
            np.broadcast_to(np.linspace(0, 255, hw[1]).astype(np.uint8)
                            if kind == "gray" else np.uint8(90), shape).copy(),
            np.full(shape, 128, np.uint8)]
    paths = [str(tmp_path / f"{i}.jpg") for i in range(3)]
    write = native.write_jpg_batch if kind == "gray" else native.write_jpg_color_batch
    write(np.stack(imgs), paths)
    for img, p in zip(imgs, paths):
        assert Path(p).read_bytes() == twriter.encode_jpg(img)


def test_failed_batch_raises(tmp_path, rng):
    planes = rng.integers(0, 256, (3, 8, 8), dtype=np.uint8)
    missing = [str(tmp_path / "no_such_dir" / f"{i}.jpg") for i in range(3)]
    with pytest.raises(RuntimeError, match="failed for a batch of 3"):
        native.write_jpg_batch(planes, missing)
    with pytest.raises(RuntimeError, match="failed"):
        native.write_png_batch(np.zeros((3, 8, 8, 3), np.uint8), missing)
    with pytest.raises(ValueError, match="3 images but 2 paths"):
        native.write_jpg_batch(planes, missing[:2])
    with pytest.raises(ValueError, match=r"\(N, H, W, 3\)"):
        native.write_png_batch(planes, missing)


def _break_emitter(m, message):
    """Make the emitter's build fail with `message`, as on a host without
    g++ or the libjpeg headers (`m`: a monkeypatch)."""
    def fail(name):
        raise RuntimeError(message)

    m.setattr(native._build, "load", fail)
    m.setattr(native, "_lib", None)
    m.setattr(native, "_error", None)


def test_unbuilt_emitter_says_why(monkeypatch, tmp_path):
    _break_emitter(monkeypatch, "g++ failed for denseflow_tpu_torch/native/emitter.cpp:\n"
                   "emitter.cpp:25:10: fatal error: jpeglib.h: No such file or "
                   "directory\ncompilation terminated.")
    assert not native.available()
    assert "jpeglib.h" in native.build_error()
    assert native.describe() == ("cv2: emitter not built (emitter.cpp:25:10: fatal "
                                 "error: jpeglib.h: No such file or directory)")
    with pytest.raises(RuntimeError, match="(?s)not available.*jpeglib.h"):
        native.write_jpg_batch(np.zeros((1, 8, 8), np.uint8), [str(tmp_path / "a.jpg")])


@pytest.mark.parametrize("st", ["jpg", "png"])
def test_cv2_writer_runs_when_the_emitter_does_not_build(
        video, tmp_path, monkeypatch, capsys, st):
    """The fallback writes the same files and says so in -v and stats."""
    path, _ = video
    args = [path, "-a=nv", "-s=1", "-b=8", "--pairBatch=4", f"-st={st}", CPU]
    stats = {}
    assert run(parse_args(args + [f"-o={tmp_path / 'n'}"]), stats_out=stats) == 0
    assert stats["writer"] == f"native, {native.DEFAULT_THREADS} threads"
    with monkeypatch.context() as m:
        _break_emitter(m, "g++ not found")
        capsys.readouterr()
        stats = {}
        assert run(parse_args(args + [f"-o={tmp_path / 'c'}", "-v"]), stats_out=stats) == 0
        assert stats["writer"] == "cv2: emitter not built (g++ not found)"
        assert "writer: cv2: emitter not built (g++ not found)" in capsys.readouterr().out
    n = {p.name: p.read_bytes() for p in (tmp_path / "n" / "v").iterdir()}
    c = {p.name: p.read_bytes() for p in (tmp_path / "c" / "v").iterdir()}
    assert sorted(n) == sorted(c) and len(n) == (16 if st == "jpg" else 8)
    for k in n:
        if st == "jpg":
            assert n[k] == c[k]  # the same libjpeg at q95
        else:  # libpng's and cv2's png settings differ; the pixels do not
            np.testing.assert_array_equal(
                cv2.imdecode(np.frombuffer(n[k], np.uint8), cv2.IMREAD_UNCHANGED),
                cv2.imdecode(np.frombuffer(c[k], np.uint8), cv2.IMREAD_UNCHANGED))


def test_failing_emitter_batch_fails_the_video(video, tmp_path, monkeypatch):
    """A batch the emitter cannot write raises; nothing falls back to cv2."""
    path, _ = video

    def fail(*a, **kw):
        raise RuntimeError("native df_write_jpg_batch failed for a batch of 8")

    monkeypatch.setattr(native, "write_jpg_batch", fail)
    stats = {}
    assert run(parse_args([path, f"-o={tmp_path}", "-a=nv", "-s=1", CPU]),
               stats_out=stats) == 1
    assert "failed for a batch" in stats["errors"][0].error
    assert list((tmp_path / "v").iterdir()) == []


def test_h5_run_reports_h5py_and_needs_it(video, tmp_path, monkeypatch):
    path, _ = video
    stats = {}
    args = [path, "-a=nv", "-s=1", "-st=h5", CPU]
    assert run(parse_args(args + [f"-o={tmp_path / 'a'}"]), stats_out=stats) == 0
    assert stats["writer"] == "h5py"
    import denseflow_tpu_torch.io.writer as w

    monkeypatch.setattr(w, "HAVE_H5", False)
    stats = {}
    assert run(parse_args(args + [f"-o={tmp_path / 'b'}"]), stats_out=stats) == 1
    assert "HDF5 support is not available" in stats["errors"][0].error


# ---------------- the CLI against the JAX CLI ----------------

@pytest.mark.parametrize("alg", ["farn", "brox"])
def test_jpg_files_byte_identical_to_jax(video, tmp_path, monkeypatch, alg):
    path, _ = video
    args = [path, f"-a={alg}", "-s=1", "-b=8", "--pairBatch=4"]
    assert main(args + [f"-o={tmp_path / 't'}", CPU]) == 0
    assert j_main_fused(monkeypatch, args + [f"-o={tmp_path / 'j'}"]) == 0
    t = {p.name: p.read_bytes() for p in (tmp_path / "t" / "v").iterdir()}
    j = {p.name: p.read_bytes() for p in (tmp_path / "j" / "v").iterdir()}
    assert len(t) == 16 and t == j


@pytest.mark.parametrize("alg", ["farn", "brox"])
def test_png_matches_jax(video, tmp_path, monkeypatch, alg):
    path, (fx, _) = video
    args = [path, f"-a={alg}", "-s=1", "-st=png", "--pairBatch=4"]
    assert main(args + [f"-o={tmp_path / 't'}", CPU]) == 0
    assert j_main_fused(monkeypatch, args + [f"-o={tmp_path / 'j'}"]) == 0
    assert_png_close(tmp_path / "t" / "v", tmp_path / "j" / "v", 1e-4)
    img = cv2.imread(str(tmp_path / "t" / "v" / "flow_00004.png"), cv2.IMREAD_UNCHANGED)
    rec = tq.dequantize_flow_png(torch.from_numpy(img)).numpy()
    assert abs(rec[16:-16, 16:-16, 0].mean() - fx) < 0.3


@pytest.mark.parametrize("alg,dtype", [("farn", "f32"), ("brox", "f32"), ("farn", "f16")])
def test_h5_matches_jax(video, tmp_path, monkeypatch, alg, dtype):
    path, (fx, _) = video
    args = [path, f"-a={alg}", "-s=1", "-st=h5", "--pairBatch=4", f"--h5Dtype={dtype}"]
    assert main(args + [f"-o={tmp_path / 't'}", CPU]) == 0
    assert j_main_fused(monkeypatch, args + [f"-o={tmp_path / 'j'}"]) == 0
    if dtype == "f32":
        t, _ = assert_h5_close(tmp_path / "t" / "v.h5", tmp_path / "j" / "v.h5", 1e-5, 1e-6)
    else:
        t, j = read_h5(tmp_path / "t" / "v.h5"), read_h5(tmp_path / "j" / "v.h5")
        assert sorted(t) == sorted(j)
        for k in t:
            # float32 datasets of float16 values: the f32 tolerance and one
            # float16 step apart at most (measured max 1.95e-3, one step at 2-4)
            a, b = t[k], j[k]
            assert a.dtype == np.float32 and np.array_equal(a.astype(np.float16), a)
            step = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float16))
            assert (np.abs(a - b) <= 1e-5 + step.astype(np.float32)).all(), k
    assert len(t) == 16 and abs(t["flow_x_00004"][16:-16, 16:-16].mean() - fx) < 0.3


def test_width_bucket_png_matches_jax(video, tmp_path, monkeypatch):
    """--widthBucket=32 solves at 96 px: the png bound is taken over the
    padded columns before the crop, in both packages."""
    path, _ = video
    args = [path, "-a=farn", "-s=1", "-st=png", "--pairBatch=4", "--widthBucket=32"]
    assert main(args + [f"-o={tmp_path / 't'}", CPU]) == 0
    assert j_main_fused(monkeypatch, args + [f"-o={tmp_path / 'j'}"]) == 0
    assert_png_close(tmp_path / "t" / "v", tmp_path / "j" / "v", 1e-4)
    img = cv2.imread(str(tmp_path / "t" / "v" / "flow_00000.png"), cv2.IMREAD_UNCHANGED)
    assert img.shape == (64, 80, 3)


@pytest.mark.parametrize("st,shape,dtype", [
    ("png", (8, 64, 80, 3), np.uint8), ("h5", (8, 64, 80, 2), np.float32)])
@pytest.mark.parametrize("h5_f16", [False, True])
def test_executor_payload_per_save_type(video, st, shape, dtype, h5_f16):
    """The payload the JAX executor yields: png (m, H, W, 3) uint8, h5
    (m, H, W, 2) float32 (f16 widened on the host); a chunk without pairs
    gives the same shape with m = 0."""
    from denseflow_tpu_torch.config import FlowConfig
    from denseflow_tpu_torch.io.reader import VideoSource

    path, _ = video
    frames = next(iter(VideoSource(path, FlowConfig(input=path, step=1)).chunks(1))).frames
    ex = DeviceExecutor("nv", 64, 80, 1, 8, 4, device="cpu", save_type=st, h5_f16=h5_f16)
    out = ex.run_chunk(frames, len(frames))
    assert out.shape == shape and out.dtype == dtype
    assert ex.h5_f16 == (h5_f16 and st == "h5")
    if ex.h5_f16:
        assert np.array_equal(out.astype(np.float16).astype(np.float32), out)
    empty = ex.run_chunk(frames[:1], 1)
    assert empty.shape == (0,) + shape[1:] and empty.dtype == dtype


def test_width_bucket_png_bound_spans_the_padded_columns(video):
    """The executor's png payload: the bound of the padded solve, cropped."""
    path, _ = video
    from denseflow_tpu_torch.config import FlowConfig
    from denseflow_tpu_torch.io.reader import VideoSource

    frames = next(iter(VideoSource(path, FlowConfig(input=path, step=1)).chunks(1))).frames
    ex = DeviceExecutor("nv", 64, 80, 1, 8, 4, width_bucket=32, device="cpu", save_type="png")
    png = ex.run_chunk(frames, len(frames))
    assert png.shape == (8, 64, 80, 3) and png.dtype == np.uint8
    flow = ex._solver(*(ex.upload_chunk(frames).frames[i:i + 8] for i in (0, 1)))
    want = tq.quantize_flow_png(flow)[..., :80, :].numpy()
    np.testing.assert_array_equal(png, want)
