"""The port's wire codecs (denseflow_tpu_torch/wire.py, native/wire.cpp)
against the JAX package's (denseflow_tpu/wire.py), and the executor and
CLI with --wirePack=1 against --wirePack=0.

The codecs are integer and bit-level, so every tolerance here is exact:
equal bytes of buf[:used] and equal used, equal decoded arrays, equal
files. The inputs are made from seeds with numpy; the cases are those of
tests/test_wire.py. The JAX side is decoded with its NumPy functions only
(`denseflow_tpu.wire.unpack_chunk*`), never its native library.
"""

from pathlib import Path

import h5py
import jax
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import denseflow_tpu.executor as jex
import denseflow_tpu.wire as J
import denseflow_tpu_torch.executor as tex
import denseflow_tpu_torch.wire as T
from conftest import make_translating_video, write_video
from denseflow_tpu_torch.cli import parse_args, run
from denseflow_tpu_torch.config import FlowConfig
from denseflow_tpu_torch.io.reader import VideoSource
from denseflow_tpu_torch.native import wire as native_wire

torch.set_num_threads(1)

CPU = "--device=cpu"


# ---------------- the codecs, case by case ----------------

def _cumsum_u8(rng, choices, shape):
    return np.cumsum(rng.choice(choices, shape).astype(np.uint8), axis=-1, dtype=np.uint8)


def _smooth(rng):
    return _cumsum_u8(rng, [0, 0, 0, 1, 255], (4, 2, 33, 341)), J.EXC_CAP


def _sparse_violations(rng):
    q = _cumsum_u8(rng, [0, 0, 1, 255], (2, 2, 16, 101))
    q[0, 0, 3, 40:] += np.uint8(100)
    q[0, 0, 3, 70:] += np.uint8(201)  # a second escape in the same row
    q[1, 1, 15, 100] += np.uint8(50)  # last column
    q[0, 1, 0, 1] += np.uint8(77)  # first delta of the array
    return q, J.EXC_CAP


def _cap_overflow(rng):
    return rng.integers(0, 256, (2, 2, 16, 64), dtype=np.uint8), 16


def _per_pair_flags(rng):
    smooth = np.zeros((1, 2, 16, 64), np.uint8) + 7
    noisy = rng.integers(0, 256, (1, 2, 16, 64), dtype=np.uint8)
    return np.concatenate([smooth, noisy]), 16


def _width(w):
    def make(rng):
        q = _cumsum_u8(rng, [0, 1, 255, 9], (2, 3, w)).reshape(2, 1, 3, w)
        return q, J.EXC_CAP
    return make


def _wraparound(rng):
    # 250 -> 251 -> ... -> 0 -> 1 crosses the wrap with +1 codes
    return (np.arange(250, 262) % 256).astype(np.uint8).reshape(1, 1, 1, 12), J.EXC_CAP


def _full_random_big_cap(rng):
    # every delta may escape; with cap >= the deltas every pair decodes
    return rng.integers(0, 256, (2, 1, 8, 33), dtype=np.uint8), 8 * 32


U8_CASES = {
    "smooth": _smooth,
    "sparse_violations": _sparse_violations,
    "cap_overflow": _cap_overflow,
    "per_pair_flags": _per_pair_flags,
    **{f"width_{w}": _width(w) for w in (1, 2, 5, 33, 131)},
    "mod256_wraparound": _wraparound,
    "full_random_big_cap": _full_random_big_cap,
}


def _u8_case(name):
    return U8_CASES[name](np.random.default_rng(sorted(U8_CASES).index(name)))


def _assert_decodes(flags, out, q, want_flags=None):
    """Every pair whose flag is set decodes to q exactly; flags as given."""
    if want_flags is not None:
        assert flags.tolist() == list(want_flags)
    for p in np.flatnonzero(flags):
        assert np.array_equal(out[p], q[p]), p


def _expected_flags(q, cap):
    m = q.shape[0]
    d = (q[..., 1:].astype(np.int32) - q[..., :-1]) & 0xFF
    esc = ((d != 0) & (d != 1) & (d != 255)).reshape(m, -1).sum(axis=1)
    return esc <= cap


@pytest.mark.parametrize("case", sorted(U8_CASES))
def test_v2_matches_jax(case):
    q, cap = _u8_case(case)
    m, c, h, w = q.shape
    ours = T.pack_chunk(torch.from_numpy(q), cap).numpy()
    theirs = np.asarray(jax.jit(lambda x: J.pack_chunk(x, cap))(q))
    assert ours.shape == (T.buffer_size(m, c, h, w, cap),) == theirs.shape
    assert np.array_equal(ours, theirs)
    want = _expected_flags(q, cap)
    _assert_decodes(*J.unpack_chunk(ours, m, c, h, w, cap), q, want)  # port -> JAX
    _assert_decodes(*T.unpack_chunk(theirs, m, c, h, w, cap), q, want)  # JAX -> port
    _assert_decodes(*native_wire.wire_unpack(theirs, m, c, h, w, cap), q, want)


@pytest.mark.parametrize("case", sorted(U8_CASES))
def test_v3_matches_both_jax_producers(case):
    q, cap = _u8_case(case)
    m, c, h, w = q.shape
    buf, used = T.pack_chunk_v3(torch.from_numpy(q), cap)
    assert used.dtype == torch.int64 and buf.dtype == torch.uint8
    ours, used = buf.numpy(), int(used)
    assert T.v3_fixed_size(m, c, h, w) <= used <= ours.size
    if w > 1:  # a single column is seeds only
        assert ours.shape == (T.v3_max_size(m, c, h, w, cap),)
    for producer in (J.pack_chunk_v3, J.pack_chunk_v3_sorted):
        jb, ju = jax.jit(lambda x: producer(x, cap))(q)
        assert int(ju) == used and jb.shape == ours.shape, producer.__name__
        assert np.array_equal(np.asarray(jb)[:used], ours[:used]), producer.__name__
    theirs = np.asarray(jb)[:used]
    want = _expected_flags(q, cap)
    _assert_decodes(*J.unpack_chunk_v3(ours[:used], m, c, h, w, cap), q, want)
    _assert_decodes(*T.unpack_chunk_v3(theirs, m, c, h, w, cap), q, want)
    _assert_decodes(*native_wire.wire_unpack_v3(theirs, m, c, h, w, cap), q, want)


def _v4_noise(rng):
    return rng.normal(0, 3, (5, 20, 31, 2)).astype(np.float32)


def _v4_special(rng):
    flow = rng.normal(0, 1, (2, 8, 9, 2)).astype(np.float32)
    flow[0, 0, 0, 0] = np.inf
    flow[0, 0, 1, 0] = -np.inf
    flow[0, 1, 0, 1] = np.nan
    flow[0, 1, 1, 1] = -0.0
    flow[1, 0, 0, 0] = 1e-42  # denormal
    flow[1, 0, 1, 0] = np.float32(3.4e38)
    flow[1, 2, 3, 1] = np.float32(-1e-45)
    return flow


def _v4_width(w):
    return lambda rng: rng.normal(0, 2, (2, 7, w, 2)).astype(np.float32)


V4_CASES = {
    "noise": _v4_noise,
    "special_values": _v4_special,
    "single_column": lambda rng: rng.normal(0, 2, (3, 6, 1, 2)).astype(np.float32),
    "constant": lambda rng: np.full((4, 32, 48, 2), -2.5, np.float32),
    **{f"width_{w}": _v4_width(w) for w in (2, 5, 6, 7)},
}


@pytest.mark.parametrize("case", sorted(V4_CASES))
def test_v4_matches_jax(case):
    flow = V4_CASES[case](np.random.default_rng(sorted(V4_CASES).index(case)))
    m, h, w, _ = flow.shape
    buf, used = T.pack_chunk_v4(torch.from_numpy(flow))
    assert used.dtype == torch.int64
    ours, used = buf.numpy(), int(used)
    assert used <= ours.size
    if w > 1:  # a single column is header and seeds only
        assert ours.shape == (T.v4_max_size(m, h, w),)
    jb, ju = jax.jit(J.pack_chunk_v4)(flow)
    assert int(ju) == used and jb.shape == ours.shape
    assert np.array_equal(np.asarray(jb)[:used], ours[:used])
    theirs = np.asarray(jb)[:used]
    bits = flow.view(np.uint32)
    for out in (J.unpack_chunk_v4(ours[:used], m, h, w),
                T.unpack_chunk_v4(theirs, m, h, w),
                native_wire.wire_unpack_v4(theirs, m, h, w)):
        assert out.dtype == np.float32 and out.shape == flow.shape
        assert np.array_equal(out.view(np.uint32), bits)
    if case == "constant":  # header, seeds and bitmaps only
        assert used < flow.nbytes / 10


# ---------------- sizes and offsets ----------------

@pytest.mark.parametrize("m,c,h,w", [(1, 2, 1, 1), (4, 2, 33, 341), (128, 2, 256, 341),
                                     (128, 3, 256, 341), (3, 1, 7, 2)])
def test_sizes_match_jax(m, c, h, w):
    assert T.codes_width(w) == J.codes_width(w)
    assert T.buffer_size(m, c, h, w) == J.buffer_size(m, c, h, w)
    assert T._v3_geom(c, h, w) == J._v3_geom(c, h, w)
    assert T.v3_fixed_size(m, c, h, w) == J.v3_fixed_size(m, c, h, w)
    assert T.v3_max_size(m, c, h, w) == J.v3_max_size(m, c, h, w)
    assert T._v4_geom(h, w) == J._v4_geom(h, w)
    assert T.v4_fixed_size(m, h, w) == J.v4_fixed_size(m, h, w)
    assert T.v4_max_size(m, h, w) == J.v4_max_size(m, h, w)
    assert np.array_equal(T._CODE_LUT, J._CODE_LUT)
    assert (T.EXC_CAP, T._PAD_IDX) == (J.EXC_CAP, J._PAD_IDX)


def test_v4_worst_case_passes_int32():
    """A 128-pair 1080x1920 chunk's worst case is over 2^31 bytes: where
    the JAX package sums offsets in int32 (wire.py:692-698) the port does
    not."""
    assert T.v4_max_size(128, 1080, 1920) > 2 ** 31
    assert T.v4_max_size(128, 1080, 1920) == 2_189_687_072


@pytest.mark.parametrize("counts", [
    [66_320_640] * 8,  # every group of a 128-pair 1080x1920 chunk occupied
    [2 ** 31 - 1, 2 ** 31 - 1, 5, 0, 2 ** 30, 7, 2 ** 31, 1],
    [0] * 8,
])
def test_v4_offsets_int64(counts):
    """_v4_offsets against the layout summed in Python ints, exact, for
    counts that put the offsets and used past 2^31 (and 2^32)."""
    bw, fixed = 8_290_080, 1_105_952  # the 1080x1920 chunk's
    off_b, off_w, used = T._v4_offsets(torch.tensor(counts, dtype=torch.int64), bw, fixed)
    assert off_b.dtype == off_w.dtype == used.dtype == torch.int64
    o, want_b, want_w = fixed, [], []
    for cnt in counts:
        want_b.append(o)
        want_w.append(o + bw)
        o += bw + 4 * cnt
    assert off_b.tolist() == want_b and off_w.tolist() == want_w and int(used) == o
    if counts[0]:
        assert o > 2 ** 31


# ---------------- the native decoder ----------------

def test_native_decoder_builds_with_gxx_alone():
    from denseflow_tpu_torch.kernels import _build

    r = _build.recipe("wire")
    assert r.source.name == "wire.cpp" and r.libs == ("-lpthread",)
    assert native_wire.wire_available(), native_wire.wire_build_error()
    assert native_wire.wire_build_error() is None
    assert T.decoder().startswith("native")


@pytest.mark.parametrize("codec", ["v2", "v3", "v4"])
def test_native_decoder_raises_on_a_short_buffer(codec):
    """The _fast entry points never swallow a native failure."""
    rng = np.random.default_rng(3)
    if codec == "v4":
        flow = rng.normal(0, 1, (2, 5, 9, 2)).astype(np.float32)
        buf, used = T.pack_chunk_v4(torch.from_numpy(flow))
        with pytest.raises(RuntimeError, match="v4 unpack failed"):
            T.unpack_chunk_v4_fast(buf.numpy()[:int(used) - 1], 2, 5, 9)
        return
    q = _cumsum_u8(rng, [0, 1, 255, 9], (2, 2, 5, 9))
    if codec == "v2":
        buf = T.pack_chunk(torch.from_numpy(q)).numpy()
        with pytest.raises(RuntimeError, match="wire unpack failed"):
            T.unpack_chunk_fast(buf[:-1], 2, 2, 5, 9)
    else:
        buf, used = T.pack_chunk_v3(torch.from_numpy(q))
        with pytest.raises(RuntimeError, match="v3 unpack failed"):
            T.unpack_chunk_v3_fast(buf.numpy()[:int(used) - 1], 2, 2, 5, 9)


def test_numpy_decoder_when_native_is_missing(monkeypatch):
    """Without the library the _fast functions decode with NumPy, and
    decoder() says why."""
    monkeypatch.setattr(native_wire, "_lib", None)
    monkeypatch.setattr(native_wire, "_error", "g++ failed for wire.cpp:\nx: error: no")
    q, cap = _u8_case("sparse_violations")
    buf, used = T.pack_chunk_v3(torch.from_numpy(q), cap)
    flags, out = T.unpack_chunk_v3_fast(buf.numpy()[:int(used)], *q.shape, cap)
    assert flags.all() and np.array_equal(out, q)
    assert T.decoder() == "numpy: native decoder not built (x: error: no)"


# ---------------- the executor's guard ----------------

@pytest.mark.parametrize("st,h,w,f16", [
    ("jpg", 256, 341, False), ("png", 256, 341, False), ("h5", 256, 341, False),
    ("h5", 256, 341, True), ("png", 2160, 3840, False), ("jpg", 2160, 3840, False),
    ("png", 1366, 4096, False),
])
def test_codec_guard_matches_jax(st, h, w, f16):
    """v3 while n_chan*H*(W-1) < 2^24, v4 for h5 f32, raw otherwise
    (denseflow_tpu/executor.py:164-185)."""
    t = tex.DeviceExecutor("nv", h, w, 1, 20, 4, device="cpu", save_type=st,
                           h5_f16=f16, wire_pack=True)
    j = jex.DeviceExecutor("nv", h, w, 1, 20, st, 4, 16, None, 1, True, 0, f16)
    assert (t.wire_pack, t.wire_f32) == (j.wire_pack, j.wire_f32)
    assert t.codec == ("v3" if j.wire_pack else "v4" if j.wire_f32 else "raw")
    off = tex.DeviceExecutor("nv", h, w, 1, 20, 4, device="cpu", save_type=st,
                             h5_f16=f16)
    assert off.codec == "raw"


# ---------------- the CLI: --wirePack=1 writes the files of --wirePack=0 ----------------

def _files(out: Path):
    """Every file under `out` (h5 files by their datasets' bytes)."""
    files = {}
    for p in sorted(out.rglob("*")):
        if p.is_file():
            if p.suffix == ".h5":
                with h5py.File(p) as f:
                    files[p.relative_to(out).as_posix()] = {k: f[k][:].tobytes() for k in f}
            else:
                files[p.relative_to(out).as_posix()] = p.read_bytes()
    return files


def _cli(path, out, pack, *extra):
    stats = {}
    cfg = parse_args([path, f"-o={out}", "-s=1", "-b=20", "--pairBatch=4",
                      f"--wirePack={pack}", CPU, *extra])
    assert run(cfg, stats_out=stats) == 0 and not stats["errors"]
    return _files(Path(out)), stats["wire"]


@pytest.mark.parametrize("st,codec", [("jpg", "v3"), ("png", "v3"), ("h5", "v4")])
def test_cli_wire_pack_byte_identical(tmp_path, st, codec):
    path, _ = make_translating_video(tmp_path / "v.avi", h=48, w=64, n=10, dx=2)
    raw, w0 = _cli(path, tmp_path / "raw", 0, "-a=farn", f"-st={st}")
    packed, w1 = _cli(path, tmp_path / "packed", 1, "-a=farn", f"-st={st}")
    assert packed == raw and len(raw) == (1 if st == "h5" else 9 if st == "png" else 18)
    assert (w0["codec"], w0["decoder"]) == ("raw", "none")
    assert w1["codec"] == codec and w1["decoder"].startswith("native")
    assert w1["fallbacks"] == 0 and w1["d2h_calls"] == 2  # used, then buf[:used]
    if st != "h5":  # smooth content: fewer bytes down
        assert w1["d2h_bytes"] < w0["d2h_bytes"] / 2, (w1, w0)


def _noise_video(path, n=6, h=48, w=64, seed=11):
    """Frames of independent noise: flow that overflows EXC_CAP."""
    rng = np.random.default_rng(seed)
    write_video(path, [rng.integers(0, 256, (h, w), dtype=np.uint8) for _ in range(n)])
    return str(path)


def test_cli_raw_fallback_on_overflow(tmp_path):
    """Pairs over EXC_CAP escapes: the raw payload comes down, counted,
    and the files are those of --wirePack=0."""
    path = _noise_video(tmp_path / "noise.avi")
    raw, _ = _cli(path, tmp_path / "raw", 0, "-a=farn", "-b=2")
    packed, w1 = _cli(path, tmp_path / "packed", 1, "-a=farn", "-b=2")
    assert packed == raw and len(raw) == 10
    assert w1["codec"] == "v3" and w1["fallbacks"] == 1
    assert w1["d2h_calls"] == 3  # used, buf[:used], the raw payload


@pytest.fixture
def eight_cpus(monkeypatch):
    """local_devices("cpu") as eight CPU devices (tests/test_torch_sharding.py)."""
    monkeypatch.setattr(tex, "local_devices", lambda name: [torch.device("cpu")] * 8)
    tex._get_executor_locked.cache_clear()
    yield
    tex._get_executor_locked.cache_clear()


@pytest.mark.parametrize("n_dev", [2, 4])
def test_cli_wire_pack_on_shards(eight_cpus, tmp_path, n_dev):
    """Each shard packs its own sub-slabs; the host puts their pairs at
    their global offsets: the jpg and h5 files of one unpacked device."""
    path, _ = make_translating_video(tmp_path / "v.avi", h=32, w=40, n=7, dx=1)
    for st in ("jpg", "h5"):
        raw, _ = _cli(path, tmp_path / f"raw_{st}", 0, "-a=nv", f"-st={st}", "--devices=1")
        packed, w1 = _cli(path, tmp_path / f"packed_{st}", 1, "-a=nv", f"-st={st}",
                          f"--devices={n_dev}")
        assert packed == raw and w1["fallbacks"] == 0
        assert w1["d2h_calls"] == 2 * n_dev


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_raw_fallback_a_shard(eight_cpus, tmp_path, n_dev):
    """Three still pairs, then three of noise: each shard that holds a
    real pair over EXC_CAP escapes brings its own raw payload down, and
    only such a shard."""
    rng = np.random.default_rng(11)
    still = ndi.gaussian_filter(rng.uniform(0, 255, (48, 64)), 2.0).astype(np.uint8)
    path = write_video(tmp_path / "mixed.avi", [still] * 4 + [
        rng.integers(0, 256, (48, 64), dtype=np.uint8) for _ in range(3)])
    frames = next(iter(VideoSource(path, FlowConfig(input=path, step=1)).chunks(1))).frames

    def go(pack):
        ex = tex.DeviceExecutor("nv", 48, 64, 1, 20, 4, device="cpu", n_devices=n_dev,
                                wire_pack=pack)
        before = tex.WIRE_STATS.snapshot()["fallbacks"]
        qx, qy = ex.run_chunk(frames.copy(), 7)
        return ex, np.stack([qx, qy], axis=1), tex.WIRE_STATS.snapshot()["fallbacks"] - before

    _, want, _ = go(False)
    ex, got, fallbacks = go(True)
    assert np.array_equal(got, want) and got.shape == (6, 2, 48, 64)
    over = ~_expected_flags(want, T.EXC_CAP)  # real pairs over the cap
    g = np.arange(6)
    shard_of = (g % ex.B) // ex.b_loc
    assert over.any() and not over.all()
    assert fallbacks == len(set(shard_of[over].tolist()))


def test_executor_pack_matches_raw_with_padding_and_shards(eight_cpus):
    """run_chunk with the codec against without, at a chunk whose pairs do
    not fill its bucket (9 pairs in 16), on 1 and 4 shards, png."""
    rng = np.random.default_rng(5)
    base = ndi.gaussian_filter(rng.uniform(0, 255, (10, 40, 52)), (0, 2, 2))
    frames = np.clip(base[:, 4:36, 4:48], 0, 255).astype(np.uint8)
    want = tex.DeviceExecutor("nv", 32, 44, 1, 20, 4, device="cpu", save_type="png",
                              n_devices=1).run_chunk(frames.copy(), 10)
    for n_dev in (1, 4):
        ex = tex.DeviceExecutor("nv", 32, 44, 1, 20, 4, device="cpu", save_type="png",
                                n_devices=n_dev, wire_pack=True)
        before = tex.WIRE_STATS.snapshot()
        got = ex.run_chunk(frames.copy(), 10)
        after = tex.WIRE_STATS.snapshot()
        assert got.shape == (9, 32, 44, 3) and np.array_equal(got, want)
        assert after["d2h_calls"] - before["d2h_calls"] == 2 * n_dev
        assert after["fallbacks"] == before["fallbacks"]


def test_verbose_names_the_codec(tmp_path, capsys):
    path, _ = make_translating_video(tmp_path / "v.avi", h=32, w=40, n=4, dx=1)
    _cli(path, tmp_path / "o", 1, "-a=nv", "-v")
    out = capsys.readouterr().out
    assert "wire: v3 (decoder native" in out and "0 raw fallbacks" in out
