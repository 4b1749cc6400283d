"""The port's host layer equals the JAX package's: naming grammar, .done
markers, the config validation matrix and its error strings, the resize
policy, halo chunking and job expansion — each case run through both."""

import os

import numpy as np
import pytest
import torch

from conftest import write_video
from denseflow_tpu import config as jcfg
from denseflow_tpu.io import reader as jreader
from denseflow_tpu.io import writer as jwriter
from denseflow_tpu.ops.resize import compute_new_size as j_new_size
from denseflow_tpu_torch import config as tcfg
from denseflow_tpu_torch.io import reader as treader
from denseflow_tpu_torch.io import writer as twriter

torch.set_num_threads(1)


# ---------------- naming grammar and .done markers ----------------

@pytest.mark.parametrize("step", [-2, -1, 1, 2])
def test_flow_file_grammar_matches(tmp_path, step):
    for mod, sub in ((jwriter, "j"), (twriter, "t")):
        d = tmp_path / sub
        d.mkdir()
        mod.write_flow_images([b"a", b"b", b"c"], str(d / "flow_x"), step, start=5)
        mod.write_images([b"a", b"b"], str(d / "img"), start=3)
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    for idx in (0, 7, 12345):
        for ext in ("jpg", "png"):
            assert twriter.flow_file_name("flow_y", step, idx, ext) == \
                jwriter.flow_file_name("flow_y", step, idx, ext)
    assert twriter.step_base(step) == jwriter.step_base(step)


@pytest.mark.parametrize("has_class", [False, True])
@pytest.mark.parametrize("video", ["/data/v1.avi", "/data/Jump/v2.mp4", "rel/c/x.y.avi"])
def test_done_paths_and_mark_done_match(tmp_path, has_class, video):
    assert twriter.done_paths(str(tmp_path), video, has_class) == \
        jwriter.done_paths(str(tmp_path), video, has_class)
    outdir, _, donefile = twriter.done_paths(str(tmp_path), video, has_class)
    os.makedirs(outdir)
    assert twriter.mark_done(outdir, has_class) == jwriter.mark_done(outdir, has_class)
    # mark_done takes the stem of the output dir, so a video whose stem
    # holds a dot ("x.y.avi") gets marker ".done/x", not done_paths'
    # ".done/x.y" — in both packages alike (ROADMAP.md C)
    assert os.path.isfile(donefile) == ("." not in os.path.basename(outdir))


def test_encode_jpg_matches():
    img = np.random.default_rng(0).integers(0, 256, (24, 40), dtype=np.uint8)
    assert twriter.encode_jpg(img) == jwriter.encode_jpg(img)


# ---------------- config validation matrix ----------------

CONFIG_CASES = [
    dict(),
    dict(algorithm="nv", step=1),
    dict(algorithm="tvl1", step=1),
    dict(algorithm="farn", step=1),
    dict(algorithm="farn", step=-2, preset="fast"),
    dict(algorithm="farn", preset="warpspeed"),
    dict(algorithm="dis"),
    dict(bound=0),
    dict(bound=-3),
    dict(new_width=-1),
    dict(new_height=-1),
    dict(new_short=-5),
    dict(new_short=256, new_width=100),
    dict(new_short=256, new_height=100),
    dict(new_short=256),
    dict(save_type="jpg"),
    dict(save_type="npy"),
    dict(pair_batch=0),
    dict(devices=-1),
    dict(max_disp=-1),
    dict(h5_dtype="f64"),
    dict(width_bucket=-8),
    dict(preset="warpspeed"),
    dict(preset="fast", algorithm="nv"),
    dict(step=5, chunk_frames=5),
    dict(host_id=2, num_hosts=2),
    dict(host_id=-1),
]


def _outcome(cls, kw):
    try:
        cls(input="x", **kw).validate()
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("kw", CONFIG_CASES, ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "defaults")
def test_config_validation_matches(kw):
    assert _outcome(tcfg.FlowConfig, kw) == _outcome(jcfg.FlowConfig, kw)


def test_config_defaults_match():
    j, t = jcfg.FlowConfig(), tcfg.FlowConfig()
    for f in ("input", "output_dir", "algorithm", "step", "bound", "new_width",
              "new_height", "new_short", "save_type", "pair_batch",
              "chunk_frames", "max_disp", "width_bucket", "preset"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.device == "cuda"


@pytest.mark.parametrize("kw,flag,item", [
    (dict(algorithm="brox", devices=2, step=-1), "--devices>1", "A10"),
    (dict(devices=2), "--devices>1", "A10"),
    (dict(distributed=True), "--distributed", "A10"),
])
def test_unported_features_name_their_roadmap_item(kw, flag, item):
    """Valid for the JAX package; refused here with the item that ports it."""
    jcfg.FlowConfig(input="x", **kw).validate()
    with pytest.raises(NotImplementedError, match=f"{flag}.*ROADMAP.md {item}"):
        tcfg.FlowConfig(input="x", **kw).validate()


def test_only_multi_device_features_stay_unported():
    assert set(tcfg.UNPORTED) == {"devices", "distributed"}


@pytest.mark.parametrize("kw", [
    dict(algorithm="brox", save_type="png", step=1),
    dict(save_type="png", step=1),
    dict(save_type="h5", step=2),
    dict(algorithm="farn", save_type="h5", h5_dtype="f16", step=-1),
])
def test_png_and_h5_validate_as_in_jax(kw):
    """-st=png and -st=h5 are ported: accepted wherever the JAX package
    accepts them."""
    for cfg in (jcfg, tcfg):
        cfg.FlowConfig(input="x", **kw).validate()


@pytest.mark.parametrize("step", [1, -1, 2])
def test_brox_validates_as_in_jax(step):
    """-a=brox is ported: accepted wherever the JAX package accepts it."""
    for cfg in (jcfg, tcfg):
        cfg.FlowConfig(input="x", algorithm="brox", step=step, preset="fast").validate()


def test_frame_extraction_ignores_flow_only_limits():
    # step=0 writes frames only, whatever -a / -st say
    tcfg.FlowConfig(input="x", algorithm="farn", save_type="h5").validate()


# ---------------- resize policy ----------------

@pytest.mark.parametrize("w,h", [(480, 360), (360, 480), (340, 256), (256, 341),
                                 (1920, 1080), (17, 13), (256, 256)])
@pytest.mark.parametrize("nw,nh,ns", [(0, 0, 0), (0, 0, 256), (0, 0, 16),
                                      (320, 0, 0), (0, 240, 0), (100, 60, 0),
                                      (0, 0, 4000)])
def test_compute_new_size_matches(w, h, nw, nh, ns):
    assert treader.compute_new_size(w, h, nw, nh, ns) == j_new_size(w, h, nw, nh, ns)


# ---------------- halo chunking ----------------

@pytest.fixture(scope="module")
def video_11(tmp_path_factory):
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 256, (32, 40), dtype=np.uint8) for _ in range(11)]
    return write_video(tmp_path_factory.mktemp("v") / "v.avi", frames)


@pytest.mark.parametrize("step,chunk", [(1, 4), (2, 5), (-1, 4), (-3, 6), (1, 64), (-2, 3)])
@pytest.mark.parametrize("ns", [0, 16])
def test_chunks_match(video_11, step, chunk, ns):
    jc = list(jreader.VideoSource(
        video_11, jcfg.FlowConfig(input=video_11, step=step, chunk_frames=chunk, new_short=ns)
    ).chunks(step))
    ts = treader.VideoSource(
        video_11, tcfg.FlowConfig(input=video_11, step=step, chunk_frames=chunk, new_short=ns)
    )
    tc = list(ts.chunks(step))
    assert len(tc) == len(jc)
    pairs = 0
    for a, b in zip(tc, jc):
        assert (a.base_start, a.last, a.halo) == (b.base_start, b.last, b.halo)
        np.testing.assert_array_equal(a.frames, b.frames)
        pairs += max(len(a.frames) - abs(step), 0)
    assert pairs == 11 - abs(step)  # every pair exactly once


# ---------------- job expansion ----------------

def _mklist(tmp_path, names):
    vids = []
    for n in names:
        p = tmp_path / n
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(b"fake")
        vids.append(str(p))
    lst = tmp_path / "list.txt"
    lst.write_text("\n".join(vids) + "\n")
    return str(lst)


@pytest.mark.parametrize("has_class", [False, True])
@pytest.mark.parametrize("force", [False, True])
@pytest.mark.parametrize("host_id,num_hosts", [(0, 1), (1, 2)])
def test_expand_jobs_matches(tmp_path, has_class, force, host_id, num_hosts):
    lst = _mklist(tmp_path, ["c1/a.avi", "c1/b.avi", "c2/v0.avi", "c2/v3.avi"])
    out = tmp_path / "out"
    for done in ((".done", "a"), (".done", "c1", "b"), (".done", "v0")):
        p = out.joinpath(*done)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.touch()
    kw = dict(input=lst, output_dir=str(out), has_class=has_class, force=force,
              host_id=host_id, num_hosts=num_hosts)
    tj, t_rec = treader.expand_jobs(tcfg.FlowConfig(**kw))
    jj, j_rec = jreader.expand_jobs(jcfg.FlowConfig(**kw))
    assert t_rec == j_rec is True
    assert [(j.video_path, j.output_dir) for j in tj] == \
        [(j.video_path, j.output_dir) for j in jj]


def test_expand_single_video_matches(tmp_path):
    v = tmp_path / "a.avi"
    v.write_bytes(b"x")
    kw = dict(input=str(v), output_dir=str(tmp_path / "out"))
    tj, t_rec = treader.expand_jobs(tcfg.FlowConfig(**kw))
    jj, j_rec = jreader.expand_jobs(jcfg.FlowConfig(**kw))
    assert (t_rec, [(j.video_path, j.output_dir) for j in tj]) == \
        (j_rec, [(j.video_path, j.output_dir) for j in jj])
