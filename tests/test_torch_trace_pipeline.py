"""The port's TRACE pipeline against the JAX package's, key for key, on the
same numbers; its streaming and batched dispatch; its copies of the host
trackers; and the port's `trace2` CLI end to end on the CPU.

As `tests/test_trace_pipeline.py` does, the image backbone is replaced by a
stand-in (here at 32x32 features), computed once by JAX and handed to both
pipelines as the same numbers; the head runs for real on both sides."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import romp_tpu.pipeline.trace_pipeline as jtp
import romp_tpu_torch.pipeline.trace_pipeline as ttp
from romp_tpu.models.trace import init_trace_params
from romp_tpu.pipeline import trace_tracking as jtrack
from romp_tpu.smpl.assets import synthetic_assets
from romp_tpu.smpl.body_model import SmplModel as JaxSmpl
from romp_tpu.tracker import bytetrack3d as jbyte
from romp_tpu.tracker import oneeuro as jeuro
from romp_tpu_torch.pipeline import trace_tracking as ttrack
from romp_tpu_torch.smpl.body_model import SmplModel
from romp_tpu_torch.tracker import bytetrack3d as tbyte
from romp_tpu_torch.tracker import oneeuro as teuro
from romp_tpu_torch.utils.checkpoint import state_dict_from_jax
from tests.test_trace_pipeline import _dets_for_two_people

torch.set_num_threads(2)
MAP = 32
SEQ_KW = dict(large_object_thresh=-1e9, first_frame_det_thresh=-1e9,
              tracker_det_thresh=-1e9, tracker_match_thresh=1e9)
INT_KEYS = ("track_ids", "frame_ids", "frame_valid", "czyxs")


@jax.jit
def _fake_feats(frames):
    x = jax.image.resize(frames.astype(jnp.float32) / 255.0,
                         (frames.shape[0], MAP, MAP, 3), "bilinear")
    return jnp.tile(x, (1, 1, 1, 11))[..., :32]


@jax.jit
def _pair_flow(prev, cur):
    d = jax.image.resize((cur.astype(jnp.float32) - prev.astype(jnp.float32)),
                         (cur.shape[0], MAP, MAP, 3), "bilinear")
    return d[..., :2] * 0.01


def _to_jax(t):
    return jnp.asarray(t.cpu().numpy())


def _port_feats(net, frames, cfg):
    """The port's stand-in backbone: the JAX stand-in's numbers, NCHW."""
    return torch.from_numpy(np.array(_fake_feats(_to_jax(frames)))
                            ).permute(0, 3, 1, 2).contiguous()


def _flows(kind):
    """(JAX flow_fn, port flow_fn) computing the same flows."""
    if kind is None:
        return None, None
    if kind == "pair":
        def port(prev, cur):
            return torch.from_numpy(np.array(
                _pair_flow(_to_jax(prev), _to_jax(cur))))
        return _pair_flow, port

    def jseq(frames):
        return _pair_flow(frames[:-1], frames[1:])

    def tseq(frames):
        return torch.from_numpy(np.array(jseq(_to_jax(frames))))
    jseq.takes_sequence = tseq.takes_sequence = True
    return jseq, tseq


@pytest.fixture(scope="module")
def setup():
    jp = init_trace_params(jax.random.PRNGKey(0), clip_length=2, map_size=MAP)
    sd = state_dict_from_jax({k: np.asarray(v) for k, v in jp.items()})
    adult = synthetic_assets(seed=0, num_betas=11)
    baby = synthetic_assets(seed=1, num_betas=10)
    rng = np.random.RandomState(3)
    clips = [(rng.rand(2, 64, 64, 3) * 255).astype(np.float32)
             for _ in range(2)]
    return dict(jp=jp, sd=sd, adult=adult, baby=baby, clips=clips)


def _port_pipe(s, flow_fn=None):
    cfg = ttp.TraceConfig(temp_clip_length=2, max_person=4, conf_thresh=-1e9,
                          backbone=None)
    return ttp.TracePipeline(s["sd"], SmplModel(s["adult"]),
                             SmplModel(s["baby"]), cfg,
                             ttrack.SeqConfig(**SEQ_KW), flow_fn=flow_fn,
                             device="cpu")


def _assert_same(ref, got, exact_floats=False):
    assert ref is not None and got is not None
    assert set(ref) == set(got)
    for k in ref:
        r, g = np.asarray(ref[k]), np.asarray(got[k])
        assert r.shape == g.shape, k
        if k in INT_KEYS or exact_floats:
            np.testing.assert_array_equal(r, g, err_msg=k)
        else:
            scale = max(float(np.abs(r).max()), 1e-30)
            assert float(np.abs(r - g).max()) <= 1e-4 * scale, (
                k, float(np.abs(r - g).max()) / scale)


@pytest.mark.parametrize("flow", [None, "pair", "sequence"])
def test_pipeline_matches_jax_two_clips(setup, monkeypatch, flow):
    """Every output key over two clips (carried ConvGRU state, tracker and
    memory): ids and masks exactly, floats within 1e-4 of max|ref| (f32)."""
    monkeypatch.setattr(jtp, "trace_extract_features",
                        lambda p, f, u, c: _fake_feats(f))
    monkeypatch.setattr(ttp, "trace_extract_features", _port_feats)
    jflow, tflow = _flows(flow)
    jpipe = jtp.TracePipeline(
        setup["jp"], JaxSmpl.from_assets(setup["adult"]),
        JaxSmpl.from_assets(setup["baby"]),
        jtp.TraceConfig(temp_clip_length=2, max_person=4, conf_thresh=-1e9),
        jtrack.SeqConfig(**SEQ_KW), flow_fn=jflow)
    tpipe = _port_pipe(setup, tflow)
    for frames in setup["clips"]:
        ref, got = jpipe.process_clip(frames), tpipe.process_clip(frames)
        _assert_same(ref, got)
        assert got["verts"].shape[1:] == (6890, 3)


def test_stream_and_batched_dispatch_match_process_clip(setup, monkeypatch):
    monkeypatch.setattr(ttp, "trace_extract_features", _port_feats)
    _, tflow = _flows("pair")
    clips = setup["clips"]
    a = _port_pipe(setup, tflow)
    ref = [a.process_clip(f) for f in clips]
    for frontend_batch in (1, 2):
        b = _port_pipe(setup, tflow)
        got = list(b.process_stream(iter(clips),
                                    frontend_batch=frontend_batch))
        assert len(got) == 2
        for r, g in zip(ref, got):
            _assert_same(r, g, exact_floats=True)
    c = _port_pipe(setup, tflow)
    for r, h in zip(ref, c.dispatch_clips(clips)):
        _assert_same(r, c.collect_clip(h), exact_floats=True)


def test_tracker_copies_match_jax():
    """The port's copies of the numpy trackers give the JAX package's
    outputs on the same detections."""
    for cfg_kw in ({}, {"subject_num": 1, "accept_new_dets": False}):
        dets = _dets_for_two_people(8, jitter=0.005, drop=[(3, 0), (4, 0)])
        jtraj, _ = jtrack.assemble_trajectories(
            *dets, jtrack.SeqConfig(**cfg_kw))
        ttraj, _ = ttrack.assemble_trajectories(
            *dets, ttrack.SeqConfig(**cfg_kw))
        for field in ("track_ids", "czyxs", "frame_valid", "det_confs",
                      "tracked_flags"):
            np.testing.assert_array_equal(getattr(jtraj, field),
                                          getattr(ttraj, field))
        feats = np.random.RandomState(1).randn(
            len(jtraj.track_ids), 8, 8).astype(np.float32)
        cams = np.random.RandomState(2).rand(
            len(jtraj.track_ids), 8, 3).astype(np.float32) + 0.5
        jm, tm = jtrack.Memory5D(), ttrack.Memory5D()
        np.testing.assert_array_equal(
            jtrack.gate_features_with_memory(
                jtraj, feats, jm, jtrack.SeqConfig(**cfg_kw)),
            ttrack.gate_features_with_memory(
                ttraj, feats, tm, ttrack.SeqConfig(**cfg_kw)))
        np.testing.assert_array_equal(
            jtrack.infill_and_smooth_cams(jtraj, cams, jm,
                                          jtrack.SeqConfig(**cfg_kw)),
            ttrack.infill_and_smooth_cams(ttraj, cams, tm,
                                          ttrack.SeqConfig(**cfg_kw)))
    rng = np.random.RandomState(4)
    jb, tb = jbyte.ByteTracker3D(), tbyte.ByteTracker3D()
    jf, tf = jeuro.OneEuroFilter(1.0, 0.7), teuro.OneEuroFilter(1.0, 0.7)
    base = rng.rand(3, 4) * 4                    # (x, y, z, h)
    for f in range(6):
        pts = base + rng.randn(3, 4) * 0.02 + f * 0.05
        scores = rng.rand(3) * 0.5 + 0.5
        assert jb.update(pts, scores) == tb.update(pts, scores)
        np.testing.assert_array_equal(jf.process(pts[0]), tf.process(pts[0]))


def test_trace2_cli_end_to_end_on_cpu(tmp_path, capsys):
    """Full width (HRNet-W32 at 512x512, 128x128 maps) on the CPU: two
    64x64 frames, one clip of two, seeded weights and synthetic SMPL-A /
    SMIL (the missing-file fallbacks), --GPU -1."""
    cv2 = pytest.importorskip("cv2")
    from romp_tpu_torch.cli.trace import main

    frames = tmp_path / "seq"
    frames.mkdir()
    rng = np.random.RandomState(0)
    for i in range(2):
        cv2.imwrite(str(frames / f"{i:04d}.png"),
                    (rng.rand(64, 64, 3) * 255).astype(np.uint8))
    out = tmp_path / "out"
    rc = main(["-i", str(frames), "-o", str(out), "--GPU", "-1",
               "--temp_clip_length", "2", "--center_thresh=-1e9",
               "--model_path", str(tmp_path / "missing.pth"),
               "--smpl_path", str(tmp_path / "missing_smpla.pth"),
               "--smil_path", str(tmp_path / "missing_smil.pth"),
               "--raft_model_path", ""])
    assert rc == 0
    err = capsys.readouterr().err
    assert "using random init" in err and "synthetic" in err
    assert "zero optical flow" in err
    res = np.load(out / "seq.npz", allow_pickle=True)["results"][()]
    assert (out / "TRACE_seq.txt").exists()
    for fid, fr in res.items():
        assert fr["verts"].shape[1:] == (6890, 3)
        assert fr["pj2d"].shape[1:] == (71, 2)
        for k, v in fr.items():
            assert np.isfinite(v).all(), (fid, k)
