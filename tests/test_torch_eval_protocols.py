"""Port parity for the official-protocol drivers, the collectors, the MOT
metrics, keypoint AP and COCO RLE: each case runs the same inputs through
romp_tpu.eval and romp_tpu_torch.eval, on the fixtures the JAX package's
own tests build (`tests/test_protocols.py`, `test_collectors.py`,
`test_mot_metrics.py`, `test_mask_ap.py`), and the outputs must be equal.
The two functions that ran JAX and now run torch, `make_gt_smpl_fn` and
`agora_refine_translation`, are held to 1e-5 of max|ref|."""
import copy
import pickle
import types

import numpy as np
import pytest
import torch

from romp_tpu.eval import collectors as jcol
from romp_tpu.eval import keypoint_ap as jap
from romp_tpu.eval import mask_rle as jrle
from romp_tpu.eval import mot_metrics as jmot
from romp_tpu.eval import protocols as jp
from romp_tpu_torch.eval import collectors as tcol
from romp_tpu_torch.eval import keypoint_ap as tap
from romp_tpu_torch.eval import mask_rle as trle
from romp_tpu_torch.eval import mot_metrics as tmot
from romp_tpu_torch.eval import protocols as tp
from tests.test_collectors import _camera_frame_preds, _fixture_with_anchors
from tests.test_mask_ap import _rect_mask
from tests.test_mot_metrics import _make_tracks
from tests.test_protocols import (
    _cmu_preds_from_annots, _make_cmu_fixture, _make_pw3d_fixture,
    _rh_fixture, _rot_z,
)

torch.set_num_threads(2)

JAX = types.SimpleNamespace(p=jp, col=jcol, mot=jmot, ap=jap, rle=jrle)
PORT = types.SimpleNamespace(p=tp, col=tcol, mot=tmot, ap=tap, rle=trle)


def assert_same(a, b, path="out"):
    """Equal structure and equal values (NaN equal to NaN)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, (np.ndarray, np.generic, float, int, bool)) \
            and not isinstance(a, (str, bytes)):
        a_, b_ = np.asarray(a), np.asarray(b)
        assert a_.dtype == b_.dtype, (path, a_.dtype, b_.dtype)
        np.testing.assert_array_equal(a_, b_, err_msg=path)
    else:
        assert a == b, path


def _pw3d(tmp_path, M, **kw):
    smpl_fn = _make_pw3d_fixture(tmp_path, **kw)
    return M.p.pw3d_evaluate(str(tmp_path / "submit"),
                             str(tmp_path / "truth"), smpl_fn)


def _collector_roundtrip(tmp_path, M):
    """tests/test_protocols.py's collector round trip, frame 2 left
    missing (fill_empty), scored by the same module's pw3d_evaluate."""
    smpl_fn = _make_pw3d_fixture(tmp_path)
    gt_path = tmp_path / "truth" / "test" / "seq0.pkl"
    gt = pickle.load(open(gt_path, "rb"), encoding="latin1")
    N = np.asarray(gt["poses"][0]).shape[0]
    gt["img_frame_ids"] = np.arange(N)
    pickle.dump(gt, open(gt_path, "wb"))
    col = M.p.Pw3dSubmissionCollector(str(tmp_path / "truth"))
    for s, gender in enumerate(gt["genders"]):
        poses = np.asarray(gt["poses"])[s]
        betas = np.tile(np.asarray(gt["betas"][s])[None, :10], (N, 1))
        j24, glob = smpl_fn(gender, poses, betas, np.asarray(gt["trans"])[s])
        j24, _ = M.p.pw3d_apply_camera(j24, glob, np.asarray(gt["cam_poses"]))
        for f in range(N):
            if f != 2:
                col.add("seq0", f, s, poses[f], betas[f], j24[f])
    col.write(str(tmp_path / "submit2"))
    written = pickle.load(open(tmp_path / "submit2" / "test" / "seq0.pkl",
                               "rb"))
    return written, col.layout, M.p.pw3d_evaluate(
        str(tmp_path / "submit2"), str(tmp_path / "truth"), smpl_fn)


def _pw3d_score(tmp_path, M):
    rng = np.random.RandomState(8)
    jp_gt = rng.randn(7, 24, 3)
    jp_pred = jp_gt + rng.randn(7, 24, 3) * 0.03
    jp_pred[3] = 0.0                              # the all-zero fallback
    aa = rng.randn(7 * 24, 3) * 0.4
    mats = np.stack([jp._quat_to_mat(jp._aa_to_quat_wxyz(a)) for a in aa]
                    ).reshape(7, 24, 3, 3)
    return M.p.pw3d_score(jp_pred, jp_gt, mats[:, jp.PW3D_OR_JOINTS] @ _rot_z(
        0.1), mats), M.p.similarity_align_batch(jp_pred, jp_gt)


def _pw3d_small(tmp_path, M):
    poses2d = np.ones((5, 18, 3))
    poses2d[2] = 0.0
    rng = np.random.RandomState(7)
    cam = np.tile(np.eye(4)[None], (2, 1, 1))
    cam[:, :3, :3] = _rot_z(0.7)
    cam[:, :3, 3] = [0.3, -1.2, 4.0]
    pose = rng.randn(72) * 0.3
    return (M.p.pw3d_valid_indices(poses2d, np.array([0, 1, 1, 1, 1.0])),
            M.p.pw3d_global_orientations(pose),
            M.p.pw3d_apply_camera(rng.randn(2, 24, 3),
                                  np.tile(_rot_z(0.2)[None, None],
                                          (2, 24, 1, 1)), cam),
            M.p.rotmat_geodesic_rad(np.tile(_rot_z(0.3), (4, 1, 1)),
                                    np.tile(np.eye(3), (4, 1, 1))))


def _rh(tmp_path, M):
    annots, results = _rh_fixture()
    rng = np.random.RandomState(5)
    noisy = {k: [{"kp2ds": r["kp2ds"] + rng.randn(14, 2) * 4,
                  "trans": r["trans"] + rng.randn(3) * 0.3} for r in v]
             for k, v in results.items()}
    dropped = {k: v[:2] for k, v in results.items()}
    M.p.rh_save_results(str(tmp_path / "res.npz"), noisy)
    np.savez(tmp_path / "annots.npz", annots=annots)
    return (M.p.rh_evaluate(copy.deepcopy(results), copy.deepcopy(annots)),
            M.p.rh_evaluate(dropped, copy.deepcopy(annots)),
            M.p.rh_evaluate(M.p.rh_load_results(str(tmp_path / "res.npz")),
                            M.p.rh_load(str(tmp_path / "annots.npz"))),
            M.p.joint_mapping(M.p.BK_19, M.p.CROWDPOSE_14))


def _mupots(tmp_path, M):
    rng = np.random.RandomState(0)
    F, P = 4, 2
    gt, preds = {}, {}
    for seq in ("TS1", "TS2"):
        kp3d = rng.randn(F, P, 17, 3) * 300
        kp2d = kp3d[..., :2] / 5.0 + 500
        gt[seq] = {"kp2ds": kp2d, "kp3ds": kp3d,
                   "valid": np.ones((F, P), bool)}
        preds[seq] = [{"kp2ds": kp2d[f][[1, 0]],
                       "kp3ds": kp3d[f][[1, 0]] + rng.randn(P, 17, 3) * 60}
                      for f in range(F)]
    preds_miss = dict(preds)
    preds_miss["TS2"] = [{"kp2ds": np.zeros((0, 17, 2)),
                          "kp3ds": np.zeros((0, 17, 3))} for _ in range(F)]
    g1, g2 = rng.randn(3, 17) * 100, rng.randn(3, 17) * 100
    return (M.p.mupots_evaluate(gt, preds), M.p.mupots_evaluate(gt, preds_miss),
            M.p.mupots_match_3d([g1, g2], [g2 * 0.8 + 5.0, g1 * 1.3]),
            M.p.mupots_match_2d(np.stack([g1[:2], g2[:2]]),
                                np.stack([g2[:2] + 0.5, g1[:2] - 0.5,
                                          g1[:2] + 1e3]), thresh=100.0),
            M.p.norm_by_bone_length(g2, g1, parents=[0, 1],
                                    traversal=[1, 2]),
            M.p.mupots_pck([[np.full(17, 100.0)] * 4,
                            [np.abs(rng.randn(17)) * 150 for _ in range(4)]]))


def _agora_files(tmp_path, M):
    rng = np.random.RandomState(0)
    K = jp.AGORA_DEFAULT_K
    t_true = np.array([[0.4, -0.2, 6.0], [-1.0, 0.5, 9.0]], np.float32)
    j3 = rng.randn(2, 24, 3).astype(np.float32) * 0.4
    cam = j3 + t_true[:, None]
    pj = cam[..., :2] / cam[..., 2:] * K[0, 0] + K[:2, 2]
    outputs = {
        "smpl_thetas": rng.randn(2, 72).astype(np.float32),
        "smpl_betas": rng.randn(2, 11).astype(np.float32),
        "cam_trans": t_true,
        "joints": np.concatenate([j3 + t_true[:, None],
                                  np.zeros((2, 47, 3), np.float32)], 1),
        "pj2d_org": np.concatenate([pj, np.zeros((2, 47, 2))], 1),
    }
    # without the translation refinement: the writer alone (the refinement
    # is held to 1e-5 in its own test)
    files = M.p.agora_save_predictions(outputs, "/x/agora_img_001.png",
                                       str(tmp_path), cam_K=K,
                                       refine_trans=False)
    return [f[len(str(tmp_path)):] for f in files], [
        pickle.load(open(f, "rb")) for f in files]


def _cmu(tmp_path, M):
    annots = M.p.cmu_panoptic_convert_gts(_make_cmu_fixture())
    hidden = _make_cmu_fixture(n_imgs=1, n_person=2)
    hidden[0]["kpts2d"][1, :, 0] = -50.0
    return (annots, M.p.cmu_panoptic_convert_gts(hidden),
            M.p.cmu_panoptic_evaluate(annots, _cmu_preds_from_annots(annots)),
            M.p.cmu_panoptic_evaluate(
                annots, _cmu_preds_from_annots(annots, jitter=0.05)),
            M.p.cmu_panoptic_evaluate(annots, {}))


def _dynacam(tmp_path, M):
    rng = np.random.RandomState(3)
    F = 10
    trans = np.cumsum(rng.randn(F, 3) * 0.2, axis=0)
    grots = np.stack([[0.0, 0.0, 0.05 * t] for t in range(F)])
    ext = np.tile(np.eye(4)[None], (F, 1, 1))
    ext[:, :3, 3] = rng.randn(F, 3) * 0.1
    annots = {"seq_a": {"frame_ids": np.arange(F), "world_trans": trans[None],
                        "world_grots": grots[None],
                        "camera_extrinsics": ext},
              "seq_b": {"frame_ids": np.arange(F),
                        "world_trans": trans[None] * 2,
                        "world_grots": grots[None],
                        "camera_extrinsics": ext}}
    idx = np.arange(0, F, 2)
    preds = {"seq_a": [{i: i for i in range(F)}, None,
                       trans + rng.randn(F, 3) * 0.05,
                       grots + rng.randn(F, 3) * 0.02],
             "seq_b": [{i: k for k, i in enumerate(idx)}, None,
                       trans[idx] * 1.5, grots[idx]]}
    est = np.concatenate([trans, np.stack([jp._aa_to_quat_wxyz(g)
                                           for g in grots])], 1)
    return (M.p.dynacam_evaluate(annots, preds),
            M.p.dynacam_evaluate(annots, {"seq_a": None}),
            M.p.evaluate_ate_ape(est * 1.1 + 0.3, est, align=True),
            M.p.evaluate_ate_ape(est * 1.1 + 0.3, est, align=False))


def _collectors(tmp_path, M):
    smpl_fn, gt, subj_centers, N = _fixture_with_anchors(tmp_path)
    preds = _camera_frame_preds(smpl_fn, gt, N)
    frames = {"seq0": {}}
    for f in range(N):
        order = [1, 0] if f % 2 else [0, 1]
        frames["seq0"][f] = {
            "bbox_centers": subj_centers[order] + 7.0,
            "pose": np.stack([preds[s][0][f] for s in order]),
            "betas": np.stack([preds[s][1][f] for s in order]),
            "joints24": np.stack([preds[s][2][f] for s in order]),
        }
    frames["seq0"][3] = None                   # a frame without results
    tracks = {"seq0": {9 - s: {
        "frame_ids": np.arange(N),
        "bbox_centers": np.tile(subj_centers[s] + 3.0, (N, 1)),
        "pose": preds[s][0], "betas": preds[s][1], "joints24": preds[s][2]}
        for s in range(2)}}
    a = M.col.collect_frame_matched(frames, str(tmp_path / "truth"),
                                    str(tmp_path / "sub_f"))
    b = M.col.collect_track_matched(tracks, str(tmp_path / "truth"),
                                    str(tmp_path / "sub_t"))
    rng = np.random.RandomState(0)
    aa = rng.randn(16, 3)
    R = np.stack([jp._quat_to_mat(jp._aa_to_quat_wxyz(x)) for x in aa])
    return (a.results, b.results,
            M.p.pw3d_evaluate(str(tmp_path / "sub_f"),
                              str(tmp_path / "truth"), smpl_fn),
            M.col.rotmat_to_axis_angle(R),
            M.col.gt_anchor_centers(gt["poses2d"]))


def _mot(tmp_path, M):
    gt, pred = _make_tracks()
    for f in range(5, 10):                     # an id switch
        ids, pos = pred[f]
        pred[f] = (ids[::-1].copy(), pos)
    for f in range(3):                         # misses
        ids, pos = pred[f]
        pred[f] = (ids[:1], pos[:1])
    _, noisy = _make_tracks(noise=0.3, seed=1)
    tgt = {1: {f: np.array([0, 0, 50, 50.0]) for f in range(5)},
           2: {f: np.array([100, 100, 50, 50.0]) for f in range(20)}}
    return (M.mot.evaluate_tracking(gt, pred), M.mot.clear_mot(gt, noisy),
            M.mot.id_f1(gt, noisy), M.mot.hota(gt, noisy),
            M.mot.track_bbox_iou({0: np.array([2, 0, 4, 4.0])},
                                 {0: np.array([0, 0, 4, 4.0]),
                                  1: np.array([1, 1, 4, 4.0])}),
            M.mot.track_map([{"gt_tracks": tgt, "dt_tracks": {1: tgt[1]},
                              "dt_scores": {1: 0.9}},
                             {"gt_tracks": tgt, "dt_tracks": dict(tgt),
                              "dt_scores": {1: 0.9, 2: 0.8}}]))


def _rle(tmp_path, M):
    rng = np.random.RandomState(0)
    masks = [(rng.rand(13, 17) > 0.6).astype(np.uint8) for _ in range(3)]
    masks.append(_rect_mask(13, 17, 2, 3, 5, 6))
    rles = [M.rle.encode(m) for m in masks]
    comp = M.rle.toCompressed(rles[0])
    return (rles, [M.rle.decode(r) for r in rles],
            [M.rle.area(r) for r in rles], [M.rle.to_bbox(r) for r in rles],
            M.rle.merge(rles), M.rle.merge(rles, intersect=True),
            M.rle.iou_masks(rles[:2], rles[2:], [0, 1]), comp,
            M.rle.frUncompressed(comp),
            M.rle.iou_boxes(np.array([[0, 0, 4, 4], [1, 2, 3, 3]]),
                            np.array([[2, 2, 4, 4.0]]), [1]))


def _keypoint_ap(tmp_path, M):
    rng = np.random.RandomState(3)
    kp = np.concatenate([rng.rand(14, 2) * 200, np.full((14, 1), 2.0)], -1)
    gt_doc = {
        "images": [{"id": 1, "crowdIndex": 0.05}, {"id": 2, "crowdIndex": 0.5},
                   {"id": 3, "crowdIndex": 0.9}],
        "annotations": [
            {"image_id": i, "keypoints": (kp + 3 * i).flatten().tolist(),
             "bbox": [0, 0, 200, 200], "area": 40000} for i in (1, 2, 3)],
    }
    dts = [{"image_id": i, "keypoints": (kp + 3 * i + rng.randn(14, 3) * s
                                         ).flatten().tolist(), "score": sc}
           for i, s, sc in ((1, 1.0, 0.9), (2, 8.0, 0.7), (3, 30.0, 0.95),
                            (2, 90.0, 0.99))]
    per_image = [{"ious": rng.rand(3, 2), "dt_scores": rng.rand(3),
                  "gt_ignore": np.array([False, True])}]
    return (M.ap.crowdpose_keypoint_eval(gt_doc, dts),
            M.ap.evaluate_ap(per_image),
            M.ap.oks_iou(kp[None], np.array([900.0]),
                         (kp + rng.randn(14, 3))[None], M.ap.CROWDPOSE_SIGMAS))


CASES = {
    "pw3d_perfect": _pw3d,
    "pw3d_jitter": lambda t, M: _pw3d(t, M, jitter=0.1, rot_jitter=0.2),
    "pw3d_collector": _collector_roundtrip,
    "pw3d_score": _pw3d_score,
    "pw3d_small": _pw3d_small,
    "relative_human": _rh,
    "mupots": _mupots,
    "agora_writer": _agora_files,
    "cmu_panoptic": _cmu,
    "dynacam": _dynacam,
    "collectors": _collectors,
    "mot_metrics": _mot,
    "mask_rle": _rle,
    "keypoint_ap": _keypoint_ap,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_protocol_outputs_equal_jax(name, tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    ref = CASES[name](tmp_path / "jax", JAX)
    ours = CASES[name](tmp_path / "port", PORT)
    assert_same(ours, ref)


@pytest.fixture(scope="module")
def smpl_models():
    from romp_tpu.smpl.assets import synthetic_assets
    from romp_tpu.smpl.body_model import SmplModel as JaxSmpl
    from romp_tpu_torch.smpl.body_model import SmplModel

    return ({g: JaxSmpl.from_assets(synthetic_assets(seed=s))
             for g, s in (("f", 0), ("m", 1))},
            {g: SmplModel(synthetic_assets(seed=s))
             for g, s in (("f", 0), ("m", 1))})


@pytest.mark.parametrize("gender", ["f", "m"])
@pytest.mark.parametrize("n_betas", [10, 4])
def test_make_gt_smpl_fn_matches_jax(smpl_models, gender, n_betas):
    """The same poses, betas (padded when fewer than the model's) and
    translations through both GT SMPL functions: joints and global
    rotations to 1e-5 of max|ref|. JAX's forward runs as its own tests run
    it on the CPU."""
    jmodels, tmodels = smpl_models
    rng = np.random.RandomState(11)
    poses = (rng.randn(5, 72) * 0.3).astype(np.float32)
    betas = (rng.randn(5, n_betas) * 0.5).astype(np.float32)
    trans = rng.randn(5, 3).astype(np.float32)
    ref = jp.make_gt_smpl_fn(jmodels)(gender, poses, betas, trans)
    ours = tp.make_gt_smpl_fn(tmodels, "cpu")(gender, poses, betas, trans)
    for o, r in zip(ours, ref):
        assert o.shape == r.shape and o.dtype == r.dtype
        assert np.abs(o - r).max() <= 1e-5 * np.abs(r).max()


def test_pw3d_evaluate_with_each_sides_gt_smpl(tmp_path, smpl_models):
    """The whole 3DPW flow with each side's own GT SMPL forward (the
    fixture's predictions are JAX's GT plus a jitter): the scores agree to
    1e-3 mm / degree plus 1e-5 of their value. The joints are f32 meters
    about 4 m from the camera, whose spacing is 4.8e-4 mm there."""
    jmodels, tmodels = smpl_models
    _make_pw3d_fixture(tmp_path, jitter=0.05, rot_jitter=0.1)
    args = (str(tmp_path / "submit"), str(tmp_path / "truth"))
    ref = jp.pw3d_evaluate(*args, jp.make_gt_smpl_fn(
        {g: jmodels["f"] for g in "fmn"}))
    ours = tp.pw3d_evaluate(*args, tp.make_gt_smpl_fn(
        {g: tmodels["f"] for g in "fmn"}, "cpu"))
    assert list(ours) == list(ref)
    for k in ref:
        assert abs(ours[k] - ref[k]) <= 1e-3 + 1e-5 * abs(ref[k]), k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_agora_refine_translation_matches_jax(seed):
    rng = np.random.RandomState(seed)
    K = jp.AGORA_DEFAULT_K
    n = 4
    t_true = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                       rng.uniform(4, 12, n)], -1).astype(np.float32)
    j3 = (rng.randn(n, 24, 3) * 0.4).astype(np.float32)
    cam = j3 + t_true[:, None]
    pj = (cam[..., :2] / cam[..., 2:] * K[0, 0] + K[:2, 2]
          + rng.randn(n, 24, 2) * 0.5).astype(np.float32)
    org = rng.randn(n, 3).astype(np.float32)
    pj[-1] = np.nan                          # degenerate: falls back to org
    ref = jp.agora_refine_translation(j3, pj, org, K)
    ours = tp.agora_refine_translation(j3, pj, org, K)
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    np.testing.assert_array_equal(ours[-1], org[-1])
    np.testing.assert_array_equal(ref[-1], org[-1])
    assert np.abs(ours - ref).max() <= 1e-5 * np.abs(ref).max()
    # and the refinement recovers the translation
    assert np.abs(ours[:-1] - t_true[:-1]).max() < 0.2
