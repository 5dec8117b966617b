"""The port's clip data (`romp_tpu_torch/train/data/video_dataset.py`)
against the JAX package's: the converters on the same temporary files,
`ClipDataset.sample_clip` from the same seed (dynamic-camera augmentation
included), the video packs both ways, and `clip_batch_iterator` with the
same feature function."""
import os.path as osp
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from romp_tpu.train.data import video_dataset as jvd
from romp_tpu_torch.models.trace import trace_cam_anchor
from romp_tpu_torch.train.data import video_dataset as tvd

torch.set_num_threads(2)


def _same_sequences(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.frame_paths == b.frame_paths
        assert a.is_static_cam == b.is_static_cam
        assert (a.cam_intrinsics is None) == (b.cam_intrinsics is None)
        if a.cam_intrinsics is not None:
            np.testing.assert_array_equal(a.cam_intrinsics, b.cam_intrinsics)
        assert sorted(a.subjects) == sorted(b.subjects)
        for sid, sub in b.subjects.items():
            assert sorted(a.subjects[sid]) == sorted(sub)
            for k, v in sub.items():
                assert a.subjects[sid][k].dtype == np.asarray(v).dtype, k
                np.testing.assert_array_equal(a.subjects[sid][k], v,
                                              err_msg=k)


def _images(root, names, size=64):
    import cv2

    rng = np.random.RandomState(len(names))
    for n in names:
        path = osp.join(root, n)
        if osp.dirname(n):
            import os

            os.makedirs(osp.dirname(path), exist_ok=True)
        cv2.imwrite(path, (rng.rand(size, size, 3) * 255).astype(np.uint8))


def _dynacam(tmp):
    rng = np.random.RandomState(4)
    F, N = 6, 2
    extr = np.tile(np.eye(4, dtype=np.float32), (F, 1, 1))
    extr[:, 0, 3] = np.linspace(0, 1, F)
    annots = {"sequence_dict": {"seq0": list(range(F))}, "seq0": {
        "person_id": np.arange(N),
        "camera_intrinsics": np.tile(np.eye(3, dtype=np.float32), (F, 1, 1)),
        "camera_extrinsics": extr,
        "world_trans": np.stack([np.tile([0.0, 0.0, 4.0], (F, 1)),
                                 np.tile([1.0, 0.2, 6.0], (F, 1))]
                                ).astype(np.float32),
        "world_grots": rng.randn(N, F, 3).astype(np.float32) * 0.2,
        "poses": rng.randn(N, F, 72).astype(np.float32) * 0.2,
        "betas": rng.randn(N, F, 10).astype(np.float32) * 0.5}}
    path = str(tmp / "dynacam.npz")
    np.savez(path, annots=annots)
    return "from_dynacam_npz", (path,), {"image_root": str(tmp)}


def _penn(tmp):
    from scipy.io import savemat

    F = 5
    rng = np.random.RandomState(5)
    (tmp / "labels").mkdir()
    vis = np.ones((F, 13))
    vis[2, :12] = 0
    savemat(str(tmp / "labels" / "0001.mat"), {
        "x": rng.uniform(100, 200, (F, 13)),
        "y": rng.uniform(80, 400, (F, 13)), "visibility": vis,
        "dimensions": np.array([[480, 640, F]])})
    return "from_penn_action_mats", (str(tmp / "labels"),), {}


def _h36m(tmp):
    rng = np.random.RandomState(0)
    F = 12
    names = ([f"S1_Walking.54138969_{i:06d}.jpg" for i in range(F)]
             + [f"S1_Eating.54138969_{i:06d}.jpg" for i in range(F)])
    S = np.zeros((2 * F, 17, 4), np.float32)
    S[:, :, :3] = rng.randn(2 * F, 17, 3)
    S[:, 0, 2] = 4.0 + rng.rand(2 * F)
    S[:, :, 3] = 1.0
    np.savez(tmp / "h36m.npz", imgname=np.array(names), S=S,
             pose=rng.randn(2 * F, 72).astype(np.float32) * 0.1,
             shape=rng.randn(2 * F, 10).astype(np.float32) * 0.1)
    return "from_h36m_video", (str(tmp / "h36m.npz"),), {
        "image_root": "/img", "subsample": 2}


def _mpiinf(tmp):
    rng = np.random.RandomState(1)
    annots = {}
    for subj in ("S1", "S8"):
        for i in range(6):
            kp3d = rng.randn(28, 3).astype(np.float32)
            kp3d[4, 2] = 3.0 + i
            annots[f"{subj}_Seq1_V0_{i:05d}.jpg"] = {
                "kp2d": rng.rand(28, 2) * 512, "kp3d": kp3d}
    np.savez(tmp / "mpiinf.npz", annots=annots)
    return "from_mpi_inf_3dhp_video", (str(tmp / "mpiinf.npz"),), {}


def _pw3d(tmp):
    rng = np.random.RandomState(2)
    (tmp / "train").mkdir()
    F = 7
    seq = {"sequence": "courtyard_x", "poses": [rng.randn(F, 72)] * 2,
           "betas": [rng.randn(10), rng.randn(10)],
           "jointPositions": [rng.randn(F, 72) + [0, 0, 4] * 24,
                              rng.randn(F, 72) + [0.5, 0, 6] * 24],
           "campose_valid": [np.ones(F), np.arange(F) % 3 > 0]}
    with open(tmp / "train" / "courtyard_x.pkl", "wb") as f:
        pickle.dump(seq, f)
    return "from_pw3d_video", (str(tmp), "/imgs"), {}


def _internet(tmp):
    _images(str(tmp), [f"f{i:04d}.jpg" for i in range(3)], 8)
    return "from_internet_video", (str(tmp),), {}


@pytest.mark.parametrize("make", [_dynacam, _penn, _h36m, _mpiinf, _pw3d,
                                  _internet])
def test_converters_match_jax(tmp_path, make):
    name, args, kwargs = make(tmp_path)
    _same_sequences(getattr(tvd, name)(*args, **kwargs),
                    getattr(jvd, name)(*args, **kwargs))


def _sequences(tmp, F=12):
    """Two static-camera sequences of seeded cv2 frames: one subject moving
    across, one appearing half-way (invalid before)."""
    seqs = []
    for s in range(2):
        names = [f"s{s}/f{f:03d}.jpg" for f in range(F)]
        _images(str(tmp), names)
        t = np.linspace(-0.5, 0.5, F).astype(np.float32)
        depth = 4.0 + s
        trans = np.stack([t * depth * jvd._FOV_HALF_TAN,
                          np.full(F, 0.1, np.float32),
                          np.full(F, depth, np.float32)], -1)
        subjects = {}
        for sid in range(2):
            tr = trans + [0.3 * sid, 0, sid]
            valid = np.ones(F, bool)
            if sid:
                valid[:F // 2] = False
            subjects[sid] = {
                "valid": valid,
                "czyx": tvd.trans3d_to_czyx(
                    tr, trace_cam_anchor(), map_size=16),
                "trans3d": tr.astype(np.float32),
                "world_trans": tr.astype(np.float32),
                "pose": np.full((F, 66), 0.1 * sid, np.float32),
                "betas": np.full((F, 10), 0.2, np.float32)}
        seqs.append(tvd.VideoSequence(
            [osp.join(str(tmp), n) for n in names], subjects))
    return seqs


def test_sample_clip_matches_jax(tmp_path):
    """The same seed gives the same clips, frames and GT arrays, with the
    dynamic-camera augmentation (curves and subject tracking) on."""
    seqs = _sequences(tmp_path)
    kw = dict(clip_length=4, max_tracks=3, input_size=64,
              dynamic_aug_prob=0.8, tracking_aug_prob=0.5)
    ours, ref = tvd.ClipDataset(seqs, **kw), jvd.ClipDataset(seqs, **kw)
    assert len(ours) == len(ref)
    r1, r2 = np.random.RandomState(7), np.random.RandomState(7)
    for _ in range(6):
        a, b = ours.sample_clip(r1), ref.sample_clip(r2)
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_video_packs_read_both_ways(tmp_path):
    seqs = _sequences(tmp_path, F=6)
    tvd.save_video_pack(str(tmp_path / "ours.npz"), seqs)
    jvd.save_video_pack(str(tmp_path / "ref.npz"), seqs)
    _same_sequences(jvd.load_video_pack(str(tmp_path / "ours.npz")), seqs)
    _same_sequences(tvd.load_video_pack(str(tmp_path / "ref.npz")), seqs)


def test_clip_batch_iterator_matches_jax(tmp_path):
    """The same clips and a feature function of the same numbers (the port's
    NCHW, JAX's NHWC): the same batch, with the carry frame and zero flow
    sized to the feature map."""
    seqs = _sequences(tmp_path)
    ds = tvd.ClipDataset(seqs, clip_length=3, max_tracks=2, input_size=64)
    jds = jvd.ClipDataset(seqs, clip_length=3, max_tracks=2, input_size=64)

    def feats_np(frames):                     # (T, 64, 64, 3) -> (T, 16, 16, 32)
        f = frames[:, ::4, ::4] / 255.0
        return np.concatenate([f] * 11, -1)[..., :32]

    ours = next(tvd.clip_batch_iterator(
        ds, lambda fr: torch.from_numpy(feats_np(fr.numpy())).permute(
            0, 3, 1, 2), batch_size=2, seed=3))
    ref = next(jvd.clip_batch_iterator(
        jds, lambda fr: jnp.asarray(feats_np(np.asarray(fr))), batch_size=2,
        seed=3))
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    assert ours["feature_maps"].shape == (2, 4, 16, 16, 32)
    assert ours["flows"].shape == (2, 3, 16, 16, 2)
