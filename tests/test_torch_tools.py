"""The port's tools (`romp_tpu_torch/tools/`) and Blender addon
(`romp_tpu_torch/vis/blender_addon.py`) against the JAX package's on the
same inputs, with the JAX tests' own checks (`tests/test_export.py`,
`tests/test_aux.py`, `tests/test_video_data.py`, `tests/test_tb_blender.py`)
on the port."""
import json
import os.path as osp
import pickle
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from romp_tpu.ops.rotations import axis_angle_to_matrix as jax_aa2mat

torch.set_num_threads(2)


def _official_smpl(rng, V=120):
    """An official-layout SMPL pickle's dict (chumpy-free), 24 joints, with
    the 0xFFFFFFFF root of `kintree_table`."""
    kin = np.zeros((2, 24), np.int64)
    kin[0] = [2 ** 32 - 1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13,
              14, 16, 17, 18, 19, 20, 21]
    return {"v_template": rng.randn(V, 3), "shapedirs": rng.randn(V, 3, 10),
            "posedirs": rng.randn(V, 3, 207), "J_regressor": rng.rand(24, V),
            "kintree_table": kin, "weights": rng.rand(V, 24),
            "f": rng.randint(0, V, (2 * V, 3))}


@pytest.mark.parametrize("tool,name", [("prepare_smpl", "SMPL_NEUTRAL"),
                                       ("prepare_smil", "smil_web")])
def test_prepare_tools_pack_as_jax_does(tmp_path, tool, name, capsys):
    """`romp_torch.prepare_smpl` / `bev_torch.prepare_smil` on a synthetic
    official pickle: the archive equals the JAX tool's, and the port's
    `load_smpl_assets_flexible` reads it back."""
    import importlib

    from romp_tpu_torch.cli.common import load_smpl_assets_flexible

    with open(tmp_path / f"{name}.pkl", "wb") as f:
        pickle.dump(_official_smpl(np.random.RandomState(0)), f)
    ours = importlib.import_module(f"romp_tpu_torch.tools.{tool}")
    ref = importlib.import_module(f"romp_tpu.tools.{tool}")
    for mod, out in ((ours, "torch"), (ref, "jax")):
        assert mod.main(["--source_dir", str(tmp_path), "--out_dir",
                         str(tmp_path / out)]) == 0
    assert "packed" in capsys.readouterr().out
    with np.load(tmp_path / "torch" / f"{name}.npz") as a, \
            np.load(tmp_path / "jax" / f"{name}.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assets = load_smpl_assets_flexible(str(tmp_path / "torch" / f"{name}.npz"))
    assert assets.v_template.shape == (120, 3) and assets.parents[0] == -1
    assert assets.posedirs.shape == (207, 360)
    assert ours.main(["--source_dir", str(tmp_path / "none")]) == 1


def test_missing_assets_warning_names_the_ports_tool(capsys):
    """Without SMPL files the port falls back to synthetic assets and
    points the user at its own packer, not the JAX package's."""
    from romp_tpu_torch.cli.common import load_smpl_assets_flexible

    assets = load_smpl_assets_flexible("/nonexistent/SMPL_NEUTRAL.pth")
    err = capsys.readouterr().err
    assert assets.v_template.shape == (6890, 3)
    assert "romp_torch.prepare_smpl" in err
    assert "romp_tpu_torch.tools.prepare_smpl" in err
    assert "romp_tpu.tools" not in err


def test_bvh_export_equals_jax(tmp_path):
    from romp_tpu.tools.export_motion import export_bvh as jax_bvh
    from romp_tpu_torch.tools.export_motion import export_bvh

    rng = np.random.RandomState(0)
    poses = rng.randn(5, 72).astype(np.float32) * 0.3
    trans = rng.randn(5, 3).astype(np.float32)
    export_bvh(poses, trans, str(tmp_path / "a.bvh"), frame_rate=30)
    jax_bvh(poses, trans, str(tmp_path / "b.bvh"), frame_rate=30)
    text = open(tmp_path / "a.bvh").read()
    assert text == open(tmp_path / "b.bvh").read()
    assert text.startswith("HIERARCHY") and "ROOT Pelvis" in text
    motion = text.split("MOTION")[1].strip().splitlines()[2:]
    assert len(motion) == 5 and len(motion[0].split()) == 3 + 24 * 3


def test_export_motion_cli(tmp_path):
    """`python -m romp_tpu_torch.tools.export_motion`: video_results.npz ->
    one BVH per track."""
    from romp_tpu_torch.tools.export_motion import main

    seqs = {1: {"smpl_thetas": np.zeros((5, 72), np.float32),
                "cam_trans": np.zeros((5, 3), np.float32)},
            2: {"smpl_thetas": np.zeros((3, 72), np.float32)}}
    npz = str(tmp_path / "video_results.npz")
    np.savez_compressed(npz, sequence_results=seqs)
    out = str(tmp_path / "bvh")
    assert main(["-i", npz, "-o", out, "--frame_rate", "24"]) == 0
    for tid in (1, 2):
        assert osp.exists(osp.join(out, f"track_{tid}.bvh"))
    assert "Frames: 5" in open(osp.join(out, "track_1.bvh")).read()


def _standing_joints():
    """tests/test_export.py's standing SMPL-24 skeleton (y down)."""
    j = np.zeros((24, 3), np.float32)
    rows = {1: [0.1, 0.05, 0], 2: [-0.1, 0.05, 0], 3: [0, -0.1, 0],
            4: [0.1, 0.5, 0], 5: [-0.1, 0.5, 0], 6: [0, -0.2, 0],
            7: [0.1, 0.95, 0], 8: [-0.1, 0.95, 0], 9: [0, -0.3, 0],
            10: [0.1, 1.0, 0.1], 11: [-0.1, 1.0, 0.1], 12: [0, -0.45, 0],
            13: [0.08, -0.4, 0], 14: [-0.08, -0.4, 0], 15: [0, -0.6, 0],
            16: [0.2, -0.4, 0], 17: [-0.2, -0.4, 0], 18: [0.45, -0.4, 0],
            19: [-0.45, -0.4, 0], 20: [0.7, -0.4, 0], 21: [-0.7, -0.4, 0],
            22: [0.75, -0.4, 0], 23: [-0.75, -0.4, 0]}
    for i, v in rows.items():
        j[i] = v
    return j


def test_deepmimic_export_frames_equal_jax(tmp_path):
    """The 44-dof humanoid3d frames (the JAX test's layout checks) and the
    same frames as JAX's tool, exactly; the CLI round trip."""
    from romp_tpu.tools.export_deepmimic import (
        smpl_joints_to_deepmimic as jax_mimic,
    )
    from romp_tpu_torch.tools.export_deepmimic import (
        FRAME_DOF, main, smpl_joints_to_deepmimic,
    )

    T = 3
    joints = np.stack([_standing_joints() + [0.01 * t, 0, 0]
                       for t in range(T)])
    doc = smpl_joints_to_deepmimic(joints, fps=10.0)
    assert doc == jax_mimic(joints, fps=10.0)
    frames = np.asarray(doc["Frames"])
    assert frames.shape == (T, FRAME_DOF) and doc["Loop"] == "none"
    np.testing.assert_allclose(frames[:, 0], 0.1)
    for q0 in (4, 8, 12, 16, 21, 25, 30, 35, 39):
        np.testing.assert_allclose(
            np.linalg.norm(frames[:, q0:q0 + 4], axis=1), 1.0, atol=1e-6)
    for a0 in (20, 29, 34, 43):
        assert np.abs(frames[:, a0]).max() < 0.35
    npz, out = tmp_path / "motion.npz", tmp_path / "motion.json"
    np.savez(npz, joints=joints)
    assert main([str(npz), str(out), "--fps", "10"]) == 0
    assert len(json.load(open(out))["Frames"]) == T


def test_h36m_frame_extractor_equals_jax(tmp_path):
    """A tiny cv2 video per camera: the port writes the same frames, under
    the same names, as JAX's extractor (the JAX test's counts)."""
    import cv2

    from romp_tpu.tools import extract_h36m_frames as jax_h36m
    from romp_tpu_torch.tools.extract_h36m_frames import (
        extract_subject, extract_video, main,
    )

    vid_dir = tmp_path / "S1" / "Videos"
    vid_dir.mkdir(parents=True)
    for name in ("Walking 1.54138969.mp4", "Walking 1_ALL.55011271.mp4"):
        w = cv2.VideoWriter(str(vid_dir / name),
                            cv2.VideoWriter_fourcc(*"mp4v"), 25, (32, 24))
        for i in range(22):
            w.write(np.full((24, 32, 3), i * 10, np.uint8))
        w.release()
    for out in ("torch", "jax"):
        (tmp_path / out).mkdir()
    written = extract_subject("S1", str(tmp_path), str(tmp_path / "torch"),
                              every=5, max_frames=3)
    ref = jax_h36m.extract_subject("S1", str(tmp_path), str(tmp_path / "jax"),
                                   every=5, max_frames=3)
    assert [osp.basename(p) for p in written] == [osp.basename(p)
                                                  for p in ref]
    assert len(written) == 3 and all("S1_Walking 1_0_" in p for p in written)
    for a, b in zip(written, ref):
        np.testing.assert_array_equal(cv2.imread(a), cv2.imread(b))
    assert cv2.imread(written[0]).shape == (24, 32, 3)
    assert len(extract_video(str(vid_dir / "Walking 1.54138969.mp4"),
                             str(tmp_path / "torch"), every=10)) == 2
    assert main([str(tmp_path), str(tmp_path / "cli"), "--subjects", "S1",
                 "--max-frames", "1"]) == 0


def test_show_results_renders_a_saved_result(tmp_path, capsys):
    """`show_results` re-renders one saved result (a CLI's npz beside its
    frame) through the port's renderer and compositor."""
    import cv2

    from romp_tpu_torch.smpl.body_model import synthetic_assets
    from romp_tpu_torch.tools.show_results import main

    res_dir = tmp_path / "results"
    res_dir.mkdir()
    assets = synthetic_assets(seed=0)
    rng = np.random.RandomState(0)
    verts = assets.v_template[None] * 0.5 + rng.randn(1, 1, 3) * 0.01
    results = {"verts": verts.astype(np.float32),
               "cam_trans": np.array([[0.0, 0.0, 3.0]], np.float32),
               "verts_camed_org": np.concatenate(
                   [verts[..., :2] * 100 + 32, verts[..., 2:]], -1
               ).astype(np.float32),
               "pj2d_org": rng.rand(1, 54, 2).astype(np.float32) * 64}
    np.savez(res_dir / "frame0.npz", results=results)
    cv2.imwrite(str(res_dir / "frame0.png"), np.full((64, 64, 3), 90,
                                                     np.uint8))
    assert main(["--results_dir", str(res_dir), "--save_dir",
                 str(tmp_path / "out"), "--show_items", "mesh"]) == 0
    assert "rendered 1 frames" in capsys.readouterr().out
    img = cv2.imread(str(tmp_path / "out" / "frame0.png"))
    assert img is not None and img.shape[:2] == (64, 64)


# --- the Blender addon (tests/test_tb_blender.py on the port) -------------

class _StubBone:
    def __init__(self):
        self.rotation_quaternion = (1.0, 0.0, 0.0, 0.0)
        self.location = (0.0, 0.0, 0.0)


class _StubArmature:
    def __init__(self):
        from romp_tpu_torch.vis.blender_addon import SMPL_BONES

        class Pose:
            bones = {n: _StubBone() for n in SMPL_BONES}

        self.pose = Pose()


def test_retarget_equals_jax_and_identity_pose():
    from romp_tpu.vis import blender_addon as jb
    from romp_tpu_torch.vis.blender_addon import _PELVIS_FIX, retarget_pose

    assert jb.bpy is None
    quats, loc = retarget_pose(np.zeros(72), np.zeros(3))
    np.testing.assert_allclose(quats["L_Knee"], [1, 0, 0, 0])
    np.testing.assert_allclose(quats["Pelvis"], _PELVIS_FIX)
    np.testing.assert_allclose(loc, 0.0)
    _, loc2 = retarget_pose(np.zeros(72), np.array([0.5, 0.2, 3.0]))
    np.testing.assert_allclose(loc2, [20.0, 0.0, 0.0])
    rng = np.random.RandomState(0)
    pose, trans, head = rng.randn(72) * 0.5, rng.randn(3), rng.randn(3)
    ours, ours_loc = retarget_pose(pose, trans, head)
    ref, ref_loc = jb.retarget_pose(pose, trans, head)
    assert ours.keys() == ref.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], ref[k])
    np.testing.assert_array_equal(ours_loc, ref_loc)


def test_quat_math_against_rotation_composition():
    """The quaternion product equals the product of the port's (and JAX's)
    rotation matrices."""
    from romp_tpu_torch.ops.rotations import axis_angle_to_matrix
    from romp_tpu_torch.vis.blender_addon import axis_angle_to_quat, quat_mul

    rng = np.random.RandomState(0)
    a, b = rng.randn(3) * 0.7, rng.randn(3) * 0.7
    w, x, y, z = quat_mul(axis_angle_to_quat(a), axis_angle_to_quat(b))
    R_q = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
    Ra, Rb = (axis_angle_to_matrix(torch.from_numpy(v[None]))[0].numpy()
              for v in (a, b))
    np.testing.assert_allclose(R_q, Ra @ Rb, atol=1e-6)
    Ja, Jb = (np.asarray(jax_aa2mat(jnp.asarray(v[None], jnp.float32))[0])
              for v in (a, b))
    np.testing.assert_allclose(R_q, Ja @ Jb, atol=1e-6)


def test_addon_consumes_socket_stream():
    """End to end: the port's ResultsServer.broadcast -> ResultsClient ->
    apply_frame_to_armature on a bpy-stubbed armature."""
    from romp_tpu_torch.vis.blender_addon import apply_frame_to_armature
    from romp_tpu_torch.vis.socket_server import ResultsClient, ResultsServer

    server = ResultsServer(port=0)
    try:
        client = ResultsClient(port=server.port)
        deadline = time.time() + 5.0
        while server.broadcast({}) == 0:      # wait for accept
            assert time.time() < deadline
            time.sleep(0.01)
        thetas = np.zeros((2, 72))
        thetas[0, 3:6] = [0.3, 0.0, 0.0]      # L_Hip bend, person 0
        results = {"smpl_thetas": thetas, "smpl_betas": np.zeros((2, 10)),
                   "cam_trans": np.array([[0.0, 0.4, 3.0], [1.0, 0.0, 5.0]]),
                   "track_ids": np.array([7, 9])}
        assert server.broadcast(results, frame_id=3) == 1
        client.receive()                       # the empty probe frame
        payload = client.receive()
        assert payload["frame_id"] == 3
        arm = _StubArmature()
        assert apply_frame_to_armature(arm, payload)
        np.testing.assert_allclose(
            np.asarray(arm.pose.bones["L_Hip"].rotation_quaternion),
            [np.cos(0.15), np.sin(0.15), 0, 0], atol=1e-6)
        np.testing.assert_allclose(arm.pose.bones["Pelvis"].location,
                                   [40.0, 0.0, 0.0])
        arm2 = _StubArmature()
        assert apply_frame_to_armature(arm2, payload, track_id=9)
        np.testing.assert_allclose(
            arm2.pose.bones["L_Hip"].rotation_quaternion, [1, 0, 0, 0])
        assert not apply_frame_to_armature(arm2, payload, track_id=42)
        client.close()
    finally:
        server.close()
