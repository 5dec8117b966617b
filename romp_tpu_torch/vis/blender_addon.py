"""Blender live-mocap addon: drive an SMPL armature from the port's socket
stream (the port's numpy copy of `romp_tpu/vis/blender_addon.py`; its
operator reads `romp_tpu_torch.vis.socket_server.ResultsClient`).

Parity target: `romp/exports/blender_mocap.py:19-161` (the bpy receiver for
the reference's realtime webcam demo). Differences, by design:
- consumes OUR TCP length-prefixed JSON protocol (vis/socket_server.py)
  instead of the reference's UDP poll, so no frames are dropped and
  multi-person payloads arrive intact;
- the retarget math (axis-angle -> per-bone quaternion + the upright-pelvis
  correction) is pure numpy below, importable and unit-testable WITHOUT
  bpy; only the thin operator layer at the bottom touches bpy.

Install: Blender > Edit > Preferences > Add-ons > Install... this file,
then Ctrl+W in the 3D view (or search "Connect romp_tpu_torch mocap")
while `romp_torch --mode webcam --socket_stream` (cli/runner.py) is
running. The scene needs
an SMPL armature with the standard 24 bone names (e.g. from the official
SMPL Blender add-on).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

SMPL_BONES = (
    "Pelvis", "L_Hip", "R_Hip", "Spine1", "L_Knee", "R_Knee", "Spine2",
    "L_Ankle", "R_Ankle", "Spine3", "L_Foot", "R_Foot", "Neck", "L_Collar",
    "R_Collar", "Head", "L_Shoulder", "R_Shoulder", "L_Elbow", "R_Elbow",
    "L_Wrist", "R_Wrist", "L_Hand", "R_Hand",
)


def axis_angle_to_quat(aa: np.ndarray) -> np.ndarray:
    """(..., 3) axis-angle -> (..., 4) quaternion (w, x, y, z)."""
    aa = np.asarray(aa, np.float64)
    angle = np.linalg.norm(aa, axis=-1, keepdims=True)
    half = angle / 2.0
    axis = np.where(angle > 1e-12, aa / np.maximum(angle, 1e-12), aa * 0.0)
    return np.concatenate(
        [np.cos(half), axis * np.sin(half)], axis=-1)


def quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Hamilton product, (w, x, y, z) convention."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw], axis=-1)


def _axis_quat(axis: Tuple[float, float, float], deg: float) -> np.ndarray:
    return axis_angle_to_quat(np.asarray(axis, np.float64)
                              * math.radians(deg))

# pelvis correction: stand upright, face -Y (blender_mocap.py:119-122 —
# rotate -90deg about X then -90deg about Z, composed onto the pelvis)
_QUAT_X_N90 = _axis_quat((1.0, 0.0, 0.0), -90.0)
_QUAT_Z_N90 = _axis_quat((0.0, 0.0, 1.0), -90.0)
_PELVIS_FIX = quat_mul(_QUAT_X_N90, _QUAT_Z_N90)


def retarget_pose(pose: np.ndarray, trans: np.ndarray,
                  pelvis_head: np.ndarray = np.zeros(3),
                  scale: float = 100.0
                  ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """SMPL axis-angle pose (72,) + camera translation (3,) ->
    ({bone: quaternion (w,x,y,z)}, pelvis location (3,)).

    Matches the reference retarget (blender_mocap.py:92-143): per-joint
    local rotations go straight onto the bones, the pelvis additionally
    gets the upright-facing correction, and the root location is the
    depth-forward translation remap (x->Y, y->Z, z->X after dropping the
    lateral offset) scaled to Blender cm units.
    """
    pose = np.asarray(pose, np.float64).reshape(-1, 3)[:24]
    quats = axis_angle_to_quat(pose)
    out = {SMPL_BONES[0]: quat_mul(_PELVIS_FIX, quats[0])}
    for i in range(1, 24):
        out[SMPL_BONES[i]] = quats[i]
    trans = np.asarray(trans, np.float64)
    rel = trans - np.array([trans[0], 0.0, trans[2]])   # keep height only
    loc = scale * np.array([rel[1], rel[2], rel[0]]) - np.asarray(
        pelvis_head, np.float64)
    return out, loc


def pick_person(payload: dict, track_id: Optional[int] = None
                ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """From a socket frame payload, the (pose, trans) of the requested
    track id (or the first person)."""
    poses = payload.get("poses") or []
    if not len(poses):
        return None
    idx = 0
    tids = payload.get("track_ids")
    if track_id is not None and tids:
        try:
            idx = list(tids).index(track_id)
        except ValueError:
            return None
    trans = (payload.get("trans") or [[0.0, 0.0, 0.0]] * len(poses))[idx]
    return np.asarray(poses[idx], np.float64), np.asarray(trans, np.float64)


def apply_frame_to_armature(armature, payload: dict,
                            track_id: Optional[int] = None,
                            pelvis_head: np.ndarray = np.zeros(3)) -> bool:
    """Apply one socket frame to a (bpy or stub) armature object exposing
    .pose.bones[name].rotation_quaternion / .location. Returns False when
    the payload holds no person."""
    picked = pick_person(payload, track_id)
    if picked is None:
        return False
    pose, trans = picked
    quats, loc = retarget_pose(pose, trans, pelvis_head)
    bones = armature.pose.bones
    for name, q in quats.items():
        bones[name].rotation_quaternion = tuple(q)
    bones[SMPL_BONES[0]].location = tuple(loc)
    return True


# ------------------------------------------------------------- bpy layer --

bl_info = {
    "name": "romp_tpu_torch Real-Time Mocap",
    "author": "romp_tpu_torch",
    "blender": (2, 80, 0),
    "version": (1, 0, 0),
    "category": "Animation",
}

try:  # pragma: no cover - exercised only inside Blender
    import bpy
except ImportError:
    bpy = None


if bpy is not None:  # pragma: no cover
    class ROMPTPU_OT_connect(bpy.types.Operator):
        """Connect to a running romp_tpu_torch socket server and stream
        poses."""

        bl_idname = "romp_tpu_torch.connect"
        bl_label = "Connect romp_tpu_torch mocap"

        def execute(self, ctx):
            from romp_tpu_torch.vis.socket_server import ResultsClient

            self._client = ResultsClient()
            arm = bpy.data.objects["Armature"]
            bpy.ops.object.mode_set(mode="EDIT")
            self._pelvis_head = np.array(
                arm.data.edit_bones[SMPL_BONES[0]].head)
            bpy.ops.object.mode_set(mode="OBJECT")
            ctx.window_manager.modal_handler_add(self)
            self._timer = ctx.window_manager.event_timer_add(
                1 / 60, window=ctx.window)
            return {"RUNNING_MODAL"}

        def modal(self, ctx, evt):
            if evt.type == "TIMER":
                payload = self._client.receive()
                if payload is None:
                    self._client.close()
                    return {"FINISHED"}
                apply_frame_to_armature(bpy.data.objects["Armature"],
                                        payload,
                                        pelvis_head=self._pelvis_head)
            if evt.type == "A":
                self._client.close()
                return {"FINISHED"}
            return {"RUNNING_MODAL"}

    _keymaps: List = []

    def register():
        bpy.utils.register_class(ROMPTPU_OT_connect)
        wm = bpy.context.window_manager
        kc = wm.keyconfigs.addon
        if kc:
            km = kc.keymaps.new(name="3D View", space_type="VIEW_3D")
            kmi = km.keymap_items.new(ROMPTPU_OT_connect.bl_idname,
                                      type="W", value="PRESS", ctrl=True)
            _keymaps.append((km, kmi))

    def unregister():
        bpy.utils.unregister_class(ROMPTPU_OT_connect)
        for km, kmi in _keymaps:
            km.keymap_items.remove(kmi)
        _keymaps.clear()

    if __name__ == "__main__":
        register()
