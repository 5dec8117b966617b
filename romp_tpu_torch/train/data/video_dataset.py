"""Video clip datasets for TRACE training (the port's own copy of
`romp_tpu/train/data/video_dataset.py`; it imports nothing of that package:
the anchors come from `romp_tpu_torch/models/trace.py`, and the batch
iterator runs a torch feature extractor on the training device).

Reference: `trace/lib/datasets/` video adapters + clip samplers
(`video_base_relative.py`, resampled per epoch in `trace/train_video.py:252`).
A VideoSequence holds per-frame annotations with persistent subject IDs;
ClipDataset samples fixed-length clips and emits the TRACE train-batch
schema (see train/trace_train_step.py), with trajectories indexed by subject.

The image backbone is frozen during TRACE training, so the loader emits
IMAGES; callers run the feature extractor once per clip and cache,
matching the reference's precomputed-feature flow.
"""
from __future__ import annotations

import dataclasses
import os.path as osp
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class VideoSequence:
    """One video's annotations. All arrays are per frame."""

    frame_paths: List[str]
    # {subject_id: dict with per-frame arrays masked by 'valid'}
    subjects: Dict[int, Dict[str, np.ndarray]]
    # each subject dict: valid (F,), czyx (F, 3) int GT center bins,
    # trans3d (F, 3), world_trans (F, 3), world_grot (F, 3),
    # pose (F, 66), betas (F, 11)
    cam_intrinsics: Optional[np.ndarray] = None
    # static-camera sequences are eligible for dynamic-camera augmentation
    # (`trace/lib/datasets/video_base_relative.py:77` gates on is_static_cam)
    is_static_cam: bool = True

    @property
    def num_frames(self) -> int:
        return len(self.frame_paths)


# --------------------------------------------- dynamic-camera augmentation --
# Reference: `trace/lib/datasets/video_base_relative.py:200-350` — static-
# camera clips are turned into synthetic moving-camera clips by sliding /
# zooming a crop window over the frames. Camera-space GT is re-derived for
# the synthetic camera; WORLD GT stays fixed, so the world-consistency
# losses teach the camera-motion heads to undo the synthetic motion.

_FOV_HALF_TAN = float(np.tan(np.radians(25.0)))  # TRACE FOV 50 deg


def _changing_curve(mode: str, T: int, ratio: float,
                    rng: np.random.RandomState) -> np.ndarray:
    """One normalized motion curve over T frames
    (`video_base_relative.py:301-313` gambling_changing_curve)."""
    t = np.arange(T, dtype=np.float32)
    if mode == "static":
        return np.zeros(T, np.float32)
    if mode == "single_direction":
        base = [np.sin(np.pi / 2 * t / max(T - 1, 1)),
                -np.sin(np.pi / 2 * t / max(T - 1, 1)),
                t / max(T - 1, 1), -t / max(T - 1, 1)]
        curve = base[rng.randint(4)] * ratio * (0.4 + rng.rand() * 0.6)
        return curve + (rng.rand(T).astype(np.float32) - 0.5) / 100
    if mode == "shaking":
        return (rng.rand(T).astype(np.float32) - 0.5) / rng.randint(10, 20)
    if mode == "return":
        rp = rng.randint(T)
        sgn = 1.0 if rng.rand() < 0.5 else -1.0
        curve = sgn * (np.sin(np.pi / 2 + np.pi / 2 * (t - rp)
                              / max(T - 1, 1)) - (rng.rand() + 0.5))
        return (curve * ratio * rng.rand()
                + (rng.rand(T).astype(np.float32) - 0.5) / 100)
    raise ValueError(mode)


def dynamic_camera_curves(T: int, rng: np.random.RandomState,
                          changing_ratio: float = 0.2):
    """Per-axis (x, y, zoom) synthetic camera-motion curves; mode pools per
    `video_base_relative.py:315-333` (x pans often, y rarely, scale static).
    Returns (dx (T,), dy (T,), zoom (T,)) in normalized full-frame units."""
    x_modes = (["single_direction"] * 7 + ["return"] * 4 + ["shaking"] * 1
               + ["static"] * 1)
    y_modes = (["shaking"] * 1 + ["return"] * 2 + ["static"] * 5
               + ["single_direction"] * 2)
    dx = _changing_curve(x_modes[rng.randint(len(x_modes))], T,
                         changing_ratio, rng)
    dy = _changing_curve(y_modes[rng.randint(len(y_modes))], T,
                         changing_ratio / 2, rng)
    zoom = np.ones(T, np.float32)  # scale mode is 'static' (reference :327)
    return dx, dy, zoom


def retarget_camera_space(trans3d: np.ndarray, ox: np.ndarray,
                          oy: np.ndarray, zoom: np.ndarray,
                          fov_half_tan: float = _FOV_HALF_TAN) -> np.ndarray:
    """Camera-space person positions under the synthetic camera.

    A crop with normalized center (ox, oy) and zoom k is the weak-persp
    equivalent of a camera panned so the crop center is the new principal
    axis and moved to depth Z/k:
      X' = X - ox * Z * tan(fov/2);  Y' = Y - oy * Z * tan;  Z' = Z / k.
    trans3d: (..., 3); ox/oy/zoom broadcastable to (...,).
    """
    X, Y, Z = trans3d[..., 0], trans3d[..., 1], trans3d[..., 2]
    return np.stack([X - ox * Z * fov_half_tan,
                     Y - oy * Z * fov_half_tan,
                     Z / np.maximum(zoom, 1e-6)], -1).astype(np.float32)


def trans3d_to_czyx(trans3d: np.ndarray, anchors: np.ndarray,
                    map_size: int = 128,
                    fov_half_tan: float = _FOV_HALF_TAN) -> np.ndarray:
    """Camera-space root positions -> (cz, cy, cx) centermap bins (the same
    binning as the pw3d converter below)."""
    depth = np.clip(trans3d[..., 2], 0.3, 100.0)
    scale = 1.0 / fov_half_tan / depth
    cz = np.argmin(np.abs(scale[..., None] - anchors), axis=-1)
    xy = trans3d[..., :2] / depth[..., None] / fov_half_tan
    cxy = np.clip((xy + 1) / 2 * map_size, 0, map_size - 1).astype(np.int32)
    return np.stack([cz, cxy[..., 1], cxy[..., 0]], -1).astype(np.int32)


class ClipDataset:
    """Samples fixed-length clips across sequences.

    With dynamic_aug_prob > 0, static-camera clips are augmented into
    synthetic moving-camera clips: either curve-driven panning
    (`generate_dynamic_augments`) or subject-tracking crops
    (`generate_dynamic_tracking_augments`, chosen with
    tracking_aug_prob, reference ratio 0.6 in `trace/configs/trace.yml:51`).
    """

    def __init__(self, sequences: Sequence[VideoSequence],
                 clip_length: int = 8, max_tracks: int = 8,
                 input_size: int = 512, dynamic_aug_prob: float = 0.0,
                 tracking_aug_prob: float = 0.6,
                 changing_ratio: float = 0.2):
        self.sequences = [s for s in sequences
                          if s.num_frames >= clip_length]
        self.clip_length = clip_length
        self.max_tracks = max_tracks
        self.input_size = input_size
        # centermap resolution the czyx bins address (OUTMAP=input/4)
        self.map_size = input_size // 4
        self.dynamic_aug_prob = dynamic_aug_prob
        self.tracking_aug_prob = tracking_aug_prob
        self.changing_ratio = changing_ratio

    def __len__(self):
        return sum(s.num_frames // self.clip_length for s in self.sequences)

    def _read_frames(self, seq: VideoSequence, start: int,
                     crops: Optional[np.ndarray] = None) -> np.ndarray:
        """crops: optional (T, 3) per-frame (ox, oy, zoom) in normalized
        full-frame units; out-of-bounds regions are zero-padded."""
        import cv2

        frames = []
        S = self.input_size
        for t, p in enumerate(seq.frame_paths[start:start
                                              + self.clip_length]):
            img = cv2.imread(p)
            if img is None:
                raise FileNotFoundError(p)
            img = cv2.resize(img[:, :, ::-1], (S, S))
            if crops is not None:
                ox, oy, zoom = crops[t]
                half = S / 2.0 / max(zoom, 1e-6)
                cx = (ox + 1.0) / 2.0 * S
                cy = (oy + 1.0) / 2.0 * S
                # pad from the ACTUAL window extent (not just half) so the
                # slice stays inside the canvas even for far-off-center
                # windows (noisy pseudo-depth can push |ox|,|oy| past 1)
                x0f = int(round(cx - half))
                y0f = int(round(cy - half))
                w = max(int(round(2 * half)), 2)
                pad = max(1, -min(x0f, y0f, 0),
                          max(x0f + w - S, y0f + w - S, 0)) + 1
                padded = np.zeros((S + 2 * pad, S + 2 * pad, 3), img.dtype)
                padded[pad:pad + S, pad:pad + S] = img
                x0 = x0f + pad
                y0 = y0f + pad
                img = cv2.resize(padded[y0:y0 + w, x0:x0 + w], (S, S))
            frames.append(img.astype(np.float32))
        return np.stack(frames)

    def sample_clip(self, rng: np.random.RandomState
                    ) -> Dict[str, np.ndarray]:
        seq = self.sequences[rng.randint(len(self.sequences))]
        start = rng.randint(seq.num_frames - self.clip_length + 1)
        T, N = self.clip_length, self.max_tracks
        sl = slice(start, start + T)

        crops = None
        if (self.dynamic_aug_prob > 0 and seq.is_static_cam
                and rng.rand() < self.dynamic_aug_prob):
            crops = self._synthesize_camera_motion(seq, sl, rng)

        frames = self._read_frames(seq, start, crops)
        out = {
            "frames": frames,
            "traj_czyx": np.zeros((N, T, 3), np.int32),
            "traj_valid": np.zeros((N, T), bool),
            "traj3d_gt": np.zeros((N, T, 3), np.float32),
            "world_trans_gt": np.zeros((N, T, 3), np.float32),
            "world_grot_gt": np.zeros((N, T, 3), np.float32),
            "pose_gt": np.zeros((N, T, 66), np.float32),
            "betas_gt": np.zeros((N, T, 11), np.float32),
        }
        for i, (sid, s) in enumerate(sorted(seq.subjects.items())[:N]):
            out["traj_valid"][i] = s["valid"][sl]
            trans3d = s["trans3d"][sl].astype(np.float32)
            czyx = s["czyx"][sl]
            if crops is not None:
                # camera-space GT re-derived for the synthetic camera; the
                # world GT below stays fixed (the original static camera IS
                # the world frame), so world-consistency supervision teaches
                # the camera-motion heads the synthetic motion.
                from romp_tpu_torch.models.trace import trace_cam_anchor

                trans3d = retarget_camera_space(
                    trans3d, crops[:, 0], crops[:, 1], crops[:, 2])
                czyx = trans3d_to_czyx(trans3d, trace_cam_anchor(),
                                       map_size=self.map_size)
            out["traj_czyx"][i] = czyx
            out["traj3d_gt"][i] = trans3d
            out["world_trans_gt"][i] = s.get("world_trans", s["trans3d"])[sl]
            out["world_grot_gt"][i] = s["world_grot"][sl] \
                if "world_grot" in s else s["pose"][sl, :3]
            out["pose_gt"][i] = s["pose"][sl]
            b = s["betas"][sl]
            out["betas_gt"][i, :, :b.shape[-1]] = b
        return out

    def _synthesize_camera_motion(self, seq: VideoSequence, sl: slice,
                                  rng: np.random.RandomState) -> np.ndarray:
        """(T, 3) per-frame (ox, oy, zoom)."""
        T = self.clip_length
        if rng.rand() < self.tracking_aug_prob and seq.subjects:
            # tracking mode: the camera follows one subject with a complete
            # trajectory (`generate_dynamic_tracking_augments`)
            complete = [s for s in seq.subjects.values()
                        if s["valid"][sl].all()]
            if complete:
                s = complete[rng.randint(len(complete))]
                tr = s["trans3d"][sl].astype(np.float32)
                depth = np.clip(tr[:, 2], 0.3, 100.0)
                # clamp: noisy pseudo-depth can put the projected center
                # outside the frame; keep the window on-canvas
                ox = np.clip(tr[:, 0] / depth / _FOV_HALF_TAN, -1.0, 1.0)
                oy = np.clip(tr[:, 1] / depth / _FOV_HALF_TAN, -1.0, 1.0)
                # fixed zoom from the subject's max apparent size x margin
                app = 1.0 / (_FOV_HALF_TAN * depth)
                margin = 1.6 + rng.rand() * 0.8
                zoom = np.full(T, min(1.0 / max(app.max() * margin, 1e-3),
                                      3.0), np.float32)
                zoom = np.maximum(zoom, 1.0)
                return np.stack([ox, oy, zoom], -1).astype(np.float32)
        dx, dy, zoom = dynamic_camera_curves(T, rng, self.changing_ratio)
        return np.stack([dx, dy, zoom], -1).astype(np.float32)


def clip_batch_iterator(ds: ClipDataset, feature_fn, flow_fn=None,
                        batch_size: int = 1, seed: int = 0, device="cpu",
                        rows: Optional[slice] = None,
                        ) -> Iterator[Dict[str, torch.Tensor]]:
    """Assemble TRACE train batches (the `trace_train_step` schema, on
    `device`): the frozen backbone's features with the carry frame, flows,
    and the GT trajectories.

    feature_fn: (T, S, S, 3) f32 frames on `device` -> (T, 32, S/4, S/4)
    features (`trace_extract_features`), run under no_grad. flow_fn:
    (prev, cur) frames -> (T, S/4, S/4, 2) flows (`make_trace_flow_fn`), or
    None for zero flow. rows: the clips of each batch to keep (a
    data-parallel rank's), after all `batch_size` are drawn, so that every
    rank follows the same random stream; only those are put on `device`
    and through `feature_fn` and `flow_fn`."""
    rng = np.random.RandomState(seed)
    while True:
        clips = [ds.sample_clip(rng) for _ in range(batch_size)]
        if rows is not None:
            clips = clips[rows]
        feats, flows = [], []
        for c in clips:
            fr = torch.from_numpy(c["frames"]).to(device)
            with torch.no_grad():
                f = feature_fn(fr).permute(0, 2, 3, 1)    # (T, H, W, 32)
                feats.append(torch.cat([f[:1], f], dim=0))
                if flow_fn is not None:
                    prev = torch.cat([fr[:1], fr[:-1]], dim=0)
                    flows.append(flow_fn(prev, fr).float())
                else:
                    # zero flow sized to the FEATURE map (not 128, so small
                    # smoke configs work)
                    flows.append(f.new_zeros((*f.shape[:3], 2)))
        batch = {k: torch.from_numpy(np.stack([c[k] for c in clips])).to(
            device) for k in clips[0] if k != "frames"}
        batch["feature_maps"] = torch.stack(feats).contiguous()
        batch["flows"] = torch.stack(flows).contiguous()
        yield batch


def from_dynacam_npz(npz_path: str, image_root: str = "",
                     map_size: int = 128) -> List[VideoSequence]:
    """DynaCam (rotation/translation) packed annotations -> VideoSequences.

    Format (`trace/lib/datasets/DynaCamTranslation.py:26-100`): annots npz
    with {'sequence_dict': {seq: [frame ids]}, seq: {person_id (N,),
    camera_intrinsics (F, 3, 3), camera_extrinsics (F, 4, 4), kp2ds_crop,
    poses (N, F, 72), betas (N, F, 10), world_grots (N, F, 3),
    world_trans (N, F, 3)}}. Camera-space roots come from applying the
    per-frame extrinsics to the world translations; cameras are DYNAMIC so
    these sequences are never re-augmented (is_static_cam=False)."""
    from romp_tpu_torch.models.trace import trace_cam_anchor

    data = np.load(npz_path, allow_pickle=True)["annots"][()]
    seq_dict = data.get("sequence_dict", {})
    anchors = trace_cam_anchor()
    out = []
    for seq_name, frame_ids in seq_dict.items():
        ann = data[seq_name]
        F = len(frame_ids)
        frame_paths = [osp.join(image_root, seq_name, f"{fid:06d}.png")
                       for fid in frame_ids]
        extr = np.asarray(ann["camera_extrinsics"], np.float32)  # (F, 4, 4)
        world_trans = np.asarray(ann["world_trans"], np.float32)  # (N, F, 3)
        world_grots = np.asarray(ann["world_grots"], np.float32)
        poses = np.asarray(ann["poses"], np.float32)
        betas = np.asarray(ann["betas"], np.float32)
        subjects = {}
        for i, pid in enumerate(np.asarray(ann["person_id"]).reshape(-1)):
            wt = world_trans[i, :F]
            # camera-space root: R @ t_world + t_cam per frame
            cam_t = (np.einsum("fij,fj->fi", extr[:F, :3, :3], wt)
                     + extr[:F, :3, 3])
            czyx = trans3d_to_czyx(cam_t, anchors, map_size)
            valid = np.isfinite(wt).all(-1) & (cam_t[:, 2] > 0.05)
            b = betas[i, :F, :10]
            subjects[int(pid)] = {
                "valid": valid,
                "czyx": czyx,
                "trans3d": cam_t.astype(np.float32),
                "world_trans": wt.astype(np.float32),
                "world_grot": world_grots[i, :F],
                "pose": poses[i, :F, :66],
                "betas": np.concatenate(
                    [b, np.zeros((F, 1), np.float32)], -1),
            }
        out.append(VideoSequence(frame_paths, subjects,
                                 cam_intrinsics=np.asarray(
                                     ann["camera_intrinsics"], np.float32),
                                 is_static_cam=False))
    return out


def from_penn_action_mats(labels_dir: str, image_root: str = "",
                          map_size: int = 128) -> List[VideoSequence]:
    """Penn Action per-video label .mat files -> VideoSequences.

    Format (`trace/lib/datasets/penn_action.py:115-140` pack_annots): each
    {video}.mat has x/y/visibility (F, 13) single-subject 2D pose + bbox.
    Static-camera sports clips -> prime dynamic-augmentation material.
    Depth is pseudo-labeled from the bbox height via the weak-perspective
    anchor relation (the same scale->depth binning BEV/TRACE use for all
    2D-only data)."""
    import glob as _glob

    from scipy.io import loadmat

    from romp_tpu_torch.models.trace import trace_cam_anchor

    anchors = trace_cam_anchor()
    out = []
    for mat_path in sorted(_glob.glob(osp.join(labels_dir, "*.mat"))):
        m = loadmat(mat_path)
        video = osp.basename(mat_path).replace(".mat", "")
        x, y = m["x"].astype(np.float32), m["y"].astype(np.float32)
        vis = m["visibility"].astype(bool)
        F = x.shape[0]
        if "dimensions" in m:
            dims = np.asarray(m["dimensions"]).reshape(-1)
            h, w = float(dims[0]), float(dims[1])
        else:
            h = w = float(max(x.max(), y.max(), 1.0))
        side = max(h, w)
        frame_paths = [osp.join(image_root, video, f"{f + 1:06d}.jpg")
                       for f in range(F)]
        # normalized person center + apparent size -> pseudo camera space
        cx = np.where(vis, x, np.nan)
        cy = np.where(vis, y, np.nan)
        with np.errstate(invalid="ignore"):
            ctr_x = (np.nanmean(cx, 1) + (side - w) / 2) / side * 2 - 1
            ctr_y = (np.nanmean(cy, 1) + (side - h) / 2) / side * 2 - 1
            height = (np.nanmax(cy, 1) - np.nanmin(cy, 1)) / side
        valid = vis.sum(1) >= 2
        height = np.clip(np.nan_to_num(height, nan=0.5), 0.05, 1.0)
        depth = 1.0 / (_FOV_HALF_TAN * height * 1.25)   # bbox->torso margin
        trans3d = np.stack(
            [np.nan_to_num(ctr_x) * depth * _FOV_HALF_TAN,
             np.nan_to_num(ctr_y) * depth * _FOV_HALF_TAN, depth],
            -1).astype(np.float32)
        subjects = {0: {
            "valid": valid,
            "czyx": trans3d_to_czyx(trans3d, anchors, map_size),
            "trans3d": trans3d,
            "world_trans": trans3d,
            "pose": np.zeros((F, 66), np.float32),
            "betas": np.zeros((F, 11), np.float32),
        }}
        out.append(VideoSequence(frame_paths, subjects, is_static_cam=True))
    return out


def from_pw3d_video(seq_dir: str, image_dir: str, split: str = "train",
                    map_size: int = 128,
                    depth_levels: int = 64) -> List[VideoSequence]:
    """Official 3DPW sequenceFiles -> VideoSequences with GT trajectories
    (camera-space SMPL roots binned onto the TRACE centermap grid)."""
    import glob
    import os.path as osp
    import pickle

    from romp_tpu_torch.models.trace import trace_cam_anchor

    anchors = trace_cam_anchor()
    out = []
    for pkl in sorted(glob.glob(osp.join(seq_dir, split, "*.pkl"))):
        with open(pkl, "rb") as f:
            seq = pickle.load(f, encoding="latin1")
        name = seq["sequence"]
        n_frames = seq["poses"][0].shape[0]
        frame_paths = [osp.join(image_dir, name, f"image_{i:05d}.jpg")
                       for i in range(n_frames)]
        subjects = {}
        for a in range(len(seq["poses"])):
            j3d = np.asarray(seq["jointPositions"][a], np.float32
                             ).reshape(n_frames, 24, 3)
            root = j3d[:, 0]
            valid = np.asarray(seq.get(
                "campose_valid", [np.ones(n_frames)] * (a + 1))[a],
                bool)[:n_frames]
            depth = np.clip(root[:, 2], 0.3, 100.0)
            scale = 1.0 / np.tan(np.radians(25.0)) / depth
            cz = np.argmin(np.abs(scale[:, None] - anchors[None]), axis=1)
            xy = root[:, :2] / depth[:, None] / np.tan(np.radians(25.0))
            cx = np.clip(((xy[:, 0] + 1) / 2 * map_size), 0,
                         map_size - 1).astype(np.int32)
            cy = np.clip(((xy[:, 1] + 1) / 2 * map_size), 0,
                         map_size - 1).astype(np.int32)
            subjects[a] = {
                "valid": valid,
                "czyx": np.stack([cz, cy, cx], -1).astype(np.int32),
                "trans3d": root,
                "world_trans": root,
                "pose": np.asarray(seq["poses"][a], np.float32)[:, :66],
                "betas": np.tile(np.asarray(seq["betas"][a],
                                            np.float32)[:10][None],
                                 (n_frames, 1)),
            }
        out.append(VideoSequence(frame_paths, subjects))
    return out


def _group_by_sequence(names: Sequence[str]):
    """imgname list -> {seq_key: [indices]} keeping frame order (frame id =
    trailing number in the basename)."""
    import re

    groups: Dict[str, List[int]] = {}
    for i, name in enumerate(names):
        base = osp.basename(str(name))
        m = re.match(r"^(.*?)[._-]?(\d+)\.(jpg|jpeg|png)$", base)
        key = m.group(1) if m else base
        groups.setdefault(osp.join(osp.dirname(str(name)), key),
                          []).append(i)
    return groups


def from_h36m_video(npz_path: str, image_root: str = "",
                    subsample: int = 5, map_size: int = 128
                    ) -> List[VideoSequence]:
    """H36M SPIN-layout npz ({imgname, S (N, 17, 4) camera-space 3D,
    optional pose (N, 72)/shape (N, 10)}) grouped into per-video sequences
    (`trace/lib/datasets/h36m.py:21-77` uses the same packs clip-wise).
    Single-subject; the camera root (pelvis) gives the GT trajectory."""
    from romp_tpu_torch.models.trace import trace_cam_anchor

    data = np.load(npz_path, allow_pickle=True)
    names = [str(n) for n in data["imgname"]]
    S = data["S"].astype(np.float32) if "S" in data.files else None
    poses = data["pose"].astype(np.float32) if "pose" in data.files else None
    betas = data["shape"].astype(np.float32) if "shape" in data.files \
        else None
    anchors = trace_cam_anchor()
    out = []
    for key, idxs in _group_by_sequence(names).items():
        idxs = idxs[::subsample]
        F = len(idxs)
        if F < 2:
            continue
        frame_paths = [osp.join(image_root, names[i]) for i in idxs]
        if S is not None:
            root = S[idxs][:, 0, :3]            # pelvis, camera meters
            valid = S[idxs][:, 0, 3] > 0
        else:
            root = np.tile(np.array([[0, 0, 5.0]], np.float32), (F, 1))
            valid = np.ones(F, bool)
        sub = {
            "valid": valid.astype(bool),
            "czyx": trans3d_to_czyx(root, anchors, map_size),
            "trans3d": root,
            "world_trans": root,
            "pose": (poses[idxs][:, :66] if poses is not None
                     else np.zeros((F, 66), np.float32)),
            "betas": (np.pad(betas[idxs], ((0, 0), (0, 1)))
                      if betas is not None
                      else np.zeros((F, 11), np.float32)),
        }
        out.append(VideoSequence(frame_paths, {0: sub},
                                 is_static_cam=True))
    return out


def from_mpi_inf_3dhp_video(npz_path: str, image_root: str = "",
                            split: str = "train", map_size: int = 128
                            ) -> List[VideoSequence]:
    """MPI-INF-3DHP packed annots (same {img_name: {kp2d, kp3d,
    univ_kp3d?, intrinsics?}} pack as the image converter) grouped into
    per-sequence trajectories (`trace/lib/datasets/mpi_inf_3dhp.py`).
    Camera-space roots come from the UNALIGNED kp3d pelvis (the image
    converter root-centers; trajectories must keep absolute depth)."""
    from romp_tpu_torch.models.trace import trace_cam_anchor
    from romp_tpu_torch.train.data.skeletons import FORMATS

    annots = np.load(npz_path, allow_pickle=True)["annots"][()]
    anchors = trace_cam_anchor()
    val_subjects = ("S8",)
    names = sorted(annots)
    pelvis_idx = FORMATS["mpiinf28"]["Pelvis"]
    out = []
    for key, idxs in _group_by_sequence(names).items():
        subject = osp.basename(str(names[idxs[0]])).split("_")[0]
        if (split == "train") == (subject in val_subjects):
            continue
        F = len(idxs)
        if F < 2:
            continue
        frame_paths = [osp.join(image_root, names[i]) for i in idxs]
        root = np.stack([np.asarray(annots[names[i]]["kp3d"],
                                    np.float32)[pelvis_idx, :3]
                         for i in idxs])
        if np.abs(root).max() > 100.0:           # mm pack -> meters
            root = root / 1000.0
        sub = {
            "valid": np.ones(F, bool),
            "czyx": trans3d_to_czyx(root, anchors, map_size),
            "trans3d": root,
            "world_trans": root,
            "pose": np.zeros((F, 66), np.float32),
            "betas": np.zeros((F, 11), np.float32),
        }
        out.append(VideoSequence(frame_paths, {0: sub},
                                 is_static_cam=True))
    return out


def from_internet_video(frame_dir: str, exts=("jpg", "jpeg", "png")
                        ) -> List[VideoSequence]:
    """Unannotated frame folder -> a VideoSequence with no subjects
    (`trace/lib/datasets/internet_video.py`: inference / pseudo-label
    material; the clip sampler only uses frame_paths)."""
    import glob as _glob

    paths: List[str] = []
    for e in exts:
        paths += _glob.glob(osp.join(frame_dir, f"*.{e}"))
    paths = sorted(paths)
    if not paths:
        return []
    return [VideoSequence(paths, {}, is_static_cam=True)]


# ------------------------------------------------------------ pack persist --
# Video annotation packs: converter output (List[VideoSequence]) serialized
# to one flat npz so the training launcher can consume
# <data_root>/<name>.npz like the image packs (`dataset.py save_pack`).

def save_video_pack(path: str, sequences: Sequence[VideoSequence]) -> None:
    flat: Dict[str, np.ndarray] = {"n_sequences": np.asarray(len(sequences))}
    for i, seq in enumerate(sequences):
        p = f"seq{i}"
        flat[f"{p}::frame_paths"] = np.asarray(seq.frame_paths, dtype=object)
        flat[f"{p}::is_static_cam"] = np.asarray(seq.is_static_cam)
        if seq.cam_intrinsics is not None:
            flat[f"{p}::cam_intrinsics"] = np.asarray(seq.cam_intrinsics)
        flat[f"{p}::subject_ids"] = np.asarray(
            sorted(seq.subjects), np.int64)
        for sid in sorted(seq.subjects):
            for field, arr in seq.subjects[sid].items():
                flat[f"{p}::s{sid}::{field}"] = np.asarray(arr)
    np.savez_compressed(path, **flat)


def load_video_pack(path: str) -> List[VideoSequence]:
    data = np.load(path, allow_pickle=True)
    n = int(data["n_sequences"])
    out: List[VideoSequence] = []
    for i in range(n):
        p = f"seq{i}"
        subjects: Dict[int, Dict[str, np.ndarray]] = {}
        for sid in data[f"{p}::subject_ids"]:
            sid = int(sid)
            pre = f"{p}::s{sid}::"
            subjects[sid] = {k[len(pre):]: data[k] for k in data.files
                             if k.startswith(pre)}
        cam_key = f"{p}::cam_intrinsics"
        out.append(VideoSequence(
            frame_paths=[str(s) for s in data[f"{p}::frame_paths"]],
            subjects=subjects,
            cam_intrinsics=data[cam_key] if cam_key in data.files else None,
            is_static_cam=bool(data[f"{p}::is_static_cam"])))
    return out
