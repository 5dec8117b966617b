"""Dataset layer: normalized annotation packs, augmentation, mixed sampling.

The port's copy of the JAX package's numpy-only
`romp_tpu/train/data/dataset.py`, so that the port imports nothing of that
package.

Replaces the reference's 20-adapter torch Dataset stack
(`romp/lib/dataset/*.py`, `image_base.py:40-200`, `mixed_dataset.py:35-61`)
with one normalized record format + thin per-source converters:

- every dataset is converted (offline or at load) into ImageAnnotation
  records: per-person SMPL54-mapped kp2d/kp3d + optional SMPL params;
- MixedDataset samples sources with configured probabilities
  (`mixed_dataset.py:35`: prob-weighted concat);
- batches are fixed-shape (B, P, ...) dicts consumed directly by the SPMD
  train step (center maps + sampling indices are derived ON DEVICE from the
  normalized centers, so the host emits only compact annotations).
"""
from __future__ import annotations

import dataclasses
import os.path as osp
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from romp_tpu_torch.train.data.augment import AugmentConfig, augment_sample
from romp_tpu_torch.train.data.skeletons import (
    FORMATS, INVALID, SMPL_ALL_54, joint_mapping, map_joints,
)


@dataclasses.dataclass
class ImageAnnotation:
    """One image's normalized annotations (P persons, SMPL54 joint order)."""

    image_path: str
    kp2ds: np.ndarray                      # (P, 54, 2) pixels, INVALID=-2
    kp3ds: Optional[np.ndarray] = None     # (P, 54, 3) root-relative meters
    poses: Optional[np.ndarray] = None     # (P, 66) axis-angle
    betas: Optional[np.ndarray] = None     # (P, 10)
    kp3d_mask: Optional[np.ndarray] = None   # (P,) bool
    pose_mask: Optional[np.ndarray] = None
    betas_mask: Optional[np.ndarray] = None
    # BEV relative supervision (Relative Human / AGORA):
    depth_ids: Optional[np.ndarray] = None    # (P,) int ordinal layer, -1
    age_gts: Optional[np.ndarray] = None      # (P,) {0..3}, -1 unannotated
    kid_offsets: Optional[np.ndarray] = None  # (P,) [0,1], -1 unannotated
    # Detection-only supervision (CrowdHuman / bbox-fallback persons,
    # `romp/lib/dataset/crowdhuman.py` vmask_2d=[False,...,True]): persons
    # with a bbox but no keypoints still supervise the centermap.
    bboxes: Optional[np.ndarray] = None       # (P, 4) ltrb pixels, or NaN row

    @property
    def num_person(self) -> int:
        return self.kp2ds.shape[0]


def save_pack(path: str, records: Sequence[ImageAnnotation]) -> None:
    blob = [dataclasses.asdict(r) for r in records]
    np.savez_compressed(path, records=np.asarray(blob, dtype=object))


def load_pack(path: str) -> List[ImageAnnotation]:
    data = np.load(path, allow_pickle=True)["records"]
    return [ImageAnnotation(**d) for d in data]


class SingleDataset:
    """Records + augmentation -> fixed-shape samples."""

    def __init__(self, records: Sequence[ImageAnnotation], name: str,
                 aug: Optional[AugmentConfig] = None, num_person: int = 8,
                 train: bool = True, image_root: str = ""):
        self.records = list(records)
        self.name = name
        self.aug = aug or AugmentConfig()
        self.num_person = num_person
        self.train = train
        self.image_root = image_root

    def __len__(self):
        return len(self.records)

    def _read_image(self, path: str) -> np.ndarray:
        import cv2

        full = osp.join(self.image_root, path) if self.image_root else path
        img = cv2.imread(full)
        if img is None:
            raise FileNotFoundError(full)
        return img[:, :, ::-1]  # BGR -> RGB

    def get_sample(self, index: int,
                   rng: np.random.RandomState) -> Dict[str, np.ndarray]:
        rec = self.records[index % len(self.records)]
        image = self._read_image(rec.image_path)
        P = self.num_person
        n = min(rec.num_person, P)

        kp2ds = rec.kp2ds[:n].astype(np.float32)
        kp3ds = (rec.kp3ds[:n].astype(np.float32)
                 if rec.kp3ds is not None else None)
        poses = (rec.poses[:n].astype(np.float32)
                 if rec.poses is not None else None)
        bbox_pts = None
        if rec.bboxes is not None:
            lt = rec.bboxes[:n, :2].astype(np.float32)
            rb = rec.bboxes[:n, 2:].astype(np.float32)
            bbox_pts = np.stack([lt, rb], axis=1)              # (n, 2, 2)
            bbox_pts[np.isnan(bbox_pts)] = INVALID
        image, kp2ds, kp3ds, poses, bbox_pts = augment_sample(
            image, kp2ds, kp3ds, poses, self.aug, rng, self.train,
            extra_pts=bbox_pts)

        def _pad(a, shape, fill):
            out = np.full(shape, fill, np.float32)
            if a is not None:
                out[:a.shape[0]] = a
            return out

        vis = (kp2ds > INVALID + 1e-6).all(-1)                 # (n, 54)
        has_pose2d = vis.sum(-1) >= 2
        has_bbox = np.zeros(n, bool)
        if bbox_pts is not None:
            has_bbox = (bbox_pts > INVALID + 1e-6).all(axis=(-2, -1))
        person_ok = has_pose2d | has_bbox
        centers = np.full((P, 2), -2.0, np.float32)
        bbox_hw = np.zeros((P, 2), np.float32)
        for p in range(n):
            if not person_ok[p]:
                continue
            if has_pose2d[p]:
                pts = kp2ds[p][vis[p]]
            else:                                  # bbox-only person
                pts = bbox_pts[p]
            centers[p] = (pts.min(0) + pts.max(0)) / 2.0
            bbox_hw[p] = (pts.max(0) - pts.min(0))[::-1]       # (h, w)

        mask = np.zeros(P, bool)
        mask[:n] = person_ok
        kp2d_mask = np.zeros(P, bool)
        kp2d_mask[:n] = has_pose2d

        def _flag(m):
            out = np.zeros(P, bool)
            if m is not None:
                out[:n] = np.asarray(m[:n], bool) & person_ok
            return out

        def _opt_per_person(vals, fill=-1.0):
            out = np.full(P, fill, np.float32)
            if vals is not None:
                out[:n] = np.asarray(vals[:n], np.float32)
            return out

        return {
            "image": image,
            "depth_ids": _opt_per_person(rec.depth_ids),
            "age_gts": _opt_per_person(rec.age_gts),
            "kid_offsets_gt": _opt_per_person(rec.kid_offsets),
            "person_centers": centers,
            "person_bbox_hw": bbox_hw,
            "person_mask": mask,
            "kp2d_mask": kp2d_mask,
            "kp2d_gt": _pad(kp2ds, (P, 54, 2), INVALID),
            "kp3d_gt": _pad(kp3ds, (P, 54, 3), INVALID),
            "kp3d_mask": _flag(rec.kp3d_mask
                               if rec.kp3d_mask is not None
                               else ([True] * n if kp3ds is not None
                                     else None)),
            "pose_gt": _pad(poses, (P, 66), 0.0),
            "pose_mask": _flag(rec.pose_mask
                               if rec.pose_mask is not None
                               else ([True] * n if poses is not None
                                     else None)),
            "betas_gt": _pad(rec.betas[:n] if rec.betas is not None else None,
                             (P, 10), 0.0),
            "betas_mask": _flag(rec.betas_mask
                                if rec.betas_mask is not None
                                else ([True] * n if rec.betas is not None
                                      else None)),
        }


class MixedDataset:
    """Probability-weighted multi-source sampler (`mixed_dataset.py:35-61`)."""

    def __init__(self, datasets: Sequence[SingleDataset],
                 sample_probs: Optional[Sequence[float]] = None):
        self.datasets = list(datasets)
        if sample_probs is None or not len(sample_probs):
            sample_probs = [len(d) for d in datasets]
        p = np.asarray(sample_probs, np.float64)
        self.probs = p / p.sum()

    def sample(self, rng: np.random.RandomState) -> Dict[str, np.ndarray]:
        d = self.datasets[rng.choice(len(self.datasets), p=self.probs)]
        return d.get_sample(rng.randint(len(d)), rng)


def batch_iterator(mixed: MixedDataset, batch_size: int,
                   seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.RandomState(seed)
    while True:
        samples = [mixed.sample(rng) for _ in range(batch_size)]
        yield {k: np.stack([s[k] for s in samples]) for k in samples[0]}


# ------------------------------------------------------------- converters --

def from_coco_json(json_path: str, min_kps: int = 2) -> List[ImageAnnotation]:
    """COCO person-keypoints json -> records (COCO_17 -> SMPL54 mapping as
    `romp/lib/dataset/coco14.py:31`)."""
    import json

    with open(json_path) as f:
        doc = json.load(f)
    images = {im["id"]: im["file_name"] for im in doc["images"]}
    mapping = joint_mapping(FORMATS["coco17"], SMPL_ALL_54)
    per_image: Dict[int, List[np.ndarray]] = {}
    for ann in doc["annotations"]:
        if ann.get("num_keypoints", 0) < min_kps or ann.get("iscrowd", 0):
            continue
        kp = np.asarray(ann["keypoints"], np.float32).reshape(17, 3)
        kp2d = kp[:, :2].copy()
        kp2d[kp[:, 2] < 1] = INVALID
        per_image.setdefault(ann["image_id"], []).append(kp2d)
    records = []
    for img_id, kps in per_image.items():
        kp54 = map_joints(np.stack(kps), mapping)
        records.append(ImageAnnotation(images[img_id], kp54))
    return records


def from_pw3d_sequences(seq_dir: str, image_dir: str,
                        split: str = "train") -> List[ImageAnnotation]:
    """Official 3DPW sequenceFiles pkls -> records (poses/betas/jointPositions
    per frame per actor; layout as `romp/lib/dataset/pw3d.py` pack_data)."""
    import glob
    import pickle

    from romp_tpu_torch.train.data.skeletons import SMPL_24

    mapping24 = joint_mapping(FORMATS["smpl24"], SMPL_ALL_54)
    records = []
    for pkl in sorted(glob.glob(osp.join(seq_dir, split, "*.pkl"))):
        with open(pkl, "rb") as f:
            seq = pickle.load(f, encoding="latin1")
        name = seq["sequence"]
        n_frames = len(seq["img_frame_ids"]) if "img_frame_ids" in seq \
            else seq["poses"][0].shape[0]
        n_actors = len(seq["poses"])
        for fid in range(n_frames):
            kp2ds, kp3ds, poses, betas = [], [], [], []
            for a in range(n_actors):
                if "campose_valid" in seq and \
                        not seq["campose_valid"][a][fid]:
                    continue
                p2 = np.asarray(seq["poses2d"][a][fid], np.float32)  # (3, 18)
                kp2d = p2[:2].T.copy()
                kp2d[p2[2].T < 0.3] = INVALID
                # poses2d are COCO18-ordered; map the common joints
                from romp_tpu_torch.train.data.skeletons import joint_mapping as jm
                COCO_18 = {
                    'Nose': 0, 'Neck': 1, 'R_Shoulder': 2, 'R_Elbow': 3,
                    'R_Wrist': 4, 'L_Shoulder': 5, 'L_Elbow': 6,
                    'L_Wrist': 7, 'R_Hip': 8, 'R_Knee': 9, 'R_Ankle': 10,
                    'L_Hip': 11, 'L_Knee': 12, 'L_Ankle': 13, 'R_Eye': 14,
                    'L_Eye': 15, 'R_Ear': 16, 'L_Ear': 17}
                kp2ds.append(map_joints(kp2d[None],
                                        jm(COCO_18, SMPL_ALL_54))[0])
                j3d = np.asarray(
                    seq["jointPositions"][a][fid], np.float32).reshape(24, 3)
                j3d = j3d - j3d[0]
                kp3ds.append(map_joints(j3d[None], mapping24)[0])
                poses.append(np.asarray(seq["poses"][a][fid],
                                        np.float32)[:66])
                betas.append(np.asarray(seq["betas"][a], np.float32)[:10])
            if not kp2ds:
                continue
            records.append(ImageAnnotation(
                osp.join(image_dir, name, f"image_{fid:05d}.jpg"),
                np.stack(kp2ds), np.stack(kp3ds), np.stack(poses),
                np.stack(betas)))
    return records


def from_crowdpose_json(json_path: str,
                        min_kps: int = 2) -> List[ImageAnnotation]:
    """CrowdPose json (COCO-style, 14-joint skeleton) -> records
    (`romp/lib/dataset/crowdpose.py` uses Crowdpose_14 -> SMPL54)."""
    import json

    CROWDPOSE_14 = {
        "L_Shoulder": 0, "R_Shoulder": 1, "L_Elbow": 2, "R_Elbow": 3,
        "L_Wrist": 4, "R_Wrist": 5, "L_Hip": 6, "R_Hip": 7, "L_Knee": 8,
        "R_Knee": 9, "L_Ankle": 10, "R_Ankle": 11, "Head_top": 12,
        "Neck_LSP": 13}
    with open(json_path) as f:
        doc = json.load(f)
    images = {im["id"]: im["file_name"] for im in doc["images"]}
    mapping = joint_mapping(CROWDPOSE_14, SMPL_ALL_54)
    per_image: Dict[int, List[np.ndarray]] = {}
    for ann in doc["annotations"]:
        kp = np.asarray(ann["keypoints"], np.float32).reshape(14, 3)
        if (kp[:, 2] > 0).sum() < min_kps:
            continue
        kp2d = kp[:, :2].copy()
        kp2d[kp[:, 2] < 1] = INVALID
        per_image.setdefault(ann["image_id"], []).append(kp2d)
    return [ImageAnnotation(images[i], map_joints(np.stack(k), mapping))
            for i, k in per_image.items()]


def from_mpii_json(json_path: str) -> List[ImageAnnotation]:
    """MPII annotations in the common converted-json format
    ([{image, joints (16, 2), joints_vis (16,)}...]) -> records."""
    import json

    with open(json_path) as f:
        doc = json.load(f)
    mapping = joint_mapping(FORMATS["mpii16"], SMPL_ALL_54)
    per_image: Dict[str, List[np.ndarray]] = {}
    for ann in doc:
        kp2d = np.asarray(ann["joints"], np.float32)
        vis = np.asarray(ann.get("joints_vis", np.ones(16)), np.float32)
        kp2d[vis < 1] = INVALID
        per_image.setdefault(ann["image"], []).append(kp2d)
    return [ImageAnnotation(name, map_joints(np.stack(k), mapping))
            for name, k in per_image.items()]


def from_h36m_npz(npz_path: str, image_root: str = "",
                  subsample: int = 5) -> List[ImageAnnotation]:
    """H36M preprocessed npz ({imgname, part (N,17|54,2|3), S (N,17,4) 3D}
    — the common SPIN/ROMP preprocessing layout) -> records."""
    data = np.load(npz_path, allow_pickle=True)
    names = data["imgname"][::subsample]
    kp2d_all = data["part"][::subsample].astype(np.float32)
    mapping = joint_mapping(FORMATS["h36m17"], SMPL_ALL_54)
    records = []
    kp3d_all = data["S"][::subsample].astype(np.float32) \
        if "S" in data.files else None
    for i, name in enumerate(names):
        kp2d = kp2d_all[i][..., :2]
        if kp2d.ndim == 2:
            kp2d = kp2d[None]
        kp2d54 = map_joints(kp2d[:, :17], mapping)
        kp3d54 = None
        if kp3d_all is not None:
            k3 = kp3d_all[i][..., :3]
            if k3.ndim == 2:
                k3 = k3[None]
            kp3d54 = map_joints(k3[:, :17], mapping)
        records.append(ImageAnnotation(
            osp.join(image_root, str(name)), kp2d54, kp3ds=kp3d54))
    return records


def from_relative_human_npz(npz_path: str, image_root: str = "",
                            src_format: str = "smpl54"
                            ) -> List[ImageAnnotation]:
    """Relative Human annots npz ({img_name: [person dicts with kp2d, age,
    depth_id, ...]}, `romp/lib/dataset/relative_human.py:22-89`) -> records
    with ordinal depth layers + age groups."""
    annots = np.load(npz_path, allow_pickle=True)["annots"][()]
    mapping = joint_mapping(FORMATS[src_format], SMPL_ALL_54)
    records = []
    for img_name, persons in annots.items():
        kp2ds, depth_ids, ages = [], [], []
        for a in persons:
            kp = np.asarray(a["kp2d"], np.float32)
            kp2d = kp[..., :2].copy()
            if kp.shape[-1] >= 3:
                kp2d[kp[..., 2] <= 0] = INVALID
            kp2ds.append(kp2d)
            depth_ids.append(int(a.get("depth_id", -1)))
            ages.append(int(a.get("age", -1)))
        if not kp2ds:
            continue
        records.append(ImageAnnotation(
            osp.join(image_root, str(img_name)),
            map_joints(np.stack(kp2ds), mapping),
            depth_ids=np.asarray(depth_ids),
            age_gts=np.asarray(ages)))
    return records


def from_agora_npz(npz_path: str, image_root: str = "",
                   src_format: str = "smpl54") -> List[ImageAnnotation]:
    """AGORA packed annots ({imgpath: [person dicts with kp2d/kp3d/
    body_pose/betas]}, `romp/lib/dataset/agora.py:32-76`) -> records with
    SMPL params and kid-shape offsets (11th beta)."""
    annots = np.load(npz_path, allow_pickle=True)["annots"][()]
    mapping = joint_mapping(FORMATS[src_format], SMPL_ALL_54)
    records = []
    for img_name, persons in annots.items():
        kp2ds, kp3ds, poses, betas, kids = [], [], [], [], []
        for a in persons:
            if not a.get("isValid", True):
                continue
            kp2ds.append(np.asarray(a["kp2d"], np.float32)[..., :2])
            kp3ds.append(np.asarray(a["kp3d"], np.float32)[..., :3])
            b = np.asarray(a["betas"], np.float32).reshape(-1)
            pose = np.concatenate([
                np.asarray(a.get("global_orient", np.zeros(3)),
                           np.float32).reshape(-1)[:3],
                np.asarray(a["body_pose"], np.float32).reshape(-1)[:63]])
            poses.append(pose)
            betas.append(b[:10])
            kids.append(float(b[10]) if b.shape[0] > 10 else -1.0)
        if not kp2ds:
            continue
        records.append(ImageAnnotation(
            osp.join(image_root, str(img_name)),
            map_joints(np.stack(kp2ds), mapping),
            kp3ds=map_joints(np.stack(kp3ds), mapping),
            poses=np.stack(poses), betas=np.stack(betas),
            kid_offsets=np.asarray(kids)))
    return records


def from_packed_npz(npz_path: str, image_root: str = "",
                    src_format: str = "smpl54") -> List[ImageAnnotation]:
    """Generic loader for reference-style preprocessed annotation npz files
    ({image_name: (P, J, 2|3) kp arrays}, like coco14.py annots_*.npz)."""
    annots = np.load(npz_path, allow_pickle=True)["annot"][()]
    mapping = joint_mapping(FORMATS[src_format], SMPL_ALL_54)
    records = []
    for img_name, kps in annots.items():
        kps = np.asarray(kps, np.float32)
        if kps.ndim == 2:
            kps = kps[None]
        kp2d = kps[..., :2]
        if kps.shape[-1] >= 3:
            kp2d = np.where((kps[..., 2:3] > 0), kp2d, INVALID)
        records.append(ImageAnnotation(
            osp.join(image_root, str(img_name)),
            map_joints(kp2d, mapping)))
    return records
