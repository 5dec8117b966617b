"""Extra dataset converters — the remainder of the reference's 20-adapter

The port's copy of the JAX package's numpy-only
`romp_tpu/train/data/converters.py`, so that the port imports nothing of that
package.
image-dataset roster (`romp/lib/dataset/mixed_dataset.py:31`).

Each converter ingests the dataset's canonical annotation file(s) (the same
packed formats the reference adapters read) and emits normalized
`ImageAnnotation` records. Core converters for COCO / 3DPW / CrowdPose /
MPII / H36M / Relative Human / AGORA live in `dataset.py`; this module adds:

- MPI-INF-3DHP (train/val splits)  — `romp/lib/dataset/mpi_inf_3dhp.py`
- MuCo-3DHP                        — `romp/lib/dataset/MuCo.py`
- MuPoTS-3D                        — `romp/lib/dataset/MuPoTS.py`
- CMU-Panoptic (eval)              — `romp/lib/dataset/cmu_panoptic_eval.py`
- CrowdHuman (bbox-only)           — `romp/lib/dataset/crowdhuman.py`
- PoseTrack21                      — `romp/lib/dataset/posetrack21.py`
- LSP / LSPET                      — `romp/lib/dataset/lsp.py`
- AI Challenger (AICH)             — `romp/lib/dataset/AICH.py`
- UP-3D                            — `romp/lib/dataset/up.py`
- Internet (unannotated demo dirs) — `romp/lib/dataset/internet.py`
"""
from __future__ import annotations

import glob
import json
import os.path as osp
from typing import Dict, List, Optional

import numpy as np

from romp_tpu_torch.train.data.dataset import ImageAnnotation
from romp_tpu_torch.train.data.skeletons import (
    AICH_TO_LSP, FORMATS, INVALID, SMPL_ALL_54, joint_mapping, map_joints,
)


def _vis_masked(kp: np.ndarray, conf_thresh: float = 0.0) -> np.ndarray:
    """(J, 2|3) raw kps -> (J, 2) with low-confidence rows INVALID."""
    kp2d = kp[..., :2].astype(np.float32).copy()
    if kp.shape[-1] >= 3:
        kp2d[kp[..., 2] <= conf_thresh] = INVALID
    return kp2d


def _root_relative(kp3d: np.ndarray, root_idx: int) -> np.ndarray:
    """Subtract the root joint; invalid (INVALID) rows stay put."""
    v = (kp3d != INVALID).any(-1)
    out = kp3d - kp3d[..., root_idx:root_idx + 1, :]
    return np.where(v[..., None], out, INVALID).astype(np.float32)


def from_mpi_inf_3dhp_npz(npz_path: str, image_root: str = "",
                          split: str = "train") -> List[ImageAnnotation]:
    """MPI-INF-3DHP packed annots ({img_name: {kp2d (28, 2|3), kp3d (28, 3),
    intrinsics, extrinsics}}, `mpi_inf_3dhp.py:12-101`). Subject S8 is held
    out for validation, S1-S7 train (`:26-30`). Single-person sequences."""
    annots = np.load(npz_path, allow_pickle=True)["annots"][()]
    mapping = joint_mapping(FORMATS["mpiinf28"], SMPL_ALL_54)
    val_subjects = ("S8",)
    records = []
    for img_name, ann in annots.items():
        subject = osp.basename(str(img_name)).split("_")[0]
        in_val = subject in val_subjects
        if (split == "train") == in_val:
            continue
        kp2d = map_joints(_vis_masked(np.asarray(ann["kp2d"]))[None],
                          mapping)
        kp3d = map_joints(
            np.asarray(ann["kp3d"], np.float32)[None, ..., :3], mapping)
        kp3d = _root_relative(kp3d, SMPL_ALL_54["Pelvis"])
        records.append(ImageAnnotation(
            osp.join(image_root, str(img_name)), kp2d, kp3ds=kp3d))
    return records


def from_muco_npz(npz_path: str, image_root: str = ""
                  ) -> List[ImageAnnotation]:
    """MuCo-3DHP packed annots ({img_name: (kp2ds (P, 21, 2), kp3ds
    (P, 21, 3) mm, (f, c))}, `MuCo.py:44-90`): multi-person composited 3D;
    kp3d converted to meters, root-relative."""
    annots = np.load(npz_path, allow_pickle=True)["annots"][()]
    mapping = joint_mapping(FORMATS["muco21"], SMPL_ALL_54)
    records = []
    for img_name, ann in annots.items():
        kp2ds = map_joints(
            np.asarray(ann[0], np.float32)[..., :2], mapping)
        kp3ds = map_joints(
            np.asarray(ann[1], np.float32) / 1000.0, mapping)
        kp3ds = _root_relative(kp3ds, SMPL_ALL_54["Pelvis"])
        records.append(ImageAnnotation(
            osp.join(image_root, str(img_name)), kp2ds, kp3ds=kp3ds))
    return records


def from_mupots_npz(npz_path: str, image_root: str = ""
                    ) -> List[ImageAnnotation]:
    """MuPoTS-3D packed annots ({seq: {kp2ds (F, P, 17, 2), kp3ds (F, P, 17,
    3) mm, track_ids, camMats}} or flat {img: [kp2ds, kp3ds, ids, cam]},
    `MuPoTS.py:30-70`). Used for 3DPCK eval and mixed training."""
    annots = np.load(npz_path, allow_pickle=True)["annots"][()]
    mapping = joint_mapping(FORMATS["mupots17"], SMPL_ALL_54)
    records = []
    for img_name, ann in annots.items():
        kp2ds_raw = np.asarray(ann[0], np.float32)
        kp3ds_raw = np.asarray(ann[1], np.float32)
        kp2ds = map_joints(kp2ds_raw[..., :2], mapping)
        kp3ds = map_joints(kp3ds_raw / 1000.0, mapping)
        kp3ds = _root_relative(kp3ds, SMPL_ALL_54["Pelvis"])
        records.append(ImageAnnotation(
            osp.join(image_root, str(img_name)), kp2ds, kp3ds=kp3ds))
    return records


def from_cmu_panoptic_pkl(pkl_paths, image_root: str = ""
                          ) -> List[ImageAnnotation]:
    """CMU-Panoptic CRMH-format annotation pickles (list of {filename,
    kpts2d (P, 19, 3), kpts3d (P, 19, 4?)}, `cmu_panoptic_eval.py:59-100`).
    Joints are Panoptic_19; 3D is mm, root-relative on the pelvis."""
    import pickle

    if isinstance(pkl_paths, str):
        pkl_paths = sorted(glob.glob(pkl_paths)) or [pkl_paths]
    mapping = joint_mapping(FORMATS["panoptic19"], SMPL_ALL_54)
    records = []
    for path in pkl_paths:
        with open(path, "rb") as f:
            img_infos = pickle.load(f)
        for info in img_infos:
            parts = str(info["filename"]).split("/")
            img_name = parts[-2] + "-" + parts[-1].replace(".png", ".jpg") \
                if len(parts) > 1 else parts[-1]
            kp2ds_raw = np.asarray(info["kpts2d"], np.float32)
            kp2ds = map_joints(
                np.stack([_vis_masked(k) for k in kp2ds_raw]), mapping)
            kp3ds = None
            if "kpts3d" in info:
                k3 = np.asarray(info["kpts3d"], np.float32)
                kp3d_xyz = k3[..., :3].copy()
                if k3.shape[-1] >= 4:
                    kp3d_xyz[k3[..., 3] <= 0] = INVALID
                kp3ds = map_joints(kp3d_xyz, mapping)
                kp3ds = _root_relative(kp3ds, SMPL_ALL_54["Pelvis"])
            records.append(ImageAnnotation(
                osp.join(image_root, img_name), kp2ds, kp3ds=kp3ds))
    return records


def from_crowdhuman_npz(npz_path: str, image_root: str = ""
                        ) -> List[ImageAnnotation]:
    """CrowdHuman packed annots ({img_name: {fbox (P, 4) xywh, vbox ...}},
    `crowdhuman.py:17-55`): detection-only supervision — bbox records with
    no keypoints (centermap supervision only, vmask_2d=[False, False, True])."""
    annots = np.load(npz_path, allow_pickle=True)["annots"][()]
    records = []
    for img_name, ann in annots.items():
        fboxes = np.asarray(ann["fbox"], np.float32)
        if fboxes.ndim != 2 or not len(fboxes):
            continue
        P = len(fboxes)
        ltrb = np.stack([fboxes[:, 0], fboxes[:, 1],
                         fboxes[:, 0] + fboxes[:, 2],
                         fboxes[:, 1] + fboxes[:, 3]], -1)
        records.append(ImageAnnotation(
            osp.join(image_root, str(img_name)),
            np.full((P, 54, 2), INVALID, np.float32),
            bboxes=ltrb))
    return records


def from_posetrack_npz(npz_path: str, image_root: str = ""
                       ) -> List[ImageAnnotation]:
    """PoseTrack21 packed annots ({img_name: (joints (P, 17, 3), bboxes
    (P, 4) xywh, track_ids)}, `posetrack21.py:28-60`): 2D pose where
    annotated, bbox fallback otherwise."""
    data = np.load(npz_path, allow_pickle=True)
    annots = data["annot"][()]
    mapping = joint_mapping(FORMATS["posetrack17"], SMPL_ALL_54)
    records = []
    for img_name, ann in annots.items():
        joints = np.asarray(ann[0], np.float32)
        bboxes_xywh = np.asarray(ann[1], np.float32)
        P = len(joints)
        kp2ds = map_joints(
            np.stack([_vis_masked(j) for j in joints]), mapping)
        has_pose = (kp2ds > INVALID + 1e-6).all(-1).sum(-1) >= 2
        ltrb = np.full((P, 4), np.nan, np.float32)
        if bboxes_xywh.ndim == 2 and bboxes_xywh.shape[1] == 4:
            bb = np.stack([bboxes_xywh[:, 0], bboxes_xywh[:, 1],
                           bboxes_xywh[:, 0] + bboxes_xywh[:, 2],
                           bboxes_xywh[:, 1] + bboxes_xywh[:, 3]], -1)
            ltrb[~has_pose] = bb[~has_pose]      # bbox fallback persons
        records.append(ImageAnnotation(
            osp.join(image_root, str(img_name)), kp2ds,
            bboxes=ltrb if (~has_pose).any() else None))
    return records


def from_lsp_mat(mat_path: str, img_dir: str = "",
                 lspet_layout: bool = True) -> List[ImageAnnotation]:
    """LSP / LSPET joints.mat -> single-person records (`lsp.py:22-42`).
    LSPET stores (14, 3, N) with a visibility row; original LSP is
    (3, 14, N) — both normalized here."""
    from scipy.io import loadmat

    joints = loadmat(mat_path)["joints"].astype(np.float32)
    if joints.shape[0] == 14:            # LSPET (14, 3, N)
        joints = joints.transpose(2, 0, 1)
    else:                                # LSP (3, 14, N)
        joints = joints.transpose(2, 1, 0)
    mapping = joint_mapping(FORMATS["lsp14"], SMPL_ALL_54)
    records = []
    for i, j in enumerate(joints):
        kp2d = _vis_masked(j) if lspet_layout else j[:, :2]
        name = f"im{i + 1:05d}.png" if lspet_layout \
            else f"im{i + 1:04d}.jpg"
        records.append(ImageAnnotation(
            osp.join(img_dir, name), map_joints(kp2d[None], mapping)))
    return records


def from_aich_json(json_path: str, image_dir: str = "",
                   min_kps: int = 3) -> List[ImageAnnotation]:
    """AI Challenger keypoint json ([{image_id, keypoint_annotations:
    {human1: [42 ints]...}}], `AICH.py:27-75`). Raw order is remapped to
    LSP_14 by AICH_TO_LSP; visibility flag v: 1 visible, 2 occluded,
    3 absent -> (3 - v) / 2 confidence (`AICH.py:45-49`)."""
    with open(json_path) as f:
        doc = json.load(f)
    mapping = joint_mapping(FORMATS["lsp14"], SMPL_ALL_54)
    records = []
    for rec in doc:
        img_name = rec["image_id"] + ".jpg"
        kps = []
        for human in rec.get("keypoint_annotations", {}).values():
            pts = np.asarray(human, np.float32).reshape(14, 3)
            pts[:, 2] = (3.0 - pts[:, 2]) / 2.0
            pts = pts[AICH_TO_LSP]
            if (pts[:, 2] > 0).sum() < min_kps:
                continue
            kps.append(_vis_masked(pts))
        if not kps:
            continue
        records.append(ImageAnnotation(
            osp.join(image_dir, img_name),
            map_joints(np.stack(kps), mapping)))
    return records


def from_up3d_dir(data3d_dir: str, high_quality_only: bool = True
                  ) -> List[ImageAnnotation]:
    """UP-3D directory layout ({idx}_image.png / {idx}_joints.npy (3, 14) /
    {idx}_body.pkl with pose/betas, `up.py:25-70`): single-person with SMPL
    fits."""
    import pickle

    mapping = joint_mapping(FORMATS["lsp14"], SMPL_ALL_54)
    records = []
    for img_path in sorted(glob.glob(osp.join(data3d_dir, "*_image.png"))):
        idx = osp.basename(img_path).split("_")[0]
        if high_quality_only:
            q_file = osp.join(data3d_dir, f"{idx}_quality_info.txt")
            if osp.exists(q_file):
                with open(q_file) as f:
                    if "high" not in f.read():
                        continue
        joints_file = osp.join(data3d_dir, f"{idx}_joints.npy")
        body_file = osp.join(data3d_dir, f"{idx}_body.pkl")
        if not osp.exists(joints_file):
            continue
        kp2d = _vis_masked(np.load(joints_file).astype(np.float32).T)
        poses = betas = None
        if osp.exists(body_file):
            with open(body_file, "rb") as f:
                body = pickle.load(f, encoding="latin1")
            poses = np.asarray(body["pose"], np.float32
                               ).reshape(-1)[None, :66]
            betas = np.asarray(body["betas"], np.float32
                               ).reshape(-1)[None, :10]
        records.append(ImageAnnotation(
            img_path, map_joints(kp2d[None], mapping),
            poses=poses, betas=betas))
    return records


def from_internet_images(image_dir: str, exts=("jpg", "jpeg", "png")
                         ) -> List[ImageAnnotation]:
    """Unannotated image directory (`internet.py`): zero-person records for
    demo / pseudo-labeling flows (never valid training supervision)."""
    records = []
    for ext in exts:
        for p in sorted(glob.glob(osp.join(image_dir, f"*.{ext}"))):
            records.append(ImageAnnotation(
                p, np.full((0, 54, 2), INVALID, np.float32)))
    return records


# Converter registry: dataset name -> callable, mirroring the reference's
# dataset_dict (`mixed_dataset.py:31`).
CONVERTERS: Dict[str, object] = {
    "mpiinf": from_mpi_inf_3dhp_npz,
    "muco": from_muco_npz,
    "mupots": from_mupots_npz,
    "cmup": from_cmu_panoptic_pkl,
    "crowdhuman": from_crowdhuman_npz,
    "posetrack": from_posetrack_npz,
    "lsp": from_lsp_mat,
    "aich": from_aich_json,
    "up": from_up3d_dir,
    "internet": from_internet_images,
}
