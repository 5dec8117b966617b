"""The accuracy loop: train -> rotating checkpoints -> official-protocol
scoring of each checkpoint on held-out synthetic scenes (counterpart of
`scripts/convergence.py`).

With no dataset to download, the loop closes train -> checkpoint ->
metric on synthetic data whose image -> pose mapping is learnable:

  * scenes: the JAX script's, from the same seeds and numpy RNG. ROMP: one
    person an image, a GT pose near the rest pose, GT joints from the
    synthetic-SMPL forward, each of the 54 joints rendered as a fixed-color
    gaussian blob at its weak-perspective 2D location. BEV: two persons (an
    adult near, a kid far, another palette). TRACE: moving-blob feature
    sequences on curved paths, their world trajectory a function of the
    blob's position.
  * train: ROMP through the port's `Trainer` (full objective, rotating
    `step_*.npz` checkpoints; the loop passes it an `eval_fn` that scores
    the live state on the held-out scenes, so the trainer keeps the best
    checkpoint); BEV through `bev_train_step` (a det-only phase, then the
    full objective); TRACE through `trace_train_step` (the temporal head
    on stand-in features).
  * eval: each checkpoint is restored with `load_train_state` and run
    through the port's inference: `RompPipeline` at f32 ->
    `Pw3dSubmissionCollector` -> `pw3d_evaluate` (MPJPE / PA-MPJPE / PCK /
    AUC / MPJAE); `BevPipeline` -> `rh_evaluate` (mPCKh, PCRD) and
    `age_group_accuracy`; `maps_and_detect` -> `TracePipeline.collect_clip`
    -> `dynacam_evaluate` (ATE / APE).
  * ROMP's last checkpoint also goes through `bf16_on_checkpoint`: the
    mixed and bf16-activation paths, unfused and with `fuse_chains`,
    against f32 on the trained weights.

The record goes to `--out` (default `build/convergence_torch.json` under
the repository; the JAX package's record, `CONVERGENCE.json`, is never
written). Without `--no_assert`, ROMP's run asserts that the last
checkpoint beats the first on MPJPE and that the curve descends (2%
slack), as the JAX script does.

    python -m romp_tpu_torch.eval.convergence               # the card
    python -m romp_tpu_torch.eval.convergence --GPU -1 --steps 8 \\
        --interval 4 --n_train 8 --n_eval 4 --batch 4 --no_assert
    python -m romp_tpu_torch.eval.convergence --model bev|trace ...
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import pickle
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
DEFAULT_OUT = osp.join(REPO, "build", "convergence_torch.json")

INPUT_SIZE = 128
NUM_JOINTS = 54
CAM_GT = np.array([0.75, 0.0, 0.0], np.float32)  # (s, tx, ty) fixed camera


def _smpl_joints(smpl, betas: np.ndarray, thetas: np.ndarray,
                 device) -> np.ndarray:
    """The SMPL forward's joints (B, 71, 3) as numpy, run on `device`."""
    from romp_tpu_torch.smpl.body_model import smpl_forward

    with torch.inference_mode():
        _, joints = smpl_forward(smpl.to(device),
                                 torch.as_tensor(betas, device=device),
                                 torch.as_tensor(thetas, device=device))
    return joints.cpu().numpy()


def make_scenes(n, seed, input_size=INPUT_SIZE, device="cpu"):
    """n scenes: GT pose/betas + deterministic blob rendering of kp2d.

    Returns dict of numpy arrays shaped like ONE batch of n samples
    (P=1 person slots) + the 72-dim thetas used for the eval GT pkl. The
    SMPL forward runs on `device`; the rest is numpy.
    """
    from romp_tpu_torch.smpl.body_model import SmplModel, synthetic_assets

    rng = np.random.RandomState(seed)
    # small near-rest poses: keeps blobs in-frame and the mapping smooth
    pose66 = (rng.randn(n, 66) * 0.18).astype(np.float32)
    betas = np.zeros((n, 10), np.float32)
    thetas72 = np.concatenate([pose66, np.zeros((n, 6), np.float32)], 1)

    smpl = SmplModel(synthetic_assets(seed=0))
    joints = _smpl_joints(smpl, betas, thetas72, device)
    j54 = joints[:, :NUM_JOINTS]                      # (n, 54, 3)
    j54 = j54 - j54[:, :1]                            # root-centered
    kp2d = j54[..., :2] * CAM_GT[0] + CAM_GT[1:]      # weak perspective
    kp3d = j54.astype(np.float32)

    # render: per-joint fixed-color gaussian blobs at kp2d
    palette = (0.25 + 0.75 * np.random.RandomState(7).rand(
        NUM_JOINTS, 3)).astype(np.float32)
    S = input_size
    ys, xs = np.meshgrid(np.arange(S), np.arange(S), indexing="ij")
    sigma = S / 48.0
    images = np.zeros((n, S, S, 3), np.float32)
    for i in range(n):
        px = (kp2d[i, :, 0] + 1.0) / 2.0 * S          # (54,)
        py = (kp2d[i, :, 1] + 1.0) / 2.0 * S
        d2 = ((xs[None] - px[:, None, None]) ** 2
              + (ys[None] - py[:, None, None]) ** 2)  # (54, S, S)
        blobs = np.exp(-d2 / (2.0 * sigma * sigma))
        images[i] = np.einsum("jhw,jc->hwc", blobs, palette)
    images = np.clip(images, 0.0, 1.0) * 255.0

    P = 1
    return {
        "image": images,
        "person_centers": np.zeros((n, P, 2), np.float32),  # person at (0,0)
        "person_bbox_hw": np.full((n, P, 2), 0.8, np.float32),
        "person_mask": np.ones((n, P), bool),
        "kp2d_gt": kp2d[:, None].astype(np.float32),
        "kp3d_gt": kp3d[:, None],
        "kp3d_mask": np.ones((n, P), bool),
        "pose_gt": pose66[:, None],
        "pose_mask": np.ones((n, P), bool),
        "betas_gt": betas[:, None],
        "betas_mask": np.ones((n, P), bool),
    }, thetas72


def batch_iter(scenes, batch_size, seed):
    rng = np.random.RandomState(seed)
    n = scenes["image"].shape[0]
    while True:
        idx = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            sel = idx[i:i + batch_size]
            yield {k: v[sel] for k, v in scenes.items()}


# ---------------------------------------------------------------------------
# BEV (--model bev): 2-person adult+kid scenes -> bev_train_step -> rotating
# checkpoints -> official Relative Human scoring (rh_evaluate: mPCKh +
# PCRD) + age-group accuracy on held-out scenes.
# ---------------------------------------------------------------------------

KID_OFFSET_GT = 0.8          # age group 2 ("kid"): digitize thresholds
# Weak-persp scale ranges: larger = closer. Narrow on purpose (the JAX
# script's reasoning): the depth-anchor bin of the 3D centermap is a 64-way
# classification over blob-size cues, and two tight depth layers let it
# converge inside the recipe's budget.
ADULT_SCALE = (0.54, 0.56)   # small enough that |center| + scale*joint
KID_SCALE = (0.30, 0.32)     # extent stays on-canvas under wide centers


def make_bev_scenes(n, seed, input_size=INPUT_SIZE, device="cpu"):
    """n scenes, 2 persons each: slot 0 = adult (near), slot 1 = kid (far).

    The image encodes everything the losses supervise: joint blobs at each
    person's weak-perspective kp2d (position -> centers/kp2d), blob size
    scaled by the person's scale (-> depth via the anchor bin), and a
    DISTINCT color palette for the kid (-> age/kid-offset learnable).
    Returns (batch dict, annots dict for rh_evaluate).
    """
    from romp_tpu_torch.smpl.body_model import SmplModel, synthetic_assets
    from romp_tpu_torch.train.data.skeletons import (
        Crowdpose_14, SMPL_ALL_54, joint_mapping,
    )

    rng = np.random.RandomState(seed)
    P = 2
    pose66 = (rng.randn(n, P, 66) * 0.15).astype(np.float32)
    thetas72 = np.concatenate(
        [pose66, np.zeros((n, P, 6), np.float32)], -1)
    smpl = SmplModel(synthetic_assets(seed=0))
    joints = _smpl_joints(smpl, np.zeros((n * P, 10), np.float32),
                          thetas72.reshape(n * P, 72), device)
    j54 = joints[:, :NUM_JOINTS].reshape(n, P, NUM_JOINTS, 3)
    j54 = j54 - j54[:, :, :1]

    # wide center coverage: the cam/param maps are supervised only at GT
    # cells and sampled at detected peaks, so the centers spread over most
    # of the canvas
    scales = np.stack([
        rng.uniform(*ADULT_SCALE, size=n),
        rng.uniform(*KID_SCALE, size=n)], 1).astype(np.float32)
    centers = np.stack([
        np.stack([rng.uniform(-0.5, 0.5, n),
                  rng.uniform(-0.45, 0.45, n)], -1),
        np.stack([rng.uniform(-0.5, 0.5, n),
                  rng.uniform(-0.45, 0.45, n)], -1)], 1).astype(np.float32)
    # keep the two persons separated enough to match unambiguously
    # (adjusted x stays within +-0.5: |x0| <= 0.5 so x0 -+ 0.55 flips side)
    too_close = (np.abs(centers[:, 0, 0] - centers[:, 1, 0]) < 0.35)
    centers[too_close, 1, 0] = np.clip(np.where(
        centers[too_close, 0, 0] < 0,
        centers[too_close, 0, 0] + 0.55,
        centers[too_close, 0, 0] - 0.55), -0.5, 0.5)
    kp2d = (j54[..., :2] * scales[..., None, None]
            + centers[:, :, None]).astype(np.float32)   # (n, P, 54, 2)

    palettes = np.stack([
        0.25 + 0.75 * np.random.RandomState(7).rand(NUM_JOINTS, 3),
        0.25 + 0.75 * np.random.RandomState(13).rand(NUM_JOINTS, 3),
    ]).astype(np.float32)                                # adult / kid colors
    S = input_size
    ys, xs = np.meshgrid(np.arange(S), np.arange(S), indexing="ij")
    images = np.zeros((n, S, S, 3), np.float32)
    for i in range(n):
        for p in range(P):
            px = (kp2d[i, p, :, 0] + 1.0) / 2.0 * S
            py = (kp2d[i, p, :, 1] + 1.0) / 2.0 * S
            sigma = (S / 48.0) * (scales[i, p] / ADULT_SCALE[1])
            d2 = ((xs[None] - px[:, None, None]) ** 2
                  + (ys[None] - py[:, None, None]) ** 2)
            blobs = np.exp(-d2 / (2.0 * sigma * sigma))
            images[i] += np.einsum("jhw,jc->hwc", blobs, palettes[p])
    images = np.clip(images, 0.0, 1.0) * 255.0

    kid_off = np.tile(np.asarray([0.0, KID_OFFSET_GT], np.float32), (n, 1))
    betas11 = np.zeros((n, P, 11), np.float32)
    betas11[..., 10] = kid_off
    batch = {
        "image": images,
        "person_centers": centers,
        "person_bbox_hw": np.tile(scales[..., None], (1, 1, 2)),
        "person_mask": np.ones((n, P), bool),
        "kp2d_gt": kp2d,
        "kp3d_gt": j54.astype(np.float32),
        "kp3d_mask": np.ones((n, P), bool),
        "pose_gt": pose66,
        "pose_mask": np.ones((n, P), bool),
        "betas_gt": betas11,
        "betas_mask": np.ones((n, P), bool),
        "person_scales": scales,
        "depth_ids": np.tile(np.asarray([0, 1], np.int32), (n, 1)),
        "age_gts": np.tile(np.asarray([0, 2], np.int32), (n, 1)),
        "kid_offsets_gt": kid_off,
    }

    # official RH annots payload for the held-out scoring (rh_load layout)
    cp14 = joint_mapping(SMPL_ALL_54, Crowdpose_14)
    annots = {}
    for i in range(n):
        per = []
        for p in range(P):
            kp_px = (kp2d[i, p] + 1.0) / 2.0 * S
            k14 = np.concatenate(
                [kp_px[cp14], np.ones((14, 1), np.float32)], -1)
            k14[cp14 < 0] = 0.0
            per.append({"bbox": None, "kp2d": k14.astype(np.float32),
                        "depth_id": int(p), "age": [0, 2][p]})
        annots[f"scene_{i:05d}.jpg"] = per
    return batch, annots


def eval_bev_checkpoint(ckpt_path, template_state, eval_batch, annots,
                        adult, baby, backbone, device):
    """Restore -> the port's BEV pipeline -> official RH scoring."""
    from romp_tpu_torch.eval.drivers import match_by_center
    from romp_tpu_torch.eval.metrics import age_group_accuracy
    from romp_tpu_torch.eval.protocols import rh_evaluate
    from romp_tpu_torch.pipeline.bev_pipeline import BevConfig, BevPipeline
    from romp_tpu_torch.train.data.skeletons import (
        Crowdpose_14, SMPL_ALL_54, joint_mapping,
    )
    from romp_tpu_torch.train.trainer import load_train_state

    state = load_train_state(ckpt_path, template_state)
    cfg = BevConfig(input_size=INPUT_SIZE, max_person=4, conf_thresh=0.1,
                    compute_dtype="float32", backbone=backbone)
    pipe = BevPipeline(state.net.state_dict(), adult, baby, cfg, device)
    out = {k: v.cpu().numpy() for k, v in pipe(eval_batch["image"]).items()}

    S = INPUT_SIZE
    cp14 = joint_mapping(SMPL_ALL_54, Crowdpose_14)
    results = {}
    kid_preds, age_gts = [], []
    names = sorted(annots)
    for i, name in enumerate(names):
        rows = []
        valid = np.where(out["mask"][i])[0]
        for k in valid:
            kp_px = (out["pj2d"][i, k][:54] + 1.0) / 2.0 * S
            rows.append({"kp2ds": kp_px[cp14].astype(np.float64),
                         "trans": out["cam_trans"][i, k].astype(np.float64)})
        results[name] = rows
        # age accuracy over center-matched pairs (metrics driver)
        if len(valid):
            gt_c = (eval_batch["person_centers"][i] + 1.0) / 2.0 * S
            pred_c = np.stack([r["kp2ds"].mean(0) for r in rows])
            for gi, pi in match_by_center(gt_c, pred_c, max_dist=S):
                kid_preds.append(out["smpl_betas"][i, valid[pi], 10])
                age_gts.append(int(eval_batch["age_gts"][i, gi]))
    score = rh_evaluate(results, annots)
    if age_gts:
        acc = age_group_accuracy(np.asarray(kid_preds),
                                 np.asarray(age_gts))
        vals = [v for v in (acc.get("adult"), acc.get("kid")) if v == v]
        score["age_acc"] = float(np.mean(vals)) if vals else 0.0
        score.update({f"age_{k}": v for k, v in acc.items()})
    return score


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_bev(args, device):
    from romp_tpu_torch.models.bev import BevNet, init_bev_params
    from romp_tpu_torch.smpl.body_model import SmplModel, synthetic_assets
    from romp_tpu_torch.train.bev_train_step import (
        BevTrainConfig, bev_init_train_state, bev_train_step,
    )
    from romp_tpu_torch.train.priors import GmmPrior
    from romp_tpu_torch.train.train_step import TrainConfig
    from romp_tpu_torch.train.trainer import batch_to_device, save_train_state

    scratch = args.workdir or tempfile.mkdtemp(prefix="convergence_bev_")
    ckdir = osp.join(scratch, "ckpt")
    os.makedirs(ckdir, exist_ok=True)

    train_batch, _ = make_bev_scenes(args.n_train, seed=11, device=device)
    eval_batch, annots = make_bev_scenes(args.n_eval, seed=97, device=device)
    adult = SmplModel(synthetic_assets(seed=0, num_betas=11), device)
    baby = SmplModel(synthetic_assets(seed=1, num_betas=10), device)
    prior = GmmPrior.synthetic(num_gaussians=2, seed=0).to(device)

    # Two-phase recipe, the reference's new-training schedule
    # (`learnable_loss.py:45-47`): at random init the clamped regression
    # losses drown the detection objective, so phase A trains det-only
    # (centermap + centermap3d), then phase B the full objective.
    def mk_cfg(new_training):
        return BevTrainConfig(
            base=TrainConfig(compute_dtype="float32", lr=args.lr,
                             warmup_steps=args.warmup,
                             new_training=new_training),
            input_size=INPUT_SIZE, backbone=args.backbone)

    bcfg, det_cfg = mk_cfg(False), mk_cfg(True)
    net = BevNet(args.backbone, INPUT_SIZE // 4)
    net.load_state_dict(init_bev_params(torch.Generator().manual_seed(0),
                                        INPUT_SIZE, args.backbone))
    state = bev_init_train_state(net.to(device), bcfg)
    det_steps = int(args.steps * 0.4)

    print(f"BEV: training {args.steps} steps (det-only first {det_steps}; "
          f"backbone={args.backbone}, batch={args.batch}, "
          f"ckpt every {args.interval}, {device})", flush=True)
    it = batch_iter(train_batch, args.batch, seed=3)
    t0 = time.perf_counter()
    for step in range(1, args.steps + 1):
        batch = batch_to_device(next(it), device)
        state, metrics = bev_train_step(
            state, batch, adult, baby,
            det_cfg if step <= det_steps else bcfg, prior)
        if step % args.interval == 0:
            save_train_state(osp.join(ckdir, f"step_{step:06d}.npz"), state)
            print(f"  step {step}: total={float(metrics['total']):.2f} "
                  f"cm3d={float(metrics['centermap3d']):.3f} "
                  f"rdepth={float(metrics['rdepth']):.3f} "
                  f"rage={float(metrics['rage']):.3f}", flush=True)
    _sync(device)
    train_s = time.perf_counter() - t0

    snaps = sorted(f for f in os.listdir(ckdir) if f.endswith(".npz"))
    rows = {"steps": [], "mPCKh": [], "PCRD_0.2": [], "age_acc": []}
    t0 = time.perf_counter()
    for snap in snaps:
        step = int(snap[5:-4])
        score = eval_bev_checkpoint(
            osp.join(ckdir, snap), state, eval_batch, annots, adult, baby,
            args.backbone, device)
        rows["steps"].append(step)
        for k in ("mPCKh", "PCRD_0.2", "age_acc"):
            v = float(score.get(k, float("nan")))
            # no matched detections yet -> the metric is undefined; score 0
            # (an un-detecting checkpoint earns nothing)
            rows[k].append(round(v, 4) if v == v else 0.0)
        print(f"  step {step:6d}: mPCKh {score.get('mPCKh', float('nan')):.3f}"
              f"  PCRD {score.get('PCRD_0.2', float('nan')):.3f}"
              f"  age_acc {score.get('age_acc', float('nan')):.3f}",
              flush=True)
    eval_s = time.perf_counter() - t0

    merge_record(args.out, {"bev": {
        "protocol": "official Relative Human scoring (rh_evaluate: mPCKh + "
                    "PCRD) + age-group accuracy on held-out 2-person "
                    "adult+kid synthetic scenes",
        "backbone": args.backbone, "input_size": INPUT_SIZE,
        "n_train_scenes": args.n_train, "n_eval_scenes": args.n_eval,
        "batch_size": args.batch, **run_info(device, args.steps, train_s,
                                             eval_s),
        **rows}})

    if not args.no_assert:
        assert rows["mPCKh"][-1] > max(rows["mPCKh"][0], 0.05), rows
        assert rows["age_acc"][-1] >= 0.75, rows
        print(f"BEV improved: PCRD {rows['PCRD_0.2'][0]:.3f} -> "
              f"{rows['PCRD_0.2'][-1]:.3f}, age_acc {rows['age_acc'][0]:.3f}"
              f" -> {rows['age_acc'][-1]:.3f}, mPCKh {rows['mPCKh'][0]:.3f}"
              f" -> {rows['mPCKh'][-1]:.3f}", flush=True)
    return rows


# ---------------------------------------------------------------------------
# TRACE (--model trace): moving-blob feature sequences -> trace_train_step
# (the temporal head on stand-in features, TRACE's recipe) -> rotating
# checkpoints -> official DynaCam ATE/APE (dynacam_evaluate) on held-out
# sequences, detections / tracking / world accumulation through the
# pipeline's stages (maps_and_detect + TracePipeline.collect_clip).
# ---------------------------------------------------------------------------

TRACE_MAP = 64
TRACE_T = 8
TRACE_CH = 32


def make_trace_scenes(n, seed, T=TRACE_T, S=TRACE_MAP):
    """n single-track sequences: a blob with a fixed channel signature moves
    on a circular arc; the world translation is a fixed function of the
    pixel position (wx, wy = normalized position, wz = 0.5 + 0.8 wx wy), so
    the image->world mapping is learnable by the cam/motion heads. Returns
    (list of per-seq batch dicts, annots for dynacam_evaluate)."""
    rng = np.random.RandomState(seed)
    sig = 0.5 + np.random.RandomState(5).rand(TRACE_CH).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(S), np.arange(S), indexing="ij")
    seqs, annots = [], {}
    for i in range(n):
        # curved paths: the protocol Umeyama-aligns with rotation AND
        # scale, so a straight-line GT would align to zero error
        cy = rng.uniform(S * 0.35, S * 0.65)
        cx = rng.uniform(S * 0.35, S * 0.65)
        R = rng.uniform(S * 0.12, S * 0.22)
        phi = rng.uniform(0, 2 * np.pi)
        om = rng.uniform(0.25, 0.55) * rng.choice([-1.0, 1.0])
        ts = np.arange(-1, T)                       # frame -1 = prev slot
        yt = cy + R * np.sin(om * ts + phi)
        xt = cx + R * np.cos(om * ts + phi)
        d2 = ((xs[None] - xt[:, None, None]) ** 2
              + (ys[None] - yt[:, None, None]) ** 2)
        blobs = np.exp(-d2 / (2.0 * (S / 24.0) ** 2)).astype(np.float32)
        fm = blobs[..., None] * sig                  # (T+1, S, S, C)
        # per-frame GT motion field (constant over the image per frame)
        flows = np.zeros((T, S, S, 2), np.float32)
        flows[..., 0] = ((xt[1:] - xt[:-1]) / S * 16.0)[:, None, None]
        flows[..., 1] = ((yt[1:] - yt[:-1]) / S * 16.0)[:, None, None]
        cz = 32
        czyx = np.stack([np.full(T, cz), np.round(yt[1:]),
                         np.round(xt[1:])], -1).astype(np.int32)
        wx = xt[1:] / S * 2.0 - 1.0
        wy = yt[1:] / S * 2.0 - 1.0
        # wz a function of the observable position, not of the hidden
        # per-sequence phase
        wx_full = xt / S * 2.0 - 1.0
        wy_full = yt / S * 2.0 - 1.0
        wz_full = 0.5 + 0.8 * wx_full * wy_full
        wz = wz_full[1:]
        world = np.stack([wx, wy, wz], -1).astype(np.float32)
        motion3d = np.stack([wz_full[1:] - wz_full[:-1],
                             (yt[1:] - yt[:-1]) / S * 2.0,
                             (xt[1:] - xt[:-1]) / S * 2.0],
                            -1).astype(np.float32)
        pose = np.tile((rng.randn(66) * 0.1).astype(np.float32), (T, 1))
        seqs.append({
            "feature_maps": fm,
            "flows": flows,
            "traj_czyx": czyx[None],                       # (1, T, 3)
            "traj_valid": np.ones((1, T), bool),
            "traj3d_gt": motion3d[None],
            "world_trans_gt": world[None],
            "world_grot_gt": np.zeros((1, T, 3), np.float32),
            "pose_gt": pose[None],
            "betas_gt": np.zeros((1, T, 11), np.float32),
        })
        annots[f"seq_{i:03d}"] = {
            "frame_ids": np.arange(T),
            "world_grots": np.zeros((1, T, 3), np.float32),
            "world_trans": world[None],
            "camera_extrinsics": np.tile(np.eye(4, dtype=np.float32)[None],
                                         (T, 1, 1)),
        }
    return seqs, annots


def _trace_batch_iter(seqs, batch_size, seed):
    rng = np.random.RandomState(seed)
    while True:
        idx = rng.permutation(len(seqs))
        for i in range(0, len(idx) - batch_size + 1, batch_size):
            sel = idx[i:i + batch_size]
            yield {k: np.stack([seqs[j][k] for j in sel])
                   for k in seqs[0]}


def eval_trace_checkpoint(ckpt_path, template_state, eval_seqs, annots,
                          pipe_factory):
    """Restore -> the pipeline's stages (maps + detect -> tracker ->
    regress -> world accumulation) -> official DynaCam ATE / APE. One
    pipeline a checkpoint, reset before each sequence."""
    from romp_tpu_torch.eval.protocols import dynacam_evaluate
    from romp_tpu_torch.pipeline.romp_pipeline import precision_flags
    from romp_tpu_torch.pipeline.trace_pipeline import (
        HostCopy, maps_and_detect,
    )
    from romp_tpu_torch.train.trainer import load_train_state

    state = load_train_state(ckpt_path, template_state)
    pipe = pipe_factory(state.net.state_dict())
    preds = {}
    names = sorted(annots)
    for name, seq in zip(names, eval_seqs):
        pipe.reset()
        T = seq["traj_czyx"].shape[1]
        with torch.inference_mode(), precision_flags(pipe.cfg):
            feats = torch.from_numpy(seq["feature_maps"]).to(
                pipe.device).permute(0, 3, 1, 2).contiguous()
            flows = torch.from_numpy(seq["flows"]).to(
                pipe.device).permute(0, 3, 1, 2).contiguous()
            maps, _, det_pack = maps_and_detect(pipe.net, feats, flows, None,
                                                pipe.cfg)
        out = pipe.collect_clip({"maps": maps, "det": HostCopy(det_pack),
                                 "T": T})
        if out is None:
            preds[name] = None
            continue
        # best track = most valid frames
        valid = out["frame_valid"].reshape(-1, T)
        best = int(np.argmax(valid.sum(1)))
        rows = np.arange(best * T, (best + 1) * T)
        frame2ind = {int(t): int(rows[t]) for t in range(T)
                     if valid[best, t]}
        if len(frame2ind) < 3:
            preds[name] = None
            continue
        preds[name] = [frame2ind, None, out["world_cams"],
                       out["world_grots"]]
    return dynacam_evaluate(annots, preds)


def run_trace(args, device):
    from romp_tpu_torch.models.trace import TraceNet, init_trace_params
    from romp_tpu_torch.pipeline.trace_pipeline import (
        TraceConfig, TracePipeline,
    )
    from romp_tpu_torch.pipeline.trace_tracking import SeqConfig
    from romp_tpu_torch.smpl.body_model import SmplModel, synthetic_assets
    from romp_tpu_torch.train.trace_train_step import (
        TraceTrainConfig, trace_init_train_state, trace_train_step,
    )
    from romp_tpu_torch.train.trainer import batch_to_device, save_train_state

    scratch = args.workdir or tempfile.mkdtemp(prefix="convergence_trace_")
    ckdir = osp.join(scratch, "ckpt")
    os.makedirs(ckdir, exist_ok=True)

    train_seqs, _ = make_trace_scenes(args.n_train, seed=11)
    eval_seqs, annots = make_trace_scenes(args.n_eval, seed=97)

    tcfg = TraceTrainConfig(compute_dtype="float32", lr=args.lr,
                            warmup_steps=args.warmup)
    net = TraceNet(None, TRACE_MAP)
    net.load_state_dict(init_trace_params(
        torch.Generator().manual_seed(0), clip_length=TRACE_T,
        map_size=TRACE_MAP, backbone=None))
    state = trace_init_train_state(net.to(device), tcfg)

    print(f"TRACE: training {args.steps} steps (map={TRACE_MAP}, "
          f"T={TRACE_T}, batch={args.batch}, ckpt every {args.interval}, "
          f"{device})", flush=True)
    it = _trace_batch_iter(train_seqs, args.batch, seed=3)
    t0 = time.perf_counter()
    for step in range(1, args.steps + 1):
        batch = batch_to_device(next(it), device)
        state, metrics = trace_train_step(state, batch, tcfg)
        if step % args.interval == 0:
            save_train_state(osp.join(ckdir, f"step_{step:06d}.npz"), state)
            print(f"  step {step}: total={float(metrics['total']):.3f} "
                  f"wtrans={float(metrics['world_trans']):.4f} "
                  f"cm3d={float(metrics['centermap3d']):.4f}", flush=True)
    _sync(device)
    train_s = time.perf_counter() - t0

    adult = SmplModel(synthetic_assets(seed=0, num_betas=11, num_verts=512))
    baby = SmplModel(synthetic_assets(seed=1, num_betas=10, num_verts=512))
    pcfg = TraceConfig(temp_clip_length=TRACE_T, max_person=4,
                       conf_thresh=0.1, compute_dtype="float32",
                       backbone=None)
    scfg = SeqConfig(first_frame_det_thresh=0.05, tracker_det_thresh=0.05,
                     large_object_thresh=-1e9)

    def pipe_factory(params):
        return TracePipeline(params, adult, baby, pcfg, scfg, flow_fn=None,
                             device=device)

    snaps = sorted(f for f in os.listdir(ckdir) if f.endswith(".npz"))
    rows = {"steps": [], "ATE": [], "APE": []}
    t0 = time.perf_counter()
    for snap in snaps:
        step = int(snap[5:-4])
        err = eval_trace_checkpoint(osp.join(ckdir, snap), state,
                                    eval_seqs, annots, pipe_factory)
        rows["steps"].append(step)
        rows["ATE"].append(round(err["ate"]["mean"], 4))
        rows["APE"].append(round(err["ape"]["mean"], 4))
        print(f"  step {step:6d}: ATE {err['ate']['mean']:.4f}  "
              f"APE {err['ape']['mean']:.4f}", flush=True)
    eval_s = time.perf_counter() - t0

    merge_record(args.out, {"trace": {
        "protocol": "official DynaCam ATE/APE (dynacam_evaluate) on "
                    "held-out synthetic moving-blob sequences; detections/"
                    "tracking/world accumulation via the pipeline's stages",
        "map_size": TRACE_MAP, "clip_len": TRACE_T,
        "n_train_seqs": args.n_train, "n_eval_seqs": args.n_eval,
        "batch_size": args.batch, **run_info(device, args.steps, train_s,
                                             eval_s),
        **rows}})

    if not args.no_assert:
        assert rows["ATE"][-1] < rows["ATE"][0], rows
        print(f"TRACE ATE improved {rows['ATE'][0]:.4f} -> "
              f"{rows['ATE'][-1]:.4f}", flush=True)
    return rows


# ---------------------------------------------------------------------------
# ROMP: the Trainer -> rotating checkpoints -> the 3DPW challenge's driver
# ---------------------------------------------------------------------------

def write_truth_dir(truth_dir, thetas72, action="fixture0"):
    """Official 3DPW GT pkl for the held-out scenes: 1 subject, F frames,
    identity camera, all frames valid."""
    F = thetas72.shape[0]
    gt = {
        "genders": ["n"],
        "poses": np.asarray(thetas72, np.float32)[None],      # (1, F, 72)
        "betas": [np.zeros(10, np.float32)],
        "trans": np.zeros((1, F, 3), np.float32),
        "cam_poses": np.tile(np.eye(4, dtype=np.float32)[None], (F, 1, 1)),
        "poses2d": [np.ones((F, 3, 18), np.float32)],
        "campose_valid": [np.ones(F, np.float32)],
        "img_frame_ids": np.arange(F),
    }
    for split in ("train", "validation", "test"):
        os.makedirs(osp.join(truth_dir, split), exist_ok=True)
    with open(osp.join(truth_dir, "test", f"{action}.pkl"), "wb") as f:
        pickle.dump(gt, f)


def score_params(params, eval_scenes, truth_dir, smpl, smpl_fn, backbone,
                 scratch, tag, input_size, device):
    """A ROMP state dict -> `RompPipeline` at f32 (the best slot of each
    image) -> the 3DPW collector's submission -> `pw3d_evaluate`."""
    from romp_tpu_torch.eval.protocols import (
        Pw3dSubmissionCollector, pw3d_evaluate,
    )
    from romp_tpu_torch.pipeline.romp_pipeline import (
        RompConfig, RompPipeline,
    )

    cfg = RompConfig(input_size=input_size, max_person=4, conf_thresh=-1e9,
                     fetch_slots=1, compute_dtype="float32",
                     backbone=backbone)
    out = RompPipeline(params, smpl, cfg, device)(eval_scenes["image"])
    thetas = out["smpl_thetas"][:, 0].cpu().numpy()   # (F, 72) best slot
    betas = out["smpl_betas"][:, 0].cpu().numpy()
    joints = out["joints"][:, 0, :24].cpu().numpy().astype(np.float64)
    joints = joints - joints[:, :1]                   # center_idx=0 (GT fn)

    col = Pw3dSubmissionCollector(truth_dir)
    for f in range(thetas.shape[0]):
        col.add("fixture0", f, 0, thetas[f], betas[f], joints[f])
    submit = osp.join(scratch, f"submit_{tag}")
    col.write(submit)
    return pw3d_evaluate(submit, truth_dir, smpl_fn)


def eval_checkpoint(ckpt_path, template_state, eval_scenes, truth_dir,
                    smpl, smpl_fn, backbone, scratch, tag,
                    input_size=INPUT_SIZE, device="cpu"):
    """Restore (`load_train_state`) -> `score_params`."""
    from romp_tpu_torch.train.trainer import load_train_state

    state = load_train_state(ckpt_path, template_state)
    return score_params(state.net.state_dict(), eval_scenes, truth_dir, smpl,
                        smpl_fn, backbone, scratch, tag, input_size, device)


# the precision paths compared with f32 on trained weights:
# name -> (compute dtype, activation dtype, fuse_chains)
BF16_VARIANTS = {"mixed": ("bfloat16", "float32", False),
                 "bf16": ("bfloat16", "bfloat16", False),
                 "mixed_fused": ("bfloat16", "float32", True),
                 "bf16_fused": ("bfloat16", "bfloat16", True)}


def bf16_on_checkpoint(ckpt_path, template_state, eval_scenes, backbone,
                       smpl, input_size=INPUT_SIZE, device="cpu"):
    """f32 vs the mixed and bf16-activation paths, unfused and with
    `fuse_chains`, on the trained weights of a checkpoint: per variant the
    share of images whose best slot sits at f32's center cell, the mean and
    95th-percentile vertex delta (mm) over those images, and the largest
    confidence delta (the JAX script's four fields)."""
    from romp_tpu_torch.pipeline.romp_pipeline import (
        RompConfig, RompPipeline,
    )
    from romp_tpu_torch.train.trainer import load_train_state

    params = load_train_state(ckpt_path, template_state).net.state_dict()
    outs = {}
    for name, (cd, ad, fuse) in (("f32", ("float32", "float32", False)),
                                 *BF16_VARIANTS.items()):
        cfg = RompConfig(input_size=input_size, max_person=4,
                         conf_thresh=-1e9, fetch_slots=0, compute_dtype=cd,
                         act_dtype=ad, backbone=backbone, fuse_chains=fuse)
        out = RompPipeline(params, smpl, cfg, device)(eval_scenes["image"])
        outs[name] = {k: v.double().cpu().numpy() for k, v in out.items()}

    rep = {}
    a = outs["f32"]
    for variant in BF16_VARIANTS:
        b = outs[variant]
        # detection agreement: same top-1 center cell picked per image;
        # the vertex deltas are conditioned on it (when the two paths pick
        # different cells the delta measures the layout, not the numerics)
        same = (np.abs(a["centers"][:, 0] - b["centers"][:, 0])
                .max(axis=-1) < 1.0)
        dverts = np.linalg.norm(a["verts"][:, 0] - b["verts"][:, 0],
                                axis=-1)[same]
        rep[variant] = {
            "top1_center_agreement": float(same.mean()),
            "vertex_mean_delta_mm": float(dverts.mean() * 1000.0)
            if same.any() else None,
            "vertex_p95_delta_mm": float(np.percentile(dverts, 95) * 1000.0)
            if same.any() else None,
            "conf_max_delta": float(np.abs(
                a["center_confs"][:, 0] - b["center_confs"][:, 0]).max()),
        }
    return rep


def run_info(device, steps, train_s, eval_s) -> Dict:
    """Where and how long: the device (and the card's name), the training
    wall time and seconds a step, the scoring wall time."""
    dev = torch.device(device)
    info = {"device": str(dev), "train_seconds": train_s,
            "s_per_step": train_s / max(steps, 1), "eval_seconds": eval_s}
    if dev.type == "cuda":
        info["card"] = torch.cuda.get_device_name(dev)
    return info


def merge_record(out_path, section: Dict) -> None:
    """Merge `section`'s keys into the JSON record at out_path."""
    payload = {}
    if osp.exists(out_path):
        with open(out_path) as f:
            payload = json.load(f)
    payload.update(section)
    os.makedirs(osp.dirname(osp.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(payload, f, indent=1)
    print(f"wrote {out_path} [{', '.join(section)}]", flush=True)


def romp_config(args, ckdir):
    """The training config of the loop (the JAX script's)."""
    from romp_tpu_torch.config import Config

    cfg = Config()
    cfg.model.backbone = args.backbone
    cfg.model.input_size = args.input_size
    cfg.model.max_person = 4
    cfg.train.lr = args.lr
    cfg.train.warmup_steps = args.warmup
    cfg.train.batch_size = args.batch
    cfg.train.compute_dtype = "float32"
    cfg.train.test_interval = args.interval
    cfg.train.keep_checkpoints = max(
        2 * (args.steps // max(args.interval, 1)) + 2, 4)
    cfg.train.checkpoint_dir = ckdir
    cfg.train.log_every = max(args.interval // 2, 1)
    cfg.train.tensorboard = False
    cfg.data.num_person = 1
    cfg.mesh.n_devices = 1
    return cfg


def run_romp(args, device):
    from romp_tpu_torch.eval.protocols import make_gt_smpl_fn
    from romp_tpu_torch.smpl.body_model import SmplModel, synthetic_assets
    from romp_tpu_torch.train.trainer import Trainer

    scratch = args.workdir or tempfile.mkdtemp(prefix="convergence_")
    ckdir = osp.join(scratch, "ckpt")
    eval_scenes, eval_thetas = make_scenes(args.n_eval, seed=97,
                                           input_size=args.input_size,
                                           device=device)
    smpl = SmplModel(synthetic_assets(seed=0), device)

    if args.bf16_ckpt:
        # standalone: the precision paths on an existing checkpoint
        trainer = Trainer(romp_config(args, ckdir), smpl, device=device)
        rep = bf16_on_checkpoint(args.bf16_ckpt, trainer.state, eval_scenes,
                                 args.backbone, smpl, args.input_size,
                                 device)
        key = f"bf16_on_trained_{torch.device(device).type}"
        print(key + ":", json.dumps(rep), flush=True)
        merge_record(args.out, {key: rep})
        return rep

    train_scenes, _ = make_scenes(args.n_train, seed=11,
                                  input_size=args.input_size, device=device)
    truth_dir = osp.join(scratch, "truth")
    write_truth_dir(truth_dir, eval_thetas)
    smpl_fn = make_gt_smpl_fn({"n": smpl}, device)

    # the trainer's held-out metric: the live state scored as a checkpoint
    # is, so that the trainer keeps the best one (best.npz)
    in_fit_eval_s = [0.0]

    def eval_fn(state):
        t0 = time.perf_counter()
        step = int(state.step)
        s = score_params(state.net.state_dict(), eval_scenes, truth_dir,
                         smpl, smpl_fn, args.backbone, scratch,
                         f"live_{step}", args.input_size, device)
        in_fit_eval_s[0] += time.perf_counter() - t0
        return {"pampjpe": s["MPJPE_PA"], "mpjpe": s["MPJPE"],
                "pck": s["PCK"]}

    trainer = Trainer(romp_config(args, ckdir), smpl, eval_fn=eval_fn,
                      device=device)
    print(f"training {args.steps} steps (backbone={args.backbone}, "
          f"{args.input_size}x{args.input_size}, batch={args.batch}, ckpt "
          f"every {args.interval}, {device})", flush=True)
    t0 = time.perf_counter()
    trainer.fit(batch_iter(train_scenes, args.batch, seed=3),
                max_steps=args.steps)
    _sync(device)
    fit_s = time.perf_counter() - t0
    train_s = fit_s - in_fit_eval_s[0]

    snaps = sorted(f for f in os.listdir(ckdir)
                   if f.startswith("step_") and f.endswith(".npz"))
    assert snaps, f"no checkpoints written in {ckdir}"
    rows = {"steps": [], "MPJPE": [], "MPJPE_PA": [], "PCK": [], "AUC": [],
            "MPJAE": [], "MPJAE_PA": []}
    t0 = time.perf_counter()
    for snap in snaps:
        step = int(snap[5:-4])
        score = eval_checkpoint(
            osp.join(ckdir, snap), trainer.state, eval_scenes, truth_dir,
            smpl, smpl_fn, args.backbone, scratch, tag=str(step),
            input_size=args.input_size, device=device)
        rows["steps"].append(step)
        for k in ("MPJPE", "MPJPE_PA", "PCK", "AUC", "MPJAE", "MPJAE_PA"):
            rows[k].append(round(float(score[k]), 3))
        print(f"step {step:6d}: MPJPE {score['MPJPE']:8.1f} mm  "
              f"PA {score['MPJPE_PA']:8.1f} mm  PCK {score['PCK']:5.1f}",
              flush=True)
    eval_s = time.perf_counter() - t0

    # the precision paths on the trained weights of the last checkpoint
    bf16_report = bf16_on_checkpoint(
        osp.join(ckdir, snaps[-1]), trainer.state, eval_scenes,
        args.backbone, smpl, args.input_size, device)
    print("bf16 on trained weights:", json.dumps(bf16_report), flush=True)

    section = {
        "protocol": "3DPW-challenge driver (eval/protocols.py) on held-out "
                    "synthetic blob-rendered scenes",
        "backbone": args.backbone, "input_size": args.input_size,
        "n_train_scenes": args.n_train, "n_eval_scenes": args.n_eval,
        "batch_size": args.batch, "warmup_steps": args.warmup,
        **run_info(device, args.steps, train_s, eval_s),
        "best_val_pampjpe": trainer.best_val,
        "bf16_on_trained": bf16_report,
        **rows,
    }
    # the 128x128 recipe is the headline; other sizes (the full-scale 512
    # + hrnet32 run) under their own key, as in the JAX record
    key = ("romp" if args.input_size == INPUT_SIZE
           else f"full_scale_{args.input_size}")
    merge_record(args.out, {key: section})

    if not args.no_assert:
        first, last = rows["MPJPE"][0], rows["MPJPE"][-1]
        assert last < first, (
            f"MPJPE did not improve: first {first} -> last {last}")
        # with warmup the curve should only descend; 2% slack absorbs
        # checkpoint-to-checkpoint eval noise
        m = rows["MPJPE"]
        for a, b in zip(m, m[1:]):
            assert b <= a * 1.02, f"MPJPE non-monotone: {m}"
        print(f"MPJPE improved {first:.1f} -> {last:.1f} mm "
              f"(best {min(m):.1f}, monotone)", flush=True)
    return section


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="Train on synthetic scenes, score every rotating "
                    "checkpoint by the official protocols")
    ap.add_argument("--model", default="romp",
                    choices=["romp", "bev", "trace"],
                    help="romp = 3DPW-challenge driver; bev = Relative "
                         "Human (PCRD / mPCKh / age accuracy); trace = "
                         "DynaCam ATE / APE")
    ap.add_argument("--steps", type=int, default=240)
    ap.add_argument("--interval", type=int, default=40,
                    help="checkpoint / eval cadence (train.test_interval)")
    ap.add_argument("--n_train", type=int, default=48)
    ap.add_argument("--n_eval", type=int, default=12)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=40,
                    help="linear LR warmup steps (train.warmup_steps): "
                         "keeps the early objective from blowing up the "
                         "shared trunk, so the ROMP curve descends")
    ap.add_argument("--backbone", default="hrnet32_tiny")
    ap.add_argument("--input_size", type=int, default=INPUT_SIZE,
                    help="ROMP's scene / model resolution; 512 with "
                         "--backbone hrnet32 is the full-scale "
                         "configuration (BEV and TRACE keep theirs)")
    ap.add_argument("--GPU", type=int, default=0,
                    help="cuda:N (default 0); -1 runs on the CPU")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="the JSON record (sections merged into it)")
    ap.add_argument("--workdir", default=None,
                    help="checkpoints and submissions (default: a new "
                         "temporary directory)")
    ap.add_argument("--no_assert", action="store_true")
    ap.add_argument("--bf16_ckpt", default=None,
                    help="skip training: load this step_*.npz checkpoint "
                         "and run only the precision comparison, merged "
                         "into --out under 'bf16_on_trained_<device>'")
    return ap.parse_args(argv)


def main(argv=None) -> Optional[Dict]:
    from romp_tpu_torch.cli.common import device_from_flag

    args = parse_args(argv)
    device = device_from_flag(args.GPU)
    if args.model == "bev":
        return run_bev(args, device)
    if args.model == "trace":
        return run_trace(args, device)
    return run_romp(args, device)


if __name__ == "__main__":
    main()
