"""The port's training end to end on the CPU: the f64 train step against
JAX's (in a subprocess: it switches JAX's float32 to float64), and the
launcher (`romp_tpu_torch.train.launch.main`) on a small seeded pack, with
resume."""
import json
import os
import os.path as osp
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
torch.set_num_threads(2)


def test_f64_train_step_matches_jax():
    """The same step in float64 on both sides (JAX with x64 on and its
    float32 taken as float64, so that its hard f32 casts keep f64; the port
    with `.float()` taken as `.double()`): the losses and the BatchNorm
    updates agree to 1e-9 of max|ref|, every gradient tensor to 1e-6
    (measured 5.4e-8 at the worst tensor here, 4e-13 on JAX's own init:
    the f32 step's gaps of 1e-2 are its conditioning, see
    `test_torch_train_step.py`). The three conv biases whose gradient is
    exactly zero hold summation noise on both sides: 1e-9 of the largest
    gradient."""
    code = textwrap.dedent("""
        import sys
        import numpy as np, jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        import jax.numpy as jnp
        jnp.float32 = jnp.float64
        import torch
        torch.Tensor.float = torch.Tensor.double
        torch.set_num_threads(2)
        sys.path.insert(0, "tests")
        from test_torch_train_step import (
            TINY, ZERO_GRAD, make_batch, to_jax_layout)
        from romp_tpu.smpl.assets import synthetic_assets
        from romp_tpu.smpl.body_model import SmplModel as JaxSmpl
        from romp_tpu.train import train_step as jts
        from romp_tpu.train.priors import GmmPrior as JaxGmm
        from romp_tpu_torch.models.layers import record_bn_updates
        from romp_tpu_torch.models.romp import RompNet, init_romp_params
        from romp_tpu_torch.smpl.body_model import SmplModel
        from romp_tpu_torch.train import train_step as tts
        from romp_tpu_torch.train.priors import GmmPrior
        from romp_tpu_torch.utils.checkpoint import state_dict_from_jax
        f64 = lambda t: jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float64)
            if jnp.issubdtype(a.dtype, jnp.floating) else a, t)
        sd = init_romp_params(torch.Generator().manual_seed(0), TINY)
        jp = f64(to_jax_layout(sd))
        batch = make_batch()
        assets = synthetic_assets(seed=0)
        cfg = jts.TrainConfig(remat="none", backbone=TINY)
        tr, bn = jts.split_params(jp)
        jsmpl, jprior = f64(JaxSmpl.from_assets(assets)), f64(
            JaxGmm.synthetic())
        (_, (jbn, jm)), jg = jax.jit(lambda a, b, c: jax.value_and_grad(
            jts.compute_losses, has_aux=True)(a, b, c, jsmpl, cfg, jprior))(
            tr, bn, f64({k: jnp.asarray(v) for k, v in batch.items()}))
        assert jax.tree_util.tree_leaves(jg)[0].dtype == jnp.float64
        net = RompNet(TINY).double()
        net.load_state_dict(state_dict_from_jax(
            {k: np.asarray(v) for k, v in jp.items()}))
        net = net.double().train()
        updates = record_bn_updates(net)
        prior = GmmPrior(*(t.double() for t in GmmPrior.synthetic()
                           .__dict__.values()))
        tb = {k: torch.from_numpy(v).double() if v.dtype == np.float32
              else torch.from_numpy(v) for k, v in batch.items()}
        total, m = tts.compute_losses(
            net, tb, SmplModel(assets).double(),
            tts.TrainConfig(remat="none", backbone=TINY), prior)
        names = sorted(k for k, _ in net.named_parameters())
        params = dict(net.named_parameters())
        grads = torch.autograd.grad(total, [params[k] for k in names])
        rel = lambda a, b: float(np.abs(np.asarray(a) - np.asarray(b)).max()
                                 / max(np.abs(np.asarray(b)).max(), 1e-300))
        for k, v in jm.items():
            assert abs(float(m[k].detach()) - float(v)) <= 1e-9 * max(
                abs(float(v)), 1e-3), k
        ref = state_dict_from_jax({k: np.asarray(v) for k, v in jg.items()})
        gmax = max(float(np.abs(v.numpy()).max()) for v in ref.values())
        worst = 0.0
        for k, g in zip(names, grads):
            assert g.dtype == torch.float64
            if k in ZERO_GRAD:
                assert float(g.abs().max()) <= 1e-9 * gmax, k
                continue
            worst = max(worst, rel(g.numpy(), ref[k].numpy()))
        assert worst <= 1e-6, worst
        assert max(rel(updates[k].numpy(), v) for k, v in jbn.items()) <= 1e-9
        print("OK", worst)
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().startswith("OK"), proc.stdout


def _write_pack(root, n=4, size=96):
    """n seeded images (cv2) and a pack of 2D-keypoint records for them."""
    import cv2

    from romp_tpu_torch.train.data.dataset import ImageAnnotation, save_pack

    rng = np.random.RandomState(0)
    os.makedirs(osp.join(root, "data"), exist_ok=True)
    records = []
    for i in range(n):
        path = osp.join(root, f"img{i}.jpg")
        cv2.imwrite(path, (rng.rand(size, size, 3) * 255).astype(np.uint8))
        kp = rng.uniform(10, size - 10, (2, 54, 2)).astype(np.float32)
        kp[:, 30:] = -2.0                       # some joints unlabelled
        records.append(ImageAnnotation(path, kp))
    save_pack(osp.join(root, "data", "mini.npz"), records)


def test_launch_main_trains_and_resumes_on_cpu(tmp_path):
    """`launch.main` with --GPU -1 on a 4-image pack at 64x64 (the tiny
    HRNet, f32, batch 2): 3 steps, each logged with finite losses and
    grads_finite == 1, checkpoints in the port's format; then a resume
    from last.npz continues at step 4 with the same weights and moments."""
    from romp_tpu_torch.train import launch

    root = str(tmp_path)
    _write_pack(root)
    ck = osp.join(root, "ck")
    args = ["--data_root", osp.join(root, "data"), "--GPU", "-1",
            "model.input_size=64", "model.backbone=hrnet32_tiny",
            "train.batch_size=2", "train.compute_dtype=float32",
            "train.test_interval=0", "train.log_every=1",
            f"train.checkpoint_dir={ck}", "data.datasets=mini",
            "train.tensorboard=false"]
    assert launch.main(["--max_steps", "3", *args]) == 0
    with open(osp.join(ck, "train_log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    assert [r["step"] for r in log] == [1, 2, 3]
    for r in log:
        assert r["grads_finite"] == 1.0
        assert all(np.isfinite(r[k]) for k in ("total", "kp2d", "centermap"))
        assert r["total"] > 0
    with np.load(osp.join(ck, "last.npz")) as saved:
        assert int(saved["step"]) == 3 and int(saved["o::count"]) == 3
        first = {k: saved[k] for k in saved.files}
    assert launch.main(["--max_steps", "1", *args,
                        f"train.resume={osp.join(ck, 'last.npz')}"]) == 0
    with open(osp.join(ck, "train_log.jsonl")) as f:
        assert json.loads(f.readlines()[-1])["step"] == 4
    with np.load(osp.join(ck, "last.npz")) as saved:
        assert int(saved["step"]) == 4 and int(saved["o::count"]) == 4
        moved = [k for k in first if k.startswith("p::")
                 and not np.array_equal(first[k], saved[k])]
    assert moved       # the resumed step trained from the loaded weights


def test_launch_refuses_what_is_not_ported():
    from romp_tpu_torch.train import launch

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        launch.main(["model.version=bev", "--GPU", "-1"])


def write_video_pack(root, n_seq=2, frames=5, size=64):
    """A video pack (`save_video_pack`) of n_seq seeded cv2 sequences with
    two subjects each, the second valid from frame 2 on."""
    import cv2

    from romp_tpu_torch.models.trace import trace_cam_anchor
    from romp_tpu_torch.train.data.video_dataset import (
        VideoSequence, save_video_pack, trans3d_to_czyx,
    )

    rng = np.random.RandomState(0)
    os.makedirs(osp.join(root, "data"), exist_ok=True)
    seqs = []
    for s in range(n_seq):
        paths = []
        for f in range(frames):
            path = osp.join(root, f"s{s}_f{f}.jpg")
            cv2.imwrite(path, (rng.rand(size, size, 3) * 255).astype(
                np.uint8))
            paths.append(path)
        subjects = {}
        for sid in range(2):
            tr = np.stack([np.linspace(-0.4, 0.4, frames) + 0.2 * sid,
                           np.full(frames, 0.1), np.full(frames, 4.0 + sid)],
                          -1).astype(np.float32)
            valid = np.arange(frames) >= 2 * sid
            subjects[sid] = {
                "valid": valid,
                "czyx": trans3d_to_czyx(tr, trace_cam_anchor(),
                                        map_size=size // 4),
                "trans3d": tr, "world_trans": tr,
                "pose": (rng.randn(frames, 66) * 0.2).astype(np.float32),
                "betas": (rng.randn(frames, 11) * 0.3).astype(np.float32)}
        seqs.append(VideoSequence(paths, subjects))
    save_video_pack(osp.join(root, "data", "clips.npz"), seqs)


@pytest.mark.parametrize("flow", ["zero", "raft"])
def test_launch_trains_trace_on_cpu(tmp_path, flow):
    """`launch.main` with model.version=trace and --GPU -1 on a 2-sequence
    video pack at 64x64 (the tiny HRNet as the frozen backbone, clips of 2
    frames, batch 2, 2 tracks; zero flow with the batches assembled by a
    `PrefetchLoader` worker, or RAFT from a seeded weights file): 2 steps
    logged to trace_train_log.jsonl with finite losses, and trace_last.npz
    written (the port's checkpoint format)."""
    from romp_tpu_torch.models.raft import init_raft_params
    from romp_tpu_torch.train import launch

    root = str(tmp_path)
    write_video_pack(root)
    ck = osp.join(root, "ck")
    args = ["--data_root", osp.join(root, "data"), "--GPU", "-1",
            "--max_steps", "2", "model.version=trace", "model.input_size=64",
            "model.backbone=hrnet32_tiny", "train.batch_size=2",
            "train.compute_dtype=float32", "train.log_every=1",
            f"train.checkpoint_dir={ck}", "data.datasets=clips",
            "trace.clip_length=2", "trace.max_tracks=2"]
    if flow == "zero":
        args.append("train.num_workers=1")
    if flow == "raft":
        raft = osp.join(root, "raft.pth")
        torch.save(init_raft_params(torch.Generator().manual_seed(0)), raft)
        args += ["trace.use_optical_flow=true",
                 f"trace.raft_model_path={raft}"]
    assert launch.main(args) == 0
    with open(osp.join(ck, "trace_train_log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    assert [r["step"] for r in log] == [1, 2]
    for r in log:
        for k in ("total", "centermap3d", "motion", "pose", "shape",
                  "world_trans", "world_grot", "temp_shape"):
            assert np.isfinite(r[k]), (k, r)
        assert r["total"] > 0
    with np.load(osp.join(ck, "trace_last.npz")) as saved:
        assert int(saved["step"]) == 2 and int(saved["o::count"]) == 2
        assert "p::deform_warper.weight" in saved.files
        assert not any(k.startswith("p::backbone.") for k in saved.files)


def test_trace_launch_keeps_tf32_off_while_workers_run(tmp_path,
                                                       monkeypatch):
    """The precision flags are global to the process, so the f32 recipe's
    launcher sets them once for the run: with two `PrefetchLoader` workers
    computing the backbone's features while the main thread steps, cuDNN's
    and the matmuls' TF32 stay off in every step and in every feature
    call, the flags are restored after the run, and no worker outlives
    it."""
    import threading
    import time

    from romp_tpu_torch.models import trace as trace_mod
    from romp_tpu_torch.train import launch
    from romp_tpu_torch.train import trace_train_step as ttts

    def flags():
        return (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)

    seen = {"step": [], "features": []}
    features, step = trace_mod.backbone_features, ttts.trace_train_step

    def recorded_features(*a, **k):
        seen["features"].append((threading.current_thread().name, flags()))
        out = features(*a, **k)
        time.sleep(0.05)          # a worker still busy when a step starts
        seen["features"].append((threading.current_thread().name, flags()))
        return out

    def recorded_step(*a, **k):
        seen["step"].append(flags())
        out = step(*a, **k)
        seen["step"].append(flags())
        return out

    monkeypatch.setattr(trace_mod, "backbone_features", recorded_features)
    monkeypatch.setattr(ttts, "trace_train_step", recorded_step)
    root = str(tmp_path)
    write_video_pack(root)
    before, threads = flags(), threading.active_count()
    assert launch.main([
        "--data_root", osp.join(root, "data"), "--GPU", "-1",
        "--max_steps", "3", "model.version=trace", "model.input_size=64",
        "model.backbone=hrnet32_tiny", "train.batch_size=1",
        "train.compute_dtype=float32", "train.num_workers=2",
        f"train.checkpoint_dir={osp.join(root, 'ck')}",
        "data.datasets=clips", "trace.clip_length=2",
        "trace.max_tracks=2"]) == 0
    assert flags() == before and threading.active_count() == threads
    assert len(seen["step"]) == 6
    assert all(f == (False, False) for f in seen["step"]), seen["step"]
    workers = {name for name, _ in seen["features"]}
    assert workers and threading.main_thread().name not in workers
    assert all(f == (False, False) for _, f in seen["features"]), seen
