"""The port's `romp` CLI end to end on the CPU, and the port's freedom from
jax and from the JAX package."""
import os
import os.path as osp
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(2)
REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


def test_romp_cli_image_mode_on_cpu(tmp_path, capsys):
    """Full-width HRNet-W32 at 512x512, random init and synthetic SMPL
    (both missing-file fallbacks), one image, --GPU -1."""
    from romp_tpu_torch.cli.romp import main

    img = (np.random.RandomState(0).rand(96, 80, 3) * 255).astype(np.uint8)
    png = str(tmp_path / "person.png")
    cv2.imwrite(png, img)
    out_dir = tmp_path / "out"
    rc = main(["-m", "image", "-i", png, "-o", str(out_dir), "--GPU", "-1",
               "--model_path", str(tmp_path / "missing.pkl"),
               "--smpl_path", str(tmp_path / "missing.pth"),
               "--center_thresh=-1e9"])     # every slot is a detection
    assert rc == 0
    err = capsys.readouterr().err
    assert "using random init" in err and "synthetic" in err
    res = np.load(out_dir / "person.npz", allow_pickle=True)["results"][()]
    assert res["verts"].shape == (64, 6890, 3)
    assert res["pj2d_org"].shape == (64, 71, 2)
    assert np.isfinite(res["smpl_thetas"]).all()
    assert (out_dir / "person.png").exists()


def test_bev_cli_image_mode_on_cpu(tmp_path, capsys):
    """Full-width BEV (HRNet-W32 at 512x512, 128x128x64 3D maps), random
    init and synthetic SMPL-A / SMIL (the missing-file fallbacks), one
    image, --GPU -1."""
    from romp_tpu_torch.cli.bev import main

    img = (np.random.RandomState(1).rand(80, 96, 3) * 255).astype(np.uint8)
    png = str(tmp_path / "crowd.png")
    cv2.imwrite(png, img)
    out_dir = tmp_path / "out"
    rc = main(["-m", "image", "-i", png, "-o", str(out_dir), "--GPU", "-1",
               "--model_path", str(tmp_path / "missing.pth"),
               "--smpl_path", str(tmp_path / "missing_smpla.pth"),
               "--smil_path", str(tmp_path / "missing_smil.pth"),
               "--center_thresh=-1e9", "--max_person", "8"])
    assert rc == 0
    err = capsys.readouterr().err
    assert "using random init" in err and "synthetic" in err
    res = np.load(out_dir / "crowd.npz", allow_pickle=True)["results"][()]
    n = res["cam"].shape[0]
    assert 0 < n <= 8
    assert res["verts"].shape == (n, 6890, 3)
    assert res["pj2d_org"].shape == (n, 71, 2)
    assert res["pred_czyxs"].shape == (n, 3)
    for k in ("smpl_thetas", "smpl_betas", "cam_trans", "verts"):
        assert np.isfinite(res[k].astype(np.float32)).all(), k


def test_trace2_cli_with_raft_and_world_view_on_cpu(tmp_path, capsys,
                                                    monkeypatch):
    """trace2 with a RAFT weights file (seeded, torch layout, with the
    checkpoint's `downsample.1` aliases and BatchNorm counters): the flow
    comes from RAFT (2 iterations at --flow_size 64, non-zero, at the
    128x128 map size), and `--show_items world` writes the global-view
    renders, the top-down trajectory and the HTML viewer."""
    from romp_tpu_torch.cli.trace import main
    from romp_tpu_torch.models import raft

    ckpt = raft.init_raft_params(torch.Generator().manual_seed(0))
    for k in list(ckpt):
        if ".norm3." in k:
            ckpt[k.replace(".norm3.", ".downsample.1.")] = ckpt[k]
        if k.endswith("running_mean"):
            ckpt[k.replace("running_mean", "num_batches_tracked")] = (
                torch.tensor(0))
    torch.save(ckpt, tmp_path / "raft-things.pth")
    flows = []
    make = raft.make_trace_flow_fn

    def recording(*args, **kwargs):
        fn = make(*args, **kwargs)

        def wrapped(frames):
            flows.append(fn(frames))
            return flows[-1]
        wrapped.takes_sequence = fn.takes_sequence
        return wrapped
    monkeypatch.setattr(raft, "make_trace_flow_fn", recording)

    frames = tmp_path / "seq"
    frames.mkdir()
    rng = np.random.RandomState(0)
    base = (rng.rand(64, 64, 3) * 255).astype(np.uint8)
    for i in range(2):
        cv2.imwrite(str(frames / f"{i:04d}.png"), np.roll(base, 4 * i, 1))
    out = tmp_path / "out"
    rc = main(["-i", str(frames), "-o", str(out), "--GPU", "-1",
               "--temp_clip_length", "2", "--center_thresh=-1e9",
               "--model_path", str(tmp_path / "missing.pth"),
               "--smpl_path", "", "--smil_path", "",
               "--raft_model_path", str(tmp_path / "raft-things.pth"),
               "--raft_iters", "2", "--flow_size", "64",
               "--show_items", "mesh,world"])
    assert rc == 0
    assert "zero optical flow" not in capsys.readouterr().err
    assert len(flows) == 1 and flows[0].shape == (2, 128, 128, 2)
    assert torch.isfinite(flows[0]).all() and flows[0].abs().max() > 0
    res = np.load(out / "seq.npz", allow_pickle=True)["results"][()]
    assert res and all(np.isfinite(fr["verts"]).all() for fr in res.values())
    vis = out / "world_vis"
    assert (vis / "trajectories.html").exists()
    assert len(list(vis.glob("*.png"))) >= 2


def test_gpu_flag_never_falls_back_to_cpu():
    from romp_tpu_torch.cli.common import device_from_flag

    assert device_from_flag(-1) == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--GPU -1"):
            device_from_flag(0)


def test_port_runs_without_jax():
    """With `import jax`, `import optax` and `import romp_tpu` made to fail,
    every module of the port imports (`romp_tpu_torch.serve` and
    `romp_tpu_torch.train`, TRACE's training among them, the tools and the
    Blender addon without `bpy`), and the tiny ROMP
    slice (directly and behind the port's server), the tiny TRACE slice
    with RAFT's flow and the tiny BEV slice run on the CPU."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["optax"] = None
        sys.modules["romp_tpu"] = None
        import numpy as np, torch
        import romp_tpu_torch
        for m in pkgutil.walk_packages(romp_tpu_torch.__path__,
                                       "romp_tpu_torch."):
            importlib.import_module(m.name)
        for name in ("train.launch", "train.trainer", "train.train_step",
                     "train.data.loader", "models.resnet", "config",
                     "utils.tensorboard", "train.trace_train_step",
                     "train.video_losses", "train.data.video_dataset",
                     "eval.metrics", "eval.protocols", "eval.convergence",
                     "ops.pnp", "ops.epropnp_mc", "smpl.family",
                     "tools.export_program", "tools.prepare_smpl",
                     "tools.show_results", "vis.blender_addon"):
            assert "romp_tpu_torch." + name in sys.modules, name
        from romp_tpu_torch.models.bev import init_bev_params
        from romp_tpu_torch.models.raft import (
            init_raft_params, make_trace_flow_fn)
        from romp_tpu_torch.models.romp import init_romp_params
        from romp_tpu_torch.models.trace import init_trace_params
        from romp_tpu_torch.pipeline.bev_pipeline import (
            BevConfig, BevPipeline)
        from romp_tpu_torch.pipeline.romp_pipeline import (
            RompConfig, RompPipeline)
        from romp_tpu_torch.pipeline.trace_pipeline import (
            TraceConfig, TracePipeline)
        from romp_tpu_torch.pipeline.trace_tracking import SeqConfig
        from romp_tpu_torch.smpl.body_model import SmplModel
        from romp_tpu_torch.smpl.assets import synthetic_assets
        torch.set_num_threads(2)
        cfg = RompConfig(input_size=64, max_person=4, conf_thresh=-1e9,
                         backbone="hrnet32_tiny", compute_dtype="bfloat16",
                         fuse_chains=True)
        params = init_romp_params(torch.Generator().manual_seed(0),
                                  "hrnet32_tiny")
        pipe = RompPipeline(params, SmplModel(synthetic_assets(seed=0)), cfg,
                            "cpu")
        out = pipe(np.zeros((1, 64, 64, 3), np.uint8))
        assert out["verts"].shape == (1, 4, 6890, 3), out["verts"].shape
        assert all(torch.isfinite(v.float()).all() for v in out.values())
        from romp_tpu_torch.serve import (
            InferenceClient, InferenceServer, make_romp_service)
        srv = InferenceServer(make_romp_service(
            params, SmplModel(synthetic_assets(seed=0)), cfg, max_batch=2,
            device="cpu"))
        client = InferenceClient(port=srv.port)
        served = client.infer(np.zeros((40, 64, 3), np.uint8))
        client.close()
        srv.close()
        assert served["verts"].shape == (4, 6890, 3), served["verts"].shape

        tcfg = TraceConfig(input_size=64, temp_clip_length=2, max_person=4,
                           conf_thresh=-1e9, backbone="hrnet32_tiny",
                           compute_dtype="bfloat16")
        tparams = init_trace_params(torch.Generator().manual_seed(0),
                                    map_size=16, backbone="hrnet32_tiny")
        seq = SeqConfig(large_object_thresh=-1e9, first_frame_det_thresh=-1e9,
                        tracker_det_thresh=-1e9, tracker_match_thresh=1e9)
        tpipe = TracePipeline(
            tparams, SmplModel(synthetic_assets(seed=0, num_betas=11)),
            SmplModel(synthetic_assets(seed=1, num_betas=10)), tcfg, seq,
            device="cpu")
        frames = (np.random.RandomState(0).rand(2, 64, 64, 3) * 255)
        tpipe.flow_fn = flow = make_trace_flow_fn(
            init_raft_params(torch.Generator().manual_seed(0)), iters=2,
            out_size=16, compute_dtype="bfloat16", flow_input_size=32,
            sequence=True, device="cpu")
        assert flow(torch.zeros((3, 64, 64, 3))).shape == (2, 16, 16, 2)
        res = list(tpipe.process_stream([frames, frames]))
        assert all(r is not None for r in res)
        assert res[0]["verts"].shape[1:] == (6890, 3)
        assert all(np.isfinite(v).all() for r in res for v in r.values())

        bcfg = BevConfig(input_size=64, max_person=4, conf_thresh=-1e9,
                         backbone="hrnet32_tiny", compute_dtype="bfloat16",
                         fuse_chains=True)
        bpipe = BevPipeline(
            init_bev_params(torch.Generator().manual_seed(0), 64,
                            "hrnet32_tiny"),
            SmplModel(synthetic_assets(seed=0, num_betas=11)),
            SmplModel(synthetic_assets(seed=1, num_betas=10)), bcfg, "cpu")
        bout = bpipe(np.zeros((1, 64, 64, 3), np.uint8))
        assert bout["verts"].shape == (1, 4, 6890, 3), bout["verts"].shape
        assert all(torch.isfinite(v.float()).all() for v in bout.values())
        assert not any(k.split(".")[0] in ("jax", "optax", "romp_tpu")
                       for k, v in sys.modules.items() if v is not None)
        print("OK")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_port_sources_import_nothing_of_the_jax_package():
    """No line of the port (its server and trainer included), nor of
    chip_smoke.py, imports `romp_tpu`, `jax` or `optax` (docstrings may name
    them)."""
    pattern = re.compile(
        r"^\s*(from|import)\s+(romp_tpu|jax|optax)(\.|\s|$)")
    files = [osp.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(osp.join(REPO, "romp_tpu_torch")):
        files += [osp.join(root, n) for n in names if n.endswith(".py")]
    offenders = []
    for path in files:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if pattern.match(line):
                    offenders.append(f"{osp.relpath(path, REPO)}:{i}: "
                                     f"{line.strip()}")
    assert osp.join(REPO, "romp_tpu_torch", "serve.py") in files
    assert osp.join(REPO, "romp_tpu_torch", "train", "launch.py") in files
    assert len(files) > 20 and not offenders, offenders
