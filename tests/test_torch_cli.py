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


def test_gpu_flag_never_falls_back_to_cpu():
    from romp_tpu_torch.cli.common import device_from_flag

    assert device_from_flag(-1) == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--GPU -1"):
            device_from_flag(0)


def test_port_runs_without_jax():
    """With `import jax` and `import romp_tpu` made to fail, every module of
    the port imports, and the tiny ROMP slice and the tiny TRACE slice run
    on the CPU."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["romp_tpu"] = None
        import numpy as np, torch
        import romp_tpu_torch
        for m in pkgutil.walk_packages(romp_tpu_torch.__path__,
                                       "romp_tpu_torch."):
            importlib.import_module(m.name)
        from romp_tpu_torch.models.romp import init_romp_params
        from romp_tpu_torch.models.trace import init_trace_params
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
        res = list(tpipe.process_stream([frames, frames]))
        assert all(r is not None for r in res)
        assert res[0]["verts"].shape[1:] == (6890, 3)
        assert all(np.isfinite(v).all() for r in res for v in r.values())
        assert not any(k.split(".")[0] in ("jax", "romp_tpu")
                       for k, v in sys.modules.items() if v is not None)
        print("OK")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_port_sources_import_nothing_of_the_jax_package():
    """No line of the port, nor of chip_smoke.py, imports `romp_tpu` or
    `jax` (docstrings may name them)."""
    pattern = re.compile(r"^\s*(from|import)\s+(romp_tpu|jax)(\.|\s|$)")
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
    assert len(files) > 20 and not offenders, offenders
