"""The plain reference against romp_tpu_torch at tiny sizes on the CPU:
the same parameters, and the served outputs of the port's pipelines equal
to the reference's `outputs` in float32 and on the mixed path."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from gpubench import seeded
from gpubench.reference import bev as ref_bev
from gpubench.reference import romp as ref_romp
from gpubench.reference.nn import spec_of

CFG = {"backbone": "hrnet32_tiny", "input_size": 64, "max_person": 8,
       "conf_thresh": 0.25, "cam_scale_base": 1.1, "transfer_dtype": "float16",
       "act_dtype": "float32", "nms_thresh": 16.0,
       "relative_scale_thresh": 3.0, "outlier_scale_thresh": 0.25,
       "smpl": {"verts": 6890, "joints": 24}}
CPU = torch.device("cpu")


def state(ref, seed=3):
    def fwd(c, x):
        return ref.forward(c, x, CFG["backbone"])
    sd = seeded.weights(spec_of(fwd, (1, 64, 64, 3)), seed, CPU)
    seeded.calibrate(fwd, sd, seeded.images(seed, 2, 64, CPU, "calibration"))
    return sd


@pytest.mark.parametrize("model", ["romp", "bev"])
def test_parameters_match_the_port(model):
    from romp_tpu_torch.models.bev import BevNet
    from romp_tpu_torch.models.romp import RompNet
    ref = {"romp": ref_romp, "bev": ref_bev}[model]
    spec = spec_of(lambda c, x: ref.forward(c, x, "hrnet32"),
                   (1, 512, 512, 3))
    net = RompNet("hrnet32") if model == "romp" else BevNet("hrnet32")
    port = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert port == {k: s for k, (s, _) in spec.items()}


def _port_romp(sd, arrays, images, cfg, fetch):
    from romp_tpu_torch.pipeline.romp_pipeline import RompConfig, RompPipeline
    from romp_tpu_torch.smpl.body_model import SmplAssets, SmplModel
    rc = RompConfig(input_size=64, max_person=8, backbone="hrnet32_tiny",
                    compute_dtype=cfg["compute_dtype"],
                    transfer_dtype="float16", fetch_slots=fetch)
    pipe = RompPipeline(sd, SmplModel(SmplAssets(
        **seeded.host_assets(arrays["smpl"]))), rc, "cpu")
    return pipe(images)


def _port_bev(sd, arrays, images, cfg, fetch):
    from romp_tpu_torch.pipeline.bev_pipeline import BevConfig, BevPipeline
    from romp_tpu_torch.smpl.body_model import SmplAssets, SmplModel
    bc = BevConfig(input_size=64, max_person=8, backbone="hrnet32_tiny",
                   compute_dtype=cfg["compute_dtype"],
                   transfer_dtype="float16")
    pipe = BevPipeline(sd, *(SmplModel(SmplAssets(**seeded.host_assets(
        arrays[n]))) for n in ("adult", "baby")), bc, "cpu")
    return pipe(images)


@pytest.mark.parametrize("model,dtype,fetch", [
    ("romp", "float32", 0), ("romp", "bfloat16", 4), ("bev", "float32", 0),
    ("bev", "bfloat16", 0)])
def test_outputs_match_the_port(model, dtype, fetch):
    ref = {"romp": ref_romp, "bev": ref_bev}[model]
    cfg = dict(CFG, compute_dtype=dtype,
               conf_thresh=0.25 if model == "romp" else 0.1)
    models = {"smpl": 10} if model == "romp" else {"adult": 11, "baby": 10}
    arrays = {n: seeded.smpl_arrays(5, b, CPU, f"smpl.{n}")
              for n, b in models.items()}
    sd = state(ref)
    images = seeded.images(4, 3, 64, CPU)
    port = (_port_romp if model == "romp" else _port_bev)(
        sd, arrays, images, cfg, fetch)
    with torch.no_grad():
        out = ref.outputs(sd, arrays, seeded.SMPL_PARENTS, images, cfg, dtype,
                          fetch)
    assert set(out) == set(port)
    for k in out:
        a, b = port[k].float(), out[k].float()
        tol = 2e-3 * float(b.abs().max()) + 1e-6
        assert torch.allclose(a, b, atol=tol, rtol=0), (k, float(
            (a - b).abs().max()), tol)
    # and the judge finds no gap in them
    with torch.no_grad():
        gaps = ref.judge(sd, arrays, seeded.SMPL_PARENTS, images, port, cfg)
    for k, v in gaps.items():
        assert float(v.max()) < 5e-3, (k, v)
