"""The skinning kernel as custom ops, and model export through
`torch.export` (`romp_tpu_torch/tools/export_program.py`, the counterpart of
`romp_tpu/tools/export_stablehlo.py`), on the CPU at small sizes."""
import numpy as np
import pytest
import torch

import jax

from romp_tpu.models.romp import init_romp_params as jax_init_romp
from romp_tpu.utils.checkpoint import save_params
from romp_tpu_torch.ops.lbs import skinning
from romp_tpu_torch.pipeline.bev_pipeline import BevConfig, BevPipeline
from romp_tpu_torch.pipeline.romp_pipeline import RompConfig, RompPipeline
from romp_tpu_torch.smpl.body_model import SmplModel, synthetic_assets
from romp_tpu_torch.tools import export_program as ep
from romp_tpu_torch.utils.checkpoint import state_dict_from_jax

torch.set_num_threads(2)
TINY = "hrnet32_tiny"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("op", ["skinning", "skinning_bwd"])
def test_skinning_custom_ops_pass_opcheck(op, dtype):
    """Schema, fake (shape-only) implementation, autograd registration and
    AOT dispatch with dynamic shapes, on the CPU route (the plain
    versions), f32 and f64: the fakes follow the inputs' dtype."""
    g = torch.Generator().manual_seed(0)
    B, V = 3, 50
    a16 = torch.randn(B, 16, 24, generator=g, dtype=dtype)
    w = torch.rand(V, 24, generator=g, dtype=dtype)
    vpos = torch.randn(B, 3, V, generator=g, dtype=dtype)
    if op == "skinning":
        args = (a16.requires_grad_(), w, vpos.requires_grad_())
    else:
        args = (a16, w, vpos, torch.randn(B, 3, V, generator=g, dtype=dtype))
    torch.library.opcheck(getattr(torch.ops.romp_tpu_torch, op).default, args)


def _node_targets(program):
    return [str(n.target) for n in program.graph.nodes
            if n.op == "call_function"]


@pytest.fixture(scope="module")
def romp_export(tmp_path_factory):
    """JAX's init of the tiny net written as a JAX `.npz`, exported by the
    port on the CPU at batch 1, max_person 2, and loaded back."""
    root = tmp_path_factory.mktemp("export")
    jp = jax_init_romp(jax.random.PRNGKey(0), input_size=64, backbone=TINY)
    save_params(str(root / "romp_tiny.npz"), jp)
    out = ep.export_romp(str(root / "romp_tiny.npz"), str(root / "romp.pt2"),
                         batch=1, backbone=TINY, max_person=2, device="cpu")
    return dict(jp={k: np.asarray(v) for k, v in jp.items()},
                model=ep.load_exported(out))


def test_export_romp_holds_the_skinning_op(romp_export):
    model = romp_export["model"]
    assert "romp_tpu_torch.skinning.default" in _node_targets(model.program)
    assert model.meta == {"model": "romp", "batch": 1, "input_size": 512,
                          "max_person": 2, "compute_dtype": "float32"}


def test_export_romp_state_is_the_jax_checkpoint(romp_export):
    """Every parameter the exported program holds equals JAX's
    `init_romp_params` array, carried across by `load_checkpoint_flexible`
    (HWIO -> OIHW), exactly."""
    state = romp_export["model"].program.state_dict
    ref = state_dict_from_jax(romp_export["jp"])
    assert {k for k in state if k.startswith("net.")} == {
        "net." + k for k in ref}
    for k, v in ref.items():
        assert torch.equal(state["net." + k], v), k
    assert "smpl.lbs_weights" in state      # the SMPL tensors are state too


def test_loaded_romp_program_equals_eager(romp_export):
    """The loaded program against the port's eager `romp_inference` on the
    same params and image: 1e-6 of each output's max|ref| (the same CPU
    ops in the same order; measured exact). Skinning runs through the
    custom op's CPU route: no kernel launch."""
    images = torch.from_numpy(
        np.random.RandomState(0).rand(1, 512, 512, 3).astype(np.float32)
        * 255.0)
    before = skinning.launches
    out = romp_export["model"](images)
    assert skinning.launches == before
    pipe = RompPipeline(state_dict_from_jax(romp_export["jp"]),
                        SmplModel(synthetic_assets(seed=0)),
                        RompConfig(max_person=2, backbone=TINY), "cpu")
    ref = pipe(images)
    assert set(out) == set(ref)
    for k, r in ref.items():
        assert out[k].shape == r.shape and out[k].dtype == r.dtype, k
        r = r.float()
        err = float((out[k].float() - r).abs().max())
        assert err <= 1e-6 * max(float(r.abs().max()), 1.0), (k, err)


def test_export_bev_round_trip(tmp_path):
    """BEV at 64x64 (the JAX test's size) on the tiny backbone, SMPL+A
    embedded: two skinning nodes, and the loaded program equals eager
    `bev_inference` (1e-6 of max|ref|)."""
    cfg = BevConfig(max_person=2, input_size=64, backbone=TINY)
    out = ep.export_bev(str(tmp_path / "missing.npz"),
                        str(tmp_path / "bev.pt2"), batch=1, device="cpu",
                        cfg=cfg)
    model = ep.load_exported(out)
    assert _node_targets(model.program).count(
        "romp_tpu_torch.skinning.default") == 2
    assert model.meta["model"] == "bev" and model.meta["input_size"] == 64
    images = torch.from_numpy(
        np.random.RandomState(1).rand(1, 64, 64, 3).astype(np.float32) * 255)
    res = model(images)
    from romp_tpu_torch.models.bev import init_bev_params

    pipe = BevPipeline(init_bev_params(torch.Generator().manual_seed(0), 64,
                                       TINY),
                       SmplModel(synthetic_assets(seed=0, num_betas=11)),
                       SmplModel(synthetic_assets(seed=1, num_betas=10)),
                       cfg, "cpu")
    ref = pipe(images)
    assert set(res) == set(ref)
    for k, r in ref.items():
        r = r.float()
        err = float((res[k].float() - r).abs().max())
        assert torch.isfinite(res[k].float()).all(), k
        assert err <= 1e-6 * max(float(r.abs().max()), 1.0), (k, err)


@pytest.mark.parametrize("export,cfg", [
    (ep.export_romp, RompConfig(fuse_chains=True)),
    (ep.export_romp, RompConfig(compute_dtype="bfloat16",
                                act_dtype="bfloat16")),
    (ep.export_bev, BevConfig(fuse_chains=True)),
    (ep.export_bev, BevConfig(compute_dtype="bfloat16",
                              act_dtype="bfloat16"))])
def test_export_refuses_configs_whose_kernels_are_not_ops(tmp_path, export,
                                                          cfg):
    with pytest.raises(ValueError, match="not registered as custom ops"):
        export(str(tmp_path / "x.npz"), str(tmp_path / "x.pt2"),
               device="cpu", cfg=cfg)
    assert not (tmp_path / "x.pt2").exists()


def test_main_exports_on_the_cpu(tmp_path, capsys):
    """`romp_torch.export ckpt out.pt2 --GPU -1`: the CLI exports on the
    CPU, and its program loads and runs."""
    out = tmp_path / "romp.pt2"
    assert ep.main([str(tmp_path / "missing.npz"), str(out), "--backbone",
                    TINY, "--GPU", "-1"]) == 0
    assert "exported" in capsys.readouterr().out
    model = ep.load_exported(str(out))
    assert model.meta["max_person"] == 8
    res = model(torch.zeros(1, 512, 512, 3))
    assert res["verts"].shape == (1, 8, 6890, 3)
