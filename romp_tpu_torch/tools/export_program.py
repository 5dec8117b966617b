"""Model export through `torch.export`: a saved ExportedProgram of ROMP or
BEV inference (counterpart of `romp_tpu/tools/export_stablehlo.py`, which
serializes the jitted inference function to StableHLO with `jax.export`).

The program is `romp_inference` / `bev_inference` traced into one graph,
with the network's weights and the SMPL tensors as its state and the
skinning kernel as the custom op `romp_tpu_torch::skinning`
(`ops/lbs.py`), saved with `torch.export.save` as a `.pt2` file. Beside
the graph the file holds the configuration's name, batch, input size and
compute dtype: `load_exported` runs the program under the same precision
flags as the pipeline (`precision_flags`), which a graph does not record.

    python -m romp_tpu_torch.tools.export_program ckpt.npz romp.pt2 \\
        --model romp [--GPU -1]

The configurations are the JAX tool's: `RompConfig(max_person, backbone)`
and `BevConfig(max_person, input_size)`, f32 compute, `fuse_chains` off,
synthetic SMPL (ROMP) and SMPL+A from two synthetic models (BEV). The
fused chain and the bf16-activation path call kernels that are not custom
ops yet; `export_romp` / `export_bev` refuse such a config.
"""
from __future__ import annotations

import argparse
import json
import sys
import types
from typing import Dict, Optional

import torch
import torch.nn as nn

from romp_tpu_torch.cli.common import (
    device_from_flag, load_checkpoint_flexible,
)
from romp_tpu_torch.pipeline.bev_pipeline import (
    BevConfig, BevPipeline, bev_inference,
)
from romp_tpu_torch.pipeline.romp_pipeline import (
    RompConfig, RompPipeline, precision_flags, romp_inference,
)
from romp_tpu_torch.smpl.body_model import SmplModel, synthetic_assets

# the name of the entry in the .pt2 archive that holds the settings
META = "romp_tpu_torch.json"


class RompProgram(nn.Module):
    """`romp_inference` as one module: the net's weights and the SMPL
    tensors are its parameters and buffers, so the export saves them as
    state rather than as constants."""

    def __init__(self, net: nn.Module, smpl: SmplModel, cfg: RompConfig):
        super().__init__()
        self.net, self.smpl, self.cfg = net, smpl, cfg

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        return romp_inference(self.net, self.smpl, images, self.cfg)


class BevProgram(nn.Module):
    """`bev_inference` as one module (the net, SMPL-A and SMIL)."""

    def __init__(self, net: nn.Module, adult: SmplModel, baby: SmplModel,
                 cfg: BevConfig):
        super().__init__()
        self.net, self.adult, self.baby, self.cfg = net, adult, baby, cfg

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        return bev_inference(self.net, self.adult, self.baby, images,
                             self.cfg)


def _refuse_kernels_without_ops(cfg) -> None:
    if cfg.fuse_chains or cfg.act_dtype != "float32":
        raise ValueError(
            f"export: fuse_chains={cfg.fuse_chains}, act_dtype="
            f"{cfg.act_dtype!r} run the chain / bf16 kernels, which are not "
            "registered as custom ops (only skinning is), so torch.export "
            "cannot trace them; export with fuse_chains=False and "
            "act_dtype='float32'")


def _export(module: nn.Module, cfg, batch: int, out_path: str,
            model: str, device) -> str:
    images = torch.zeros((batch, cfg.input_size, cfg.input_size, 3),
                         dtype=torch.float32, device=device)
    program = torch.export.export(module, (images,))
    meta = {"model": model, "batch": batch, "input_size": cfg.input_size,
            "max_person": cfg.max_person, "compute_dtype": cfg.compute_dtype}
    torch.export.save(program, out_path,
                      extra_files={META: json.dumps(meta)})
    return out_path


def export_romp(checkpoint: str, out_path: str, batch: int = 1,
                backbone: str = "hrnet32", max_person: int = 8, *,
                device="cuda", cfg: Optional[RompConfig] = None) -> str:
    """ROMP inference on (batch, 512, 512, 3) f32 images -> `out_path`.
    `cfg` replaces the default `RompConfig(max_person, backbone)`."""
    from romp_tpu_torch.models.romp import init_romp_params

    cfg = cfg or RompConfig(max_person=max_person, backbone=backbone)
    _refuse_kernels_without_ops(cfg)
    params = load_checkpoint_flexible(
        checkpoint, lambda g: init_romp_params(g, cfg.backbone))
    pipe = RompPipeline(params, SmplModel(synthetic_assets(seed=0)), cfg,
                        device)
    return _export(RompProgram(pipe.net, pipe.smpl, cfg), cfg, batch,
                   out_path, "romp", pipe.device)


def export_bev(checkpoint: str, out_path: str, batch: int = 1,
               max_person: int = 8, input_size: int = 512, *,
               device="cuda", cfg: Optional[BevConfig] = None) -> str:
    """BEV inference with SMPL+A embedded (the JAX tool's second program,
    after the reference's second ONNX graph) -> `out_path`. `cfg` replaces
    the default `BevConfig(max_person, input_size)`."""
    from romp_tpu_torch.models.bev import init_bev_params

    cfg = cfg or BevConfig(max_person=max_person, input_size=input_size)
    _refuse_kernels_without_ops(cfg)
    params = load_checkpoint_flexible(
        checkpoint,
        lambda g: init_bev_params(g, cfg.input_size, cfg.backbone))
    pipe = BevPipeline(params,
                       SmplModel(synthetic_assets(seed=0, num_betas=11)),
                       SmplModel(synthetic_assets(seed=1, num_betas=10)),
                       cfg, device)
    return _export(BevProgram(pipe.net, pipe.smpl_adult, pipe.smpl_baby, cfg),
                   cfg, batch, out_path, "bev", pipe.device)


class ExportedModel:
    """A loaded program: `model(images)` runs it under the precision flags
    of the configuration it was exported with. `program` is the
    ExportedProgram, `meta` the settings saved beside it."""

    def __init__(self, program: torch.export.ExportedProgram, meta: dict):
        self.program, self.meta = program, meta
        self.module = program.module()
        self._flags = types.SimpleNamespace(
            compute_dtype=meta["compute_dtype"])

    def __call__(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        with torch.no_grad(), precision_flags(self._flags):
            return self.module(images)


def load_exported(path: str) -> ExportedModel:
    """Load a program written by `export_romp` / `export_bev`. The op
    modules are imported first, so that its custom ops resolve."""
    import romp_tpu_torch.ops.lbs  # noqa: F401  (registers the ops)

    extra = {META: ""}
    program = torch.export.load(path, extra_files=extra)
    return ExportedModel(program, json.loads(extra[META]))


def main(input_args=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("checkpoint", type=str)
    parser.add_argument("output", type=str)
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--backbone", type=str, default="hrnet32")
    parser.add_argument("--model", type=str, default="romp",
                        choices=("romp", "bev"))
    parser.add_argument("--GPU", type=int, default=0,
                        help="CUDA device index to export on; -1 the CPU")
    args = parser.parse_args(input_args)
    device = device_from_flag(args.GPU)
    if args.model == "bev":
        out = export_bev(args.checkpoint, args.output, args.batch,
                         device=device)
    else:
        out = export_romp(args.checkpoint, args.output, args.batch,
                          args.backbone, device=device)
    print(f"exported a torch.export program to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
