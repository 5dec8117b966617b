"""Device-time profile of the port's ROMP image path on one GPU
(counterpart of `romp_tpu/utils/profiling.py`).

    python -m romp_tpu_torch.utils.profiling [--out profile.txt]

Full width (HRNet-W32, 512x512, V = 6890) with seeded random weights
(BatchNorm calibrated, `calibrate_batchnorm`) and synthetic SMPL assets.
For the mixed path (the CLI default) with `fuse_chains` off and on, at
batch 1 and 64, it runs `RompPipeline` under `torch.profiler` (CPU + CUDA
activities) after warm-up calls and prints, per configuration:
- wall ms per call: host clock around the profiled calls, ended by
  `torch.cuda.synchronize()`;
- device busy ms per call: the union of the device-side events' intervals
  (kernels, copies, memsets);
- the idle share, 1 - busy / wall, and the kernels launched per call;
- the busy time split by kind of kernel.
With --out, the profiler's op tables go to that file.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from romp_tpu_torch.models.romp import (
    RompNet, calibrate_batchnorm, init_romp_params,
)
from romp_tpu_torch.pipeline.romp_pipeline import RompConfig, RompPipeline
from romp_tpu_torch.smpl.body_model import SmplModel, synthetic_assets

# kind of kernel -> substrings of its name; the first match wins
KINDS = (
    ("skinning kernel", ("skinning_kernel",)),
    ("chain kernel", ("conv3x3_bn_act_kernel",)),
    ("batch norm", ("bn_fw", "batch_norm")),
    ("conv (cuDNN / cuBLAS)", ("conv", "gemm", "xmma", "cutlass", "cudnn")),
    ("copies and casts", ("copy", "Memcpy")),
)
OTHER = "other elementwise / reduce"
NOT_DEVICE_WORK = ("Command Buffer Full",)   # a launch-queue marker


def kind_of(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return OTHER


def busy_us(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def seeded_params(seed: int = 0) -> Dict[str, torch.Tensor]:
    """Full-width ROMP weights: seeded He-normal init (`init_romp_params`),
    BatchNorm statistics calibrated on one seeded random 512x512 batch."""
    net = RompNet()
    net.load_state_dict(init_romp_params(torch.Generator().manual_seed(seed)))
    calibrate_batchnorm(net, torch.from_numpy(np.random.RandomState(
        seed + 9).rand(2, 512, 512, 3).astype(np.float32) * 255.0))
    return net.state_dict()


def profile_config(pipe: RompPipeline, batch: int, calls: int,
                   warmup: int = 3) -> Tuple[dict, str]:
    images = (np.random.RandomState(batch).rand(batch, 512, 512, 3)
              * 255).astype(np.uint8)
    for _ in range(warmup):
        pipe(images)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            pipe(images)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    device = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and e.name not in NOT_DEVICE_WORK]
    by_kind: Dict[str, float] = {}
    for e in device:
        k = kind_of(e.name)
        by_kind[k] = by_kind.get(k, 0.0) + e.time_range.elapsed_us()
    busy_ms = busy_us([(e.time_range.start, e.time_range.end)
                       for e in device]) / 1e3 / calls
    row = dict(compute_dtype=pipe.cfg.compute_dtype,
               fuse_chains=pipe.cfg.fuse_chains, batch=batch, calls=calls,
               wall_ms_per_call=wall_ms, device_busy_ms_per_call=busy_ms,
               idle_share=1.0 - busy_ms / wall_ms,
               kernels_per_call=len(device) / calls,
               busy_ms_per_call_by_kind={
                   k: v / 1e3 / calls for k, v in sorted(
                       by_kind.items(), key=lambda kv: -kv[1])})
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=30)
    return row, table


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="write the profiler's op tables to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiling: no CUDA device; this profiles the GPU")
    dev = torch.device("cuda", 0)
    params, assets = seeded_params(), synthetic_assets(seed=0)
    tables = []
    for fuse in (False, True):
        cfg = RompConfig(compute_dtype="bfloat16", fuse_chains=fuse)
        pipe = RompPipeline(params, SmplModel(assets), cfg, dev)
        for batch, calls in ((1, 10), (64, 3)):
            row, table = profile_config(pipe, batch, calls)
            print(json.dumps(row), flush=True)
            tables.append(f"== fuse_chains={fuse} batch={batch}\n{table}")
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n\n".join(tables))


if __name__ == "__main__":
    main()
