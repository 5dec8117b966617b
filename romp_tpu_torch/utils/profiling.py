"""Device-time profile of the port's ROMP and BEV image paths and TRACE
video path on one GPU (counterpart of `romp_tpu/utils/profiling.py`).

    python -m romp_tpu_torch.utils.profiling [--path romp|bev|trace|all]
        [--act_dtype float32|bfloat16] [--romp_batches 1 64]
        [--out profile.txt]

Full width (HRNet-W32, 512x512, V = 6890) with seeded random weights
(BatchNorm calibrated, `calibrate_batchnorm`) and synthetic SMPL assets.
ROMP: the mixed path (the CLI default) with `fuse_chains` off and on, at
batch 1 and 64, through `RompPipeline`. BEV: `BevPipeline`, mixed path,
`fuse_chains` off and on, batch 1 and 16 (`seeded_bev_params`). TRACE:
`TracePipeline` with the CLI's defaults (64 slots, center_thresh 0.1), one
call being a stream of four 8-frame clips through `process_stream`: with
zero flow, mixed path and f32, and with RAFT's flow (seeded RAFT weights,
the CLI's defaults: 512x512, 20 iterations, bf16, sequence form), mixed.
`--act_dtype bfloat16` runs every configuration with bf16 activations
instead (TRACE's f32 one is then left out: JAX refuses bf16 activations
of f32 convs). Each runs under `torch.profiler` (CPU + CUDA activities) after warm-up
calls and prints, per configuration:
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
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from romp_tpu_torch.models.bev import (
    BevNet, calibrate_bev_batchnorm, init_bev_params,
)
from romp_tpu_torch.models.raft import init_raft_params, make_trace_flow_fn
from romp_tpu_torch.models.romp import (
    RompNet, calibrate_batchnorm, init_romp_params,
)
from romp_tpu_torch.models.trace import (
    TraceNet, calibrate_trace_batchnorm, init_trace_params,
)
from romp_tpu_torch.pipeline.bev_pipeline import BevConfig, BevPipeline
from romp_tpu_torch.pipeline.romp_pipeline import RompConfig, RompPipeline
from romp_tpu_torch.pipeline.trace_pipeline import TraceConfig, TracePipeline
from romp_tpu_torch.smpl.body_model import SmplModel, synthetic_assets

# kind of kernel -> substrings of its name; the first match wins
KINDS = (
    ("skinning kernel", ("skinning_tf32_kernel",)),
    ("skinning backward kernel", ("skinning_bwd_",)),
    ("deform backward kernel", ("deform_bwd_",)),
    ("deform kernel", ("deform_conv_tf32_kernel", "deform_prep_kernel",
                       "deform_bf16_persistent_kernel")),
    ("chain kernel", ("conv3x3_bn_act_mma_kernel", "ksplit_reduce_kernel",
                      "nchw_to_nhwc_bf16_kernel", "chain_block_bf16_kernel")),
    ("batch norm", ("bn_fw", "batch_norm")),
    ("conv (cuDNN / cuBLAS)", ("conv", "gemm", "xmma", "cutlass", "cudnn",
                               "fft", "pointwise_mult_and_sum_complex")),
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


def seeded_trace_params(seed: int = 0, clip_length: int = 8,
                        device="cuda") -> Dict[str, torch.Tensor]:
    """Full-width TRACE weights (HRNet-W32 backbone + head, 128x128 maps):
    the backbone of `seeded_params`, a seeded head (`init_trace_params`)
    whose BatchNorm statistics are calibrated on one seeded random clip of
    clip_length 512x512 frames (`calibrate_trace_batchnorm`), on `device`.
    Returned on the CPU."""
    params = init_trace_params(torch.Generator().manual_seed(seed),
                               clip_length)
    params.update({k: v for k, v in seeded_params(seed).items()
                   if k.startswith("backbone.")})
    net = TraceNet()
    net.load_state_dict(params)
    net = net.to(device).eval()
    frames = torch.from_numpy((np.random.RandomState(seed + 11).rand(
        clip_length, 512, 512, 3) * 255).astype(np.uint8)).to(device)
    with torch.no_grad():
        feats = net.extract_features(frames)
        calibrate_trace_batchnorm(net, torch.cat([feats[:1], feats]),
                                  clip_length)
    return {k: v.cpu() for k, v in net.state_dict().items()}


def seeded_bev_params(seed: int = 0, device="cuda"
                      ) -> Dict[str, torch.Tensor]:
    """Full-width BEV weights (HRNet-W32, 512x512, 128x128x64 maps): a
    seeded init (`init_bev_params`) whose BatchNorm statistics, backbone's
    included, are calibrated on one seeded random batch of two 512x512
    images (`calibrate_bev_batchnorm`), on `device`. Returned on the CPU."""
    net = BevNet()
    net.load_state_dict(init_bev_params(torch.Generator().manual_seed(seed)))
    net = net.to(device)
    images = torch.from_numpy((np.random.RandomState(seed + 13).rand(
        2, 512, 512, 3) * 255).astype(np.uint8)).to(device)
    calibrate_bev_batchnorm(net, images)
    return {k: v.cpu() for k, v in net.state_dict().items()}


def seeded_raft_flow_fn(seed: int = 0, device="cuda"):
    """The trace2 CLI's flow function on seeded RAFT weights
    (`init_raft_params`): 20 iterations at 512x512, bf16, sequence form."""
    return make_trace_flow_fn(
        init_raft_params(torch.Generator().manual_seed(seed)), iters=20,
        compute_dtype="bfloat16", flow_input_size=512, sequence=True,
        device=device)


def profile_config(pipe, batch: int, calls: int,
                   warmup: int = 3) -> Tuple[dict, str]:
    images = (np.random.RandomState(batch).rand(batch, 512, 512, 3)
              * 255).astype(np.uint8)
    row, table = device_profile(lambda: pipe(images), calls, warmup)
    return dict(compute_dtype=pipe.cfg.compute_dtype,
                act_dtype=pipe.cfg.act_dtype,
                fuse_chains=pipe.cfg.fuse_chains, batch=batch,
                **row), table


def profile_trace(pipe: TracePipeline, calls: int = 2, clips: int = 4,
                  warmup: int = 1) -> Tuple[dict, str]:
    """One call: a stream of `clips` 8-frame clips through process_stream
    (the tracker state carries on from call to call)."""
    rng = np.random.RandomState(7)
    frames = [(rng.rand(8, 512, 512, 3) * 255).astype(np.uint8)
              for _ in range(clips)]

    def stream():
        list(pipe.process_stream(pipe.prefetch(f) for f in frames))

    row, table = device_profile(stream, calls, warmup)
    return dict(compute_dtype=pipe.cfg.compute_dtype,
                act_dtype=pipe.cfg.act_dtype, clips_per_call=clips,
                **row), table


def device_profile(fn, calls: int, warmup: int,
                   table: bool = True) -> Tuple[dict, Optional[str]]:
    """fn() `calls` times under torch.profiler after `warmup` calls: wall
    and device-busy ms, idle share, kernels, busy time by kind, per call;
    and the op table. With table=False only the device is traced and no
    table is made (None): the host then reads a fraction of the events,
    which on a train step's tens of thousands of kernels takes seconds."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    activities = ([ProfilerActivity.CPU, ProfilerActivity.CUDA] if table
                  else [ProfilerActivity.CUDA])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
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
    row = dict(calls=calls, wall_ms_per_call=wall_ms, device_busy_ms_per_call=busy_ms,
               idle_share=1.0 - busy_ms / wall_ms,
               kernels_per_call=len(device) / calls,
               busy_ms_per_call_by_kind={
                   k: v / 1e3 / calls for k, v in sorted(
                       by_kind.items(), key=lambda kv: -kv[1])})
    if not table:
        return row, None
    return row, prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=30)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("romp", "bev", "trace", "all"),
                    default="all")
    ap.add_argument("--act_dtype", choices=("float32", "bfloat16"),
                    default="float32")
    ap.add_argument("--romp_batches", type=int, nargs="+", default=[1, 64])
    ap.add_argument("--out", default=None,
                    help="write the profiler's op tables to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiling: no CUDA device; this profiles the GPU")
    dev = torch.device("cuda", 0)
    tables = []
    act = args.act_dtype
    if args.path in ("romp", "all"):
        params, assets = seeded_params(), synthetic_assets(seed=0)
        for fuse in (False, True):
            cfg = RompConfig(compute_dtype="bfloat16", act_dtype=act,
                             fuse_chains=fuse)
            pipe = RompPipeline(params, SmplModel(assets), cfg, dev)
            for batch in args.romp_batches:
                calls = 10 if batch <= 8 else 3
                row, table = profile_config(pipe, batch, calls)
                print(json.dumps(dict(path="romp", **row)), flush=True)
                tables.append(f"== fuse_chains={fuse} batch={batch}\n{table}")
    adult = SmplModel(synthetic_assets(seed=0, num_betas=11))
    baby = SmplModel(synthetic_assets(seed=1, num_betas=10))
    if args.path in ("bev", "all"):
        params = seeded_bev_params(device=dev)
        for fuse in (False, True):
            cfg = BevConfig(compute_dtype="bfloat16", act_dtype=act,
                            fuse_chains=fuse)
            pipe = BevPipeline(params, adult, baby, cfg, dev)
            for batch, calls in ((1, 10), (16, 3)):
                row, table = profile_config(pipe, batch, calls)
                print(json.dumps(dict(path="bev", **row)), flush=True)
                tables.append(f"== bev fuse_chains={fuse} batch={batch}\n"
                              f"{table}")
    if args.path in ("trace", "all"):
        params = seeded_trace_params(device=dev)
        for dtype, raft in (("bfloat16", False), ("float32", False),
                            ("bfloat16", True)):
            if dtype == "float32" and act == "bfloat16":
                continue
            cfg = TraceConfig(max_person=64, conf_thresh=0.1,
                              compute_dtype=dtype, act_dtype=act)
            pipe = TracePipeline(
                params, adult, baby, cfg, device=dev,
                flow_fn=seeded_raft_flow_fn(device=dev) if raft else None)
            row, table = profile_trace(pipe)
            print(json.dumps(dict(path="trace", raft=raft, **row)),
                  flush=True)
            tables.append(f"== trace compute_dtype={dtype} raft={raft}\n"
                          f"{table}")
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n\n".join(tables))


if __name__ == "__main__":
    main()
