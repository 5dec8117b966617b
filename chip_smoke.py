"""Drive the PyTorch + CUDA port (the ROMP and BEV image paths, the TRACE
video path with and without RAFT's optical flow, serving, the training
of ROMP (also with bf16 activations), TRACE and BEV, 2D-pose pretraining,
evaluation with the accuracy loop, the SMPL family, the PnP solvers,
model export through torch.export, and data parallelism: training as
several ranks, serving over replicas) once on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is nonzero:
 1. device: a CUDA device is required (nothing here runs on the CPU instead);
 2. build: compile the hand-written kernels from romp_tpu_torch/csrc, with
    the chain, skinning and deform kernels' registers, spills and static
    shared memory (ptxas -v), and their dynamic shared memory; fails
    unless the skinning backward fits two CTAs an SM;
 3. kernels: each kernel against its plain PyTorch version at the main
    paths' shapes, with kernel and plain times (CUDA events, medians), the
    kernel's device time (torch.profiler) and the least time the card could
    take (bound; for skinning and the deform read both for the split-TF32
    tensor-core work and, as the CUDA-core kernels were, for f32);
    skinning at N = 64, 512, 1024 and 4096 (the CLI, the train steps,
    batch 16 and batch 64 x 64 slots), forward and backward (the backward
    also twice on the same inputs, bitwise equal), each timed
    through its custom op (`ms`) and through the bare ctypes launch
    (`direct_ms`); the chain at batch 1, 2 and 64 for each branch shape, beside
    the unfused mixed branch it replaces (`unfused_ms`); and a check that
    the SASS of every chain, skinning and deform kernel holds tensor-core
    instructions (HMMA / HGMMA, by cuobjdump); the bf16 variants: the chain
    with bf16 in and out at batch 64 for the four branch shapes (beside the
    unfused bf16-activation branch) and the deform on bf16 features and
    weights at TRACE's shape, each against its plain twin; the deform's
    backward (dx, doffsets, dweight) at the train step's clip (10 frames)
    and the inference batch (8), against its plain twin, with dweight's
    run-to-run equality, dx's spread, each of its kernels' device time and
    the share of dx's contributions that took global atomics;
 4. slices, full width with seeded random weights and synthetic SMPL
    assets. ROMP: HRNet-W32 at 512x512 through the `ROMP` entry point on 4
    images and through `RompPipeline` at batch 16 in four configurations.
    TRACE: the `trace2` CLI's own pipeline (`build_trace_pipeline`, 128x128
    maps, 8-frame clips) on three clips through `process_stream`, mixed
    path and f32 with zero flow, then with a RAFT weights file (the CLI's
    RAFT branch: 512x512, 20 iterations, bf16, sequence form). BEV:
    HRNet-W32 at 512x512 with 128x128x64 3D maps, through the `BEV` entry
    point on 2 images and through `BevPipeline` at batch 1 and 16, mixed
    path, unfused and with `fuse_chains`. Then the bf16-activation mode
    (act_dtype bfloat16): ROMP and BEV at batch 16, unfused and fused, and
    TRACE on three clips. Then training at full width (HRNet-W32,
    512x512, batch 64 x 8 GT persons, the config's defaults: mixed path,
    remat "stage", AdamW): `Trainer.fit` for 4 steps on device-made
    batches, `launch.main` for 2 steps over a seeded 16-image pack, and
    ResNet-50 for 2 steps. Then TRACE's training at the recipe
    (configs/trace.yml: 6 clips x 10 frames, 16 tracks, f32): `launch.main`
    for 1 step over a seeded video pack (the frozen backbone from the
    smoke ROMP weights, RAFT's flow from the smoke RAFT weights), and
    `trace_train_step` for 4 steps on device-made batches. Then BEV's
    training at the v6 recipe (configs/v6_bev.yml: HRNet-W32 at 512x512,
    128x128x64 maps, SMPL+A, 16 GT persons, bf16 compute, lr 5e-5, no
    remat): the largest power-of-two batch up to 64 that fits, then
    `bev_train_step` for 4 steps on device-made batches (skinning
    forward and backward twice a step); 2D-pose pretraining at its recipe
    (configs/pretrain.yml: batch up to 64 x 16 persons, 54 joints, bf16
    compute) for 4 steps and `pretrain.main` for 2 steps over a seeded
    16-image 2D pack; ROMP's training with bf16 activations (the
    defaults plus train.act_dtype=bfloat16) for 4 steps and through
    `launch.main` for 2. Each path's kernel launch counters are zeroed
    just before it and read just after;
 5. card vs CPU: the same weights and inputs through the port on the CPU
    (plain versions) and on the card (kernels), f32 with TF32 off (ROMP,
    TRACE's head, RAFT on one 256x256 pair at 12 iterations, BEV's maps and
    its parameters at the detected slots at batch 1); then the mixed path,
    every conv of the net against the CPU's (ROMP at batches 1, 16 and 64
    and the whole net's maps; TRACE on one 2-frame clip; BEV at batch 1);
    then the bf16-activation path, every conv against the CPU's bf16 conv
    (one bf16 step at no more than 1% of the elements), every fused chain
    against its plain twin and TRACE's deform against its plain twin, on
    the same inputs (ROMP and BEV at batch 1, TRACE on one 2-frame clip);
    then one f32 train step of the full-width HRNet-W32 at batch 2 and
    256x256: losses, BatchNorm updates and every gradient; and one f32
    TRACE train step at full width on 1 clip of 2 frames, likewise; and
    one f32 BEV train step at full width at 128x128, batch 2 x 4, likewise;
 serve: `romp_tpu_torch.serve`'s server (built as `main` builds it) on a
    free port: ROMP at full width, max_batch 8, --precompile, bf16
    activations; `run_batch` once under torch.cuda.set_sync_debug_mode
    ("error"); batch-1 round trips (p50, p99 of 50 sequential requests), a
    burst of 64 requests from 8 client threads (wall time, images/s, the
    realized average batch); then BEV likewise, with one panorama through
    the crowd route;
 6. time: ROMP img/s; TRACE s per 8-frame clip and frames/s at steady state
    through `process_stream`, zero flow and with RAFT, with a per-stage
    split (RAFT's in the synced `flow` stage) and RAFT alone under the
    profiler (device-busy ms and kernels a clip); BEV img/s at batch 16 and
    batch-1 latency, unfused and fused; ROMP img/s at batch 64 with bf16
    activations, unfused and fused; training at the defaults: s a step,
    steps/s and img/s, peak memory, device busy / idle over a profiled
    step beside one forward, and the host syncs of one step; TRACE's
    train step at the recipe: s a step, clips/s and frames/s, peak memory,
    device busy / idle and kernels over a profiled step, the deform
    forward + backward's share, and one clip's peak; and over one clip's
    step, the share of the deform backward's dx contributions that took
    global atomics; BEV's training, pretraining and ROMP's bf16-activation
    training: s a step (the median of steps 3-4), img/s, peak memory,
    device busy / idle over a profiled step (and BEV's skinning forward
    and backward launches and device ms);
 eval: the evaluation metrics on the card (f32) against the same
    functions in f64 on the CPU, and the 3DPW GT SMPL forward
    (`make_gt_smpl_fn`, the skinning kernel) against the CPU's, both to
    1e-5 of max|ref|; then the ROMP accuracy loop at full width
    (`eval.convergence.main`: HRNet-W32 at 512x512 on synthetic scenes,
    batch 8, 4 steps through the Trainer, a checkpoint every 2, each
    restored and scored through `RompPipeline` by the 3DPW collector and
    `pw3d_evaluate` on 12 held-out scenes, then the mixed and
    bf16-activation paths, unfused and fused, against f32 on the last
    checkpoint): the metrics per checkpoint, s a step, and the launches of
    skinning forward and backward and of the chain;
 family: SMPL-X, FLAME and MANO (`smpl/family.py`) on synthetic assets at
    the real shapes, batch 64, the card against the CPU in f32, with both
    wall times;
 pnp: `lm_pnp` 6-DoF and 4-DoF at B = 512 on 24 SMPL joints, and
    `monte_carlo_pnp` (128 samples, 4 iterations) fed the same draws on
    both sides, the card against the CPU in f32, with both wall times;
 export: `export_romp` (HRNet-W32, 512x512) and `export_bev` at batch
    1 on the card, saved under build/, loaded and run: each loaded
    program against eager inference on the same weights, the skinning
    kernel's launches from inside the loaded program (the custom op), the
    export and load seconds, the loaded program's and eager ms.
 dp: data parallelism (`romp_tpu_torch/parallel/mesh.py`): (a) a NCCL
    group of one and `Trainer.fit` for 2 steps at the training defaults as
    rank 0 of 1, against the one-process Trainer on the same state and
    batches (expected bitwise); (b) two rank processes (on cuda:0 over
    gloo; on cuda:0 and cuda:1 over NCCL where there are two cards), each
    on its row of phase 5's f32 train step: their reduced gradients
    bitwise equal, and no further from the f64 CPU gradient than 1.5x the
    one-process card step; each rank's and one process's step time at a
    global batch of 16; (c) a ROMP service over two replicas on cuda:0
    against the one-device service on the same shards, image by image.
    Its launches are the paths `dp-train` ((a) and the ranks of (b)) and
    `dp-serve`.
Then the kernels' JSON line, the card's name and power limit, and the
result line.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from romp_tpu_torch.cli.bev import BEV, bev_settings  # noqa: E402
from romp_tpu_torch.cli.romp import ROMP, romp_settings  # noqa: E402
from romp_tpu_torch.cli.trace import trace_settings  # noqa: E402
from romp_tpu_torch.cli.trace_impl import build_trace_pipeline  # noqa: E402
from romp_tpu_torch.models.bev import (  # noqa: E402
    BevNet, bev_forward_maps, bev_head_maps, bev_regress_params,
    init_bev_params,
)
from romp_tpu_torch.models.hrnet import Branch  # noqa: E402
from romp_tpu_torch.models.romp import (  # noqa: E402
    RompNet, init_romp_params,
)
from romp_tpu_torch.models.layers import (  # noqa: E402
    Conv1d, Conv2d, Conv3d, LayerOpts, cast_bf16, he_normal_,
    record_bn_updates,
)
from romp_tpu_torch.models.raft import (  # noqa: E402
    Raft, init_raft_params, raft_forward,
)
from romp_tpu_torch.models.trace import (  # noqa: E402
    DeformWarp, TraceNet, init_trace_params, trace_cam_anchor,
    trace_forward_maps,
)
from romp_tpu_torch.ops import _build  # noqa: E402
from romp_tpu_torch.ops.centermap import (  # noqa: E402
    nms_heatmap, nms_heatmap3d, parse_centermap3d,
)
from romp_tpu_torch.ops.deform_conv import (  # noqa: E402
    bf16_window_hit_share, bwd_global_share, bwd_plan, deform_bf16_plan,
    deform_conv2d, deform_conv2d_backward, deform_conv2d_bwd_plain,
    deform_conv2d_plain, deform_smem,
)
from romp_tpu_torch.ops.fused_chain import (  # noqa: E402
    basic_chain, basic_chain_plain, bf16_chain_bytes, bf16_chain_plan,
    conv_pass, conv_pass_plain, launch_plan,
)
from romp_tpu_torch.ops import epropnp_mc as tmc  # noqa: E402
from romp_tpu_torch.ops import pnp as tpnp  # noqa: E402
from romp_tpu_torch.ops.rotations import axis_angle_to_matrix  # noqa: E402
from romp_tpu_torch.ops.lbs import (  # noqa: E402
    _skinning_bwd_cuda, _skinning_cuda, skinning, skinning_backward,
    skinning_bwd_plain, skinning_bwd_plan, skinning_plain, skinning_plan,
)
from romp_tpu_torch.pipeline.bev_pipeline import (  # noqa: E402
    BevConfig, BevPipeline,
)
from romp_tpu_torch.pipeline.romp_pipeline import (  # noqa: E402
    RompConfig, RompPipeline, precision_flags,
)
from romp_tpu_torch.pipeline.trace_pipeline import (  # noqa: E402
    TraceConfig, TracePipeline,
)
from romp_tpu_torch.parallel import mesh  # noqa: E402
from romp_tpu_torch.serve import (  # noqa: E402
    InferenceClient, build_server, make_romp_service, serve_args,
)
from romp_tpu_torch.smpl.body_model import (  # noqa: E402
    SmplModel, synthetic_assets,
)
from romp_tpu_torch.smpl import family as tfam  # noqa: E402
from romp_tpu_torch.smpl.body_model import smpl_forward  # noqa: E402
from romp_tpu_torch.tools import export_program as texp  # noqa: E402
from romp_tpu_torch.config import load_config  # noqa: E402
from romp_tpu_torch.train import bev_train_step as tbts  # noqa: E402
from romp_tpu_torch.train import launch as train_launch  # noqa: E402
from romp_tpu_torch.train import pretrain as tpre  # noqa: E402
from romp_tpu_torch.train import trace_train_step as ttts  # noqa: E402
from romp_tpu_torch.train import train_step as tts  # noqa: E402
from romp_tpu_torch.train.data.dataset import (  # noqa: E402
    ImageAnnotation, save_pack,
)
from romp_tpu_torch.train.data.video_dataset import (  # noqa: E402
    VideoSequence, save_video_pack, trans3d_to_czyx,
)
from romp_tpu_torch.train.priors import GmmPrior  # noqa: E402
from romp_tpu_torch.train.trainer import Trainer  # noqa: E402
from romp_tpu_torch.train.trainer import (  # noqa: E402
    train_config as step_config,
)
from romp_tpu_torch.utils.chain_plans import device_events  # noqa: E402
from romp_tpu_torch.utils.kernel_breakdown import (  # noqa: E402
    BWD_PREFIX, kernel_us, warm_clocks,
)
from romp_tpu_torch.utils.profiling import (  # noqa: E402
    device_profile, seeded_bev_params, seeded_params, seeded_trace_params,
)

MIXED = LayerOpts(compute_dtype=torch.bfloat16)
BF16_ACT = LayerOpts(compute_dtype=torch.bfloat16, act_dtype=torch.bfloat16)
BF16_ACT_FUSED = dataclasses.replace(BF16_ACT, fuse_chains=True)
# every kernel variant, as the kernels line names them
KERNELS = ("skinning", "skinning_bwd", "basic_chain", "basic_chain_bf16",
           "basic_chain_bf16_passes", "deform_conv", "deform_conv_bf16",
           "deform_conv_bwd")
BRANCHES = ((32, 128), (64, 64), (128, 32), (256, 16))  # (C, H) at 512x512
CHAIN_BATCHES = (1, 2, 64)   # batch-1 latency, PR 1's rows, offline batch
# the bf16 chain's: the server's batch 8 too
CHAIN_BF16_BATCHES = (1, 2, 8, 64)
# batch x max_person: 1, 16 and 64 x 64; 512 the train steps' (ROMP's 64 x
# 8 GT persons, BEV's 32 x 16 per SMPL+A model)
SKIN_N = (64, 512, 1024, 4096)
SKIN_BWD_N = (64, 512, 1024, 4096)   # training: 64 x 8 GT persons = 512
TRAIN_BATCH, TRAIN_PERSONS = 64, 8   # the config's defaults
# steps of each device-made training run (the median of steps 3-4 is its
# time) and of each launcher run; cut to keep the whole run well inside
# its time limit
TRAIN_STEPS, LAUNCH_STEPS = 4, 2
V = 6890
DEFORM = dict(B=8, C=32, H=128, W=128, G=8, Cout=32)   # TRACE's warp
TRACE_CLIP = 8
# configs/trace.yml: clips a step, frames a clip, supervised tracks
TRACE_TRAIN_CLIPS, TRACE_TRAIN_T, TRACE_TRAIN_N = 6, 10, 16
TRACE_TRAIN_STEPS = TRAIN_STEPS
# launch.main's TRACE steps (each runs RAFT and the backbone per clip)
TRACE_LAUNCH_STEPS = 1
# H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12


T0 = time.perf_counter()


def phase(n, title, **fields):
    """One phase line, with the seconds since the script started."""
    fields["elapsed_s"] = time.perf_counter() - T0
    print(f"phase {n} {title}: " + json.dumps(fields), flush=True)


def time_ms(fn, reps=20, warmup=3):
    """Median CUDA-event time of fn() in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_errs(a, b):
    """(max, mean) of |a - b| / max|b|."""
    d = (a.float() - b.float()).abs() / max(float(b.float().abs().max()),
                                            1e-30)
    return float(d.max()), float(d.mean())


def rel_err(a, b):
    return rel_errs(a, b)[0]


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def bound(nbytes, *ops):
    """The least time the card could take: each input read once and each
    output written once at the memory rate, against the operations, each
    (flops, rate) term at the peak rate for its type. A dict of bound_ms,
    bound_by and both times."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(flops / rate for flops, rate in ops) * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes_ms=t_bytes, operations_ms=t_ops)


def split_tf32_bounds(nbytes, products, remainder):
    """Both readings of a split-TF32 kernel's bound: as the kernel works
    (its products three times over at the TF32 rate, the rest in f32), and
    as for a CUDA-core kernel (all of it in f32, `f32_`)."""
    tc = bound(nbytes, (3 * products, TF32_FLOP_PER_S),
               (remainder, F32_FLOP_PER_S))
    f32 = bound(nbytes, (products + remainder, F32_FLOP_PER_S))
    return dict(**tc, **{f"f32_{k}": v for k, v in f32.items()
                         if k != "bytes_ms"})


def device_ms(fn, launches, calls=20, tries=3):
    """Device time of one fn() in ms, from torch.profiler: for each kernel
    name of `launches` (substring -> launches a call), the mean time of its
    kernels times its launches a call. The profiler may miss some of a
    run's kernels, so their count is not read from it, and now and then
    all of one name's: such a run is made again, and after `tries` of them
    the device time is None (a reading, not a check of the kernel)."""
    for _ in range(tries):
        events = device_events(fn, calls)
        us = {key: [e.time_range.elapsed_us() for e in events
                    if key in e.name] for key in launches}
        if all(us.values()):
            return sum(statistics.mean(v) * launches[key]
                       for key, v in us.items()) / 1e3
    missing = sorted(key for key, v in us.items() if not v)
    print(f"device time: the profiler saw no kernel named {missing} in "
          f"{tries} runs", file=sys.stderr)
    return None


def kernel_names(call):
    """The names of the kernels that runs of call() launch, as the
    profiler reports them (empty if it reported none in all its tries)."""
    return sorted({e.name.replace("(anonymous namespace)::", "")
                   .split("(")[0] for e in device_events(call)})


def reset_counts():
    """Every kernel wrapper's launch counter to 0."""
    skinning.launches = conv_pass.launches = deform_conv2d.launches = 0
    skinning_backward.launches = deform_conv2d_backward.launches = 0
    basic_chain.bf16_launches = deform_conv2d.bf16_launches = 0
    basic_chain.bf16_fused_launches = 0


def launch_counts():
    """Launches per kernel variant since reset_counts (the f32 variants'
    counters include their bf16 variants' launches: those are taken out;
    the bf16 chain's are its fused block kernel's and its passes')."""
    return {"skinning": skinning.launches,
            "skinning_bwd": skinning_backward.launches,
            "basic_chain": conv_pass.launches - basic_chain.bf16_launches,
            "basic_chain_bf16": basic_chain.bf16_fused_launches,
            "basic_chain_bf16_passes": (basic_chain.bf16_launches
                                        - basic_chain.bf16_fused_launches),
            "deform_conv": (deform_conv2d.launches
                            - deform_conv2d.bf16_launches),
            "deform_conv_bf16": deform_conv2d.bf16_launches,
            "deform_conv_bwd": deform_conv2d_backward.launches}


def skinning_bwd_occupancy():
    """CTAs of the skinning backward's segment kernel that fit one SM at
    once (the CUDA occupancy calculator): two, as its plan assumes."""
    ctas = ctypes.c_int(0)
    _build.check(_build.load().romp_skinning_bwd_occupancy(ctypes.byref(ctas)),
                 "romp_skinning_bwd_occupancy")
    check(ctas.value >= 2, f"skinning backward: {ctas.value} CTA an SM")
    return ctas.value


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def phase_kernels(dev):
    warm_clocks(dev)      # the card idled through the build
    g = torch.Generator().manual_seed(0)
    rows = {"skinning": [], "basic_chain": [], "deform_conv": []}
    for n in SKIN_N:
        a16 = torch.randn(n, 16, 24, generator=g).to(dev)
        w = torch.rand(V, 24, generator=g).to(dev)
        w /= w.sum(1, keepdim=True)
        vpos = torch.randn(n, 3, V, generator=g).to(dev)
        out = skinning(a16, w, vpos)
        ref = skinning_plain(a16, w, vpos)
        torch.cuda.synchronize()
        err = rel_err(out, ref)
        check(err <= 1e-4, f"skinning N={n}: rel err {err}")
        # 12 rows of T16 (24 FMAs each) and the 3x4 apply per (person,
        # vertex); a16, W and v_posed read once, verts written once
        bounds = split_tf32_bounds(
            4 * (n * 16 * 24 + V * 24 + 2 * n * 3 * V),
            n * V * 2 * 12 * 24, n * V * 18)
        rows["skinning"].append(dict(
            shape=f"N={n},V={V}", plan=skinning_plan(n, V)._asdict(),
            max_abs_err=float((out - ref).abs().max()),
            rel_err=err, ms=time_ms(lambda: skinning(a16, w, vpos)),
            direct_ms=time_ms(lambda: _skinning_cuda(a16, w, vpos)),
            device_ms=device_ms(lambda: skinning(a16, w, vpos),
                                {"skinning_tf32_kernel": 1}),
            plain_ms=time_ms(lambda: skinning_plain(a16, w, vpos)),
            **bounds))
    rows["skinning_bwd"] = [skin_bwd_row(dev, g, n) for n in SKIN_BWD_N]
    rows["basic_chain"] = [chain_row(dev, g, B, C, H)
                           for B in CHAIN_BATCHES for C, H in BRANCHES]
    rows["deform_conv"].append(deform_row(dev, g))
    bf16_rows = [chain_bf16_row(dev, g, B, C, H)
                 for B in CHAIN_BF16_BATCHES for C, H in BRANCHES]
    # the fused block kernel's rows and the passes', each its own kernel
    rows["basic_chain_bf16"] = [r for r in bf16_rows if r["plan"]["fused"]]
    rows["basic_chain_bf16_passes"] = [r for r in bf16_rows
                                       if not r["plan"]["fused"]]
    rows["deform_conv_bf16"] = [deform_bf16_row(dev, g)]
    # the train step's clip (T = 10 frames) and the inference batch
    rows["deform_conv_bwd"] = [deform_bwd_row(dev, g, B)
                               for B in (TRACE_TRAIN_T, DEFORM["B"])]
    for name, shapes in rows.items():
        for row in shapes:
            phase(3, f"kernel {name}", **row)
    phase(3, "sass", hmma_instructions=tensor_core_sass())
    return rows


def skin_bwd_row(dev, g, n):
    """The skinning backward kernel (dA16, dv) against
    `skinning_bwd_plain` at n persons, V = 6890: bar 1e-4 of max|ref|,
    the forward's; rows 12-15 of dA16 zero; a second launch on the same
    inputs bitwise equal (no float atomics, partials summed in order)."""
    a16 = torch.randn(n, 16, 24, generator=g).to(dev)
    w = torch.rand(V, 24, generator=g).to(dev)
    w /= w.sum(1, keepdim=True)
    vpos = torch.randn(n, 3, V, generator=g).to(dev)
    cot = torch.randn(n, 3, V, generator=g).to(dev)
    da, dv = skinning_backward(a16, w, vpos, cot)
    da2, dv2 = skinning_backward(a16, w, vpos, cot)
    ra, rv = skinning_bwd_plain(a16, w, vpos, cot)
    torch.cuda.synchronize()
    err = max(rel_err(da, ra), rel_err(dv, rv))
    check(err <= 1e-4, f"skinning backward N={n}: rel err {err}")
    check(not da[:, 12:].any(), f"skinning backward N={n}: rows 12-15")
    check(torch.equal(da, da2) and torch.equal(dv, dv2),
          f"skinning backward N={n}: two launches differ")
    # g and v_posed read and dv written once (the dominant bytes), a16 and W
    # read, dA16 written; the products of T16's 16 rows and dA16's 12 rows
    # with W (24 joints), split TF32, and per (person, vertex) dv's 3 x 3
    # FMAs and the 12 products g[m] * vh[n]
    bounds = split_tf32_bounds(
        4 * (3 * n * 3 * V + n * 16 * 24 * 2 + V * 24),
        n * V * 2 * (16 + 12) * 24, n * V * (18 + 12))
    plan = skinning_bwd_plan(n, V)
    kernels = {"skinning_bwd_segment_kernel": 1}
    if plan.segments > 1:
        kernels["skinning_bwd_sum_kernel"] = 1
    return dict(
        shape=f"N={n},V={V}", plan=plan._asdict(),
        max_abs_err=float(max((da - ra).abs().max(), (dv - rv).abs().max())),
        rel_err=err, bitwise_repeat=True,
        ms=time_ms(lambda: skinning_backward(a16, w, vpos, cot)),
        direct_ms=time_ms(lambda: _skinning_bwd_cuda(a16, w, vpos, cot)),
        device_ms=device_ms(lambda: skinning_backward(a16, w, vpos, cot),
                            kernels),
        plain_ms=time_ms(lambda: skinning_bwd_plain(a16, w, vpos, cot)),
        **bounds)


def seeded_branch(g, C, blocks=4):
    """An HRNet branch (`models/hrnet.py` Branch) of `blocks` BasicBlocks
    with He-normal convs and non-trivial BatchNorm statistics, packed."""
    br = Branch(C, blocks)
    for m in br.modules():
        if isinstance(m, torch.nn.Conv2d):
            he_normal_(m.weight, g)
        elif isinstance(m, torch.nn.BatchNorm2d):
            m.weight.data = 1 + 0.1 * torch.randn(C, generator=g)
            m.bias.data = 0.1 * torch.randn(C, generator=g)
            m.running_mean = 0.1 * torch.randn(C, generator=g)
            m.running_var = 1 + 0.2 * torch.rand(C, generator=g)
    br.pack()
    return br.eval()


def chain_row(dev, g, B, C, H, blocks=4):
    """The chain kernel on a seeded branch's packed operands against its
    plain version, and the unfused mixed branch (what the main path runs
    without `fuse_chains`: cuDNN convs of bf16-rounded operands, BN,
    ReLU, adds) timed under the pipeline's precision flags."""
    br = seeded_branch(g, C, blocks).to(dev)
    w, sc, sh = br.packed_w, br.packed_scale, br.packed_shift
    x = torch.randn(B, C, H, H, generator=g).to(dev)
    # each conv pass on the same input: 5e-4 (tests/test_pallas_fuse.py:62;
    # what is left is f32 summation order). Across passes the bf16
    # rounding of each conv input turns that noise into a bf16 step now
    # and then, and later convs spread it, so the whole chain is held to
    # 5e-3 against the plain chain, and to exactly its passes.
    y, pass_err, pass_abs = x, 0.0, 0.0
    for n in range(blocks):
        h = None
        for j in range(2):
            src, res = (y, None) if j == 0 else (h, y)
            args = (src, w[n, j], sc[n, j], sh[n, j], res)
            out, ref = conv_pass(*args), conv_pass_plain(*args)
            pass_err = max(pass_err, rel_err(out, ref))
            pass_abs = max(pass_abs, float((out - ref).abs().max()))
            h = out
        y = h
    full = basic_chain(x, w, sc, sh, blocks)
    chain_err = rel_err(full, basic_chain_plain(x, w, sc, sh, blocks))
    shape = f"B={B},C={C},H=W={H},blocks={blocks}"
    check(pass_err <= 5e-4, f"chain {shape}: pass rel err {pass_err}")
    check(torch.equal(full, y), f"chain {shape}: chain != its passes")
    check(chain_err <= 5e-3, f"chain {shape}: chain rel err {chain_err}")
    # 8 bf16 3x3 convs; x read once, the chain's output written once,
    # the packed weights and BN scale / shift read once
    bounds = bound(
        4 * 2 * x.numel() + 2 * w.numel() + 4 * (sc.numel() + sh.numel()),
        (blocks * 2 * 2 * x.numel() * 9 * C, BF16_FLOP_PER_S))
    with torch.inference_mode(), precision_flags(
            RompConfig(compute_dtype="bfloat16")):
        unfused_ms = time_ms(lambda: br(x, MIXED))
    plan = launch_plan(B, C, H, H)
    kernels = {"conv3x3_bn_act_mma_kernel": 2 * blocks,
               "nchw_to_nhwc_bf16_kernel": 1}
    if plan.ksplit > 1:
        kernels["ksplit_reduce_kernel"] = 2 * blocks
    return dict(
        shape=shape, batch=B, plan=plan._asdict(),
        max_abs_err=pass_abs, rel_err=pass_err, chain_rel_err=chain_err,
        **bounds, ms=time_ms(lambda: basic_chain(x, w, sc, sh, blocks)),
        device_ms=device_ms(lambda: basic_chain(x, w, sc, sh, blocks),
                            kernels),
        plain_ms=time_ms(lambda: basic_chain_plain(x, w, sc, sh, blocks),
                         reps=10 if B > 2 else 20),
        unfused_ms=unfused_ms)


TENSOR_CORE_KERNELS = ("conv3x3_bn_act_mma_kernel", "chain_block_bf16_kernel",
                       "skinning_tf32_kernel",
                       "skinning_bwd_segment_kernel",
                       "deform_conv_tf32_kernel",
                       "deform_bf16_persistent_kernel",
                       "deform_bwd_tf32_kernel")


def tensor_core_sass():
    """Every instantiation of the chain's conv kernel, of the skinning
    kernel and of the deform kernel runs on the tensor cores: its SASS
    (cuobjdump, shipped with nvcc) holds HMMA or HGMMA instructions. Fails,
    and does not skip, without cuobjdump."""
    out = {}
    for name in TENSOR_CORE_KERNELS:
        counts = _build.sass_opcodes(name, ("HMMA", "HGMMA"))
        check(all(n > 0 for n in counts.values()),
              f"{name} without tensor-core instructions: {counts}")
        out.update({demangled(k): n for k, n in counts.items()})
    return out


def demangled(name):
    """The kernel's name and template arguments from a mangled name, as
    'conv3x3_bn_act_mma_kernel<16,64>' or 'chain_block_bf16_kernel<32,16,
    16,float>'; other names as they are."""
    for m in re.finditer(r"\d+", name):
        # the length prefix may follow other digits (a hash in the
        # anonymous namespace's name): try each tail of the digit run
        for k in range(len(m.group())):
            ident = name[m.end():m.end() + int(m.group()[k:])]
            if re.fullmatch(r"[A-Za-z_]\w*_kernel", ident):
                rest = name[m.end() + len(ident):]
                args = re.match(r"I((?:L[ib]\d+E)+)(f|13__nv_bfloat16)?E",
                                rest)
                if args is None:
                    return ident
                vals = re.findall(r'L[ib](\d+)E', args[1])
                if args[2]:   # a type argument last: the block input's
                    vals.append("float" if args[2] == "f" else "bf16")
                return f"{ident}<{','.join(vals)}>"
    return name


def chain_bf16_row(dev, g, B, C, H, blocks=4):
    """The chain's bf16-in / bf16-out variant on a seeded branch's packed
    operands: bit-equal to the f32 kernel on the widened input, rounded
    (the same sums in the same order), bit-equal from one call to the next,
    and within the chain's 5e-3 of max|ref| plus one bf16 step (2^-8) of
    its plain twin; beside the unfused bf16-activation branch (cuDNN bf16
    convs, BN, ReLU, adds in bf16). Where `bf16_chain_plan` fuses (one
    launch a block): a call runs that kernel and nothing else, and
    allocates nothing beside its output and the inner blocks' f32
    outputs."""
    br = seeded_branch(g, C, blocks).to(dev)
    cast_bf16(br)
    w, sc, sh = br.packed_w, br.packed_scale, br.packed_shift
    x = torch.randn(B, C, H, H, generator=g).to(torch.bfloat16).to(dev)
    out = basic_chain(x, w, sc, sh, blocks)
    again = basic_chain(x, w, sc, sh, blocks)
    ref = basic_chain_plain(x, w, sc, sh, blocks)
    f32 = basic_chain(x.float(), w, sc, sh, blocks).to(torch.bfloat16)
    torch.cuda.synchronize()
    shape = f"B={B},C={C},H=W={H},blocks={blocks},bf16"
    check(out.dtype == torch.bfloat16 and torch.equal(out, f32),
          f"chain {shape}: != the f32 chain, rounded")
    check(torch.equal(out, again), f"chain {shape}: two calls differ")
    err = rel_err(out, ref)
    check(err <= 5e-3 + 2.0 ** -8, f"chain {shape}: rel err {err}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = bf16_chain_plan(B, C, H, H, sms)
    call = lambda: basic_chain(x, w, sc, sh, blocks)  # noqa: E731
    if plan.fused:
        kernels = {"chain_block_bf16_kernel": blocks}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        once = call()
        torch.cuda.synchronize()
        extra = (torch.cuda.max_memory_allocated(dev) - base
                 - 2 * once.numel() - 4 * min(blocks - 1, 2) * x.numel())
        check(extra <= 0, f"chain {shape}: {extra} bytes allocated beside "
              "the output and the inner blocks")
        del once
        names = kernel_names(call)
        check(names and all("chain_block_bf16_kernel" in n for n in names),
              f"chain {shape}: a fused call ran {names}")
    else:
        names = None
        kernels = {"conv3x3_bn_act_mma_kernel": 2 * blocks,
                   "nchw_to_nhwc_bf16_kernel": 1}
        if plan.passes.ksplit > 1:
            kernels["ksplit_reduce_kernel"] = 2 * blocks
    # 8 bf16 3x3 convs; x (bf16) read once, the output (bf16) written once,
    # the packed weights and BN scale / shift read once
    bounds = bound(
        2 * 2 * x.numel() + 2 * w.numel() + 4 * (sc.numel() + sh.numel()),
        (blocks * 2 * 2 * x.numel() * 9 * C, BF16_FLOP_PER_S))
    with torch.inference_mode(), precision_flags(
            RompConfig(compute_dtype="bfloat16", act_dtype="bfloat16")):
        unfused_ms = time_ms(lambda: br(x, BF16_ACT))
    return dict(
        shape=shape, batch=B,
        plan={k: v for k, v in plan._asdict().items() if k != "passes"},
        passes_plan=plan.passes._asdict() if plan.passes else None,
        bytes_per_element=bf16_chain_bytes(plan, blocks),
        kernels_a_call=names, bitwise_repeat=True,
        max_abs_err=float((out.float() - ref.float()).abs().max()),
        rel_err=err, **bounds,
        ms=time_ms(call),
        device_ms=device_ms(call, kernels),
        # the plain twin at the kernels line's batch and PR 1's only
        plain_ms=(time_ms(lambda: basic_chain_plain(x, w, sc, sh, blocks),
                          reps=10 if B > 2 else 20)
                  if B in (2, 64) else None),
        unfused_ms=unfused_ms)


BF16_KERNEL = "deform_bf16_persistent_kernel"


def deform_bf16_row(dev, g):
    """The deform's bf16 variant (bf16 x and weight, f32 offsets, f32 out)
    at TRACE's shape against its plain twin (the same rounding points, so
    f32 summation order: 1e-4 of max|ref|) with offsets N(0, 2^2) (the
    timed case), N(0, 24^2) (far outside the x window and the image:
    corners from device memory) and zero; with zero offsets also against
    F.conv2d of the same bf16 values in f32 (TF32 off). One launch a
    call: a profiled call runs the one kernel and nothing else, and the
    call allocates nothing beside its output. The share of the samples
    whose corners the kernel read from its x window."""
    B, C, H, W, G, Cout = (DEFORM[k] for k in ("B", "C", "H", "W", "G",
                                               "Cout"))
    x = torch.randn(B, C, H, W, generator=g).to(torch.bfloat16).to(dev)
    off = (torch.randn(B, G * 18, H, W, generator=g) * 2.0).to(dev)
    w = (torch.randn(Cout, C, 3, 3, generator=g) * 0.1).to(
        torch.bfloat16).to(dev)
    far = (torch.randn(B, G * 18, H, W, generator=g) * 24.0).to(dev)
    errs = {}
    for name, o in (("sigma2", off), ("sigma24", far),
                    ("zero", torch.zeros_like(off))):
        got = deform_conv2d(x, o, w, G)
        ref = deform_conv2d_plain(x, o, w, G)
        torch.cuda.synchronize()
        check(got.dtype == torch.float32, f"deform bf16: {got.dtype} out")
        errs[name] = rel_err(got, ref)
        if name == "sigma2":
            out, max_abs = got, float((got - ref).abs().max())
    check(max(errs.values()) <= 1e-4, f"deform bf16: rel errs {errs}")
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        conv = F.conv2d(x.float(), w.float(), padding=1)
    zero_err = rel_err(deform_conv2d(x, torch.zeros_like(off), w, G), conv)
    check(zero_err <= 1e-4, f"deform bf16 zero offsets vs conv2d: {zero_err}")
    call = lambda: deform_conv2d(x, off, w, G)  # noqa: E731
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    once = call()
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated(dev) - base - 4 * once.numel()
    check(extra == 0, f"deform bf16: {extra} bytes allocated beside the "
          "output")
    names = kernel_names(call)
    check(len(names) == 1 and BF16_KERNEL in names[0],
          f"deform bf16: a call ran {names}")
    del once
    # x (bf16) and offsets read once, the f32 output written once; per
    # output pixel, group and tap the bf16 products of the contraction, and
    # the three bilinear blends of Cg channels (3 FLOP each) in f32
    bounds = bound(
        2 * x.numel() + 4 * off.numel() + 2 * w.numel() + 4 * out.numel(),
        (B * H * W * 9 * C * 2 * Cout, BF16_FLOP_PER_S),
        (B * H * W * 9 * C * 9, F32_FLOP_PER_S))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return dict(
        shape=f"B={B},C={C},H=W={H},G={G},Cout={Cout},bf16",
        max_abs_err=max_abs, rel_err=errs["sigma2"], rel_errs=errs,
        zero_offset_rel_err=zero_err, kernels_a_call=names,
        plan=deform_bf16_plan(B, C, H, W, G, Cout, sms),
        window_hit_share=bf16_window_hit_share(off, G),
        window_hit_share_sigma24=bf16_window_hit_share(far, G),
        ms=time_ms(call),
        device_ms=device_ms(call, {BF16_KERNEL: 1}),
        plain_ms=time_ms(lambda: deform_conv2d_plain(x, off, w, G), reps=10),
        **bounds)


def deform_row(dev, g):
    """The deform kernel at TRACE's shape against its plain version, with
    random offsets (sigma 2, so samples cross the border), and with zero
    offsets against F.conv2d (TF32 off). Bar: 1e-4 of max|ref|, f32
    summation order."""
    B, C, H, W, G, Cout = (DEFORM[k] for k in ("B", "C", "H", "W", "G",
                                               "Cout"))
    x = torch.randn(B, C, H, W, generator=g).to(dev)
    off = (torch.randn(B, G * 18, H, W, generator=g) * 2.0).to(dev)
    w = (torch.randn(Cout, C, 3, 3, generator=g) * 0.1).to(dev)
    out = deform_conv2d(x, off, w, G)
    ref = deform_conv2d_plain(x, off, w, G)
    torch.cuda.synchronize()
    err = rel_err(out, ref)
    check(err <= 1e-4, f"deform: rel err {err}")
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        conv = F.conv2d(x, w, padding=1)
    zero_err = rel_err(deform_conv2d(x, torch.zeros_like(off), w, G), conv)
    check(zero_err <= 1e-4, f"deform zero offsets vs conv2d: {zero_err}")
    # x and offsets read once, the output written once; per output pixel,
    # group and tap: a 4-corner bilinear blend of Cg channels (8 FLOP each)
    # and the contraction of the C samples with Cout weights
    bounds = split_tf32_bounds(
        4 * (x.numel() + off.numel() + w.numel() + out.numel()),
        B * H * W * 9 * C * 2 * Cout, B * H * W * 9 * C * 8)
    return dict(
        shape=f"B={B},C={C},H=W={H},G={G},Cout={Cout}",
        max_abs_err=float((out - ref).abs().max()), rel_err=err,
        zero_offset_rel_err=zero_err,
        ms=time_ms(lambda: deform_conv2d(x, off, w, G)),
        # the prologue (x regrouped, weights split) and the kernel
        device_ms=device_ms(lambda: deform_conv2d(x, off, w, G),
                            {"deform_prep_kernel": 1,
                             "deform_conv_tf32_kernel": 1}),
        plain_ms=time_ms(lambda: deform_conv2d_plain(x, off, w, G), reps=10),
        **bounds)


def deform_bwd_row(dev, g, B):
    """The deform backward kernel at TRACE's shape (C = Cout = 32, 128 x
    128, G = 8) for B frames, against `deform_conv2d_bwd_plain`: offsets
    sigma 2 (samples cross the border), a random cotangent. Bar 1e-4 of
    max|ref| for each of dx, doffsets and dweight (f32 sums in another
    order); dweight and doffsets bit-equal over two runs (no float
    atomics), dx's run-to-run spread (its scatter uses atomics); the
    device time of each of its three kernels (prologue, the one pass, the
    ordered reduction of dW) and the share of dx's contributions that
    fell outside the kernel's shared-memory window (global atomics)."""
    C, H, W, G, Cout = (DEFORM[k] for k in ("C", "H", "W", "G", "Cout"))
    x = torch.randn(B, C, H, W, generator=g).to(dev)
    off = (torch.randn(B, G * 18, H, W, generator=g) * 2.0).to(dev)
    w = (torch.randn(Cout, C, 3, 3, generator=g) * 0.1).to(dev)
    gout = torch.randn(B, Cout, H, W, generator=g).to(dev)
    got = deform_conv2d_backward(x, off, w, gout, G)
    again = deform_conv2d_backward(x, off, w, gout, G)
    ref = deform_conv2d_bwd_plain(x, off, w, gout, G)
    torch.cuda.synchronize()
    errs = {name: rel_err(a, r) for name, a, r in
            zip(("dx", "doffsets", "dweight"), got, ref)}
    check(max(errs.values()) <= 1e-4, f"deform backward B={B}: {errs}")
    check(torch.equal(got[2], again[2]) and torch.equal(got[1], again[1]),
          f"deform backward B={B}: dweight / doffsets differ run to run")
    # x, offsets and gout read once, dx, doffsets (and the small dweight)
    # written once; per (pixel, tap, channel) the two contractions with
    # Cout (gcol, dweight: 2 FLOP each), and the bilinear blends and their
    # differences (~22 FLOP). As for the forward, the products are timed
    # at the card's rate for f32-accurate products (split TF32: three
    # times over at the TF32 rate, as the kernel runs them); `f32_` is the
    # CUDA-core reading
    products = B * H * W * 9 * C * Cout * 2
    remainder = B * H * W * 9 * C * 22
    nbytes = 4 * (2 * x.numel() + 2 * off.numel() + 2 * w.numel()
                  + gout.numel())
    call = lambda: deform_conv2d_backward(x, off, w, gout, G)  # noqa: E731
    plan = bwd_plan(B, C, H, W, G, Cout, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    return dict(
        shape=f"B={B},C={C},H=W={H},G={G},Cout={Cout}",
        max_abs_err=float(max((a - r).abs().max() for a, r in zip(got, ref))),
        rel_errs=errs, rel_err=max(errs.values()),
        dweight_bit_equal=True,
        dx_run_to_run_rel_spread=rel_err(again[0], got[0]),
        ms=time_ms(call),
        # the prologue (x regrouped, dx zeroed, W split), the one pass and
        # the ordered reduction of the CTAs' dW partials
        device_ms=device_ms(call, {"deform_bwd_prep_kernel": 1,
                                   "deform_bwd_tf32_kernel": 1,
                                   "deform_bwd_reduce_kernel": 1}),
        device_us_by_kernel=kernel_us(call, BWD_PREFIX),
        plan={k: plan[k] for k in ("ctas", "wrows", "ey", "ex", "dw_smem",
                                   "smem")},
        global_route_share=bwd_global_share(off, G, 1, plan),
        plain_ms=time_ms(lambda: deform_conv2d_bwd_plain(x, off, w, gout, G),
                         reps=5),
        **split_tf32_bounds(nbytes, 2 * products, remainder))


def check_outputs(out, B, K):
    for key, val in out.items():
        check(val.shape[:2] == (B, K), f"{key}: shape {tuple(val.shape)}")
        check(bool(torch.isfinite(val.float()).all()), f"{key}: not finite")


def phase_slice(dev, params, assets, images16):
    # (a) the user's entry point, ROMP(settings)(bgr), with the CLI defaults
    # (mixed path, float16 transfer, 64 slots), reading the seeded weights
    # as a checkpoint file; the missing SMPL file falls back to synthetic
    # assets, and with random weights every slot is taken as a detection
    ckpt = _build.BUILD_DIR / "smoke_weights.pth"
    ckpt.parent.mkdir(parents=True, exist_ok=True)
    torch.save(params, ckpt)
    reset_counts()
    romp = ROMP(romp_settings(["--GPU", str(dev.index or 0),
                               "--model_path", str(ckpt), "--smpl_path", "",
                               "--center_thresh=-1e9"]))
    rng = np.random.RandomState(1)
    t0 = time.perf_counter()
    for h, w in ((480, 640), (720, 1280), (512, 512), (333, 250)):
        res = romp((rng.rand(h, w, 3) * 255).astype(np.uint8))
        check(res is not None and res["verts"].shape == (64, V, 3),
              "ROMP: no result")
        for key, val in res.items():
            check(np.isfinite(val.astype(np.float32)).all(), f"ROMP {key}")
    romp_s = time.perf_counter() - t0
    check(skinning.launches > 0 and conv_pass.launches == 0,
          "ROMP run: launch counts")
    runs = {}
    # (b) the pipeline at batch 16, four configurations
    for dtype in ("float32", "bfloat16"):
        for fuse in (False, True):
            cfg = RompConfig(compute_dtype=dtype, fuse_chains=fuse)
            pipe = RompPipeline(params, SmplModel(assets), cfg, dev)
            s0, c0 = skinning.launches, conv_pass.launches
            check_outputs(pipe(images16), len(images16), cfg.max_person)
            torch.cuda.synchronize()
            ds, dc = skinning.launches - s0, conv_pass.launches - c0
            check(ds > 0, f"{dtype} fuse={fuse}: skinning not launched")
            check((dc > 0) == fuse, f"{dtype} fuse={fuse}: chain launches {dc}")
            runs[f"{dtype}{'+fuse' if fuse else ''}"] = dict(
                skinning=ds, basic_chain=dc)
    launches = launch_counts()
    check(launches["deform_conv"] == 0, "ROMP path launched the deform")
    phase(4, "slice", path="romp", romp_4_images_s=romp_s,
          pipeline_runs=runs, launches=launches)
    return launches


def trace_clips(n, seed):
    rng = np.random.RandomState(seed)
    return [(rng.rand(TRACE_CLIP, 512, 512, 3) * 255).astype(np.uint8)
            for _ in range(n)]


def trace_pipe(dev, ckpt, compute_dtype, raft_ckpt=""):
    """The trace2 CLI's own pipeline: its flags and defaults (max_person
    64, center_thresh 0.1, temp_clip_length 8; with a RAFT weights file,
    20 iterations at 512x512, bf16, sequence form), the seeded weights
    file, synthetic SMPL-A and SMIL assets; zero flow without raft_ckpt."""
    return build_trace_pipeline(trace_settings([
        "--GPU", str(dev.index or 0), "--model_path", str(ckpt),
        "--smpl_path", "", "--smil_path", "",
        "--raft_model_path", str(raft_ckpt),
        "--compute_dtype", compute_dtype]))


def record_flows(pipe):
    """Wrap the pipeline's flow function so that each call's flows are
    kept (the list returned)."""
    fn, flows = pipe.flow_fn, []

    def recorded(frames):
        flows.append(fn(frames))
        return flows[-1]
    recorded.takes_sequence = fn.takes_sequence
    pipe.flow_fn = recorded
    return flows


def phase_trace_slice(dev, ckpt):
    """Three 8-frame 512x512 clips through process_stream, on the mixed
    path (the CLI default) and on f32. One deform launch per clip, two
    skinning launches (adult, infant) per clip with tracks."""
    clips = trace_clips(3, 30)
    runs, launches = {}, dict.fromkeys(KERNELS, 0)
    for dtype in ("bfloat16", "float32"):
        pipe = trace_pipe(dev, ckpt, dtype)
        reset_counts()
        outs = list(pipe.process_stream(pipe.prefetch(c) for c in clips))
        torch.cuda.synchronize()
        d, sk = deform_conv2d.launches, skinning.launches
        check(len(outs) == len(clips), f"{dtype}: {len(outs)} results")
        with_tracks = sum(o is not None for o in outs)
        check(with_tracks > 0, f"{dtype}: no clip had tracks")
        check(d == len(clips), f"{dtype}: deform launches {d}")
        check(sk == 2 * with_tracks, f"{dtype}: skinning launches {sk}")
        check(conv_pass.launches == 0, f"{dtype}: chain launched")
        for o in outs:
            if o is None:
                continue
            nt = len(o["track_ids"])
            check(o["verts"].shape == (nt, V, 3)
                  and o["pj2d"].shape == (nt, 71, 2)
                  and o["smpl_thetas"].shape == (nt, 72), "TRACE shapes")
            for key, val in o.items():
                check(np.isfinite(np.asarray(val, np.float32)).all(),
                      f"TRACE {dtype} {key} not finite")
        runs[dtype] = dict(
            deform_conv=d, skinning=sk, clips_with_tracks=with_tracks,
            tracks=[0 if o is None else len(set(o["track_ids"].tolist()))
                    for o in outs])
        for k, n in (("deform_conv", d), ("skinning", sk)):
            launches[k] += n
    phase(4, "slice", path="trace", runs=runs, launches=launches)
    return launches


def phase_trace_raft_slice(dev, ckpt, raft_ckpt):
    """The trace2 CLI's RAFT branch: `build_trace_pipeline` with a seeded
    RAFT weights file, the CLI's defaults (512x512 frames, --flow_size 512,
    20 iterations, bf16 flow, sequence form), mixed path, three 8-frame
    clips through process_stream. Flows finite and not all zero, (8, 128,
    128, 2) a clip; one deform launch a clip, two skinning launches per
    clip with tracks."""
    clips = trace_clips(3, 31)
    pipe = trace_pipe(dev, ckpt, "bfloat16", raft_ckpt)
    check(pipe.flow_fn is not None and pipe.flow_fn.takes_sequence,
          "trace2 did not build RAFT's sequence flow")
    flows = record_flows(pipe)
    reset_counts()
    outs = list(pipe.process_stream(pipe.prefetch(c) for c in clips))
    torch.cuda.synchronize()
    launches = launch_counts()
    with_tracks = sum(o is not None for o in outs)
    check(len(outs) == len(clips) and with_tracks > 0, "RAFT: no tracks")
    check(launches["deform_conv"] == len(clips),
          f"RAFT: deform launches {launches}")
    check(launches["skinning"] == 2 * with_tracks,
          f"RAFT: skinning launches {launches}")
    check(launches["basic_chain"] == 0, "RAFT: chain launched")
    check(len(flows) == len(clips)
          and all(f.shape == (TRACE_CLIP, 128, 128, 2) for f in flows),
          f"RAFT flows {[tuple(f.shape) for f in flows]}")
    for f in flows:
        check(bool(torch.isfinite(f).all()) and float(f.abs().max()) > 0,
              "RAFT flow not finite or all zero")
    for o in outs:
        for key, val in (o or {}).items():
            check(np.isfinite(np.asarray(val, np.float32)).all(),
                  f"TRACE+RAFT {key} not finite")
    phase(4, "slice", path="trace+raft", launches=launches,
          clips_with_tracks=with_tracks,
          flow_max_abs=[float(f.abs().max()) for f in flows],
          flow_mean_abs=[float(f.abs().mean()) for f in flows])
    return launches


def phase_bev_slice(dev, params, adult, baby, images16):
    """(a) the user's entry point, BEV(settings)(bgr), with the CLI
    defaults (mixed path, float16 transfer, 64 slots), reading the seeded
    weights as a checkpoint file, synthetic SMPL-A / SMIL, every slot a
    detection; (b) BevPipeline at batch 1 and 16, mixed path, unfused and
    with fuse_chains. Two skinning launches a call (adult, infant); the
    chain only when fused."""
    ckpt = _build.BUILD_DIR / "smoke_bev_weights.pth"
    torch.save(params, ckpt)
    reset_counts()
    bev = BEV(bev_settings(["--GPU", str(dev.index or 0), "--model_path",
                            str(ckpt), "--smpl_path", "", "--smil_path", "",
                            "--center_thresh=-1e9"]))
    rng = np.random.RandomState(3)
    for h, w in ((480, 640), (512, 512)):
        res = bev((rng.rand(h, w, 3) * 255).astype(np.uint8))
        check(res is not None and res["verts"].shape[1:] == (V, 3),
              "BEV: no result")
        for key, val in res.items():
            check(np.isfinite(np.asarray(val, np.float32)).all(),
                  f"BEV {key}")
    check(skinning.launches == 4 and conv_pass.launches == 0,
          f"BEV entry point launches: {skinning.launches}, "
          f"{conv_pass.launches}")
    runs = {}
    for fuse in (False, True):
        cfg = BevConfig(compute_dtype="bfloat16", fuse_chains=fuse)
        pipe = BevPipeline(params, adult, baby, cfg, dev)
        for batch in (1, 16):
            s0, c0 = skinning.launches, conv_pass.launches
            check_outputs(pipe(images16[:batch]), batch, cfg.max_person)
            torch.cuda.synchronize()
            ds, dc = skinning.launches - s0, conv_pass.launches - c0
            check(ds == 2, f"BEV fuse={fuse} B={batch}: skinning {ds}")
            check((dc > 0) == fuse, f"BEV fuse={fuse}: chain launches {dc}")
            runs[f"bfloat16{'+fuse' if fuse else ''},B={batch}"] = dict(
                skinning=ds, basic_chain=dc)
    launches = launch_counts()
    check(launches["deform_conv"] == 0, "BEV path launched the deform")
    phase(4, "slice", path="bev", pipeline_runs=runs, launches=launches)
    return launches


def phase_bf16_slices(dev, params, assets, images16, bev_params, adult,
                      baby, trace_ckpt):
    """act_dtype=bfloat16: ROMP (RompPipeline) and BEV (BevPipeline) at
    batch 16, unfused and with fuse_chains (the chain's bf16 variant), and
    TRACE (the trace2 CLI's pipeline and settings, zero flow, with bf16
    activations) on three 8-frame clips (the deform's bf16 variant, one
    launch a clip). Counters zeroed before each run and read after it.
    Returns the launches per path."""
    by_path, runs = {}, {}
    for name, make, batch in (
            ("romp", lambda cfg: RompPipeline(params, SmplModel(assets), cfg,
                                              dev), 16),
            ("bev", lambda cfg: BevPipeline(bev_params, adult, baby, cfg,
                                            dev), 16)):
        total = dict.fromkeys(KERNELS, 0)
        for fuse in (False, True):
            Config = RompConfig if name == "romp" else BevConfig
            cfg = Config(compute_dtype="bfloat16", act_dtype="bfloat16",
                         fuse_chains=fuse)
            pipe = make(cfg)
            reset_counts()
            out = pipe(images16[:batch])
            torch.cuda.synchronize()
            c = launch_counts()
            check_outputs(out, batch, cfg.max_person)
            check(c["skinning"] == (1 if name == "romp" else 2),
                  f"{name} bf16 fuse={fuse}: skinning {c}")
            check((c["basic_chain_bf16"] > 0) == fuse
                  and (c["basic_chain_bf16_passes"] > 0) == fuse
                  and c["basic_chain"] == 0 and c["deform_conv"] == 0
                  and c["deform_conv_bf16"] == 0,
                  f"{name} bf16 fuse={fuse}: launches {c}")
            runs[f"{name},bf16-act{'+fuse' if fuse else ''},B={batch}"] = c
            total = {k: total[k] + c[k] for k in KERNELS}
        by_path[f"{name}_bf16"] = total
    base = trace_pipe(dev, trace_ckpt, "bfloat16")
    pipe = TracePipeline(
        torch.load(trace_ckpt, map_location="cpu"), base.smpl_adult,
        base.smpl_baby, dataclasses.replace(base.cfg, act_dtype="bfloat16"),
        base.seq_cfg, device=dev)
    clips = trace_clips(3, 32)
    reset_counts()
    outs = list(pipe.process_stream(pipe.prefetch(c) for c in clips))
    torch.cuda.synchronize()
    c = launch_counts()
    with_tracks = sum(o is not None for o in outs)
    check(len(outs) == len(clips) and with_tracks > 0,
          "TRACE bf16-act: no tracks")
    check(c["deform_conv_bf16"] == len(clips) and c["deform_conv"] == 0,
          f"TRACE bf16-act: deform launches {c}")
    check(c["skinning"] == 2 * with_tracks,
          f"TRACE bf16-act: skinning launches {c}")
    for o in outs:
        for key, val in (o or {}).items():
            check(np.isfinite(np.asarray(val, np.float32)).all(),
                  f"TRACE bf16-act {key} not finite")
    runs["trace,bf16-act,3 clips"] = c
    by_path["trace_bf16"] = c
    phase(4, "slice", path="bf16-act", runs=runs,
          clips_with_tracks=with_tracks, launches=by_path)
    return by_path


def phase_card_vs_cpu(dev, params, assets):
    image = (np.random.RandomState(2).rand(1, 512, 512, 3) * 255).astype(
        np.uint8)
    cpu = RompPipeline(params, SmplModel(assets), RompConfig(), "cpu")
    with torch.inference_mode():
        cmap = nms_heatmap(cpu.net(torch.from_numpy(image))[0][..., 0])
    vals = torch.sort(cmap.reshape(-1), descending=True).values
    # threshold in the widest gap among the top 10 peaks, so that a
    # summation-order difference cannot move a peak across it
    k = int(torch.argmax(vals[1:10] - vals[2:11])) + 1
    cfg = RompConfig(conf_thresh=float(0.5 * (vals[k] + vals[k + 1])),
                     max_person=16)
    cpu = RompPipeline(params, SmplModel(assets), cfg, "cpu")
    gpu = RompPipeline(params, SmplModel(assets), cfg, dev)
    with torch.inference_mode():
        maps_c = cpu.net(torch.from_numpy(image))
        with precision_flags(cfg):            # f32: TF32 off
            maps_g = gpu.net(torch.from_numpy(image).to(dev))
    map_errs = [rel_err(g.cpu(), c) for g, c in zip(maps_g, maps_c)]
    check(max(map_errs) <= 2e-4, f"maps card vs cpu: {map_errs}")
    oc, og = cpu(image), {k: v.cpu() for k, v in gpu(image).items()}
    sc = {tuple(c): i for i, c in enumerate(oc["centers"][0].tolist())
          if oc["mask"][0, i]}
    sg = {tuple(c): i for i, c in enumerate(og["centers"][0].tolist())
          if og["mask"][0, i]}
    check(len(sc) > 0 and set(sc) == set(sg), f"detections {sc} vs {sg}")
    vert_err = max(float((og["verts"][0, sg[c]] - oc["verts"][0, sc[c]])
                         .abs().max()) for c in sc)
    check(vert_err <= 1e-3, f"verts card vs cpu: {vert_err}")

    # the mixed path: every conv of the full-width net, at the batches the
    # slice runs, against the CPU's f32 conv of the same bf16-rounded
    # operands (1e-5 of max|ref|: f32 summation order)
    conv_errs = {}
    for batch in (1, 16, 64):
        images = (np.random.RandomState(20 + batch).rand(
            batch, 512, 512, 3) * 255).astype(np.uint8)
        images[0] = image[0]
        maps_m, conv_errs[batch] = mixed_convs_vs_cpu(
            gpu.net, cpu.net,
            lambda: gpu.net(torch.from_numpy(images).to(dev), MIXED))
        if batch == 1:
            maps_gm = [m.cpu() for m in maps_m]
    # and the whole net. bf16 rounding flips (a value within f32 noise of a
    # rounding boundary) spread through the later layers, and the deep
    # random net amplifies them until they saturate: its mixed and f32 maps
    # differ by about half of max|map|, and the card's mixed maps differ
    # from the CPU's by about half of that (0.51 of it, max and mean, on an
    # H100). So this bar, 0.75 of that distance, holds the whole net to the
    # bf16-noise scale; the per-conv check above is what pins the function.
    with torch.inference_mode():
        maps_cm = cpu.net(torch.from_numpy(image), MIXED)
    mixed_errs, gaps = [], []
    for g, c, f in zip(maps_gm, maps_cm, maps_c):
        mixed_errs.append(rel_errs(g, c))
        gaps.append(rel_errs(f, c))
        check(all(e <= 0.75 * gap for e, gap in zip(mixed_errs[-1], gaps[-1])),
              f"mixed maps card vs cpu {mixed_errs[-1]}, mixed vs f32 {gaps[-1]}")
    phase(5, "card vs cpu", path="romp", map_rel_errs=map_errs,
          detections=len(sc),
          verts_max_abs_err=vert_err, mixed_conv_rel_err_by_batch=conv_errs,
          mixed_map_rel_errs_max_mean=mixed_errs,
          cpu_mixed_vs_f32_max_mean=gaps)


def mixed_convs_vs_cpu(gpu_net, cpu_net, run):
    """Call run(), the card's net on the mixed path, with a hook on every
    conv of gpu_net that holds its output for the first sample against the
    CPU twin's conv of the same input. bf16 operands make every product
    exact in TF32, so the two agree to summation order, as long as cuDNN
    picks an algorithm that multiplies the operands as given (implicit
    GEMM); one that transforms them first (Winograd, FFT) rounds the
    transformed values to TF32 and fails here. Conv2d: 1e-5 of max|ref|.
    Conv1d / Conv3d round their output to bf16 (as the JAX package's do),
    so summation order can move a value across a rounding boundary: one
    bf16 step (8 mantissa bits: up to 2^-7 of max|ref| for a value near
    the max) at no more than 1% of the elements, 1e-5 at the rest.
    Returns run()'s result and the largest errors."""
    cpu_convs = dict(cpu_net.named_modules())
    conv2d_errs, rounded = [], []
    fired = set()

    def hook(name):
        def fn(module, args, out):
            check(len(args) == 2 and args[1] == MIXED,
                  f"{name}: not run as the mixed conv")
            fired.add(name)
            ref = cpu_convs[name](args[0][:1].cpu(), MIXED)
            if isinstance(module, Conv2d):
                conv2d_errs.append(rel_err(out[:1].cpu(), ref))
            else:
                d = (out[:1].cpu() - ref).abs() / max(
                    float(ref.abs().max()), 1e-30)
                rounded.append((float(d.max()),
                                float((d > 1e-5).float().mean())))
        return fn

    hooks = [m.register_forward_hook(hook(n))
             for n, m in gpu_net.named_modules()
             if isinstance(m, (Conv1d, Conv2d, Conv3d))]
    try:
        with torch.inference_mode(), precision_flags(
                RompConfig(compute_dtype="bfloat16")):
            result = run()
    finally:
        for h in hooks:
            h.remove()
    check(len(fired) == len(hooks), f"{len(fired)} of {len(hooks)} convs ran")
    errs = dict(conv2d=max(conv2d_errs),
                rounded=max((e for e, _ in rounded), default=0.0),
                rounded_share_above_1e5=max((f for _, f in rounded),
                                            default=0.0))
    check(errs["conv2d"] <= 1e-5, f"mixed convs card vs cpu: {errs}")
    check(errs["rounded"] <= 2.0 ** -7
          and errs["rounded_share_above_1e5"] <= 0.01,
          f"mixed rounded convs card vs cpu: {errs}")
    return result, errs


def bf16_vs_cpu(gpu_net, cpu_net, run):
    """Call run(), the card's net on the bf16-activation path, with a hook
    on every conv, fused chain and deform warp of gpu_net that holds its
    output for the first sample against the CPU twin module on the same
    input (the CPU's bf16 convs; the chain's and the deform's plain twins).
    A bf16 conv rounds its f32 sum once, so the card and the CPU agree but
    where summation order moves a sum across a rounding boundary: one bf16
    step (2^-7 of max|ref| at most) at no more than 1% of the elements. The
    chain: 5e-3 + 2^-8 of max|ref| (its f32 bar, plus the final rounding);
    the deform: 1e-4 (the same rounding points, f32 summation order).
    Returns run()'s result and the largest errors by kind."""
    cpu_mods = dict(cpu_net.named_modules())
    errs = {"conv_max": 0.0, "conv_share_differing": 0.0, "chain": 0.0,
            "deform": 0.0}
    checked = {"convs": 0, "chains": 0, "deforms": 0}

    def hook(name):
        def fn(module, args, out):
            opts = args[-1]
            check(isinstance(opts, LayerOpts) and opts.bf16_act,
                  f"{name}: not run on the bf16-activation path")
            cpu = cpu_mods[name]
            if isinstance(module, Branch):
                if not opts.fuse_chains:
                    return
                ref = basic_chain_plain(args[0][:1].cpu(), cpu.packed_w,
                                        cpu.packed_scale, cpu.packed_shift,
                                        len(cpu))
                errs["chain"] = max(errs["chain"], rel_err(out[:1].cpu(), ref))
                checked["chains"] += 1
            elif isinstance(module, DeformWarp):
                ref = cpu(args[0][:1].cpu(), args[1][:1].cpu(), opts)
                errs["deform"] = max(errs["deform"],
                                     rel_err(out[:1].cpu(), ref))
                checked["deforms"] += 1
            else:
                ref = cpu(args[0][:1].cpu(), opts)
                check(out.dtype == ref.dtype, f"{name}: {out.dtype}")
                d = (out[:1].cpu().float() - ref.float()).abs() / max(
                    float(ref.float().abs().max()), 1e-30)
                errs["conv_max"] = max(errs["conv_max"], float(d.max()))
                errs["conv_share_differing"] = max(
                    errs["conv_share_differing"], float((d > 0).float().mean()))
                checked["convs"] += 1
        return fn

    hooks = [m.register_forward_hook(hook(n))
             for n, m in gpu_net.named_modules()
             if isinstance(m, (Conv1d, Conv2d, Conv3d, Branch, DeformWarp))]
    try:
        with torch.inference_mode(), precision_flags(
                RompConfig(compute_dtype="bfloat16", act_dtype="bfloat16")):
            result = run()
    finally:
        for h in hooks:
            h.remove()
    check(errs["conv_max"] <= 2.0 ** -7
          and errs["conv_share_differing"] <= 0.01,
          f"bf16 convs card vs cpu: {errs}")
    check(errs["chain"] <= 5e-3 + 2.0 ** -8, f"bf16 chains vs plain: {errs}")
    check(errs["deform"] <= 1e-4, f"bf16 deform vs plain: {errs}")
    return result, dict(errs, **checked)


def phase_bf16_card_vs_cpu(dev, params, bev_params, trace_params):
    """The bf16-activation path, full width: ROMP and BEV at batch 1 (one
    seeded image), unfused (every conv hooked) and fused (every chain
    hooked); TRACE on one 2-frame clip (every conv and the deform hooked).
    The CPU twins get the same weights, cast to bf16 once by cast_bf16."""
    image = torch.from_numpy((np.random.RandomState(90).rand(
        1, 512, 512, 3) * 255).astype(np.uint8))
    out = {}
    for name, Net, fwd in (
            ("romp", RompNet, lambda net, im, o: net(im, o)),
            ("bev", BevNet, lambda net, im, o: bev_forward_maps(net, im, o))):
        nets = []
        for device in ("cpu", dev):
            net = Net()
            net.load_state_dict(params if name == "romp" else bev_params)
            net = net.to(device).eval()
            net.pack_chains()
            nets.append(cast_bf16(net))
        cpu, gpu = nets
        for opts in (BF16_ACT, BF16_ACT_FUSED):
            _, errs = bf16_vs_cpu(gpu, cpu, lambda: fwd(gpu, image.to(dev),
                                                        opts))
            check(errs["convs"] > 0 and (errs["chains"] > 0)
                  == opts.fuse_chains, f"{name} bf16 hooks: {errs}")
            out[f"{name}{'+fuse' if opts.fuse_chains else ''}"] = errs
    frames = torch.from_numpy((np.random.RandomState(91).rand(
        2, 512, 512, 3) * 255).astype(np.uint8))
    nets = []
    for device in ("cpu", dev):
        net = TraceNet()
        net.load_state_dict(trace_params)
        nets.append(cast_bf16(net.to(device).eval()))
    cpu, gpu = nets

    def trace_run():
        feats = gpu.extract_features(frames.to(dev), BF16_ACT)
        feats = torch.cat([feats[:1], feats])
        flows = feats.new_zeros((2, 2) + feats.shape[2:])
        return trace_forward_maps(gpu, feats, flows, None, TRACE_CLIP,
                                  BF16_ACT)[0]
    maps, out["trace"] = bf16_vs_cpu(gpu, cpu, trace_run)
    check(out["trace"]["deforms"] == 1 and out["trace"]["convs"] > 0,
          f"TRACE bf16 hooks: {out['trace']}")
    for field in maps._fields:
        check(bool(torch.isfinite(getattr(maps, field).float()).all()),
              f"TRACE bf16 {field} not finite")
    phase(5, "card vs cpu", path="bf16-act", errs=out)


def phase_trace_card_vs_cpu(dev, params):
    """One 2-frame 512x512 clip (the first frame carried, zero flow): the
    full-width backbone and TRACE head on the CPU (plain versions) and on
    the card (kernels), f32 with TF32 off. The head from the same features
    (the CPU's): its 8 maps within 2e-4 of max|ref| and the same 3D
    detections. The whole chain, backbone included: within 1e-3, because
    the backbone's own card-vs-CPU difference (f32 summation order, about
    1e-4 of max|ref| as on the ROMP path) enters a head that, with random
    weights, amplifies it. Mixed path: every conv against the CPU's."""
    frames = torch.from_numpy((np.random.RandomState(50).rand(
        2, 512, 512, 3) * 255).astype(np.uint8))
    cpu = TraceNet()
    cpu.load_state_dict(params)
    cpu.eval()
    gpu = TraceNet()
    gpu.load_state_dict(params)
    gpu = gpu.to(dev).eval()

    def head_maps(net, feats, opts=LayerOpts()):
        feats = torch.cat([feats[:1], feats])
        flows = feats.new_zeros((2, 2) + feats.shape[2:])
        return trace_forward_maps(net, feats, flows, None, TRACE_CLIP,
                                  opts)[0]

    with torch.inference_mode():
        feats_c = cpu.extract_features(frames)
        maps_c = head_maps(cpu, feats_c)
        with precision_flags(TraceConfig(compute_dtype="float32")):
            feats_g = gpu.extract_features(frames.to(dev))
            maps_same = head_maps(gpu, feats_c.to(dev))
            maps_full = head_maps(gpu, feats_g)
    errs = {kind: {f: rel_err(getattr(maps, f).cpu(), getattr(maps_c, f))
                   for f in maps_c._fields}
            for kind, maps in (("same_features", maps_same),
                               ("whole_chain", maps_full))}
    feat_err = rel_err(feats_g.cpu(), feats_c)
    check(max(errs["same_features"].values()) <= 2e-4,
          f"TRACE head maps card vs cpu {errs['same_features']}")
    check(max(errs["whole_chain"].values()) <= 1e-3,
          f"TRACE maps card vs cpu {errs['whole_chain']}")
    # threshold in the widest gap among the top 10 peaks, so that a
    # summation-order difference cannot move a peak across it
    vals = torch.sort(nms_heatmap3d(maps_c.center_maps_3d).reshape(-1),
                      descending=True).values
    k = int(torch.argmax(vals[1:10] - vals[2:11])) + 1
    thresh = float(0.5 * (vals[k] + vals[k + 1]))
    dets = []
    for maps in (maps_c, maps_same):
        det = parse_centermap3d(maps.center_maps_3d.cpu(), 16, thresh)
        dets.append({(t, *map(int, zyx)) for t in range(det.zyx.shape[0])
                     for zyx, m in zip(det.zyx[t].tolist(), det.mask[t])
                     if m})
    check(len(dets[0]) > 0 and dets[0] == dets[1],
          f"TRACE detections {dets[0]} vs {dets[1]}")
    _, conv_errs = mixed_convs_vs_cpu(
        gpu, cpu, lambda: head_maps(
            gpu, gpu.extract_features(frames.to(dev), MIXED), MIXED))
    phase(5, "card vs cpu", path="trace", feature_rel_err=feat_err,
          map_rel_errs=errs, detections=len(dets[0]),
          mixed_conv_errs=conv_errs)


def smooth_frames(n, size, seed, shift=5):
    """n RGB frames (size x size, [0, 255] f32) of 8x8 blocks plus noise,
    each shifted right by `shift` pixels from the one before."""
    rng = np.random.RandomState(seed)
    base = np.kron(rng.rand(1, size // 8, size // 8, 3),
                   np.ones((1, 8, 8, 1))) * 235.0
    frames = np.concatenate([np.roll(base, shift * t, axis=2)
                             for t in range(n)])
    return torch.from_numpy((frames + rng.rand(n, size, size, 3) * 20.0
                             ).astype(np.float32))


def phase_raft_card_vs_cpu(dev):
    """RAFT in f32 on one 256x256 pair at 12 iterations, seeded weights,
    on the CPU and on the card with TF32 off (convs and the correlation
    matmul): the encoders' features, flow_low and flow_up, each within
    1e-4 of max|ref|."""
    params = init_raft_params(torch.Generator().manual_seed(0))
    cpu = Raft()
    cpu.load_state_dict(params)
    cpu.eval()
    gpu = Raft()
    gpu.load_state_dict(params)
    gpu = gpu.to(dev).eval()
    frames = smooth_frames(2, 256, 60)
    with torch.inference_mode():
        x = 2.0 * frames.permute(0, 3, 1, 2) / 255.0 - 1.0
        feats_c = [cpu.fnet(x), cpu.cnet(x[:1])]
        flows_c = raft_forward(cpu, frames[:1], frames[1:], 12)
        with precision_flags(RompConfig(compute_dtype="float32")):
            xg = x.to(dev)
            feats_g = [gpu.fnet(xg), gpu.cnet(xg[:1])]
            flows_g = raft_forward(gpu, frames[:1].to(dev),
                                   frames[1:].to(dev), 12)
    errs = {name: rel_err(g.cpu(), c) for name, g, c in zip(
        ("fnet", "cnet", "flow_low", "flow_up"), feats_g + list(flows_g),
        feats_c + list(flows_c))}
    check(max(errs.values()) <= 1e-4, f"RAFT card vs cpu {errs}")
    phase(5, "card vs cpu", path="raft", rel_errs=errs,
          flow_up_max_abs=float(flows_c[1].abs().max()))


def phase_bev_card_vs_cpu(dev, params):
    """BEV at 512x512, batch 1, f32 with TF32 off, the CPU (plain
    versions) against the card (kernels). The head from the same features
    (the CPU's backbone's): its 4 maps within 1e-4 of max|ref|, the same 3D
    detections, and the regressed parameters at them within 1e-4. The
    whole chain, backbone included, within 1e-3: the backbone's own
    card-vs-CPU difference (f32 summation order, about 1e-4 of max|ref| on
    the ROMP path) enters a random head that amplifies it. Mixed path:
    every conv against the CPU's."""
    image = torch.from_numpy((np.random.RandomState(70).rand(
        1, 512, 512, 3) * 255).astype(np.uint8))
    cpu = BevNet()
    cpu.load_state_dict(params)
    cpu.eval()
    gpu = BevNet()
    gpu.load_state_dict(params)
    gpu = gpu.to(dev).eval()
    with torch.inference_mode():
        feats_c = cpu.extract_features(image)
        maps_c = bev_head_maps(cpu, feats_c)
        with precision_flags(RompConfig(compute_dtype="float32")):
            feats_g = gpu.extract_features(image.to(dev))
            maps_same = bev_head_maps(gpu, feats_c.to(dev))
            maps_full = bev_head_maps(gpu, feats_g)
    errs = {kind: {f: rel_err(getattr(maps, f).cpu(), getattr(maps_c, f))
                   for f in maps_c._fields}
            for kind, maps in (("same_features", maps_same),
                               ("whole_chain", maps_full))}
    check(max(errs["same_features"].values()) <= 1e-4,
          f"BEV head maps card vs cpu {errs['same_features']}")
    check(max(errs["whole_chain"].values()) <= 1e-3,
          f"BEV maps card vs cpu {errs['whole_chain']}")
    # threshold in the widest gap among the top 10 peaks, so that a
    # summation-order difference cannot move a peak across it
    vals = torch.sort(nms_heatmap3d(maps_c.center_maps_3d).reshape(-1),
                      descending=True).values
    k = int(torch.argmax(vals[1:10] - vals[2:11])) + 1
    thresh = float(0.5 * (vals[k] + vals[k + 1]))
    slots, regs = [], []
    for net, maps in ((cpu, maps_c), (gpu, maps_same)):
        det = parse_centermap3d(maps.center_maps_3d, 16, thresh)
        with torch.inference_mode(), precision_flags(
                RompConfig(compute_dtype="float32")):
            regs.append(bev_regress_params(net, maps, det).cpu())
        slots.append({tuple(map(int, zyx)): i for i, (zyx, m) in enumerate(
            zip(det.zyx[0].tolist(), det.mask[0].tolist())) if m})
    check(len(slots[0]) > 0 and set(slots[0]) == set(slots[1]),
          f"BEV detections {set(slots[0])} vs {set(slots[1])}")
    ref = torch.stack([regs[0][0, i] for i in slots[0].values()])
    got = torch.stack([regs[1][0, slots[1][z]] for z in slots[0]])
    param_err = rel_err(got, ref)
    check(param_err <= 1e-4, f"BEV params card vs cpu {param_err}")
    _, conv_errs = mixed_convs_vs_cpu(
        gpu, cpu, lambda: bev_forward_maps(gpu, image.to(dev), MIXED))
    phase(5, "card vs cpu", path="bev",
          feature_rel_err=rel_err(feats_g.cpu(), feats_c),
          map_rel_errs=errs, detections=len(slots[0]),
          param_rel_err=param_err, mixed_conv_errs=conv_errs)


def sync_debug(batcher, size=512):
    """run_batch once at the largest padded batch under
    torch.cuda.set_sync_debug_mode("error"): a host sync anywhere in the
    dispatch (upload, pipeline, the copies back) raises there. Returns
    "none", or raises with the sync named."""
    images = np.zeros((batcher.sizes[-1], size, size, 3), np.uint8)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        handle = batcher.run_batch(images)
    except RuntimeError as exc:
        raise AssertionError(f"run_batch synchronizes: {exc}") from exc
    finally:
        torch.cuda.set_sync_debug_mode("default")
    batcher.fetch(handle)
    return "none"


def serve_phase(model, ckpt, extra, smi):
    """The server as `python -m romp_tpu_torch.serve` builds it (--GPU 0, a
    free port, full width, max_batch 8, --precompile, bf16 activations,
    the seeded weights file, synthetic SMPL): the sync check, then 50
    sequential batch-1 round trips of a 480x640 image (p50, p99 after 5
    untimed), then a burst of 64 requests from 8 client threads (wall time,
    images/s, the realized average batch from `stats`)."""
    argv = ["--GPU", "0", "--model", model, "--port", "0", "--max_batch",
            "8", "--precompile", "--act_dtype", "bfloat16",
            "--model_path", str(ckpt), "--smpl_path", "", *extra]
    t0 = time.perf_counter()
    server = build_server(serve_args(argv))
    row = dict(model=model, argv=argv, setup_s=time.perf_counter() - t0,
               card=smi)
    try:
        row["sync_debug_run_batch"] = sync_debug(server.batcher)
        rng = np.random.RandomState(100)
        img = (rng.rand(480, 640, 3) * 255).astype(np.uint8)
        client = InferenceClient(port=server.port, timeout=600)
        for _ in range(5):
            client.infer(img)
        lat = []
        for _ in range(50):
            t = time.perf_counter()
            res = client.infer(img)
            lat.append((time.perf_counter() - t) * 1e3)
        check(res["verts"].shape[1:] == (V, 3), f"{model} serve: verts")
        for key, val in res.items():
            check(np.isfinite(val.astype(np.float32)).all(),
                  f"{model} serve: {key} not finite")
        row.update(batch1_ms_p50=float(np.percentile(lat, 50)),
                   batch1_ms_p99=float(np.percentile(lat, 99)),
                   persons_per_image=int(res["verts"].shape[0]))
        s0 = client.stats()
        errors = []

        def burst_client(i):
            try:
                c = InferenceClient(port=server.port, timeout=600)
                for j in range(8):
                    r = c.infer((np.random.RandomState(200 + 8 * i + j).rand(
                        480, 640, 3) * 255).astype(np.uint8))
                    check(np.isfinite(r["cam"]).all(), "burst: cam")
                c.close()
            except Exception as exc:  # noqa: BLE001 — raised below
                errors.append(exc)

        threads = [threading.Thread(target=burst_client, args=(i,))
                   for i in range(8)]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t
        check(not errors, f"{model} burst: {errors}")
        s1 = client.stats()
        items = s1["items_run"] - s0["items_run"]
        batches = s1["batches_run"] - s0["batches_run"]
        check(items == 64, f"{model} burst: {items} items")
        row.update(burst_requests=64, burst_clients=8, burst_wall_s=wall,
                   burst_img_per_s=64 / wall,
                   burst_avg_batch=items / max(batches, 1),
                   stats_after=s1)
        if "--crowd" in extra:
            pano = (rng.rand(512, 1536, 3) * 255).astype(np.uint8)
            t = time.perf_counter()
            res = client.infer(pano)
            row["panorama_ms"] = (time.perf_counter() - t) * 1e3
            s2 = client.stats()
            row["panorama_windows"] = s2["items_run"] - s1["items_run"]
            check(row["panorama_windows"] >= 2, f"crowd route: {s2}")
            row["panorama_persons"] = int(res["cam"].shape[0]) if res else 0
            for key, val in res.items():
                check(np.isfinite(np.asarray(val, np.float32)).all(),
                      f"crowd route: {key} not finite")
        client.close()
    finally:
        server.close()
    return row


def phase_serve(dev, romp_ckpt, bev_ckpt, smi):
    """ROMP, then BEV with the crowd route, behind the server. Returns the
    launches of the whole phase."""
    reset_counts()
    rows = [serve_phase("romp", romp_ckpt, [], smi),
            serve_phase("bev", bev_ckpt, ["--smil_path", "", "--crowd"], smi)]
    torch.cuda.synchronize()
    launches = launch_counts()
    check(launches["skinning"] > 0, f"serving launches {launches}")
    for row in rows:
        phase("serve", row.pop("model"), **row)
    return launches


def phase_time(dev, params, assets, smi):
    rows = []
    for act, fuse in (("float32", False), ("float32", True),
                      ("bfloat16", False), ("bfloat16", True)):
        cfg = RompConfig(compute_dtype="bfloat16", act_dtype=act,
                         fuse_chains=fuse)
        pipe = RompPipeline(params, SmplModel(assets), cfg, dev)
        batches = ((1, 20), (64, 5)) if act == "float32" else ((64, 5),)
        for batch, reps in batches:
            images = (np.random.RandomState(batch).rand(
                batch, 512, 512, 3) * 255).astype(np.uint8)
            for _ in range(2):
                pipe(images)
            torch.cuda.synchronize()
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                pipe(images)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            sec = statistics.median(times)
            rows.append(dict(path="romp", compute_dtype="bfloat16",
                             act_dtype=act, fuse_chains=fuse,
                             batch=batch, median_s=sec, img_per_s=batch / sec,
                             reps=reps, card=smi))
    for row in rows:
        phase(6, "time", **row)
    return rows


def phase_trace_time(dev, ckpt, raft_ckpt, smi):
    """TRACE through process_stream over 8-frame clips (ten with RAFT's
    flow, eight with zero flow): seconds per clip at steady state (the
    median gap between results, past the first two), frames/s; then three
    clips through process_clip with a device barrier after each stage, for
    the split by stage (RAFT's time in `flow`); and RAFT alone on one
    clip's 9 frames under the profiler: wall and device-busy ms, idle share
    and kernels a clip."""
    rows = []
    for dtype, raft in (("bfloat16", True), ("bfloat16", False),
                        ("float32", False)):
        clips = trace_clips(10 if raft else 8, 40)
        pipe = trace_pipe(dev, ckpt, dtype, raft_ckpt if raft else "")
        t0 = time.perf_counter()
        stamps = []
        for _ in pipe.process_stream(pipe.prefetch(c) for c in clips):
            stamps.append(time.perf_counter())
        torch.cuda.synchronize()
        sec = statistics.median(np.diff(stamps)[2:].tolist())
        pipe.reset()
        pipe.profile = True
        for c in clips[:3]:
            pipe.process_clip(c)
        row = dict(
            path="trace", compute_dtype=dtype,
            flow="raft" if raft else "zero", clips=len(clips),
            frames_per_clip=TRACE_CLIP, s_per_clip=sec,
            frames_per_s=TRACE_CLIP / sec, stream_total_s=stamps[-1] - t0,
            stage_ms_per_clip_synced={
                k: v / 3 * 1e3 for k, v in pipe.stage_times.items()},
            card=smi)
        if raft:
            frames = pipe.prefetch(np.concatenate(
                [clips[0][:1], clips[0]]))
            prof, _ = device_profile(lambda: pipe.flow_fn(frames), 3, 1,
                                     table=False)
            row["raft_profile_per_clip"] = prof
        rows.append(row)
    for row in rows:
        phase(6, "time", **row)
    return rows


def phase_bev_time(dev, params, adult, baby, smi):
    """BEV through BevPipeline, mixed path, unfused and fused: median
    seconds a call (host clock, ended by a device barrier) at batch 1
    (latency) and 16 (img/s)."""
    rows = []
    for fuse in (False, True):
        cfg = BevConfig(compute_dtype="bfloat16", fuse_chains=fuse)
        pipe = BevPipeline(params, adult, baby, cfg, dev)
        for batch, reps in ((1, 20), (16, 5)):
            images = (np.random.RandomState(80 + batch).rand(
                batch, 512, 512, 3) * 255).astype(np.uint8)
            for _ in range(2):
                pipe(images)
            torch.cuda.synchronize()
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                pipe(images)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            sec = statistics.median(times)
            rows.append(dict(path="bev", compute_dtype="bfloat16",
                             fuse_chains=fuse, batch=batch, median_s=sec,
                             img_per_s=batch / sec, reps=reps, card=smi))
    for row in rows:
        phase(6, "time", **row)
    return rows


def train_config(ckdir, *overrides):
    """The training config's defaults (`config.py`: HRNet-W32, 512x512,
    batch 64, 8 GT persons, mixed path, f32 activations, remat "stage",
    AdamW lr 3e-4, wd 1e-6, clip 3.0, the synthetic GMM prior) with a
    checkpoint directory under build/ and no validation."""
    cfg = load_config(None, overrides=[f"train.checkpoint_dir={ckdir}",
                                       "train.test_interval=0",
                                       "train.log_every=1", *overrides])
    return cfg


def recorded_fit(trainer, batches, steps):
    """trainer.fit over `steps` batches, keeping each step's packed metrics
    (device tensors, read after the run): a list of dicts."""
    packed, step = [], trainer.step
    trainer.step = lambda b: packed.append(step(b)) or packed[-1]
    trainer.fit(batches, max_steps=steps)
    torch.cuda.synchronize()
    trainer.step = step
    return [dict(zip(trainer._metric_names, p.tolist())) for p in packed]


def check_train_steps(rows, what):
    check(all(np.isfinite(r["total"]) and r["grads_finite"] == 1.0
              for r in rows), f"{what}: a step was not finite: {rows}")
    check(len({r["total"] for r in rows}) > 1, f"{what}: the loss froze")


def write_train_pack(root, n=16, size=512):
    """n seeded images (cv2) and an annotation pack of 1-3 persons each:
    2D keypoints (some unlabelled), 3D keypoints, poses and betas."""
    import cv2

    rng = np.random.RandomState(5)
    (root / "data").mkdir(parents=True, exist_ok=True)
    records = []
    for i in range(n):
        path = root / f"img{i:02d}.jpg"
        cv2.imwrite(str(path), (rng.rand(size, size, 3) * 255).astype(
            np.uint8))
        p = rng.randint(1, 4)
        kp = rng.uniform(40, size - 40, (p, 54, 2)).astype(np.float32)
        kp[:, 40:] = -2.0
        records.append(ImageAnnotation(
            str(path), kp, kp3ds=(rng.randn(p, 54, 3) * 0.3).astype(
                np.float32),
            poses=(rng.randn(p, 66) * 0.3).astype(np.float32),
            betas=(rng.randn(p, 10) * 0.5).astype(np.float32)))
    save_pack(str(root / "data" / "smoke.npz"), records)


def phase_train(dev):
    """Training at full width (HRNet-W32, 512x512, batch 64 x 8 GT persons,
    the config's defaults): Trainer.fit over TRAIN_STEPS device-made batches
    (each step finite, grads_finite 1, the loss moving, skinning's forward
    and backward kernels launched); then the launcher, `launch.main`, over
    a seeded pack of 16 cv2 images (data loading and augmentation
    included) for LAUNCH_STEPS steps; then ResNet-50 for as many. Counters
    zeroed before each and read after it. Returns the launches per path."""
    smpl = SmplModel(synthetic_assets(seed=0), dev)
    by_path, out = {}, {}
    cfg = train_config(_build.BUILD_DIR / "smoke_train")
    check((cfg.train.batch_size, cfg.data.num_person, cfg.model.input_size,
           cfg.train.compute_dtype, cfg.train.act_dtype, cfg.train.remat,
           cfg.model.backbone) == (TRAIN_BATCH, TRAIN_PERSONS, 512,
                                   "bfloat16", "float32", "stage",
                                   "hrnet32"),
          "the training defaults moved")
    trainer = Trainer(cfg, smpl, device=dev)
    reset_counts()
    t0 = time.perf_counter()
    rows = recorded_fit(trainer, (tts.make_synthetic_batch(
        i, TRAIN_BATCH, TRAIN_PERSONS, 512, dev) for i in range(TRAIN_STEPS)),
        TRAIN_STEPS)
    by_path["train"] = launch_counts()
    check(len(rows) == TRAIN_STEPS, "Trainer.fit: steps")
    check_train_steps(rows, "Trainer.fit")
    check(by_path["train"]["skinning"] == TRAIN_STEPS
          and by_path["train"]["skinning_bwd"] == TRAIN_STEPS,
          f"train launches {by_path['train']}")
    out["fit"] = dict(seconds=time.perf_counter() - t0,
                      total=[r["total"] for r in rows],
                      last=rows[-1], launches=by_path["train"])
    del trainer
    # the entry point, with data loading
    root = _build.BUILD_DIR / "smoke_pack"
    write_train_pack(root)
    ck = _build.BUILD_DIR / "smoke_launch"
    log = ck / "train_log.jsonl"
    if log.exists():
        log.unlink()
    reset_counts()
    t0 = time.perf_counter()
    check(train_launch.main(
        ["--data_root", str(root / "data"), "--max_steps",
         str(LAUNCH_STEPS), "--GPU",
         str(dev.index or 0), "data.datasets=smoke",
         f"train.checkpoint_dir={ck}", "train.test_interval=0",
         "train.log_every=1"]) == 0, "launch.main")
    torch.cuda.synchronize()
    by_path["train_launch"] = launch_counts()
    logged = [json.loads(line) for line in log.read_text().splitlines()]
    check([r["step"] for r in logged] == list(range(1, LAUNCH_STEPS + 1))
          and all(r["grads_finite"] == 1.0 and np.isfinite(r["total"])
                  for r in logged), f"launch.main log {logged}")
    check(by_path["train_launch"]["skinning_bwd"] == LAUNCH_STEPS,
          f"launch.main launches {by_path['train_launch']}")
    out["launch"] = dict(seconds=time.perf_counter() - t0, log=logged[-1],
                         launches=by_path["train_launch"])
    # ResNet-50
    cfg = train_config(_build.BUILD_DIR / "smoke_train_resnet",
                       "model.backbone=resnet50")
    trainer = Trainer(cfg, smpl, device=dev)
    reset_counts()
    t0 = time.perf_counter()
    rows = recorded_fit(trainer, (tts.make_synthetic_batch(
        50 + i, TRAIN_BATCH, TRAIN_PERSONS, 512, dev)
        for i in range(LAUNCH_STEPS)), LAUNCH_STEPS)
    by_path["train_resnet50"] = launch_counts()
    check_train_steps(rows, "ResNet-50")
    check(by_path["train_resnet50"]["skinning_bwd"] == LAUNCH_STEPS,
          f"ResNet-50 launches {by_path['train_resnet50']}")
    out["resnet50"] = dict(seconds=time.perf_counter() - t0,
                           total=[r["total"] for r in rows],
                           launches=by_path["train_resnet50"])
    del trainer
    torch.cuda.empty_cache()
    phase(4, "slice", path="train", **out)
    return by_path


def train_grads(net, batch, smpl, cfg, prior):
    """One step's losses, gradients (by name) and BatchNorm updates."""
    net.train()
    updates = record_bn_updates(net)
    ctx = (precision_flags(cfg) if next(net.parameters()).is_cuda
           else contextlib.nullcontext())
    with ctx:
        total, metrics = tts.compute_losses(net, batch, smpl, cfg, prior)
        names = sorted(k for k, _ in net.named_parameters())
        params = dict(net.named_parameters())
        grads = torch.autograd.grad(total, [params[k] for k in names])
    record_bn_updates(net, on=False)
    return ({k: float(v.detach()) for k, v in metrics.items()},
            {k: g.cpu() for k, g in zip(names, grads)},
            {k: v.cpu() for k, v in updates.items()})


def grads_vs_f64(results, what):
    """The card's and the CPU's f32 train step, each against the CPU's f64
    step: results maps "f64", "cpu" and "card" to (losses, gradients by
    name, BatchNorm updates). A random net's f32 step is ill-conditioned
    (train-mode BatchNorm's backward subtracts nearly equal terms), so the
    card is held to be as exact as the CPU: its median and worst gradient
    error at most 2x the CPU's; the losses and BatchNorm updates within
    1e-3 relative. Gradients that are exactly zero in f64 are left out.
    Returns the row to print (after which the checks run)."""
    (lr, gr, ur), (lc, gc, uc), (lg, gg, ug) = (
        results["f64"], results["cpu"], results["card"])
    loss_err = {k: abs(lg[k] - v) / max(abs(v), 1e-3) for k, v in lr.items()}
    bn_err = max(rel_err(ug[k], v) for k, v in ur.items())
    gmax = max(float(v.abs().max()) for v in gr.values())
    card, cpu = {}, {}
    for k, ref in gr.items():
        if float(ref.abs().max()) > 1e-6 * gmax:   # not exactly-zero ones
            card[k] = rel_err(gg.get(k, torch.zeros_like(ref)), ref)
            cpu[k] = rel_err(gc.get(k, torch.zeros_like(ref)), ref)
    worst = sorted(card, key=card.get)[-5:]
    row = dict(loss_rel_errs_vs_f64=loss_err, bn_update_rel_err_vs_f64=bn_err,
               grads=len(card),
               grad_rel_err_vs_f64_median={
                   "card": statistics.median(card.values()),
                   "cpu": statistics.median(cpu.values())},
               grad_rel_err_vs_f64_max={"card": max(card.values()),
                                        "cpu": max(cpu.values())},
               worst_card={k: (card[k], cpu[k]) for k in worst})

    def checks():
        check(max(loss_err.values()) <= 1e-3 and bn_err <= 1e-3,
              f"{what} card vs f64: losses {loss_err}, BN {bn_err}")
        check(row["grad_rel_err_vs_f64_median"]["card"]
              <= 2 * row["grad_rel_err_vs_f64_median"]["cpu"]
              and row["grad_rel_err_vs_f64_max"]["card"]
              <= 2 * row["grad_rel_err_vs_f64_max"]["cpu"],
              f"{what} card vs f64: gradients {row}")
    return row, checks


def train_step_inputs():
    """The f32 train step that phase 5 and the dp phase hold against f64:
    the full-width HRNet-W32's seeded weights, a batch of 2 x 4 persons at
    256x256 (on the CPU), no remat, the synthetic SMPL assets."""
    return (init_romp_params(torch.Generator().manual_seed(3)),
            tts.make_synthetic_batch(3, 2, 4, 256, "cpu"),
            tts.TrainConfig(remat="none"), synthetic_assets(seed=0))


def phase_train_card_vs_cpu(dev):
    """One f32 train step of the full-width HRNet-W32 at batch 2 (256x256:
    the CPU side at 512x512 takes minutes), the same seeded weights and
    batch on the card (TF32 off) and on the CPU, in f32, and on the CPU in
    f64 as the reference. This step is ill-conditioned at random weights
    (train-mode BatchNorm's backward subtracts nearly equal terms): the
    CPU's own f32 gradients are off the f64 ones by 2.5% at the median
    tensor and 12.6% at the worst, so the card's f32 step is held to be as
    exact as the CPU's: against f64, its median and its worst gradient
    error at most 2x the CPU's (measured on an H100: 0.021 and 0.148, 0.85x
    and 1.18x), the losses and BatchNorm updates within 1e-3 relative
    (measured 2.0e-5 and 1.6e-5, as the CPU's). Returns the three steps'
    (losses, gradients, BatchNorm updates)."""
    sd, batch, cfg, assets = train_step_inputs()
    results = {}
    for where, d, dt in (("f64", torch.device("cpu"), torch.float64),
                         ("cpu", torch.device("cpu"), torch.float32),
                         ("card", dev, torch.float32)):
        net = RompNet()
        net.load_state_dict(sd)
        prior = GmmPrior.synthetic()
        results[where] = train_grads(
            net.to(d, dt), {k: v.to(d, dt) if v.is_floating_point()
                            else v.to(d) for k, v in batch.items()},
            SmplModel(assets, d).to(dt), cfg,
            GmmPrior(*(t.to(d, dt) for t in (prior.means, prior.precisions,
                                             prior.nll_weights))))
    row, checks = grads_vs_f64(results, "train")
    phase(5, "card vs cpu", path="train", **row)
    checks()
    return results


def phase_train_time(dev, smi):
    """Training at the defaults (HRNet-W32 512x512, batch 64 x 8, mixed,
    remat "stage"): seconds a step over TRAIN_STEPS device-made batches (host
    clock, each ended by a device barrier; the median of steps 3-4), steps/s
    and images/s, peak device memory; device busy / idle share over a
    profiled step, beside one inference forward of the same net at batch
    64 (mixed, eval mode) for the step-to-forward ratio; one step under
    torch.cuda.set_sync_debug_mode("warn"), its host syncs recorded."""
    import warnings

    smpl = SmplModel(synthetic_assets(seed=0), dev)
    trainer = Trainer(train_config(_build.BUILD_DIR / "smoke_train_time",
                                   "train.tensorboard=false"), smpl,
                      device=dev)
    batches = [tts.make_synthetic_batch(100 + i, TRAIN_BATCH, TRAIN_PERSONS,
                                        512, dev) for i in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for b in batches:
        t0 = time.perf_counter()
        trainer.step(b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    sec = statistics.median(times[2:])
    peak = torch.cuda.max_memory_allocated(dev)
    prof, _ = device_profile(lambda: trainer.step(batches[0]), 1, 1,
                             table=False)
    net = trainer.state.net.eval()
    with torch.no_grad(), precision_flags(RompConfig(
            compute_dtype="bfloat16")):
        fwd, _ = device_profile(lambda: net(batches[0]["image"], MIXED), 3, 1,
                                table=False)
    trainer.state.net.train()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        trainer.step(batches[1])
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = sorted({f"{os.path.relpath(w.filename)}:{w.lineno}"
                    for w in caught
                    if "called a synchronizing" in str(w.message)})
    row = dict(path="train", backbone="hrnet32", batch=TRAIN_BATCH,
               persons=TRAIN_PERSONS, compute_dtype="bfloat16",
               remat="stage", step_s=times, median_step_s=sec,
               steps_per_s=1 / sec, img_per_s=TRAIN_BATCH / sec,
               peak_memory_gb=peak / 1e9, step_profile=prof,
               forward_profile=fwd,
               step_over_forward_device=(prof["device_busy_ms_per_call"]
                                         / fwd["device_busy_ms_per_call"]),
               host_syncs_in_a_step=syncs, card=smi)
    phase(6, "time", **row)
    del trainer
    torch.cuda.empty_cache()
    return row


def write_video_pack(root, n_seq=2, frames=12, size=512, subjects=3):
    """A video pack (`save_video_pack`) of n_seq static-camera sequences of
    seeded cv2 frames, each with `subjects` subjects (subject i appears at
    frame i), their trajectories binned onto the 128 x 128 x 64 grid."""
    import cv2

    rng = np.random.RandomState(6)
    (root / "data").mkdir(parents=True, exist_ok=True)
    seqs = []
    for s in range(n_seq):
        paths = []
        for f in range(frames):
            path = root / f"s{s}_f{f:02d}.jpg"
            cv2.imwrite(str(path), (rng.rand(size, size, 3) * 255).astype(
                np.uint8))
            paths.append(str(path))
        subs = {}
        for sid in range(subjects):
            tr = np.stack([np.linspace(-0.5, 0.5, frames) * (1 + sid),
                           np.full(frames, 0.2 * sid - 0.2),
                           np.full(frames, 3.0 + 2 * sid)], -1).astype(
                np.float32)
            subs[sid] = {
                "valid": np.arange(frames) >= sid,
                "czyx": trans3d_to_czyx(tr, trace_cam_anchor(),
                                        map_size=size // 4),
                "trans3d": tr, "world_trans": tr,
                "world_grot": (rng.randn(frames, 3) * 0.3).astype(
                    np.float32),
                "pose": (rng.randn(frames, 66) * 0.2).astype(np.float32),
                "betas": (rng.randn(frames, 11) * 0.3).astype(np.float32)}
        seqs.append(VideoSequence(paths, subs))
    save_video_pack(str(root / "data" / "smoke_clips.npz"), seqs)


TRACE_LOSSES = ("centermap3d", "motion", "pose", "shape", "world_trans",
                "world_grot", "temp_shape", "total")


def phase_trace_train(dev, raft_ckpt, backbone_ckpt):
    """TRACE's video training at the recipe (configs/trace.yml: HRNet-W32
    frozen backbone at 512x512, 128x128 maps, 6 clips of 10 frames a step,
    16 tracks, f32, lr 3e-5): `launch.main` over a seeded
    video pack of 2 sequences of 12 cv2 frames (frames read, dynamic-camera
    augmentation, the frozen backbone's features from the smoke ROMP
    weights, RAFT's flow from the smoke RAFT weights, all assembled by a
    `PrefetchLoader` worker thread while the main thread steps, with TF32
    held off in both for the run) for TRACE_LAUNCH_STEPS steps; then
    `trace_train_step` for TRACE_TRAIN_STEPS steps on device-made batches,
    each ended by a device barrier (its times are phase 6's). Each step
    finite, the loss moving, the deform's forward and backward kernels
    launched for every clip of every step. Counters zeroed before each run
    and read after it. Returns the launches per path and what phase 6
    reads."""
    by_path, out = {}, {}
    cfg = load_config("configs/trace.yml")
    check((cfg.model.version, cfg.train.batch_size, cfg.trace.clip_length,
           cfg.trace.max_tracks, cfg.model.input_size,
           cfg.train.compute_dtype, cfg.train.lr,
           cfg.trace.use_optical_flow) == (
              "trace", TRACE_TRAIN_CLIPS, TRACE_TRAIN_T, TRACE_TRAIN_N, 512,
              "float32", 3e-5, True), "the TRACE recipe moved")
    root = _build.BUILD_DIR / "smoke_trace_pack"
    write_video_pack(root)
    ck = _build.BUILD_DIR / "smoke_trace_launch"
    log = ck / "trace_train_log.jsonl"
    if log.exists():
        log.unlink()
    reset_counts()
    t0 = time.perf_counter()
    check(train_launch.main(
        ["--config", "configs/trace.yml", "--data_root", str(root / "data"),
         "--max_steps", str(TRACE_LAUNCH_STEPS), "--GPU",
         str(dev.index or 0), "data.datasets=smoke_clips",
         f"train.checkpoint_dir={ck}",
         "train.log_every=1", "train.num_workers=1",
         f"trace.raft_model_path={raft_ckpt}",
         f"trace.backbone_ckpt={backbone_ckpt}"]) == 0, "launch.main trace")
    torch.cuda.synchronize()
    by_path["trace-train"] = n = launch_counts()
    logged = [json.loads(line) for line in log.read_text().splitlines()]
    check([r["step"] for r in logged]
          == list(range(1, TRACE_LAUNCH_STEPS + 1))
          and all(np.isfinite(r[k]) for r in logged for k in TRACE_LOSSES),
          f"trace launch.main log {logged}")
    check((ck / "trace_last.npz").exists(), "trace_last.npz not written")
    per_run = TRACE_LAUNCH_STEPS * TRACE_TRAIN_CLIPS
    check(n["deform_conv_bwd"] == per_run and n["deform_conv"] >= per_run,
          f"trace launch.main launches {n}")
    out["launch"] = dict(seconds=time.perf_counter() - t0, log=logged[-1],
                         launches=n)

    tcfg = train_launch.trace_train_config(cfg)
    head = TraceNet(None)
    head.load_state_dict(init_trace_params(torch.Generator().manual_seed(0),
                                           backbone=None))
    state = ttts.trace_init_train_state(head.to(dev), tcfg)
    batches = [ttts.make_trace_synthetic_batch(
        200 + i, TRACE_TRAIN_CLIPS, TRACE_TRAIN_N, TRACE_TRAIN_T, 128, dev)
        for i in range(TRACE_TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    times, totals = [], []
    for b in batches:
        t0 = time.perf_counter()
        _, m = ttts.trace_train_step(state, b, tcfg)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        totals.append(m["total"])
    by_path["trace-train-step"] = n = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    totals = [float(t) for t in totals]
    check(all(np.isfinite(totals)) and len(set(totals)) > 1,
          f"trace_train_step totals {totals}")
    per_run = TRACE_TRAIN_STEPS * TRACE_TRAIN_CLIPS
    check(n["deform_conv_bwd"] == per_run and n["deform_conv"] >= per_run,
          f"trace_train_step launches {n}")
    out["step"] = dict(steps=TRACE_TRAIN_STEPS, total=totals,
                       seconds=sum(times), launches=n)
    phase(4, "slice", path="trace-train", **out)
    return by_path, dict(state=state, cfg=tcfg, batch=batches[0],
                         times=times, peak=peak)


def trace_train_grads(net, batch, cfg):
    """One TRACE step's losses, gradients (by name) and BatchNorm
    updates."""
    net.train()
    total, (bn, metrics) = ttts.trace_compute_losses(net, batch, cfg)
    params = dict(net.named_parameters())
    names = sorted(params)
    grads = torch.autograd.grad(total, [params[k] for k in names],
                                allow_unused=True)
    return ({k: float(v.detach()) for k, v in metrics.items()},
            {k: g.cpu() for k, g in zip(names, grads) if g is not None},
            {k: v.cpu() for k, v in bn.items()})


def phase_trace_train_card_vs_cpu(dev):
    """One f32 TRACE train step at full width (128x128 maps, 64 depth
    bins, 16 tracks) on 1 clip of 2 frames: the same seeded head and batch
    on the card (the deform's forward and backward kernels, TF32 off) and
    on the CPU in f32 (plain versions), and on the CPU in f64 as the
    reference. As ROMP's step, this one is ill-conditioned at random
    weights (train-mode BatchNorm over 2 frames), so the card's f32 step
    is held to be as exact as the CPU's: against f64, its median and its
    worst gradient error at most 2x the CPU's; the losses and the
    BatchNorm updates within 1e-3 relative."""
    sd = init_trace_params(torch.Generator().manual_seed(4), backbone=None)
    batch = ttts.make_trace_synthetic_batch(4, 1, TRACE_TRAIN_N, 2, 128,
                                            "cpu")
    cfg = ttts.TraceTrainConfig()
    results = {}
    t0 = time.perf_counter()
    for where, d, dt in (("f64", torch.device("cpu"), torch.float64),
                         ("cpu", torch.device("cpu"), torch.float32),
                         ("card", dev, torch.float32)):
        net = TraceNet(None)
        net.load_state_dict(sd)
        b = {k: v.to(d, dt) if v.is_floating_point() else v.to(d)
             for k, v in batch.items()}
        with (precision_flags(cfg) if d.type == "cuda"
              else contextlib.nullcontext()):
            results[where] = trace_train_grads(net.to(d, dt), b, cfg)
    row, checks = grads_vs_f64(results, "trace train")
    phase(5, "card vs cpu", path="trace-train", **row,
          seconds=time.perf_counter() - t0)
    checks()


def phase_trace_train_time(dev, ctx, smi):
    """TRACE's step at the recipe (6 clips x 10 frames, 16 tracks, 128x128
    maps, f32, each clip recomputed in the backward): seconds a step over
    the TRACE_TRAIN_STEPS
    steps of phase 4 (host clock, each ended by a device barrier; the
    median of steps 3-4), clips/s and frames/s, peak device memory; one
    profiled step: device busy / idle share, kernels a step, busy ms by
    kind and the deform forward + backward's share of the busy time; and
    the peak of one clip's step (its activations, all held during its
    backward: why the recipe's 6 clips are recomputed one at a time)."""
    state, cfg, batch, times = (ctx[k] for k in ("state", "cfg", "batch",
                                                 "times"))
    sec = statistics.median(times[2:])
    prof, _ = device_profile(lambda: ttts.trace_train_step(state, batch, cfg),
                             1, 0, table=False)
    kinds = prof["busy_ms_per_call_by_kind"]
    deform_ms = (kinds.get("deform kernel", 0.0)
                 + kinds.get("deform backward kernel", 0.0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ttts.trace_train_step(state, {k: v[:1] for k, v in batch.items()}, cfg)
    torch.cuda.synchronize()
    clip_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    shares = deform_bwd_global_shares(
        state.net, lambda: ttts.trace_train_step(
            state, {k: v[:1] for k, v in batch.items()}, cfg), dev)
    row = dict(path="trace-train", clips=TRACE_TRAIN_CLIPS,
               frames_per_clip=TRACE_TRAIN_T, tracks=TRACE_TRAIN_N,
               compute_dtype=cfg.compute_dtype,
               step_s=times, median_step_s=sec,
               clips_per_s=TRACE_TRAIN_CLIPS / sec,
               frames_per_s=TRACE_TRAIN_CLIPS * TRACE_TRAIN_T / sec,
               peak_memory_gb=ctx["peak"] / 1e9, step_profile=prof,
               deform_fwd_bwd_ms=deform_ms,
               deform_fwd_bwd_share=deform_ms
               / prof["device_busy_ms_per_call"],
               one_clip_peak_gb=clip_peak,
               deform_bwd_global_route_share=dict(
                   mean=statistics.mean(shares), max=max(shares),
                   calls=len(shares)),
               card=smi)
    phase(6, "time", **row)
    return row


def deform_bwd_global_shares(net, step, dev):
    """Run step() and, for each call of the net's deform warp, the share of
    the deform backward's dx contributions that take the global route
    (`bwd_global_share` of the offsets the warp is given, which
    `_DeformConv2d` saves for the backward)."""
    shares = []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def record(module, args):
        x, offsets = args[0], args[1]
        plan = bwd_plan(*x.shape, DEFORM["G"], module.weight.shape[0], sms)
        shares.append(bwd_global_share(offsets.detach().float(),
                                       DEFORM["G"], 1, plan))

    hook = net.deform_warper.register_forward_pre_hook(record)
    try:
        step()
        torch.cuda.synchronize()
    finally:
        hook.remove()
    check(shares, "trace train: no deform warp in the recorded step")
    return shares


# configs/v6_bev.yml and configs/pretrain.yml: batch, GT persons an image
BEV_TRAIN_BATCH, BEV_TRAIN_PERSONS = 64, 16
PRETRAIN_BATCH, PRETRAIN_PERSONS = 64, 16
NEW_TRAIN_STEPS = TRAIN_STEPS


def largest_fitting_batch(step, batch):
    """The largest power of two <= batch at which step(b) runs on the card
    (JAX's BEV and pretraining steps recompute nothing, so their recipes'
    batch may not fit in 80 GB): tries batch, halves it after an
    out-of-memory error. Returns (that batch, the batches that did not
    fit). Any other error is raised."""
    refused = []
    while True:
        oom = False
        try:
            step(batch)
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError:
            oom = True           # freed below, outside the handler's frame
        if not oom:
            return batch, refused
        refused.append(batch)
        gc.collect()
        torch.cuda.empty_cache()
        check(batch > 1, "no batch fits on the card")
        batch //= 2


def timed_steps(step, batches, dev):
    """step(b) for each batch, each ended by a device barrier: the seconds
    of each (host clock), the median of steps 3-4, and the peak device
    memory over the run."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for b in batches:
        t0 = time.perf_counter()
        step(b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times, statistics.median(times[2:]), \
        torch.cuda.max_memory_allocated(dev)


def kernel_ms(prof, kind):
    return prof["busy_ms_per_call_by_kind"].get(kind, 0.0)


def bev_smpla(dev):
    """SMPL+A from synthetic assets: the adult (11 betas) and the infant
    (10)."""
    return (SmplModel(synthetic_assets(seed=0, num_betas=11), dev),
            SmplModel(synthetic_assets(seed=1, num_betas=10), dev))


def phase_bev_train(dev, smi):
    """BEV's training at the v6 recipe (configs/v6_bev.yml: HRNet-W32 at
    512x512, 128x128 maps x 64 depth bins, SMPL+A, batch 64 x 16 GT
    persons, bf16 compute, lr 5e-5, the synthetic GMM prior; no remat, as
    JAX's step): the largest power-of-two batch up to 64 that fits, then
    `bev_train_step` for NEW_TRAIN_STEPS steps on device-made batches
    (each finite, the loss moving, skinning's forward and backward kernels
    launched twice a step: the adult and the infant model), its seconds a
    step (the median of steps 3-4), img/s and peak memory, and a
    profiled step: the device busy / idle share and the skinning kernels'
    device ms. Counters zeroed before the timed steps, read after them."""
    cfg = load_config("configs/v6_bev.yml")
    check((cfg.train.batch_size, cfg.model.input_size,
           cfg.model.centermap_size, cfg.model.max_person,
           cfg.train.compute_dtype, cfg.train.lr, cfg.model.backbone) == (
              BEV_TRAIN_BATCH, 512, 128, BEV_TRAIN_PERSONS, "bfloat16",
              5e-5, "hrnet32"), "the BEV recipe moved")
    bcfg = tbts.bev_train_config(cfg)
    adult, baby = bev_smpla(dev)
    prior = GmmPrior.synthetic().to(dev)
    net = BevNet()
    net.load_state_dict(init_bev_params(torch.Generator().manual_seed(0)))
    state = tbts.bev_init_train_state(net.to(dev), bcfg)

    def step(b):
        return tbts.bev_train_step(state, b, adult, baby, bcfg, prior)[1]

    t0 = time.perf_counter()
    batch, refused = largest_fitting_batch(
        lambda n: step(tbts.make_bev_synthetic_batch(
            299, n, BEV_TRAIN_PERSONS, 512, dev)), BEV_TRAIN_BATCH)
    fit_s = time.perf_counter() - t0
    batches = [tbts.make_bev_synthetic_batch(300 + i, batch,
                                             BEV_TRAIN_PERSONS, 512, dev)
               for i in range(NEW_TRAIN_STEPS)]
    totals = []
    reset_counts()
    times, sec, peak = timed_steps(lambda b: totals.append(step(b)["total"]),
                                   batches, dev)
    n = launch_counts()
    totals = [float(t) for t in totals]
    check(all(np.isfinite(totals)) and len(set(totals)) > 1,
          f"bev_train_step totals {totals}")
    check(n["skinning"] == 2 * NEW_TRAIN_STEPS
          and n["skinning_bwd"] == 2 * NEW_TRAIN_STEPS,
          f"bev_train_step launches {n}")
    phase(4, "slice", path="bev-train", batch=batch, refused=refused,
          total=totals, launches=n)
    prof, _ = device_profile(lambda: step(batches[0]), 1, 0, table=False)
    row = dict(path="bev-train", backbone="hrnet32", batch=batch,
               recipe_batch=BEV_TRAIN_BATCH, batches_refused=refused,
               persons=BEV_TRAIN_PERSONS, compute_dtype="bfloat16",
               remat="none", step_s=times, median_step_s=sec,
               img_per_s=batch / sec, peak_memory_gb=peak / 1e9,
               fit_search_s=fit_s, step_profile=prof,
               skinning_fwd_launches_per_step=n["skinning"] // NEW_TRAIN_STEPS,
               skinning_bwd_launches_per_step=(n["skinning_bwd"]
                                               // NEW_TRAIN_STEPS),
               skinning_fwd_device_ms=kernel_ms(prof, "skinning kernel"),
               skinning_bwd_device_ms=kernel_ms(prof,
                                                "skinning backward kernel"),
               card=smi)
    phase(6, "time", **row)
    del state, batches
    gc.collect()
    torch.cuda.empty_cache()
    return {"bev-train": n}


def bev_train_grads(net, batch, adult, baby, cfg):
    """One BEV step's losses, gradients (by name) and BatchNorm updates."""
    net.train()
    updates = record_bn_updates(net)
    ctx = (precision_flags(cfg.base) if next(net.parameters()).is_cuda
           else contextlib.nullcontext())
    with ctx:
        total, metrics = tbts.bev_compute_losses(net, batch, adult, baby,
                                                 cfg)
        names = sorted(k for k, _ in net.named_parameters())
        params = dict(net.named_parameters())
        grads = torch.autograd.grad(total, [params[k] for k in names],
                                    allow_unused=True)
    record_bn_updates(net, on=False)
    return ({k: float(v.detach()) for k, v in metrics.items()},
            {k: g.cpu() for k, g in zip(names, grads) if g is not None},
            {k: v.cpu() for k, v in updates.items()})


def phase_bev_train_card_vs_cpu(dev):
    """One f32 BEV train step of the full-width net (HRNet-W32, BEV's heads)
    at 128x128 input (32x32 maps x 64 depth bins), batch 2 x 4 persons: the
    same seeded weights and batch on the card (TF32 off; the skinning
    kernels), on the CPU in f32 (plain versions) and on the CPU in f64 as
    the reference. As ROMP's and TRACE's steps, this one is ill-conditioned
    at random weights (train-mode BatchNorm over 2 images), so the card's
    f32 step is held to be as exact as the CPU's: against f64, its median
    and its worst gradient error at most 2x the CPU's; the losses and the
    BatchNorm updates within 1e-3 relative."""
    size = 128
    sd = init_bev_params(torch.Generator().manual_seed(5), size)
    batch = tbts.make_bev_synthetic_batch(5, 2, 4, size, "cpu")
    cfg = tbts.BevTrainConfig(base=tts.TrainConfig(), input_size=size)
    results = {}
    t0 = time.perf_counter()
    for where, d, dt in (("f64", torch.device("cpu"), torch.float64),
                         ("cpu", torch.device("cpu"), torch.float32),
                         ("card", dev, torch.float32)):
        net = BevNet("hrnet32", size // 4)
        net.load_state_dict(sd)
        adult, baby = (m.to(dt) for m in bev_smpla(d))
        b = {k: v.to(d, dt) if v.is_floating_point() else v.to(d)
             for k, v in batch.items()}
        reset_counts()
        results[where] = bev_train_grads(net.to(d, dt), b, adult, baby, cfg)
    card_launches = launch_counts()
    row, checks = grads_vs_f64(results, "bev train")
    phase(5, "card vs cpu", path="bev-train", **row,
          card_launches=card_launches, seconds=time.perf_counter() - t0)
    check(card_launches["skinning"] == 2
          and card_launches["skinning_bwd"] == 2,
          f"bev train card vs cpu: launches {card_launches}")
    checks()


def write_pretrain_pack(root, n=16, size=512):
    """n seeded images (cv2) and a 2D-only annotation pack of 1-3 persons
    each (some joints unlabelled)."""
    import cv2

    rng = np.random.RandomState(6)
    (root / "data").mkdir(parents=True, exist_ok=True)
    records = []
    for i in range(n):
        path = root / f"img{i:02d}.jpg"
        cv2.imwrite(str(path), (rng.rand(size, size, 3) * 255).astype(
            np.uint8))
        kp = rng.uniform(40, size - 40, (rng.randint(1, 4), 54, 2)).astype(
            np.float32)
        kp[:, 30:] = -2.0
        records.append(ImageAnnotation(str(path), kp))
    save_pack(str(root / "data" / "smoke2d.npz"), records)


def phase_pretrain(dev, smi):
    """2D-pose pretraining at its recipe (configs/pretrain.yml: HRNet-W32
    at 512x512, batch 64 x 16 persons, 54 joints, bf16 compute; no remat,
    as JAX's step): the largest power-of-two batch up to 64 that fits,
    then `pretrain_step` for NEW_TRAIN_STEPS steps on device-made batches
    (each finite with grads_finite 1, the loss moving): seconds a step,
    img/s, peak memory and a profiled step; then `pretrain.main` for
    LAUNCH_STEPS steps over a seeded 16-image 2D pack at that batch (its
    log and checkpoint). Pretraining runs none of the port's kernels (no
    SMPL; the chain kernel is off in train mode): its counts are recorded."""
    cfg = load_config("configs/pretrain.yml")
    check((cfg.train.batch_size, cfg.model.input_size, cfg.model.backbone,
           cfg.train.compute_dtype, cfg.model.max_person) == (
              PRETRAIN_BATCH, 512, "hrnet32", "bfloat16", PRETRAIN_PERSONS),
          "the pretraining recipe moved")
    pcfg = tpre.pretrain_config(cfg)
    net = tpre.PretrainNet()
    net.load_state_dict(tpre.init_pretrain_params(
        torch.Generator().manual_seed(0), pcfg))
    state = tpre.init_pretrain_state(net.to(dev), pcfg)

    def step(b):
        return tpre.pretrain_step(state, b, pcfg)[1]

    batch, refused = largest_fitting_batch(
        lambda n: step(tpre.make_synthetic_pretrain_batch(
            399, n, PRETRAIN_PERSONS, 512, dev)), PRETRAIN_BATCH)
    batches = [tpre.make_synthetic_pretrain_batch(400 + i, batch,
                                                  PRETRAIN_PERSONS, 512, dev)
               for i in range(NEW_TRAIN_STEPS)]
    rows = []
    reset_counts()
    times, sec, peak = timed_steps(lambda b: rows.append(step(b)), batches,
                                   dev)
    by_path = {"pretrain": launch_counts()}
    rows = [{k: float(v) for k, v in r.items()} for r in rows]
    check_train_steps(rows, "pretrain_step")
    prof, _ = device_profile(lambda: step(batches[0]), 1, 0, table=False)
    del state, batches
    gc.collect()
    torch.cuda.empty_cache()
    root = _build.BUILD_DIR / "smoke_pretrain_pack"
    write_pretrain_pack(root)
    ck = _build.BUILD_DIR / "smoke_pretrain"
    log = ck / "pretrain_log.jsonl"
    if log.exists():
        log.unlink()
    reset_counts()
    t0 = time.perf_counter()
    check(tpre.main(["--config", "configs/pretrain.yml", "--data_root",
                     str(root / "data"), "--max_steps",
                     str(LAUNCH_STEPS), "--GPU",
                     str(dev.index or 0), "data.datasets=smoke2d",
                     f"train.batch_size={batch}",
                     f"train.checkpoint_dir={ck}",
                     "train.log_every=1"]) == 0, "pretrain.main")
    torch.cuda.synchronize()
    by_path["pretrain_launch"] = launch_counts()
    logged = [json.loads(line) for line in log.read_text().splitlines()]
    check([r["step"] for r in logged] == list(range(1, LAUNCH_STEPS + 1))
          and all(r["grads_finite"] == 1.0 and np.isfinite(r["total"])
                  for r in logged), f"pretrain.main log {logged}")
    check((ck / "pretrain_last.npz").exists(), "pretrain_last.npz")
    phase(4, "slice", path="pretrain", batch=batch, refused=refused,
          total=[r["total"] for r in rows], launches=by_path["pretrain"],
          launch=dict(seconds=time.perf_counter() - t0, log=logged[-1],
                      launches=by_path["pretrain_launch"]))
    phase(6, "time", path="pretrain", backbone="hrnet32", batch=batch,
          recipe_batch=PRETRAIN_BATCH, batches_refused=refused,
          persons=PRETRAIN_PERSONS, joints=tpre.NUM_JOINTS,
          compute_dtype="bfloat16", step_s=times, median_step_s=sec,
          img_per_s=batch / sec, peak_memory_gb=peak / 1e9,
          step_profile=prof, card=smi)
    return by_path


def phase_train_bf16_act(dev, smi):
    """ROMP's training with bf16 activations (the `phase_train_time` setup,
    batch 64 x 8, mixed compute, remat "stage", with train.act_dtype
    bfloat16): Trainer.step over NEW_TRAIN_STEPS device-made batches (each
    finite, grads_finite 1, skinning's kernels launched once forward and
    once backward a step), seconds a step, img/s, peak memory and a
    profiled step, beside the mixed step's (phase 6's "train" row); then
    `launch.main` for LAUNCH_STEPS steps with train.act_dtype=bfloat16
    over the seeded 16-image pack of the train phase."""
    smpl = SmplModel(synthetic_assets(seed=0), dev)
    trainer = Trainer(train_config(_build.BUILD_DIR / "smoke_train_bf16",
                                   "train.tensorboard=false",
                                   "train.act_dtype=bfloat16"), smpl,
                      device=dev)
    check(trainer.tcfg.act_dtype == "bfloat16", "act_dtype did not reach")
    batches = [tts.make_synthetic_batch(500 + i, TRAIN_BATCH, TRAIN_PERSONS,
                                        512, dev)
               for i in range(NEW_TRAIN_STEPS)]
    packed = []
    reset_counts()
    times, sec, peak = timed_steps(
        lambda b: packed.append(trainer.step(b)), batches, dev)
    by_path = {"train_bf16_act": launch_counts()}
    rows = [dict(zip(trainer._metric_names, p.tolist())) for p in packed]
    check_train_steps(rows, "bf16-act train step")
    n = by_path["train_bf16_act"]
    check(n["skinning"] == NEW_TRAIN_STEPS
          and n["skinning_bwd"] == NEW_TRAIN_STEPS,
          f"bf16-act train launches {n}")
    prof, _ = device_profile(lambda: trainer.step(batches[0]), 1, 0,
                             table=False)
    del trainer, batches
    gc.collect()
    torch.cuda.empty_cache()
    root = _build.BUILD_DIR / "smoke_pack"
    if not (root / "data" / "smoke.npz").exists():
        write_train_pack(root)
    ck = _build.BUILD_DIR / "smoke_launch_bf16"
    log = ck / "train_log.jsonl"
    if log.exists():
        log.unlink()
    reset_counts()
    t0 = time.perf_counter()
    check(train_launch.main(
        ["--data_root", str(root / "data"), "--max_steps",
         str(LAUNCH_STEPS), "--GPU",
         str(dev.index or 0), "data.datasets=smoke",
         f"train.checkpoint_dir={ck}", "train.test_interval=0",
         "train.log_every=1", "train.act_dtype=bfloat16"]) == 0,
          "launch.main bf16-act")
    torch.cuda.synchronize()
    by_path["train_launch_bf16_act"] = launch_counts()
    logged = [json.loads(line) for line in log.read_text().splitlines()]
    check([r["step"] for r in logged] == list(range(1, LAUNCH_STEPS + 1))
          and all(r["grads_finite"] == 1.0 and np.isfinite(r["total"])
                  for r in logged), f"launch.main bf16-act log {logged}")
    check(by_path["train_launch_bf16_act"]["skinning_bwd"] == LAUNCH_STEPS,
          f"launch.main bf16-act launches {by_path}")
    phase(4, "slice", path="train-bf16-act",
          total=[r["total"] for r in rows], launches=n,
          launch=dict(seconds=time.perf_counter() - t0, log=logged[-1],
                      launches=by_path["train_launch_bf16_act"]))
    phase(6, "time", path="train-bf16-act", backbone="hrnet32",
          batch=TRAIN_BATCH, persons=TRAIN_PERSONS, compute_dtype="bfloat16",
          act_dtype="bfloat16", remat="stage", step_s=times,
          median_step_s=sec, steps_per_s=1 / sec,
          img_per_s=TRAIN_BATCH / sec, peak_memory_gb=peak / 1e9,
          step_profile=prof, card=smi)
    return by_path


# the accuracy loop's check at full width: HRNet-W32 at 512x512 on
# synthetic scenes, batch 8, EVAL_STEPS steps, a checkpoint every
# EVAL_INTERVAL, EVAL_TRAIN / EVAL_HELD_OUT scenes
EVAL_STEPS, EVAL_INTERVAL, EVAL_TRAIN, EVAL_HELD_OUT = 4, 2, 16, 12


def phase_eval(dev, smi):
    """The evaluation slice (`romp_tpu_torch/eval/`) on the card: the
    metrics on cuda (f32) against the same functions in f64 on the CPU;
    `make_gt_smpl_fn` on cuda against the CPU's (the skinning kernel
    against the plain skinning); then the ROMP accuracy chain at full
    width through its entry point (`eval.convergence.main`): the Trainer
    with rotating checkpoints, each restored by `load_train_state` and
    scored through `RompPipeline` by the 3DPW collector and
    `pw3d_evaluate`, then `bf16_on_checkpoint`'s four rows on the last
    one (mixed, bf16-act, each unfused and fused). Bars: 1e-5 of max|ref|
    for the metrics and the GT SMPL; finite metrics for every checkpoint;
    skinning forward, backward and the chain (f32 and bf16 I/O) launched
    on the chain's path. Returns its launches."""
    from romp_tpu_torch.eval import convergence as tconv
    from romp_tpu_torch.eval import metrics as tmetrics
    from romp_tpu_torch.eval import protocols as tprot

    rng = np.random.RandomState(21)
    gt = rng.randn(64, 24, 3) * 0.4
    pred = gt + rng.randn(64, 24, 3) * 0.08
    gv = rng.randn(16, V, 3) * 0.4
    pv = gv + rng.randn(16, V, 3) * 0.05
    fns = {"mpjpe": lambda m, a, b, *_: m.mpjpe(a, b, align_inds=(2, 5)),
           "pa_mpjpe": lambda m, a, b, *_: m.pa_mpjpe(a, b),
           "pve": lambda m, a, b, c, d: m.pve(c, d),
           "pck": lambda m, a, b, *_: m.pck(a, b),
           "auc": lambda m, a, b, *_: m.auc(a, b),
           "acceleration_error": lambda m, a, b, *_:
               m.acceleration_error(a, b)}
    metric_errs = {}
    for name, fn in fns.items():
        ref = fn(tmetrics, *(torch.from_numpy(a) for a in (gt, pred, gv, pv)))
        out = fn(tmetrics, *(torch.from_numpy(a).float().to(dev)
                             for a in (gt, pred, gv, pv)))
        check(out.device.type == "cuda", f"{name} left the card")
        metric_errs[name] = rel_err(out.cpu().double(), ref)
    check(max(metric_errs.values()) <= 1e-5, f"metrics on cuda {metric_errs}")

    poses = (rng.randn(24, 72) * 0.3).astype(np.float32)
    betas = (rng.randn(24, 10) * 0.5).astype(np.float32)
    trans = rng.randn(24, 3).astype(np.float32)
    assets = synthetic_assets(seed=0)
    cpu_fn = tprot.make_gt_smpl_fn({"n": SmplModel(assets)}, "cpu")
    reset_counts()
    card_fn = tprot.make_gt_smpl_fn({"n": SmplModel(assets)}, dev)
    j_card, r_card = card_fn("n", poses, betas, trans)
    gt_smpl_launches = launch_counts()["skinning"]
    j_cpu, r_cpu = cpu_fn("n", poses, betas, trans)
    gt_smpl_errs = {"joints": rel_err(torch.from_numpy(j_card),
                                      torch.from_numpy(j_cpu)),
                    "global_rotations": rel_err(torch.from_numpy(r_card),
                                                torch.from_numpy(r_cpu))}
    check(max(gt_smpl_errs.values()) <= 1e-5 and gt_smpl_launches >= 1,
          f"make_gt_smpl_fn on cuda {gt_smpl_errs}, {gt_smpl_launches}")
    phase("eval", "card vs cpu", metric_rel_errs=metric_errs,
          gt_smpl_rel_errs=gt_smpl_errs,
          gt_smpl_skinning_launches=gt_smpl_launches, bar=1e-5)

    out = _build.BUILD_DIR / "smoke_eval.json"
    if out.exists():
        out.unlink()
    reset_counts()
    t0 = time.perf_counter()
    tconv.main(["--GPU", str(dev.index or 0), "--backbone", "hrnet32",
                "--input_size", "512", "--steps", str(EVAL_STEPS),
                "--interval", str(EVAL_INTERVAL), "--n_train",
                str(EVAL_TRAIN), "--n_eval", str(EVAL_HELD_OUT), "--batch",
                "8", "--no_assert", "--out", str(out), "--workdir",
                str(_build.BUILD_DIR / "smoke_eval")])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    n = launch_counts()
    sec, = json.loads(out.read_text()).values()     # full_scale_512
    check(sec["steps"] == list(range(EVAL_INTERVAL, EVAL_STEPS + 1,
                                     EVAL_INTERVAL)), f"checkpoints {sec}")
    metrics = ("MPJPE", "MPJPE_PA", "PCK", "AUC", "MPJAE", "MPJAE_PA")
    check(all(np.isfinite(sec[k]).all() and len(sec[k]) == len(sec["steps"])
              for k in metrics), f"3DPW metrics {sec}")
    rows = sec["bf16_on_trained"]
    check(sorted(rows) == sorted(tconv.BF16_VARIANTS)
          and all(np.isfinite(r["conf_max_delta"]) for r in rows.values()),
          f"bf16_on_checkpoint {rows}")
    check(n["skinning"] >= 1 and n["skinning_bwd"] >= EVAL_STEPS
          and n["basic_chain"] >= 1
          and n["basic_chain_bf16"] + n["basic_chain_bf16_passes"] >= 1,
          f"eval launches {n}")
    phase("eval", "romp chain", backbone="hrnet32", input_size=512, batch=8,
          steps=EVAL_STEPS, interval=EVAL_INTERVAL, n_train=EVAL_TRAIN,
          n_eval=EVAL_HELD_OUT, seconds=seconds,
          s_per_step=sec["s_per_step"], train_seconds=sec["train_seconds"],
          eval_seconds=sec["eval_seconds"],
          per_checkpoint={k: sec[k] for k in ("steps",) + metrics},
          bf16_on_checkpoint=rows, launches=n, card=smi)
    return {"eval": n}


def host_ms(fn, reps=5):
    """Median wall ms of fn() ended by a synchronize (after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_family(dev, smi):
    """SMPL-X / FLAME / MANO (`smpl/family.py`) on synthetic assets at the
    real shapes, batch 64: the card against the CPU in f32 (bar 1e-5 of
    max|ref|: f32 blend-shape products, chain and skinning einsums summed
    in other orders), with both wall times."""
    rows = []
    for kind in ("smplx", "flame", "mano"):
        assets = tfam.synthetic_family_assets(kind, seed=0)
        cpu_m = tfam.FamilyModel(assets, device="cpu")
        card_m = tfam.FamilyModel(assets, device=dev)
        rng = np.random.RandomState(5)
        betas = torch.from_numpy(rng.randn(64, 10).astype(np.float32))
        pose = torch.from_numpy((rng.randn(64, cpu_m.num_joints * 3) * 0.3
                                 ).astype(np.float32))
        v_ref, j_ref = tfam.family_forward(cpu_m, betas, pose)
        bd, pd = betas.to(dev), pose.to(dev)
        v, j = tfam.family_forward(card_m, bd, pd)
        errs = dict(verts=rel_err(v.cpu(), v_ref), joints=rel_err(j.cpu(),
                                                                  j_ref))
        check(max(errs.values()) <= 1e-5, f"family {kind}: {errs}")
        t0 = time.perf_counter()
        for _ in range(3):
            tfam.family_forward(cpu_m, betas, pose)
        rows.append(dict(
            kind=kind, verts=int(assets.v_template.shape[0]),
            joints=cpu_m.num_joints, batch=64, rel_errs=errs, bar=1e-5,
            card_ms=host_ms(lambda: tfam.family_forward(card_m, bd, pd)),
            cpu_ms=(time.perf_counter() - t0) / 3 * 1e3, card=smi))
    for row in rows:
        phase("family", "card vs cpu", **row)
    return rows


def pnp_problem(B, seed=7):
    """B camera-pose problems on the 24 SMPL joints of seeded synthetic
    bodies: the joints posed by a random rotation (0.2 rad) and a
    translation 4-7 m away, projected at f = 548 into 512x512 with 1 px of
    noise."""
    rng = np.random.RandomState(seed)
    model = SmplModel(synthetic_assets(seed=0))
    _, joints = smpl_forward(model, torch.from_numpy(
        rng.randn(B, 10).astype(np.float32)), torch.from_numpy(
        (rng.randn(B, 72) * 0.2).astype(np.float32)))
    pts3d = joints[:, :24].numpy()
    aa = (rng.randn(B, 3) * 0.2).astype(np.float32)
    t = np.stack([rng.uniform(-0.5, 0.5, B), rng.uniform(-0.5, 0.5, B),
                  rng.uniform(4, 7, B)], -1).astype(np.float32)
    R = axis_angle_to_matrix(torch.from_numpy(aa)).numpy()
    cam = np.einsum("bij,bnj->bni", R, pts3d) + t[:, None]
    pts2d = cam[..., :2] / cam[..., 2:] * 548.0 + 256.0
    pts2d += rng.randn(*pts2d.shape)
    return (torch.from_numpy(pts3d), torch.from_numpy(pts2d.astype(
        np.float32)), torch.ones(B, 24))


def phase_pnp(dev, smi):
    """`lm_pnp` 6-DoF and 4-DoF at B = 512 on 24 SMPL joints, and
    `monte_carlo_pnp` (128 samples, 4 iterations) on the first 64 of the
    problems fed the same draws (two CPU generators of one seed), in f64
    and f32: the card against the CPU, with both wall times. Bars: the LM
    pose to 1e-3 of max|pose| (a strict-`<` LM gate can take one tiny
    last step on one side only, 1e-5 in f32 on the CPU tests), in f64 the
    Monte-Carlo samples to 1e-6 of max|sample| and each log-weight to
    1e-6 of max(1, |itself|), in f32 the LM mode to 1e-3."""
    c = torch.tensor([256.0, 256.0])
    cpu = pnp_problem(512)
    card = tuple(x.to(dev) for x in cpu)
    rows = []
    for dof in (6, 4):
        def run(args, center):
            return tpnp.lm_pnp(*args, 548.0, center, iters=10, dof=dof)

        ref = run(cpu, c)
        out = run(card, c.to(dev))
        pose_ref = torch.cat([ref.rotation_aa, ref.translation], -1)
        pose = torch.cat([out.rotation_aa, out.translation], -1).cpu()
        d = (pose - pose_ref).abs().max(-1).values / pose_ref.abs().max()
        row = dict(solver="lm_pnp", dof=dof, batch=512, joints=24, iters=10,
                   pose_rel_err=float(d.max()),
                   pose_rel_err_median=float(d.median()),
                   cost_median=float(ref.cost.median()), bar=1e-3)
        check(row["pose_rel_err"] <= 1e-3, f"lm_pnp dof={dof}: {row}")
        t0 = time.perf_counter()
        run(cpu, c)
        row.update(cpu_ms=(time.perf_counter() - t0) * 1e3,
                   card_ms=host_ms(lambda: run(card, c.to(dev))), card=smi)
        rows.append(row)

    def mc(args, center):
        return tmc.monte_carlo_pnp(torch.Generator().manual_seed(3),
                                   *(a[:64] for a in args), 548.0, center,
                                   mc_samples=128, num_iter=4)

    for dtype in (torch.float64, torch.float32):
        cpu_t = tuple(a.to(dtype) for a in cpu)
        card_t = tuple(a.to(dtype) for a in card)
        ref, out = mc(cpu_t, c.to(dtype)), mc(card_t, c.to(dev, dtype))
        lw, lw_ref = out.sample_logweights.cpu(), ref.sample_logweights
        lw_rel = float(((lw - lw_ref).abs()
                        / lw_ref.abs().clamp(min=1.0)).max())
        row = dict(solver="monte_carlo_pnp", dtype=str(dtype)[6:],
                   batch=64, mc_samples=128, num_iter=4,
                   pose_opt_rel_err=rel_err(out.pose_opt.cpu(),
                                            ref.pose_opt),
                   samples_rel_err=rel_err(out.pose_samples.cpu(),
                                           ref.pose_samples),
                   logweights_rel_err=lw_rel)
        check(bool(torch.isfinite(lw).all()), f"monte_carlo_pnp: {row}")
        if dtype == torch.float64:
            # each refit weighs the samples by softmax(-cost), costs of 1e3
            # to 1e19: a rounding difference in a cost moves the next
            # proposal by cost x eps, so the iterations compound the two
            # sides' roundings (f32: 4e-5 of the samples after four). f64
            # keeps that, and a last LM step taken on one side only
            # (2.5e-9 in f64 on the CPU tests), below 1e-6; f32's
            # distances are reported
            row["bar"] = 1e-6
            check(max(row["samples_rel_err"], lw_rel) <= 1e-6,
                  f"monte_carlo_pnp: {row}")
        else:
            row["bar"] = 1e-3
            check(row["pose_opt_rel_err"] <= 1e-3, f"monte_carlo_pnp: {row}")
        t0 = time.perf_counter()
        mc(cpu_t, c.to(dtype))
        row.update(cpu_ms=(time.perf_counter() - t0) * 1e3,
                   card_ms=host_ms(lambda: mc(card_t, c.to(dev, dtype))),
                   card=smi)
        rows.append(row)
    for row in rows:
        phase("pnp", "card vs cpu", **row)
    return rows


def phase_export(dev, params, bev_params, smi):
    """The export tool on the card: `export_romp` (HRNet-W32 512x512) and
    `export_bev` (512x512) at batch 1 (batch 8 is left out to keep the
    whole run well inside its time limit), saved under build/ from
    checkpoint files of the seeded weights, loaded (`load_exported`) and
    run. Each loaded program's outputs against eager `romp_inference` /
    `bev_inference` through the pipeline on the same weights (bar 1e-5 of
    each output's max|ref|, the validity masks equal): the same cuDNN
    convs and kernels in the same order. `skinning.launches` must grow
    during the loaded program's run (the op's CUDA route). Times: export
    and load seconds, and the loaded program's and eager ms (medians of
    host-clock calls ended by a synchronize). Returns the skinning
    launches of the loaded programs' checked runs."""
    out_dir = _build.BUILD_DIR / "export"
    out_dir.mkdir(parents=True, exist_ok=True)
    ckpts = {"romp": out_dir / "romp_weights.pth",
             "bev": out_dir / "bev_weights.pth"}
    torch.save(params, ckpts["romp"])
    torch.save(bev_params, ckpts["bev"])
    pipes = {
        "romp": RompPipeline(params, SmplModel(synthetic_assets(seed=0)),
                             RompConfig(max_person=8), dev),
        "bev": BevPipeline(bev_params,
                           SmplModel(synthetic_assets(seed=0, num_betas=11)),
                           SmplModel(synthetic_assets(seed=1, num_betas=10)),
                           BevConfig(max_person=8), dev)}
    exporters = {"romp": texp.export_romp, "bev": texp.export_bev}
    rows, launches = [], dict.fromkeys(KERNELS, 0)
    for model, batches in (("romp", (1,)), ("bev", (1,))):
        for batch in batches:
            path = out_dir / f"{model}_b{batch}.pt2"
            t0 = time.perf_counter()
            exporters[model](str(ckpts[model]), str(path), batch=batch,
                             device=dev)
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            loaded = texp.load_exported(str(path))
            load_s = time.perf_counter() - t0
            size = pipes[model].cfg.input_size
            images = torch.from_numpy((np.random.RandomState(batch).rand(
                batch, size, size, 3) * 255).astype(np.float32)).to(dev)
            reset_counts()
            out = loaded(images)
            torch.cuda.synchronize()
            n = launch_counts()
            ref = pipes[model](images)
            check(n["skinning"] >= 1, f"export {model}: skinning {n}")
            check(set(out) == set(ref) and torch.equal(out["mask"],
                                                       ref["mask"]),
                  f"export {model}: outputs or masks differ")
            errs = {k: rel_err(out[k], r) for k, r in ref.items()
                    if r.is_floating_point()}
            check(max(errs.values()) <= 1e-5, f"export {model}: {errs}")
            for k in launches:
                launches[k] += n[k]
            nodes = [str(x.target) for x in loaded.program.graph.nodes
                     if x.op == "call_function"]
            rows.append(dict(
                model=model, batch=batch, export_s=export_s, load_s=load_s,
                pt2_mb=path.stat().st_size / 2 ** 20, graph_ops=len(nodes),
                skinning_nodes=nodes.count("romp_tpu_torch.skinning.default"),
                skinning_launches=n["skinning"], max_rel_err=max(
                    errs.values()), rel_errs=errs, bar=1e-5,
                loaded_ms=host_ms(lambda: loaded(images)),
                eager_ms=host_ms(lambda: pipes[model](images)), card=smi))
            del loaded
    for row in rows:
        phase("export", "loaded vs eager", **row)
    return {"export": launches}


# ------------------------------------------------------------------- dp --

DP_TIME_BATCH = 16      # the dp phase's timed steps: 8 rows a rank on two
DP_RANK_TIMEOUT = 300   # seconds a rank process may take


@contextlib.contextmanager
def cudnn_deterministic():
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


def per_tensor_errs(grads, ref):
    """(median, max) over tensors of a step's gradients' relative error
    against the f64 step's, leaving out the tensors that are exactly zero
    in f64 (as `grads_vs_f64`)."""
    gmax = max(float(v.abs().max()) for v in ref.values())
    errs = [rel_err(grads[k], v) for k, v in ref.items()
            if float(v.abs().max()) > 1e-6 * gmax]
    return statistics.median(errs), max(errs)


def dp_time_step(dev, group, rank=0, world=1):
    """The training defaults (HRNet-W32 512x512, mixed, remat "stage") at
    a global batch of DP_TIME_BATCH x 8 persons, this rank's rows: the
    seconds of a first step (ended by this process's device barrier), then
    one profiled step's wall and device-busy ms."""
    tcfg = step_config(load_config(None))
    net = RompNet()
    net.load_state_dict(init_romp_params(torch.Generator().manual_seed(4)))
    state = tts.init_train_state(net.to(dev), tcfg)
    smpl = SmplModel(synthetic_assets(seed=0), dev)
    prior = GmmPrior.synthetic().to(dev)
    batches = [mesh.shard_batch(tts.make_synthetic_batch(
        300 + i, DP_TIME_BATCH, TRAIN_PERSONS, 512, dev), rank, world)
        for i in range(2)]

    def step(b):
        tts.train_step(state, b, smpl, tcfg, prior, group)

    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    step(batches[0])
    torch.cuda.synchronize(dev)
    first = time.perf_counter() - t0
    prof, _ = device_profile(lambda: step(batches[1]), 1, 0, table=False)
    return dict(rows=len(batches[0]["image"]), first_step_s=first,
                wall_ms=prof["wall_ms_per_call"],
                busy_ms=prof["device_busy_ms_per_call"],
                idle_share=prof["idle_share"],
                kernels=prof["kernels_per_call"],
                peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9)


def dp_rank(rank, world, store, out, backend):
    """One rank of the dp phase's two (`chip_smoke.py --dp-rank '<json>'`,
    started by `phase_dp`): the f32 train step of `train_step_inputs` on
    this rank's rows through `train_step` with the group, its reduced flat
    gradient (by name) and the kernels' launches; then `dp_time_step`.
    Writes them to `out`."""
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    mesh.initialize_distributed(f"file://{store}", world, rank, dev, backend)
    group = mesh.data_group()
    try:
        _build.load()
        sd, batch, cfg, assets = train_step_inputs()
        net = RompNet()
        net.load_state_dict(sd)
        state = tts.init_train_state(net.to(dev), cfg)
        seen = {}
        update = tts.optimizer_update

        def capture(st, grad, c):
            seen["grad"] = grad.detach().cpu()
            return update(st, grad, c)

        tts.optimizer_update = capture
        reset_counts()
        tts.train_step(state, {k: v.to(dev) for k, v in
                               mesh.shard_batch(batch).items()},
                       SmplModel(assets, dev), cfg,
                       GmmPrior.synthetic().to(dev), group)
        torch.cuda.synchronize(dev)
        launches = launch_counts()
        tts.optimizer_update = update
        params = state.trainable
        grads = dict(zip(state.names, (
            g.view(params[k].shape) for k, g in zip(state.names, torch.split(
                seen["grad"], [params[k].numel() for k in state.names])))))
        del net, state, params
        torch.cuda.empty_cache()
        torch.save({"grads": grads, "launches": launches,
                    "timing": dp_time_step(dev, group, rank, world)}, out)
    finally:
        mesh.finalize_distributed()


def phase_dp(dev, params, assets, images16, step_results, smi):
    """Data parallelism (`romp_tpu_torch/parallel/mesh.py`), three parts.
    (a) A NCCL group of one (FileStore under build/), and `Trainer.fit`
    for 2 steps at the training defaults (HRNet-W32 512x512, batch 64 x 8)
    as rank 0 of 1 (mesh.multihost), against the one-process Trainer from
    the same state and batches (cuDNN deterministic in both): expected
    bitwise, else the figure; the check: the first step's metrics equal
    and the states within 1e-3 of their largest values. Its launches are
    the `dp-train` path's. (b) Two ranks (two processes on cuda:0 over
    gloo with CUDA tensors, NCCL refusing two ranks on one card; cuda:0 /
    cuda:1 over NCCL where the machine has two cards), each on its row of
    phase 5's f32 train step (batch 2 at 256x256): their reduced flat
    gradients bitwise equal, and its distance to the f64 CPU gradient at
    most 1.5x the one-process card step's (median and worst tensor); their
    kernels' launches join `dp-train`; then each rank's and the one
    process's step time at a global batch of DP_TIME_BATCH. (c) A ROMP
    service over two replicas on cuda:0 (f32), six requests in one batch
    padded to 8 and split 4 + 4, against the one-device service on the
    same 4-image shards, image by image (expected bitwise; the check:
    within 1e-5 of each output's largest value); its launches are the
    `dp-serve` path's. Returns the launches per path."""
    import torch.distributed as dist

    t_phase = time.perf_counter()
    build, out, by_path = _build.BUILD_DIR, {}, {}
    # (a) world size 1
    store = build / "dp_store_world1"
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            world_size=1, rank=0)
    try:
        ones = torch.ones(1, device=dev)
        dist.all_reduce(ones)
        smpl = SmplModel(assets, dev)
        batches = [tts.make_synthetic_batch(400 + i, TRAIN_BATCH,
                                            TRAIN_PERSONS, 512, dev)
                   for i in range(2)]
        ends, rows, counts = {}, {}, {}
        for name, extra in (("one", ()), ("rank0of1", (
                "mesh.multihost=true", f"mesh.coordinator=file://{store}",
                "mesh.num_processes=1", "mesh.process_id=0"))):
            trainer = Trainer(train_config(build / f"smoke_dp_{name}",
                                           "train.tensorboard=false",
                                           *extra), smpl, device=dev)
            reset_counts()
            with cudnn_deterministic():
                rows[name] = recorded_fit(trainer, iter(batches), 2)
            counts[name] = launch_counts()
            st = trainer.state
            ends[name] = [t.detach().clone() for t in (
                st.flat, st.bn_flat, st.opt_state.mu, st.opt_state.nu)]
            del trainer, st
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    by_path["dp-train"] = dict(counts["rank0of1"])
    pairs = list(zip(ends["one"], ends["rank0of1"]))
    world1 = dict(nccl_all_reduce_of_one=float(ones), steps=2,
                  bitwise=all(torch.equal(a, b) for a, b in pairs),
                  state_max_rel_diff=max(rel_err(b, a) for a, b in pairs),
                  metrics_equal=rows["one"] == rows["rank0of1"],
                  total=[r["total"] for r in rows["rank0of1"]],
                  launches=counts["rank0of1"],
                  seconds=time.perf_counter() - t_phase)
    out["world1"] = world1
    # (b) two ranks
    t0 = time.perf_counter()
    nccl = torch.cuda.device_count() >= 2
    backend = "nccl" if nccl else "gloo"
    store = build / "dp_store_world2"
    store.unlink(missing_ok=True)
    outs = [build / f"dp_rank{r}.pt" for r in range(2)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--dp-rank", json.dumps(dict(
                                   rank=r, world=2, store=str(store),
                                   out=str(outs[r]), backend=backend))])
             for r in range(2)]
    try:
        rcs = [p.wait(timeout=DP_RANK_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(rcs == [0, 0], f"dp ranks exited {rcs}")
    ranks = [torch.load(o) for o in outs]
    ref, card = step_results["f64"][1], step_results["card"][1]
    two = per_tensor_errs(ranks[0]["grads"], ref)
    one = per_tensor_errs(card, ref)
    for r in ranks:
        for k, v in r["launches"].items():
            by_path["dp-train"][k] += v
    one_time = dp_time_step(dev, None)
    out["two_ranks"] = dict(
        devices="cuda:0, cuda:1" if nccl else "cuda:0 twice",
        backend=backend,
        grads_bitwise_equal=all(torch.equal(ranks[0]["grads"][k], v)
                                for k, v in ranks[1]["grads"].items()),
        grad_rel_err_vs_f64_median={"two_ranks": two[0], "one": one[0]},
        grad_rel_err_vs_f64_max={"two_ranks": two[1], "one": one[1]},
        bar="two ranks' median and worst at most 1.5x one process's",
        launches=[r["launches"] for r in ranks],
        seconds=time.perf_counter() - t0)
    out["step_time"] = dict(
        config=f"HRNet-W32 512x512, mixed, remat stage, global batch "
               f"{DP_TIME_BATCH} x {TRAIN_PERSONS}",
        one_process=one_time, two_ranks=[r["timing"] for r in ranks],
        card=smi)
    # (c) serving over two replicas
    t0 = time.perf_counter()
    cfg = RompConfig(compute_dtype="float32")
    smpl = SmplModel(assets)
    mb = make_romp_service(params, smpl, cfg, max_batch=8, window_ms=50.0,
                           mesh=mesh.make_mesh(devices=[dev, dev]))
    ref_service = make_romp_service(params, smpl, cfg, max_batch=4,
                                    device=dev)
    try:
        imgs = np.zeros((8, 512, 512, 3), np.uint8)
        imgs[:6] = images16[:6]
        reset_counts()
        res = [f.result(timeout=300) for f in [mb.submit(im)
                                               for im in imgs[:6]]]
        torch.cuda.synchronize()
        by_path["dp-serve"] = launch_counts()
        batches_run = mb.batches_run
        shards = [ref_service.fetch(ref_service.run_batch(imgs[i:i + 4]))
                  for i in (0, 4)]
    finally:
        mb.close()
        ref_service.close()
    worst, bitwise = 0.0, True
    for i, r in enumerate(res):
        for k, v in shards[i // 4].items():
            a, b = r[k], v[i % 4]
            if not np.array_equal(a, b):
                bitwise = False
                worst = max(worst, float(
                    np.abs(a.astype(np.float64) - b).max()
                    / max(np.abs(b.astype(np.float64)).max(), 1e-30))
                    if np.issubdtype(b.dtype, np.floating) else np.inf)
    out["serve"] = dict(replicas="cuda:0 twice", sizes=mb.sizes,
                        batches=batches_run, bitwise=bitwise,
                        max_rel_diff=worst, launches=by_path["dp-serve"],
                        seconds=time.perf_counter() - t0)
    phase("dp", "data parallel", seconds=time.perf_counter() - t_phase,
          **out)
    check(world1["metrics_equal"] or rows["one"][0] == rows["rank0of1"][0],
          f"dp world 1: the first step's metrics differ {world1}")
    check(world1["state_max_rel_diff"] <= 1e-3, f"dp world 1: {world1}")
    check(by_path["dp-train"]["skinning"] == 4
          and by_path["dp-train"]["skinning_bwd"] == 4,
          f"dp-train launches {by_path['dp-train']}")
    check(out["two_ranks"]["grads_bitwise_equal"],
          "dp: the ranks' reduced gradients differ")
    check(two[0] <= 1.5 * one[0] and two[1] <= 1.5 * one[1],
          f"dp: two ranks' gradient vs f64 {two}, one process's {one}")
    check(batches_run == 1 and worst <= 1e-5
          and by_path["dp-serve"]["skinning"] == 2,
          f"dp serving: {out['serve']}")
    return by_path


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's smoke run "
                         "needs one GPU")
    dev = torch.device("cuda", 0)
    smi = smi_line()
    phase(1, "device", name=torch.cuda.get_device_name(0), smi=smi,
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda)

    t0 = time.perf_counter()
    _build.load()
    phase(2, "build", seconds=time.perf_counter() - t0,
          library=str(_build.library_path().name),
          chain_kernels={demangled(r.pop("kernel")): r for r in
                         _build.kernel_resources("basic_chain")
                         + _build.kernel_resources("chain_block_bf16")},
          chain_smem_bytes={f"C={C},B={B}": launch_plan(B, C, H, H).smem
                            for C, H in BRANCHES for B in CHAIN_BATCHES},
          chain_bf16_plans={
              f"C={C},B={B}": bf16_chain_plan(
                  B, C, H, H, torch.cuda.get_device_properties(
                      dev).multi_processor_count)._asdict()
              | {"passes": None} for C, H in BRANCHES
              for B in CHAIN_BF16_BATCHES},
          skinning_kernels={demangled(r.pop("kernel")): r for r in
                            _build.kernel_resources("skinning")},
          skinning_smem_bytes={f"N={n}": skinning_plan(n, V).smem
                               for n in SKIN_N},
          skinning_bwd_smem_bytes=skinning_bwd_plan(SKIN_BWD_N[0], V).smem,
          skinning_bwd_ctas_per_sm=skinning_bwd_occupancy(),
          deform_kernels={demangled(r.pop("kernel")): r for r in
                          _build.kernel_resources("deform")},
          deform_smem_bytes=deform_smem(DEFORM["G"],
                                        DEFORM["C"] // DEFORM["G"]),
          deform_bf16_plan=deform_bf16_plan(
              *(DEFORM[k] for k in ("B", "C", "H", "W", "G", "Cout")),
              torch.cuda.get_device_properties(dev).multi_processor_count))

    rows = phase_kernels(dev)
    params = seeded_params()
    assets = synthetic_assets(seed=0)
    images16 = (np.random.RandomState(0).rand(16, 512, 512, 3) * 255).astype(
        np.uint8)
    romp_launches = phase_slice(dev, params, assets, images16)
    trace_params = seeded_trace_params(device=dev)
    trace_ckpt = _build.BUILD_DIR / "smoke_trace_weights.pth"
    torch.save(trace_params, trace_ckpt)
    trace_launches = phase_trace_slice(dev, trace_ckpt)
    raft_ckpt = _build.BUILD_DIR / "smoke_raft_weights.pth"
    torch.save(init_raft_params(torch.Generator().manual_seed(0)), raft_ckpt)
    raft_launches = phase_trace_raft_slice(dev, trace_ckpt, raft_ckpt)
    bev_params = seeded_bev_params(device=dev)
    adult = SmplModel(synthetic_assets(seed=0, num_betas=11))
    baby = SmplModel(synthetic_assets(seed=1, num_betas=10))
    bev_launches = phase_bev_slice(dev, bev_params, adult, baby, images16)
    bf16_launches = phase_bf16_slices(dev, params, assets, images16,
                                      bev_params, adult, baby, trace_ckpt)
    train_launches = phase_train(dev)
    trace_train_launches, trace_train_ctx = phase_trace_train(
        dev, raft_ckpt, _build.BUILD_DIR / "smoke_weights.pth")
    phase_card_vs_cpu(dev, params, assets)
    phase_trace_card_vs_cpu(dev, trace_params)
    phase_raft_card_vs_cpu(dev)
    phase_bev_card_vs_cpu(dev, bev_params)
    phase_bf16_card_vs_cpu(dev, params, bev_params, trace_params)
    train_grads_vs_f64 = phase_train_card_vs_cpu(dev)
    phase_trace_train_card_vs_cpu(dev)
    serve_launches = phase_serve(dev, _build.BUILD_DIR / "smoke_weights.pth",
                                 _build.BUILD_DIR / "smoke_bev_weights.pth",
                                 smi)
    phase_time(dev, params, assets, smi)
    phase_trace_time(dev, trace_ckpt, raft_ckpt, smi)
    phase_bev_time(dev, bev_params, adult, baby, smi)
    phase_train_time(dev, smi)
    phase_trace_train_time(dev, trace_train_ctx, smi)
    del trace_train_ctx
    new_train_launches = phase_bev_train(dev, smi)
    phase_bev_train_card_vs_cpu(dev)
    new_train_launches.update(phase_pretrain(dev, smi))
    new_train_launches.update(phase_train_bf16_act(dev, smi))
    new_train_launches.update(phase_eval(dev, smi))
    phase_family(dev, smi)
    phase_pnp(dev, smi)
    new_train_launches.update(phase_export(dev, params, bev_params, smi))
    new_train_launches.update(phase_dp(dev, params, assets, images16,
                                       train_grads_vs_f64, smi))

    meta = {
        "skinning": ("romp_tpu_torch/csrc/lbs.cu",
                     "romp_tpu/ops/pallas_lbs.py:46"),
        "skinning_bwd": ("romp_tpu_torch/csrc/lbs.cu",
                         "romp_tpu/ops/pallas_lbs.py:113"),
        "basic_chain": ("romp_tpu_torch/csrc/basic_chain.cu",
                        "romp_tpu/ops/pallas_fuse.py:134"),
        "deform_conv": ("romp_tpu_torch/csrc/deform_conv.cu",
                        "romp_tpu/ops/pallas_deform.py:103"),
        "basic_chain_bf16": ("romp_tpu_torch/csrc/chain_block_bf16.cu",
                             "romp_tpu/ops/pallas_fuse.py:134"),
        "basic_chain_bf16_passes": ("romp_tpu_torch/csrc/basic_chain.cu",
                                    "romp_tpu/ops/pallas_fuse.py:134"),
        "deform_conv_bf16": ("romp_tpu_torch/csrc/deform_conv.cu",
                             "romp_tpu/ops/pallas_deform.py:103"),
        "deform_conv_bwd": ("romp_tpu_torch/csrc/deform_conv.cu",
                            "romp_tpu/ops/pallas_deform.py:178"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        # skinning: its largest main-path shape (N = 64 x 64); its
        # backward: the train step's (N = 64 x 8); the chain:
        # the sum over the four branch shapes at B=2, one stage-4 module's
        # chains (PR 1's definition, so the numbers compare), its bf16
        # variant the same sum at B=64, the fused block kernel's (C = 32
        # and 64) and the passes' (C = 128 and 256) apart; the deforms:
        # TRACE's shape, one
        # launch per clip; the deform backward: the train step's clip
        # (T = 10), one launch per clip
        timed = ([r for r in rows[name] if r["batch"] == 2]
                 if name == "basic_chain" else
                 [r for r in rows[name] if r["batch"] == 64]
                 if name.startswith("basic_chain_bf16") else
                 [r for r in rows[name] if r["shape"].startswith("N=512,")]
                 if name == "skinning_bwd" else rows[name][:1]
                 if name == "deform_conv_bwd" else rows[name][-1:])
        by_path = {"romp": romp_launches[name],
                   "trace": trace_launches[name],
                   "trace+raft": raft_launches[name],
                   "bev": bev_launches[name],
                   **{p: c[name] for p, c in bf16_launches.items()},
                   **{p: c[name] for p, c in train_launches.items()},
                   **{p: c[name] for p, c in trace_train_launches.items()},
                   **{p: c[name] for p, c in new_train_launches.items()},
                   "serve": serve_launches[name]}
        device = [r["device_ms"] for r in timed]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=max(r["max_abs_err"] for r in rows[name]),
            ms=sum(r["ms"] for r in timed),
            device_ms=None if None in device else sum(device),
            plain_ms=sum(r["plain_ms"] for r in timed),
            bound_ms=sum(r["bound_ms"] for r in timed),
            bound_by=max(timed, key=lambda r: r["bound_ms"])["bound_by"],
            library_ms=None,    # no single PyTorch call computes it
            shape="; ".join(r["shape"] for r in timed),
            **({"f32_bound_ms": sum(r["f32_bound_ms"] for r in timed)}
               if "f32_bound_ms" in timed[0] else {}),
            # skinning through its custom op (ms) and the bare launch
            **({"direct_ms": sum(r["direct_ms"] for r in timed)}
               if "direct_ms" in timed[0] else {})))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        dp_rank(**json.loads(sys.argv[2]))
    else:
        main()
