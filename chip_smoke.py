"""Drive the PyTorch + CUDA port (the ROMP image path and the TRACE video
path) once on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is nonzero:
 1. device: a CUDA device is required (nothing here runs on the CPU instead);
 2. build: compile the hand-written kernels from romp_tpu_torch/csrc, with
    the chain, skinning and deform kernels' registers, spills and static
    shared memory (ptxas -v), and their dynamic shared memory;
 3. kernels: each kernel against its plain PyTorch version at the main
    paths' shapes, with kernel and plain times (CUDA events, medians), the
    kernel's device time (torch.profiler) and the least time the card could
    take (bound; for skinning and the deform read both for the split-TF32
    tensor-core work and, as the CUDA-core kernels were, for f32);
    skinning at N = 64, 1024 and 4096 (the CLI, batch 16 and batch 64 x 64
    slots); the chain at batch 1, 2 and 64 for each branch shape, beside
    the unfused mixed branch it replaces (`unfused_ms`); and a check that
    the SASS of every chain, skinning and deform kernel holds tensor-core
    instructions (HMMA / HGMMA, by cuobjdump);
 4. slices: ROMP: full-width HRNet-W32 at 512x512 (seeded random weights,
    synthetic SMPL assets) through the `ROMP` entry point on 4 images and
    through `RompPipeline` at batch 16 in four configurations. TRACE: the
    `trace2` CLI's own pipeline (`build_trace_pipeline`, 128x128 maps,
    8-frame clips, seeded weights, synthetic SMPL-A / SMIL) on three clips
    through `process_stream`, mixed path and f32. Each path's kernel
    launch counters are zeroed just before it and read just after;
 5. card vs CPU: the same weights and inputs through the port on the CPU
    (plain versions) and on the card (kernels), f32 with TF32 off; then the
    mixed path, every conv of the net against the CPU's (ROMP at batches 1,
    16 and 64 and the whole net's maps; TRACE on one 2-frame clip);
 6. time: ROMP img/s; TRACE s per 8-frame clip and frames/s at steady state
    through `process_stream`, with a per-stage split.
Then the kernels' JSON line, the card's name and power limit, and the
result line.
"""
from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from romp_tpu_torch.cli.romp import ROMP, romp_settings  # noqa: E402
from romp_tpu_torch.cli.trace import trace_settings  # noqa: E402
from romp_tpu_torch.cli.trace_impl import build_trace_pipeline  # noqa: E402
from romp_tpu_torch.models.hrnet import Branch  # noqa: E402
from romp_tpu_torch.models.layers import (  # noqa: E402
    Conv1d, Conv2d, Conv3d, LayerOpts, he_normal_,
)
from romp_tpu_torch.models.trace import (  # noqa: E402
    TraceNet, trace_forward_maps,
)
from romp_tpu_torch.ops import _build  # noqa: E402
from romp_tpu_torch.ops.centermap import (  # noqa: E402
    nms_heatmap, nms_heatmap3d, parse_centermap3d,
)
from romp_tpu_torch.ops.deform_conv import (  # noqa: E402
    deform_conv2d, deform_conv2d_plain, deform_smem,
)
from romp_tpu_torch.ops.fused_chain import (  # noqa: E402
    basic_chain, basic_chain_plain, conv_pass, conv_pass_plain, launch_plan,
)
from romp_tpu_torch.ops.lbs import (  # noqa: E402
    skinning, skinning_plain, skinning_plan,
)
from romp_tpu_torch.pipeline.romp_pipeline import (  # noqa: E402
    RompConfig, RompPipeline, precision_flags,
)
from romp_tpu_torch.pipeline.trace_pipeline import TraceConfig  # noqa: E402
from romp_tpu_torch.smpl.body_model import (  # noqa: E402
    SmplModel, synthetic_assets,
)
from romp_tpu_torch.utils.chain_plans import device_events  # noqa: E402
from romp_tpu_torch.utils.kernel_breakdown import warm_clocks  # noqa: E402
from romp_tpu_torch.utils.profiling import (  # noqa: E402
    seeded_params, seeded_trace_params,
)

MIXED = LayerOpts(compute_dtype=torch.bfloat16)
BRANCHES = ((32, 128), (64, 64), (128, 32), (256, 16))  # (C, H) at 512x512
CHAIN_BATCHES = (1, 2, 64)   # batch-1 latency, PR 1's rows, offline batch
SKIN_N = (64, 1024, 4096)   # batch x max_person: 1, 16 and 64 x 64
V = 6890
DEFORM = dict(B=8, C=32, H=128, W=128, G=8, Cout=32)   # TRACE's warp
TRACE_CLIP = 8
# H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12


def phase(n, title, **fields):
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
            device_ms=device_ms(lambda: skinning(a16, w, vpos),
                                {"skinning_tf32_kernel": 1}),
            plain_ms=time_ms(lambda: skinning_plain(a16, w, vpos)),
            **bounds))
    rows["basic_chain"] = [chain_row(dev, g, B, C, H)
                           for B in CHAIN_BATCHES for C, H in BRANCHES]
    rows["deform_conv"].append(deform_row(dev, g))
    for name, shapes in rows.items():
        for row in shapes:
            phase(3, f"kernel {name}", **row)
    phase(3, "sass", hmma_instructions=tensor_core_sass())
    return rows


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


TENSOR_CORE_KERNELS = ("conv3x3_bn_act_mma_kernel", "skinning_tf32_kernel",
                       "deform_conv_tf32_kernel")


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
    'conv3x3_bn_act_mma_kernel<16,64>'; other names as they are."""
    for m in re.finditer(r"\d+", name):
        # the length prefix may follow other digits (a hash in the
        # anonymous namespace's name): try each tail of the digit run
        for k in range(len(m.group())):
            ident = name[m.end():m.end() + int(m.group()[k:])]
            if re.fullmatch(r"[A-Za-z_]\w*_kernel", ident):
                rest = name[m.end() + len(ident):]
                args = re.match(r"I((?:Li\d+E)+)E", rest)
                if args is None:
                    return ident
                return (f"{ident}<"
                        f"{','.join(re.findall(r'Li(\d+)E', args[1]))}>")
    return name


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
    skinning.launches = 0
    conv_pass.launches = 0
    deform_conv2d.launches = 0
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
    launches = {"skinning": skinning.launches,
                "basic_chain": conv_pass.launches,
                "deform_conv": deform_conv2d.launches}
    check(launches["deform_conv"] == 0, "ROMP path launched the deform")
    phase(4, "slice", path="romp", romp_4_images_s=romp_s,
          pipeline_runs=runs, launches=launches)
    return launches


def trace_clips(n, seed):
    rng = np.random.RandomState(seed)
    return [(rng.rand(TRACE_CLIP, 512, 512, 3) * 255).astype(np.uint8)
            for _ in range(n)]


def trace_pipe(dev, ckpt, compute_dtype):
    """The trace2 CLI's own pipeline: its flags and defaults (max_person
    64, center_thresh 0.1, temp_clip_length 8), the seeded weights file,
    synthetic SMPL-A and SMIL assets, zero flow."""
    return build_trace_pipeline(trace_settings([
        "--GPU", str(dev.index or 0), "--model_path", str(ckpt),
        "--smpl_path", "", "--smil_path", "", "--raft_model_path", "",
        "--compute_dtype", compute_dtype]))


def phase_trace_slice(dev, ckpt):
    """Three 8-frame 512x512 clips through process_stream, on the mixed
    path (the CLI default) and on f32. One deform launch per clip, two
    skinning launches (adult, infant) per clip with tracks."""
    clips = trace_clips(3, 30)
    runs, launches = {}, {"deform_conv": 0, "skinning": 0, "basic_chain": 0}
    for dtype in ("bfloat16", "float32"):
        pipe = trace_pipe(dev, ckpt, dtype)
        deform_conv2d.launches = skinning.launches = conv_pass.launches = 0
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


def phase_time(dev, params, assets, smi):
    rows = []
    for fuse in (False, True):
        cfg = RompConfig(compute_dtype="bfloat16", fuse_chains=fuse)
        pipe = RompPipeline(params, SmplModel(assets), cfg, dev)
        for batch, reps in ((1, 20), (64, 5)):
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
                             fuse_chains=fuse,
                             batch=batch, median_s=sec, img_per_s=batch / sec,
                             reps=reps, card=smi))
    for row in rows:
        phase(6, "time", **row)
    return rows


def phase_trace_time(dev, ckpt, smi):
    """TRACE through process_stream over ten 8-frame clips: seconds per
    clip at steady state (the median gap between results, past the first
    two), frames/s; then three clips through process_clip with a device
    barrier after each stage, for the split by stage."""
    rows = []
    clips = trace_clips(10, 40)
    for dtype in ("bfloat16", "float32"):
        pipe = trace_pipe(dev, ckpt, dtype)
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
        rows.append(dict(
            path="trace", compute_dtype=dtype, clips=len(clips),
            frames_per_clip=TRACE_CLIP, s_per_clip=sec,
            frames_per_s=TRACE_CLIP / sec, stream_total_s=stamps[-1] - t0,
            stage_ms_per_clip_synced={
                k: v / 3 * 1e3 for k, v in pipe.stage_times.items()},
            card=smi))
    for row in rows:
        phase(6, "time", **row)
    return rows


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
                         _build.kernel_resources("basic_chain")},
          chain_smem_bytes={f"C={C},B={B}": launch_plan(B, C, H, H).smem
                            for C, H in BRANCHES for B in CHAIN_BATCHES},
          skinning_kernels={demangled(r.pop("kernel")): r for r in
                            _build.kernel_resources("skinning")},
          skinning_smem_bytes={f"N={n}": skinning_plan(n, V).smem
                               for n in SKIN_N},
          deform_kernels={demangled(r.pop("kernel")): r for r in
                          _build.kernel_resources("deform")},
          deform_smem_bytes=deform_smem(DEFORM["G"],
                                        DEFORM["C"] // DEFORM["G"]))

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
    phase_card_vs_cpu(dev, params, assets)
    phase_trace_card_vs_cpu(dev, trace_params)
    phase_time(dev, params, assets, smi)
    phase_trace_time(dev, trace_ckpt, smi)

    meta = {
        "skinning": ("romp_tpu_torch/csrc/lbs.cu",
                     "romp_tpu/ops/pallas_lbs.py:46"),
        "basic_chain": ("romp_tpu_torch/csrc/basic_chain.cu",
                        "romp_tpu/ops/pallas_fuse.py:134"),
        "deform_conv": ("romp_tpu_torch/csrc/deform_conv.cu",
                        "romp_tpu/ops/pallas_deform.py:103"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        # skinning: its largest main-path shape (N = 64 x 64); the chain:
        # the sum over the four branch shapes at B=2, one stage-4 module's
        # chains (PR 1's definition, so the numbers compare); the deform:
        # TRACE's shape, one launch per clip
        timed = ([r for r in rows[name] if r["batch"] == 2]
                 if name == "basic_chain" else rows[name][-1:])
        by_path = {"romp": romp_launches[name],
                   "trace": trace_launches[name]}
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
               if "f32_bound_ms" in timed[0] else {})))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
