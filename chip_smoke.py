"""Drive the PyTorch + CUDA port of the ROMP image path once on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is nonzero:
 1. device: a CUDA device is required (nothing here runs on the CPU instead);
 2. build: compile the hand-written kernels from romp_tpu_torch/csrc;
 3. kernels: each kernel against its plain PyTorch version at the main
    path's shapes, with kernel and plain times (CUDA events, medians);
 4. slice: full-width HRNet-W32 at 512x512 (seeded random weights,
    synthetic SMPL assets) through the `ROMP` entry point on 4 images and
    through `RompPipeline` at batch 16 in four configurations, with the
    kernels' launch counters read around that run;
 5. card vs CPU: the same weights and image through the port on the CPU
    (plain versions) and on the card (kernels), f32 with TF32 off; then the
    mixed path, every conv of the net at batches 1, 16 and 64 and the
    whole net's maps;
 6. time: the slice end to end, img/s.
Then the kernels' JSON line, the card's name and power limit, and the
result line.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from romp_tpu_torch.cli.romp import ROMP, romp_settings  # noqa: E402
from romp_tpu_torch.models.layers import Conv2d, LayerOpts  # noqa: E402
from romp_tpu_torch.ops import _build  # noqa: E402
from romp_tpu_torch.ops.centermap import nms_heatmap  # noqa: E402
from romp_tpu_torch.ops.fused_chain import (  # noqa: E402
    basic_chain, basic_chain_plain, conv_pass, conv_pass_plain,
)
from romp_tpu_torch.ops.lbs import skinning, skinning_plain  # noqa: E402
from romp_tpu_torch.pipeline.romp_pipeline import (  # noqa: E402
    RompConfig, RompPipeline, precision_flags,
)
from romp_tpu_torch.smpl.body_model import (  # noqa: E402
    SmplModel, synthetic_assets,
)
from romp_tpu_torch.utils.profiling import seeded_params  # noqa: E402

MIXED = LayerOpts(compute_dtype=torch.bfloat16)
BRANCHES = ((32, 128), (64, 64), (128, 32), (256, 16))  # (C, H) at 512x512
SKIN_N = (64, 4096)     # batch x max_person: 1 x 64 (CLI), 64 x 64
V = 6890


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


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def phase_kernels(dev):
    g = torch.Generator().manual_seed(0)
    rows = {"skinning": [], "basic_chain": []}
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
        rows["skinning"].append(dict(
            shape=f"N={n},V={V}", max_abs_err=float((out - ref).abs().max()),
            rel_err=err, ms=time_ms(lambda: skinning(a16, w, vpos)),
            plain_ms=time_ms(lambda: skinning_plain(a16, w, vpos))))
    blocks = 4
    for C, H in BRANCHES:
        x = torch.randn(2, C, H, H, generator=g).to(dev)
        w = (torch.randn(blocks, 2, 3 * C, 3 * C, generator=g) * 0.05).to(
            torch.bfloat16).to(dev)
        sc = (1 + 0.1 * torch.randn(blocks, 2, C, generator=g)).to(dev)
        sh = (0.1 * torch.randn(blocks, 2, C, generator=g)).to(dev)
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
        check(pass_err <= 5e-4, f"chain C={C}: pass rel err {pass_err}")
        check(torch.equal(full, y), f"chain C={C}: chain != its passes")
        check(chain_err <= 5e-3, f"chain C={C}: chain rel err {chain_err}")
        rows["basic_chain"].append(dict(
            shape=f"B=2,C={C},H=W={H},blocks=4", max_abs_err=pass_abs,
            rel_err=pass_err, chain_rel_err=chain_err,
            ms=time_ms(lambda: basic_chain(x, w, sc, sh, blocks)),
            plain_ms=time_ms(
                lambda: basic_chain_plain(x, w, sc, sh, blocks))))
    for name, shapes in rows.items():
        for row in shapes:
            phase(3, f"kernel {name}", **row)
    return rows


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
                "basic_chain": conv_pass.launches}
    phase(4, "slice", romp_4_images_s=romp_s, pipeline_runs=runs,
          launches=launches)
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
        maps_m, conv_errs[batch] = mixed_convs_vs_cpu(gpu.net, cpu.net,
                                                      images, dev)
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
    phase(5, "card vs cpu", map_rel_errs=map_errs, detections=len(sc),
          verts_max_abs_err=vert_err, mixed_conv_rel_err_by_batch=conv_errs,
          mixed_map_rel_errs_max_mean=mixed_errs,
          cpu_mixed_vs_f32_max_mean=gaps)


def mixed_convs_vs_cpu(gpu_net, cpu_net, images, dev):
    """Run the card's net on the mixed path over `images` (B, S, S, 3) with
    a hook on every conv that holds its output for the first image against
    the CPU's conv of the same input. bf16 operands make every product exact
    in TF32, so the two agree to summation order, as long as cuDNN picks an
    algorithm that multiplies the operands as given (implicit GEMM); one
    that transforms them first (Winograd, FFT) rounds the transformed
    values to TF32 and fails here. Returns the card's maps and the largest
    error."""
    cpu_convs = dict(cpu_net.named_modules())
    errs = []

    def hook(name):
        def fn(module, args, out):
            check(len(args) == 2 and args[1] == MIXED,
                  f"{name}: not run as the mixed conv")
            ref = cpu_convs[name](args[0][:1].cpu(), MIXED)
            errs.append(rel_err(out[:1].cpu(), ref))
        return fn

    hooks = [m.register_forward_hook(hook(n))
             for n, m in gpu_net.named_modules() if isinstance(m, Conv2d)]
    try:
        with torch.inference_mode(), precision_flags(
                RompConfig(compute_dtype="bfloat16")):
            maps = gpu_net(torch.from_numpy(images).to(dev), MIXED)
    finally:
        for h in hooks:
            h.remove()
    check(len(errs) == len(hooks), f"{len(errs)} of {len(hooks)} convs ran")
    check(max(errs) <= 1e-5, f"mixed convs card vs cpu: {max(errs)}")
    return maps, max(errs)


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
            rows.append(dict(compute_dtype="bfloat16", fuse_chains=fuse,
                             batch=batch, median_s=sec, img_per_s=batch / sec,
                             reps=reps, card=smi))
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
          library=str(_build.library_path().name))

    rows = phase_kernels(dev)
    params = seeded_params()
    assets = synthetic_assets(seed=0)
    images16 = (np.random.RandomState(0).rand(16, 512, 512, 3) * 255).astype(
        np.uint8)
    launches = phase_slice(dev, params, assets, images16)
    phase_card_vs_cpu(dev, params, assets)
    phase_time(dev, params, assets, smi)

    meta = {
        "skinning": ("romp_tpu_torch/csrc/lbs.cu",
                     "romp_tpu/ops/pallas_lbs.py:46"),
        "basic_chain": ("romp_tpu_torch/csrc/basic_chain.cu",
                        "romp_tpu/ops/pallas_fuse.py:134"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        # skinning: its largest main-path shape (N = 64 x 64); the chain:
        # the sum over the four branch shapes, one stage-4 module's chains
        timed = rows[name][-1:] if name == "skinning" else rows[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in rows[name]),
            ms=sum(r["ms"] for r in timed),
            plain_ms=sum(r["plain_ms"] for r in timed),
            shape="; ".join(r["shape"] for r in timed)))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
