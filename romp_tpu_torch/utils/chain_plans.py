"""Device time of the chain kernel under every launch plan it takes, and
where a pass's time goes, at the HRNet branch shapes of a 512x512 input,
on one GPU.

    python -m romp_tpu_torch.utils.chain_plans [--batches 1 2 16 64]
    python -m romp_tpu_torch.utils.chain_plans --breakdown [--batches 64]
    python -m romp_tpu_torch.utils.chain_plans --breakdown --bf16
        [--batches 64] [--whole_only]

Plans: for each branch shape (C, H) and batch, a 4-block chain on seeded
random operands through `basic_chain`, once per valid plan (tile rows x 8
pixels, tile_n output channels, K split; splits only below batch 64),
timed as the sum of its kernels' device time under `torch.profiler`, mean
of 5 calls. Prints one JSON line per shape and batch: the plan
`launch_plan` picks, the fastest plan, and every plan's (tile_h, tile_n,
ksplit, CTAs, us). The plans sum K in other orders, so each chain is held
to 5e-3 of max|ref| against the first plan's (the chain bar of
chip_smoke.py).

Breakdown: the same chains at the picked plan, built four times with
`-DROMP_CHAIN_SKIP` (basic_chain.cu): as they are, without the copies of
A and B, without the epilogue (and the residual's prefetch), and without
both (the MMAs alone). Prints, per shape and build, the mean device time
of a chain's conv1 passes, its conv2 passes (residual, f32 and bf16
outputs) and its NCHW -> NHWC conversion. Only the first build's results
are right.

bf16 breakdown (`--bf16`): the bf16-in / bf16-out chain (4 blocks, bf16
x) at each branch shape, built as it is and then with parts of the fused
block kernel left out (`-DROMP_CHAIN_FUSED_SKIP`, csrc/chain_block_bf16.cu:
the window's loads, the MMAs, conv2's MMAs, conv2's epilogue, h's stage,
the window's rewrite, the residual, the output's stores; the MMAs
alone). Prints, per shape, batch and build, the chain's device
time in us (its kernels' sum under torch.profiler, mean of 5 calls) and
each kernel's mean. The variants build in parallel first. The rows name
only `basic_chain` and the kernels' own names, so the same file times
another checkout's package (its parent's design, say) when that package
comes first on the path; `--whole_only` keeps the first build:
    PYTHONPATH=<other checkout> python romp_tpu_torch/utils/chain_plans.py \
        --breakdown --bf16 --whole_only
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from unittest import mock

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from romp_tpu_torch.ops import _build, fused_chain
from romp_tpu_torch.ops.fused_chain import (
    basic_chain, candidate_plans, launch_plan,
)

BRANCHES = ((32, 128), (64, 64), (128, 32), (256, 16))   # (C, H) at 512x512
SKIPS = (("all", 0), ("no copies", 1 | 2), ("no epilogue", 4),
         ("MMAs only", 1 | 2 | 4))
_F = "-DROMP_CHAIN_FUSED_SKIP="
BF16_BUILDS = (("all", ""), ("no window loads", f"{_F}1"),
               ("no MMAs", f"{_F}2"), ("no conv2 MMAs", f"{_F}1024"),
               ("no conv2 epilogue", f"{_F}4"), ("no h stage", f"{_F}8"),
               ("no rewrite", f"{_F}16"), ("no residual", f"{_F}128"),
               ("no stores", f"{_F}256"), ("MMAs only", f"{_F}29"))


def device_events(fn, calls: int = 5, tries: int = 5):
    """The device events of `calls` runs of fn() after one warm-up, in
    order of their start. Now and then the profiler reports no device
    event of a whole run: such a run is made again, and after `tries` of
    them the list is empty."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if events:
            break
    return sorted(events, key=lambda e: e.time_range.start)


def device_us(fn, calls: int = 5) -> float:
    """Mean device time of fn()'s kernels, in microseconds."""
    return sum(e.time_range.elapsed_us()
               for e in device_events(fn, calls)) / calls


def pass_us(fn, blocks: int = 4) -> dict:
    """Mean device time of a chain's conversion, conv1 and conv2 kernels:
    each chain is its conversion followed by 2 * blocks conv passes
    (chains whose events the profiler did not all report are left out)."""
    times = {"convert": [], "conv1": [], "conv2": []}
    chain = None
    for e in device_events(fn) + [None]:
        if e is None or "nhwc" in e.name:
            if chain is not None and len(chain) == 2 * blocks + 1:
                times["convert"].append(chain[0])
                times["conv1"] += chain[1::2]
                times["conv2"] += chain[2::2]
            chain = None if e is None else [e.time_range.elapsed_us()]
        elif chain is not None and "conv3x3" in e.name:
            chain.append(e.time_range.elapsed_us())
    return {k: round(sum(v) / len(v), 1) if v else None
            for k, v in times.items()}


def operands(g, C, H, batches, dev):
    w = (torch.randn(4, 2, 3 * C, 3 * C, generator=g) * 0.05).to(
        torch.bfloat16).to(dev)
    sc = (1 + 0.1 * torch.randn(4, 2, C, generator=g)).to(dev)
    sh = (0.1 * torch.randn(4, 2, C, generator=g)).to(dev)
    return w, sc, sh, {B: torch.randn(B, C, H, H, generator=g).to(dev)
                       for B in batches}


def sweep(batches, dev) -> None:
    _build.load()
    g = torch.Generator().manual_seed(0)
    for C, H in BRANCHES:
        w, sc, sh, xs = operands(g, C, H, batches, dev)
        for B, x in xs.items():
            rows, ref = [], None
            for plan in candidate_plans(B, C, H, H):
                if B >= 64 and plan.ksplit > 1:
                    continue
                with mock.patch.object(fused_chain, "launch_plan",
                                       lambda *_, plan=plan: plan):
                    y = basic_chain(x, w, sc, sh, 4)
                    ref = y if ref is None else ref
                    err = float((y - ref).abs().max() / ref.abs().max())
                    if err > 5e-3:
                        raise AssertionError(f"plan {plan}: {err}")
                    us = device_us(lambda: basic_chain(x, w, sc, sh, 4))
                rows.append((plan.tile_h, plan.tile_n, plan.ksplit,
                             plan.ctas, round(us, 1)))
            best = min(rows, key=lambda r: r[-1])
            print(json.dumps(dict(
                C=C, H=H, B=B, picked=launch_plan(B, C, H, H)[:3],
                fastest=best, plans=rows)), flush=True)


def breakdown(batches, dev) -> None:
    g = torch.Generator().manual_seed(0)
    data = [(C, H, operands(g, C, H, batches, dev)) for C, H in BRANCHES]
    flags = list(_build.NVCC_FLAGS)
    try:
        for name, mask in SKIPS:
            _build.NVCC_FLAGS[:] = flags + [f"-DROMP_CHAIN_SKIP={mask}"]
            _build._lib = None
            _build.load()
            for C, H, (w, sc, sh, xs) in data:
                for B, x in xs.items():
                    print(json.dumps(dict(
                        build=name, C=C, H=H, B=B,
                        plan=launch_plan(B, C, H, H)[:3],
                        us=pass_us(lambda: basic_chain(x, w, sc, sh, 4)))),
                        flush=True)
    finally:
        _build.NVCC_FLAGS[:] = flags
        _build._lib = None


def kernel_means(fn, calls: int = 5) -> tuple:
    """fn()'s device time in us (its kernels' sum, mean over `calls`) and
    each kernel's mean, by name and template arguments."""
    events = device_events(fn, calls)
    per = {}
    for e in events:
        name = e.name.replace("(anonymous namespace)::", "")
        name = re.sub(r"\(.*", "", name).replace("void ", "")
        per.setdefault(name, []).append(e.time_range.elapsed_us())
    total = sum(e.time_range.elapsed_us() for e in events) / calls
    return round(total, 1), {k: round(sum(v) / len(v), 1)
                             for k, v in per.items()}


def bf16_breakdown(batches, dev, whole_only: bool) -> None:
    g = torch.Generator().manual_seed(0)
    data = []
    for C, H in BRANCHES:
        w, sc, sh, xs = operands(g, C, H, batches, dev)
        data.append((C, H, w, sc, sh,
                     {B: x.to(torch.bfloat16) for B, x in xs.items()}))
    # here: kernel_breakdown imports this module
    from romp_tpu_torch.utils.kernel_breakdown import warm_clocks
    builds = BF16_BUILDS[:1] if whole_only else BF16_BUILDS
    flags = list(_build.NVCC_FLAGS)
    # every variant's library at once (one nvcc per source and variant)
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         "import sys; from romp_tpu_torch.ops import _build; "
         f"_build.NVCC_FLAGS.extend({flag.split()!r}); _build.build()"],
        env=None) for _, flag in builds]
    for proc in procs:
        if proc.wait() != 0:
            raise RuntimeError("a breakdown variant failed to build")
    warm_clocks(dev)
    try:
        for name, flag in builds:
            _build.NVCC_FLAGS[:] = flags + flag.split()
            _build._lib = None
            _build.load()
            for C, H, w, sc, sh, xs in data:
                for B, x in xs.items():
                    us, kernels = kernel_means(
                        lambda: basic_chain(x, w, sc, sh, 4))
                    print(json.dumps(dict(build=name, C=C, H=H, B=B,
                                          chain_us=us, kernels_us=kernels)),
                          flush=True)
    finally:
        _build.NVCC_FLAGS[:] = flags
        _build._lib = None


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, nargs="+", default=None)
    ap.add_argument("--breakdown", action="store_true",
                    help="time conv1 / conv2 with parts of the kernel left "
                         "out, instead of sweeping the plans")
    ap.add_argument("--bf16", action="store_true",
                    help="with --breakdown: the bf16 chain's fused block "
                         "kernel instead of the f32 chain's passes")
    ap.add_argument("--whole_only", action="store_true",
                    help="with --bf16: the first build alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chain_plans: no CUDA device; this times the GPU")
    dev = torch.device("cuda", 0)
    if args.breakdown and args.bf16:
        bf16_breakdown(args.batches or [64], dev, args.whole_only)
    elif args.breakdown:
        breakdown(args.batches or [64], dev)
    else:
        sweep(args.batches or [1, 2, 16, 64], dev)


if __name__ == "__main__":
    main()
