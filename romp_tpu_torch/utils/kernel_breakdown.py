"""Where the skinning and deform kernels' time goes, on one GPU.

    python -m romp_tpu_torch.utils.kernel_breakdown [--reps 30]
        [--parts skinning skinning_bwd deform deform_bf16 deform_bwd]
        [--skin_bwd_n 512 4096] [--whole_only]

Builds the kernel library once as it is and then with parts of the
kernels left out (`-DROMP_LBS_SKIP`, `-DROMP_LBS_BWD_SKIP`,
`-DROMP_DEFORM_SKIP` and `-DROMP_DEFORM_BWD_SKIP` masks, see csrc/lbs.cu
and csrc/deform_conv.cu; the results of those builds are wrong) or
other sizes of the bf16 deform (`-DROMP_DEFORM_BF16_EY`, its x window's
rows; right results), and times skinning at N = 4096 persons, V = 6890 (ROMP at
batch 64 x 64 slots), its backward at each N of `--skin_bwd_n` (512: the
train steps' 64 x 8 GT persons), the deform at TRACE's shape (B = 8, C =
Cout = 32, 128 x 128, G = 8; f32, and bf16 x and weight as
`deform_bf16`, both with N(0, 2^2) offsets) and its backward at the
train step's clip (B = 10, the same widths) on seeded random operands.
`--parts` keeps the builds that concern those kernels; `--whole_only`
keeps the first build alone.
Times: CUDA events around `--reps` back-to-back calls, three times, after
the card has run a matrix product for 0.3 s (a card that idled through a
build starts at low clocks). Prints one JSON line per build: the three
per-call times in us of each kernel the build concerns, and for the
backwards and the bf16 deform also each of their kernels' mean device
time in us (torch.profiler).

The skinning backward's and the bf16 deform's rows name only their
wrappers and a prefix of their kernels' names, so the same file times
another checkout's package (its parent's design, say) when that package
comes first on the path:
    PYTHONPATH=<other checkout> python romp_tpu_torch/utils/kernel_breakdown.py
"""
from __future__ import annotations

import argparse
import json
import re

import torch

from romp_tpu_torch.ops import _build
from romp_tpu_torch.ops.deform_conv import (
    deform_conv2d, deform_conv2d_backward,
)
from romp_tpu_torch.ops.lbs import skinning, skinning_backward
from romp_tpu_torch.utils.chain_plans import device_events

PARTS = ("skinning", "skinning_bwd", "deform", "deform_bf16", "deform_bwd")
# (name, nvcc flag, the parts it concerns)
BUILDS = (
    ("all", "", PARTS),
    ("skinning: no MMAs", "-DROMP_LBS_SKIP=1", ("skinning",)),
    ("skinning: no v_posed copies", "-DROMP_LBS_SKIP=2", ("skinning",)),
    ("skinning: no stores", "-DROMP_LBS_SKIP=4", ("skinning",)),
    ("skinning: MMAs, A16 and the apply only", "-DROMP_LBS_SKIP=6",
     ("skinning",)),
    ("skinning: A16 and the apply only", "-DROMP_LBS_SKIP=7", ("skinning",)),
    ("skinning bwd: no MMAs", "-DROMP_LBS_BWD_SKIP=1", ("skinning_bwd",)),
    ("skinning bwd: no g / v_posed copies", "-DROMP_LBS_BWD_SKIP=2",
     ("skinning_bwd",)),
    ("skinning bwd: no dA16 meeting or partial stores",
     "-DROMP_LBS_BWD_SKIP=4", ("skinning_bwd",)),
    ("skinning bwd: no reduce kernel", "-DROMP_LBS_BWD_SKIP=8",
     ("skinning_bwd",)),
    ("skinning bwd: no dv stores", "-DROMP_LBS_BWD_SKIP=16",
     ("skinning_bwd",)),
    ("skinning bwd: MMAs and operands only (no copies, meeting, reduce "
     "or dv stores)", "-DROMP_LBS_BWD_SKIP=30", ("skinning_bwd",)),
    ("skinning bwd: none of the five", "-DROMP_LBS_BWD_SKIP=31",
     ("skinning_bwd",)),
    # the segment design's own parts (the earlier per-tile design has no
    # such bits)
    ("skinning bwd: no W split", "-DROMP_LBS_BWD_SKIP=32",
     ("skinning_bwd",)),
    ("skinning bwd: no dv part", "-DROMP_LBS_BWD_SKIP=64",
     ("skinning_bwd",)),
    ("skinning bwd: no dA16 part", "-DROMP_LBS_BWD_SKIP=128",
     ("skinning_bwd",)),
    ("skinning bwd: neither part", "-DROMP_LBS_BWD_SKIP=192",
     ("skinning_bwd",)),
    ("deform: no gathers", "-DROMP_DEFORM_SKIP=1",
     ("deform", "deform_bf16")),
    ("deform: no MMAs", "-DROMP_DEFORM_SKIP=2", ("deform", "deform_bf16")),
    ("deform: neither", "-DROMP_DEFORM_SKIP=3", ("deform", "deform_bf16")),
    ("deform bf16: no x window (no loads, no rewrite)",
     "-DROMP_DEFORM_SKIP=4", ("deform_bf16",)),
    ("deform bf16: none of the three", "-DROMP_DEFORM_SKIP=7",
     ("deform_bf16",)),
    ("deform bf16: the offsets' stream alone (no sampling, MMAs or window)",
     "-DROMP_DEFORM_SKIP=14", ("deform_bf16",)),
    ("deform bf16: no offsets' loads (the consumers alone)",
     "-DROMP_DEFORM_SKIP=16", ("deform_bf16",)),
    ("deform bf16: window rows +- 4", "-DROMP_DEFORM_BF16_EY=4",
     ("deform_bf16",)),
    ("deform bf16: window rows +- 6", "-DROMP_DEFORM_BF16_EY=6",
     ("deform_bf16",)),
    ("deform bwd: no dx scatter", "-DROMP_DEFORM_BWD_SKIP=9",
     ("deform_bwd",)),
    ("deform bwd: no window flush", "-DROMP_DEFORM_BWD_SKIP=8",
     ("deform_bwd",)),
    ("deform bwd: no tags or barriers (plain adds)",
     "-DROMP_DEFORM_BWD_SKIP=16", ("deform_bwd",)),
    ("deform bwd: no gathers", "-DROMP_DEFORM_BWD_SKIP=2", ("deform_bwd",)),
    ("deform bwd: no contractions", "-DROMP_DEFORM_BWD_SKIP=4",
     ("deform_bwd",)),
    ("deform bwd: none of the three", "-DROMP_DEFORM_BWD_SKIP=15",
     ("deform_bwd",)),
)
BWD_PREFIX = "deform_bwd_"   # in every backward kernel's name
DEFORM_PREFIX = "deform_"    # in every deform kernel's name
SKIN_BWD_PREFIX = "skinning_bwd_"


def warm_clocks(dev, ms: float = 300.0) -> None:
    """Run matrix products for `ms` of device time."""
    a = torch.randn(4096, 4096, device=dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    while True:
        for _ in range(10):
            a @ a
        end.record()
        end.synchronize()
        if start.elapsed_time(end) > ms:
            return


def event_us(fn, reps: int) -> list:
    """Three readings of the mean time of fn() over `reps` calls, in us."""
    for _ in range(5):
        fn()
    out = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps * 1e3)
    return out


def kernel_us(fn, prefix: str, calls: int = 10) -> dict:
    """Mean device time in us of each kernel of fn() whose name
    contains `prefix`, by name and template arguments (torch.profiler)."""
    times = {}
    for e in device_events(fn, calls):
        if prefix in e.name:
            name = re.search(r"(\w+(?:<[^>]*>)?)\(", e.name.replace(
                "(anonymous namespace)::", "")).group(1)
            times.setdefault(name, []).append(e.time_range.elapsed_us())
    return {k: sum(v) / len(v) for k, v in times.items()}


def selected_builds(parts, whole_only: bool):
    """The builds of BUILDS that concern `parts`, with the parts each
    times (the first build alone with `whole_only`)."""
    out = []
    for name, flag, concerns in BUILDS[:1] if whole_only else BUILDS:
        keep = tuple(p for p in concerns if p in parts)
        if keep:
            out.append((name, flag, keep))
    return out


def skin_operands(dev, g, n, v=6890):
    """Seeded skinning operands: a16 (n, 16, 24), lbs weights normalized
    over the joints, v_posed and a cotangent (n, 3, v)."""
    a16 = torch.randn(n, 16, 24, generator=g).to(dev)
    w = torch.rand(v, 24, generator=g).to(dev)
    w /= w.sum(1, keepdim=True)
    vpos = torch.randn(n, 3, v, generator=g).to(dev)
    cot = torch.randn(n, 3, v, generator=g).to(dev)
    return a16, w, vpos, cot


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--parts", nargs="+", choices=PARTS, default=PARTS)
    ap.add_argument("--skin_bwd_n", nargs="+", type=int, default=[512, 4096])
    ap.add_argument("--whole_only", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_breakdown: no CUDA device; this times the GPU")
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(0)
    calls = {}
    if "skinning" in args.parts:
        a16, w, vpos, _ = skin_operands(dev, g, 4096)
        calls["skinning"] = lambda: skinning(a16, w, vpos)
    bwd_calls = {}
    if "skinning_bwd" in args.parts:
        for n in args.skin_bwd_n:
            ops = skin_operands(dev, g, n)
            bwd_calls[n] = lambda ops=ops: skinning_backward(*ops)
    if "deform" in args.parts:
        x = torch.randn(8, 32, 128, 128, generator=g).to(dev)
        off = (torch.randn(8, 144, 128, 128, generator=g) * 2.0).to(dev)
        wd = (torch.randn(32, 32, 3, 3, generator=g) * 0.1).to(dev)
        calls["deform"] = lambda: deform_conv2d(x, off, wd, 8)
    if "deform_bf16" in args.parts:
        xh = torch.randn(8, 32, 128, 128, generator=g).to(
            torch.bfloat16).to(dev)
        offh = (torch.randn(8, 144, 128, 128, generator=g) * 2.0).to(dev)
        wh = (torch.randn(32, 32, 3, 3, generator=g) * 0.1).to(
            torch.bfloat16).to(dev)
        calls["deform_bf16"] = lambda: deform_conv2d(xh, offh, wh, 8)
    if "deform_bwd" in args.parts:
        xb = torch.randn(10, 32, 128, 128, generator=g).to(dev)
        offb = (torch.randn(10, 144, 128, 128, generator=g) * 2.0).to(dev)
        wb = (torch.randn(32, 32, 3, 3, generator=g) * 0.1).to(dev)
        gout = torch.randn(10, 32, 128, 128, generator=g).to(dev)
        calls["deform_bwd"] = lambda: deform_conv2d_backward(
            xb, offb, wb, gout, 8)
    flags = list(_build.NVCC_FLAGS)
    try:
        for name, flag, parts in selected_builds(args.parts,
                                                 args.whole_only):
            _build.NVCC_FLAGS[:] = flags + flag.split()
            _build._lib = None
            _build.load()
            warm_clocks(dev)
            row = dict(build=name)
            for part in parts:
                if part == "skinning_bwd":
                    for n, fn in bwd_calls.items():
                        row[f"skinning_bwd_N{n}_us"] = event_us(fn, args.reps)
                        row[f"skinning_bwd_N{n}_kernels_us"] = kernel_us(
                            fn, SKIN_BWD_PREFIX)
                    continue
                row[f"{part}_us"] = event_us(calls[part], args.reps)
            if "deform_bwd" in parts:
                row["deform_bwd_kernels_us"] = kernel_us(
                    calls["deform_bwd"], BWD_PREFIX)
            if "deform_bf16" in parts:
                row["deform_bf16_kernels_us"] = kernel_us(
                    calls["deform_bf16"], DEFORM_PREFIX)
            print(json.dumps(row), flush=True)
    finally:
        _build.NVCC_FLAGS[:] = flags
        _build._lib = None


if __name__ == "__main__":
    main()
