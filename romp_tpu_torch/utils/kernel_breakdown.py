"""Where the skinning and deform kernels' time goes, on one GPU.

    python -m romp_tpu_torch.utils.kernel_breakdown [--reps 30]

Builds the kernel library once as it is and then with parts of the
kernels left out (`-DROMP_LBS_SKIP`, `-DROMP_DEFORM_SKIP` and
`-DROMP_DEFORM_BWD_SKIP` masks, see csrc/lbs.cu and csrc/deform_conv.cu;
only the first build's results are right), and times skinning at N = 4096
persons, V = 6890 (ROMP at batch 64 x 64 slots), the deform at TRACE's
shape (B = 8, C = Cout = 32, 128 x 128, G = 8) and its backward at the
train step's clip (B = 10, the same widths) on seeded random operands.
Times: CUDA events around `--reps` back-to-back calls, three times, after
the card has run a matrix product for 0.3 s (a card that idled through a
build starts at low clocks). Prints one JSON line per build: the three
per-call times in us of each kernel the build concerns, and for the
backward also each of its kernels' mean device time in us
(torch.profiler).
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
from romp_tpu_torch.ops.lbs import skinning
from romp_tpu_torch.utils.chain_plans import device_events

PARTS = ("skinning", "deform", "deform_bwd")
# (name, nvcc flag, the parts it concerns)
BUILDS = (
    ("all", "", PARTS),
    ("skinning: no MMAs", "-DROMP_LBS_SKIP=1", ("skinning",)),
    ("skinning: no v_posed copies", "-DROMP_LBS_SKIP=2", ("skinning",)),
    ("skinning: no stores", "-DROMP_LBS_SKIP=4", ("skinning",)),
    ("skinning: MMAs, A16 and the apply only", "-DROMP_LBS_SKIP=6",
     ("skinning",)),
    ("skinning: A16 and the apply only", "-DROMP_LBS_SKIP=7", ("skinning",)),
    ("deform: no gathers", "-DROMP_DEFORM_SKIP=1", ("deform",)),
    ("deform: no MMAs", "-DROMP_DEFORM_SKIP=2", ("deform",)),
    ("deform: neither", "-DROMP_DEFORM_SKIP=3", ("deform",)),
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_breakdown: no CUDA device; this times the GPU")
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(0)
    a16 = torch.randn(4096, 16, 24, generator=g).to(dev)
    w = torch.rand(6890, 24, generator=g).to(dev)
    w /= w.sum(1, keepdim=True)
    vpos = torch.randn(4096, 3, 6890, generator=g).to(dev)
    x = torch.randn(8, 32, 128, 128, generator=g).to(dev)
    off = (torch.randn(8, 144, 128, 128, generator=g) * 2.0).to(dev)
    wd = (torch.randn(32, 32, 3, 3, generator=g) * 0.1).to(dev)
    xb = torch.randn(10, 32, 128, 128, generator=g).to(dev)
    offb = (torch.randn(10, 144, 128, 128, generator=g) * 2.0).to(dev)
    gout = torch.randn(10, 32, 128, 128, generator=g).to(dev)
    calls = dict(
        skinning=lambda: skinning(a16, w, vpos),
        deform=lambda: deform_conv2d(x, off, wd, 8),
        deform_bwd=lambda: deform_conv2d_backward(xb, offb, wd, gout, 8))
    flags = list(_build.NVCC_FLAGS)
    try:
        for name, flag, parts in BUILDS:
            _build.NVCC_FLAGS[:] = flags + ([flag] if flag else [])
            _build._lib = None
            _build.load()
            warm_clocks(dev)
            row = dict(build=name)
            for part in parts:
                row[f"{part}_us"] = event_us(calls[part], args.reps)
            if "deform_bwd" in parts:
                row["deform_bwd_kernels_us"] = kernel_us(
                    calls["deform_bwd"], BWD_PREFIX)
            print(json.dumps(row), flush=True)
    finally:
        _build.NVCC_FLAGS[:] = flags
        _build._lib = None


if __name__ == "__main__":
    main()
