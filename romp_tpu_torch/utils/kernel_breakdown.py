"""Where the skinning and deform kernels' time goes, on one GPU.

    python -m romp_tpu_torch.utils.kernel_breakdown [--reps 30]

Builds the kernel library once as it is and then with parts of the two
kernels left out (`-DROMP_LBS_SKIP` and `-DROMP_DEFORM_SKIP` masks, see
csrc/lbs.cu and csrc/deform_conv.cu; only the first build's results are
right), and times skinning at N = 4096 persons, V = 6890 (ROMP at batch 64
x 64 slots) and the deform at TRACE's shape (B = 8, C = Cout = 32,
128 x 128, G = 8) on seeded random operands. Times: CUDA events around
`--reps` back-to-back calls, three times, after the card has run a
matrix product for 0.3 s (a card that idled through a build starts at low
clocks). Prints one JSON line per build: the three per-call times in us.
"""
from __future__ import annotations

import argparse
import json

import torch

from romp_tpu_torch.ops import _build
from romp_tpu_torch.ops.deform_conv import deform_conv2d
from romp_tpu_torch.ops.lbs import skinning

BUILDS = (
    ("all", ""),
    ("skinning: no MMAs", "-DROMP_LBS_SKIP=1"),
    ("skinning: no v_posed copies", "-DROMP_LBS_SKIP=2"),
    ("skinning: no stores", "-DROMP_LBS_SKIP=4"),
    ("skinning: MMAs, A16 and the apply only", "-DROMP_LBS_SKIP=6"),
    ("skinning: A16 and the apply only", "-DROMP_LBS_SKIP=7"),
    ("deform: no gathers", "-DROMP_DEFORM_SKIP=1"),
    ("deform: no MMAs", "-DROMP_DEFORM_SKIP=2"),
    ("deform: neither", "-DROMP_DEFORM_SKIP=3"),
)


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
    flags = list(_build.NVCC_FLAGS)
    try:
        for name, flag in BUILDS:
            _build.NVCC_FLAGS[:] = flags + ([flag] if flag else [])
            _build._lib = None
            _build.load()
            warm_clocks(dev)
            print(json.dumps(dict(
                build=name,
                skinning_us=event_us(lambda: skinning(a16, w, vpos),
                                     args.reps),
                deform_us=event_us(lambda: deform_conv2d(x, off, wd, 8),
                                   args.reps))), flush=True)
    finally:
        _build.NVCC_FLAGS[:] = flags
        _build._lib = None


if __name__ == "__main__":
    main()
