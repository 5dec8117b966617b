"""The readings that the check's limits are set from (not run by the
benchmark's own runs).

    python3 gpubench/readings.py --workload <cell> --seeds 1 2 ...
        [--seconds 4] [--out chiprun_out/readings.jsonl]

For each seed, one run of the cell as the benchmark makes it (a short
window at the cell's own load, the check at the cell's own sizes), whose
judged numbers are the program's readings; and on the same kept images,
the reference computed one precision below the configuration's (float8 e4m3
conv operands for bfloat16) in the program's place, judged alike: the
control's readings. One JSON line a seed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# the repository's root, in place of this script's folder: the benchmark's
# modules are imported as `gpubench.*`, never as top-level names
sys.path[0] = str(ROOT)

import torch  # noqa: E402

from gpubench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--keep", type=float, default=None,
                    help="share of completions kept for the check (default "
                         "the cell's), so that a shorter window compares as "
                         "many images as a run")
    ap.add_argument("--witness", action="store_true",
                    help="also judge the reference at the configuration's "
                         "precision with cuDNN let use TF32")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        t = time.perf_counter()
        result, extra = harness.run_cell(args.workload, seed, args.seconds,
                                         False, device, control=True,
                                         witness=args.witness,
                                         keep=args.keep)
        line = json.dumps(dict(
            workload=args.workload, seed=seed, correct=result["correct"],
            program=extra["parts"], control=extra["control"],
            witness=extra["witness"],
            images=extra["images_compared"], metrics=result["metrics"],
            seconds=time.perf_counter() - t))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
