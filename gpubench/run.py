"""The benchmark's command.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout. Prints the run's compared numbers on
standard error and, as the last line of standard output, one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end metrics,
or with --trace 1 its per-layer ones), `device`, with --trace 1
`breakdown`, and last `checks` (each compared number with its limit).
Exits 2 without a result where no CUDA device is there, or fewer than the
cell asks for; 3 where JAX, Flax or the JAX package got loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the repository's root, in place of this script's folder: the benchmark's
# modules are imported as `gpubench.*`, never as top-level names
sys.path[0] = str(ROOT)
# a library that would load JAX by itself is kept from it
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

import torch  # noqa: E402

from gpubench import harness  # noqa: E402


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    entry = harness.cell_entry(harness.benchmark(ROOT), args.workload)
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < entry["chips"]):
        print(f"gpubench: the cell needs {entry['chips']} CUDA device(s); "
              f"this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(f"gpubench: {args.workload} seed {args.seed} on {power_limit()}",
          file=sys.stderr, flush=True)
    result, extra = harness.run_cell(args.workload, args.seed, args.seconds,
                                     bool(args.trace), device,
                                     t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"gpubench: loaded in this process: {found}", file=sys.stderr)
        return 3
    print("numbers " + json.dumps(extra["numbers"]), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
