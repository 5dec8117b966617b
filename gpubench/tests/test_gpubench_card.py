"""On the card: one short run of each cell through the benchmark's command,
as the driver runs it, with a correct result and the contract's keys.
Skips without a CUDA device (the `cuda` fixture)."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["romp.bulk", "bev.bulk", "romp.crowd"])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run(cuda, cell, trace):
    proc = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", cell, "--seed",
         "2147483999", "--seconds", "6", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], proc.stderr[-3000:]
    assert list(result)[-1] == "checks"
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["count"] == 1
    if trace:
        assert result["device"]["busy_s"] > 0
        assert "device_ms_per_batch" in result["metrics"]
    else:
        assert {"img_per_s", "setup_s"} <= set(result["metrics"])
