"""The control at a size a test run holds: the reference one precision
below the configuration's (float8 e4m3 conv operands for bfloat16) in the
program's place, on a tiny twin of each cell, fails the cell's own limits.
On the card it is read at each cell's own size by `gpubench/readings.py`."""
from __future__ import annotations

import pytest
import torch

from gpubench import harness, seeded

CPU = torch.device("cpu")


@pytest.mark.parametrize("cell", ["tiny.romp.bulk", "tiny.bev.bulk",
                                  "tiny.romp.crowd"])
def test_the_control_is_not_correct(tiny_root, cell):
    entry = harness.cell_entry(harness.benchmark(tiny_root), cell)
    traffic = harness.traffic_of(tiny_root, cell)
    cfg = harness.config_of(tiny_root, entry["config"])
    ref, sd, arrays, _, pool = harness.setup_state(cfg, traffic, 11, CPU)
    lower = {"bfloat16": "float8", "float32": "bfloat16"}[cfg["compute_dtype"]]
    images = torch.from_numpy(pool[:8])
    with torch.no_grad():
        out = ref.outputs(sd, arrays, seeded.SMPL_PARENTS, images, cfg, lower,
                          traffic["fetch_person"])
        kept = [(i, {k: v[i].numpy() for k, v in out.items()})
                for i in range(8)]
        parts, _, _ = harness.judge_all(ref, sd, arrays, cfg, traffic, pool,
                                        kept, CPU, False)
    numbers = harness.groups(parts)
    limits = traffic["check"]["limits"]
    assert any(numbers[n] > lim for n, lim in limits.items()), numbers
