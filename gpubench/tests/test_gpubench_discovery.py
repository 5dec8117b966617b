"""A cell, a configuration, a per-layer metric and a kernel's work count
added as files of their own (and entries in BENCHMARK.json) are found by
name: no other file of the benchmark is edited."""
from __future__ import annotations

import hashlib
import json
from pathlib import Path

import torch

from gpubench import harness

CPU = torch.device("cpu")


def digest(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "gpubench").rglob("*")) if p.is_file()}


def test_added_files_are_found_by_name(tiny_root: Path):
    before = digest(tiny_root)
    g = tiny_root / "gpubench"
    cfg = json.loads((g / "configs" / "tiny_romp_hrnet32_512.json").read_text())
    cfg["max_person"] = 6
    (g / "configs" / "tiny_romp_k6.json").write_text(json.dumps(cfg))
    traffic = json.loads((g / "workloads" / "tiny.romp.bulk.json").read_text())
    traffic.update(config="tiny_romp_k6", traffic="tiny_short", clients=4,
                   fetch_person=2)
    (g / "workloads" / "tiny.romp.k6.json").write_text(json.dumps(traffic))
    (g / "metrics" / "batches_run.py").write_text(
        "def read(run):\n    return float(run.counters[2] - run.counters[0])"
        "\n")
    (g / "metrics" / "extra_roofline.py").write_text(
        "from gpubench.roofline import kernel_roofline\n\n\n"
        "def read(run):\n    return kernel_roofline(run, 'extra')\n")
    (g / "kernels" / "extra.py").write_text(
        "NAMES = ('extra_kernel',)\n\n\ndef work(config, batch):\n"
        "    return [(4.0 * batch, [])]\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_romp_k6", "source": "test",
                             "file": "gpubench/configs/tiny_romp_k6.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny.romp.k6", "config":
                               "tiny_romp_k6", "traffic": "tiny_short",
                               "chips": 1, "why": "test"})
    bench["per_layer"] += [
        {"name": "batches_run", "unit": "batches", "better": "higher",
         "source": "program_counter", "layer": "batcher", "moves":
         "img_per_s", "workloads": ["tiny.romp.k6"]},
        {"name": "extra_roofline", "unit": "%", "better": "higher",
         "source": "device_trace", "layer": "kernels", "moves": "img_per_s",
         "workloads": ["tiny.romp.k6"]}]
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))

    after = digest(tiny_root)
    assert all(after[p] == d for p, d in before.items())   # nothing edited
    assert harness.kernel_of(tiny_root, "extra").NAMES == ("extra_kernel",)
    names = [m["name"] for m in harness.metrics_for(
        harness.benchmark(tiny_root), "tiny.romp.k6", "per_layer")]
    assert "batches_run" in names and "extra_roofline" in names
    assert "batches_run" not in [m["name"] for m in harness.metrics_for(
        harness.benchmark(tiny_root), "tiny.romp.bulk", "per_layer")]

    result, extra = harness.run_cell("tiny.romp.k6", 5, 3.0, True, CPU,
                                     root=tiny_root)
    assert result["correct"], extra
    assert result["metrics"]["batches_run"]["value"] > 0
    # the CPU has no device trace: a reader with nothing to read is left out
    assert "extra_roofline" not in result["metrics"]
    assert extra["images_compared"] > 0
