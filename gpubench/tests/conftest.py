"""Fixtures of the benchmark's CPU tests: tiny copies of the cells (the
small HRNet twin, 64x64 images, batches of 4) in a scratch checkout, and
the `cuda` fixture that skips a test where no card is there."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {"backbone": "hrnet32_tiny", "input_size": 64}


def tiny_files(root: Path) -> None:
    """BENCHMARK.json with tiny twins of the cells, their configuration and
    traffic files, under `root` (a copy of the benchmark's folder)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = []
    for cell in bench["workloads"]:
        name = "tiny." + cell["name"]
        cfg = json.loads((ROOT / "gpubench" / "configs" /
                          f"{cell['config']}.json").read_text())
        cfg.update(TINY, max_person=8)
        cfg_name = "tiny_" + cell["config"]
        (root / "gpubench" / "configs" / f"{cfg_name}.json").write_text(
            json.dumps(cfg))
        traffic = json.loads((ROOT / "gpubench" / "workloads" /
                              f"{cell['name']}.json").read_text())
        traffic.update(config=cfg_name, clients=8, max_batch=4,
                       pool_images=8, calibration_images=2,
                       fetch_person=min(traffic["fetch_person"], 4),
                       profile={"delay_s": 0.2, "seconds": 0.5})
        traffic["check"].update(keep_share=1.0, block=4)
        (root / "gpubench" / "workloads" / f"{name}.json").write_text(
            json.dumps(traffic))
        cells.append(dict(cell, name=name, config=cfg_name))
    bench["workloads"] += cells
    bench["configs"] += [dict(c, name="tiny_" + c["name"]) for c in
                         bench["configs"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    tiny_files(tmp_path)
    return tmp_path


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
