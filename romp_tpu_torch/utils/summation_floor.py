"""How far the port's f32 BEV path moves when only the order of its f32
sums changes, on the CPU: the floor against which a card-vs-CPU difference
is read (`chip_smoke.py` phase 5 holds BEV's whole chain to 1e-3 of
max|ref|).

    python -m romp_tpu_torch.utils.summation_floor

At phase 5's BEV shape (full-width BEV, HRNet-W32 at 512x512, batch 1,
seeded weights with BatchNorm calibrated on the CPU, the seeded image of
phase 5), f32 throughout, the maps are computed once per order:
- with 1 thread and with 6 (oneDNN splits some reductions by thread);
- oneDNN off (`torch.backends.mkldnn.flags(enabled=False)`: PyTorch's own
  im2col + GEMM convs, another order of every conv's sum).
Each map is held against the first run: max |a - b| / max |b|, for the
whole chain (image -> maps) and for the head fed the first run's
features. Prints one JSON line. CPU only, by design: it measures the
CPU's own spread.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from romp_tpu_torch.models.bev import BevNet, bev_head_maps
from romp_tpu_torch.utils.profiling import seeded_bev_params

THREADS = (1, 6)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def main() -> dict:
    torch.set_num_threads(THREADS[-1])
    net = BevNet()
    net.load_state_dict(seeded_bev_params(device="cpu"))
    net.eval()
    image = torch.from_numpy((np.random.RandomState(70).rand(
        1, 512, 512, 3) * 255).astype(np.uint8))

    def run(threads, mkldnn=True, feats=None):
        torch.set_num_threads(threads)
        with torch.inference_mode(), torch.backends.mkldnn.flags(
                enabled=mkldnn):
            f = net.extract_features(image) if feats is None else feats
            return f, bev_head_maps(net, f)

    runs = {f"threads={t}": run(t) for t in THREADS}
    runs[f"threads={THREADS[-1]},no_mkldnn"] = run(THREADS[-1], mkldnn=False)
    (ref_name, (ref_feats, ref_maps)), *others = runs.items()
    out = {"reference": ref_name, "shape": "BEV 512x512, batch 1, f32",
           "orders": {}}
    for name, (feats, maps) in others:
        threads = int(name.split("=")[1].split(",")[0])
        _, head = run(threads, "no_mkldnn" not in name, ref_feats)
        out["orders"][name] = {
            "feature_rel_err": _rel(feats, ref_feats),
            "whole_chain": {k: _rel(getattr(maps, k), getattr(ref_maps, k))
                            for k in maps._fields},
            "same_features": {k: _rel(getattr(head, k), getattr(ref_maps, k))
                              for k in maps._fields}}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
