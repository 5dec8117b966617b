"""One run of one cell: set-up from the seed, the measured window under a
closed loop, the traced stretch, the check against the reference, and the
result line.

Everything a cell is made of is found by name: its entry in
`BENCHMARK.json`, its traffic file `gpubench/workloads/<cell>.json`, its
configuration `gpubench/configs/<config>.json`, the configuration's model
family in `gpubench/systems/<family>.py` (the system under test) and
`gpubench/reference/<family>.py` (the plain reference and its judge), each
metric's reader `gpubench/metrics/<metric>.py` and each kernel's work count
`gpubench/kernels/<kernel>.py`.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from gpubench import devtrace, seeded
from gpubench.reference.nn import no_tf32, spec_of
from gpubench.traffic import ClosedLoop

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "romp_tpu")
DRAIN_S = 120.0


# ------------------------------------------------------------- discovery

def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def cell_entry(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def traffic_of(root: Path, cell: str) -> Dict:
    return load_json(root / "gpubench" / "workloads" / f"{cell}.json")


def config_of(root: Path, name: str) -> Dict:
    return load_json(root / "gpubench" / "configs" / f"{name}.json")


def _module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "gpubench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(root: Path, name: str) -> Callable:
    """`read(run)` of gpubench/metrics/<name>.py."""
    return _module(root / "gpubench" / "metrics" / f"{name}.py").read


def kernel_of(root: Path, name: str):
    """gpubench/kernels/<name>.py: NAMES and work(config, batch)."""
    return _module(root / "gpubench" / "kernels" / f"{name}.py")


def metrics_for(bench: Dict, cell: str, group: str) -> List[Dict]:
    """The metrics of `group` ("end_to_end" or "per_layer") this cell
    reports: those without a `workloads` list, and those that list it."""
    return [m for m in bench[group] if cell in m.get("workloads", [cell])]


# ------------------------------------------------------------------ run

@dataclass
class Run:
    """What a metric reader reads."""

    root: Path
    cell: str
    traffic: Dict
    config: Dict
    seconds: float = 0.0                  # the window's length
    setup_s: float = 0.0
    latencies_s: List[float] = field(default_factory=list)  # in the window
    failed: int = 0
    memory_peak: int = 0
    counters: Tuple[int, int, int, int] = (0, 0, 0, 0)  # batches, items at
    #                                       the window's start and end
    dispatch: List[Tuple[float, float]] = field(default_factory=list)
    # per run_batch call: (padded batch, items), by call number
    calls: List[Tuple[int, int]] = field(default_factory=list)
    # host clock: from the profiler's start to the end of its stop
    profiled: Optional[Tuple[float, float]] = None
    trace: Optional[devtrace.Trace] = None
    flops_per_image: Optional[float] = None


class _Dispatch:
    """Wraps the service's `run_batch`: a host clock around every call, the
    call's padded batch and (from the batcher's counter at the next call)
    its items, and while `marking` a marker kernel ahead of the call's
    work (see devtrace)."""

    def __init__(self, service):
        self.service = service
        self.inner = service.run_batch
        self.times: List[Tuple[float, float]] = []
        self.padded: List[int] = []
        self.items_before: List[int] = []
        self.marking = False
        self.marked: List[int] = []
        self.lock = threading.Lock()
        service.run_batch = self

    def __call__(self, images):
        with self.lock:
            self.padded.append(images.shape[0])
            self.items_before.append(self.service.items_run)
            if self.marking:
                self.marked.append(len(self.padded) - 1)
                torch.cuda._sleep(1)
        t0 = time.perf_counter()
        try:
            return self.inner(images)
        finally:
            with self.lock:
                self.times.append((t0, time.perf_counter() - t0))

    def calls(self) -> List[Tuple[int, int]]:
        after = self.items_before[1:] + [self.service.items_run]
        return [(p, a - b) for p, a, b in
                zip(self.padded, after, self.items_before)]


def _stack(results: List[Dict[str, np.ndarray]], device
           ) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.stack([r[k] for r in results])).to(device)
            for k in results[0]}


def assets_of(cfg: Dict, seed: int, device):
    """The SMPL models a configuration names: reference arrays on the
    device and the program's numpy asset fields, by model name."""
    arrays = {name: seeded.smpl_arrays(seed, betas, device, f"smpl.{name}")
              for name, betas in cfg["smpl"]["models"].items()}
    return arrays, {n: seeded.host_assets(a) for n, a in arrays.items()}


def setup_state(cfg: Dict, traffic: Dict, seed: int, device):
    """The reference module, the seeded state dict (BatchNorm calibrated),
    the SMPL arrays and the image pool (host uint8)."""
    ref = importlib.import_module(f"gpubench.reference.{cfg['model']}")
    size = cfg["input_size"]

    def fwd(c, x):
        return ref.forward(c, x, cfg["backbone"])

    sd = seeded.weights(spec_of(fwd, (1, size, size, 3)), seed, device)
    seeded.calibrate(fwd, sd, seeded.images(
        seed, traffic["calibration_images"], size, device, "calibration"))
    arrays, assets = assets_of(cfg, seed, device)
    pool = seeded.images(seed, traffic["pool_images"], size, device).cpu(
        ).numpy()
    return ref, sd, arrays, assets, pool


def flops_per_image(ref, cfg: Dict) -> float:
    """Model FLOPs of one image by the reference's shapes: the network
    (convs, linears) counted on the meta device, and SMPL for every slot
    the pipeline computes (`smpl_flops`)."""
    from torch.utils.flop_counter import FlopCounterMode
    size = cfg["input_size"]
    with FlopCounterMode(display=False) as fc:
        spec_of(lambda c, x: ref.forward(c, x, cfg["backbone"]),
                (1, size, size, 3))
    return float(fc.get_total_flops()) + smpl_flops(cfg)


def smpl_flops(cfg: Dict) -> float:
    """SMPL's products for each slot of one image and each model: shape and
    pose blend shapes, the joint regressors, the kinematic chain, the
    skinning's 3x4 transforms and their application."""
    v, j = cfg["smpl"]["verts"], cfg["smpl"]["joints"]
    per = 0.0
    for betas in cfg["smpl"]["models"].values():
        per += 2 * v * 3 * (betas + 9 * (j - 1))          # blend shapes
        per += 2 * (j + 9 + 17) * v * 3                    # regressors
        per += 2 * j * 64                                  # chain
        per += 2 * v * (12 * j + 12)                       # skinning
    return per * cfg["max_person"]


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device,
             root: Path = ROOT, fault: Optional[Callable] = None,
             t_start: Optional[float] = None,
             control: bool = False, witness: bool = False,
             keep: Optional[float] = None) -> Tuple[Dict, Dict]:
    """One run: returns (the result line's object, the judge's numbers).
    `fault` (tests only) wraps the built service to break the timed path;
    `control` also judges the reference one precision down in the
    program's place, on the same images (its parts under "control");
    `witness` the reference at the configuration's precision with cuDNN
    let use TF32, as the program lets it (under "witness"); `keep`
    overrides the traffic's share of completions kept for the check."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = benchmark(root)
    entry = cell_entry(bench, cell)
    traffic = traffic_of(root, cell)
    cfg = config_of(root, entry["config"])
    system = importlib.import_module(f"gpubench.systems.{cfg['model']}")
    ref, sd, arrays, assets, pool = setup_state(cfg, traffic, seed, device)
    run = Run(root=root, cell=cell, traffic=traffic, config=cfg)
    if trace:
        run.flops_per_image = flops_per_image(ref, cfg)

    service = system.build(cfg, traffic, sd, assets, device)
    if fault is not None:
        fault(service)
    disp = _Dispatch(service)
    service.precompile()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    rng = np.random.default_rng([int(seed), 7])
    check = traffic["check"]
    loop = ClosedLoop(service.submit, pool, traffic["clients"], rng,
                      keep=check["keep_share"] if keep is None else keep)
    loop.start()
    loop.wait_completed(traffic["warm_in_batches"] * traffic["max_batch"])

    # ---- the window
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    c0 = (service.batches_run, service.items_run)
    t0 = loop.open_window()
    run.setup_s = t0 - t_start
    prof = None
    if trace:
        prof_cfg = traffic["profile"]
        time.sleep(min(prof_cfg["delay_s"], seconds / 4))
        p0 = time.perf_counter()
        prof = devtrace.start()
        disp.marking = device.type == "cuda"
        time.sleep(max(0.0, min(prof_cfg["seconds"],
                                t0 + seconds - time.perf_counter() - 0.5)))
        disp.marking = False
        prof.stop()
        run.profiled = (p0, time.perf_counter())
    time.sleep(max(0.0, t0 + seconds - time.perf_counter()))
    t1 = loop.close_window()
    c1 = (service.batches_run, service.items_run)
    drained = loop.drain(DRAIN_S)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        run.memory_peak = torch.cuda.max_memory_allocated(device)
    run.seconds = t1 - t0
    run.counters = (*c0, *c1)
    run.latencies_s = loop.latencies(t0, t1)
    run.failed = loop.failed_in(t0, t1) + (0 if drained else
                                          loop.outstanding())
    run.dispatch = [(a, d) for a, d in disp.times if t0 <= a <= t1]
    run.calls = disp.calls()
    if prof is not None:
        path = root / "build" / "gpubench" / f"trace_{cell}_{seed}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        run.trace = devtrace.export(prof, str(path), disp.marked)
    service.close()
    kept = loop.kept
    del service, disp, loop
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the check, once the window has closed and the program is freed
    t_check = time.perf_counter()
    parts, ctrl, wit = judge_all(ref, sd, arrays, cfg, traffic, pool, kept,
                                 device, control, witness)
    numbers = groups(parts)
    limits = check["limits"]
    compared = {n: {"value": numbers.get(n, math.inf), "limit": lim}
                for n, lim in limits.items()}
    correct = (run.failed == 0 and drained and len(kept) > 0
               and all(c["value"] <= c["limit"] for c in compared.values()))

    group = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_for(bench, cell, group):
        value = metric_reader(root, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": bool(correct),
        "attempted": len(run.latencies_s) + run.failed,
        "failed": run.failed,
        "metrics": metrics,
        "device": device_info(device, run),
    }
    if run.trace is not None and run.trace.chosen:
        result["breakdown"] = devtrace.breakdown(run.trace)
        print("busy by kind (s, span): " + json.dumps(
            devtrace.busy_by_kind(run.trace)), file=sys.stderr)
    elif run.trace is not None:
        t = run.trace
        print(f"trace: no steady span: {len(t.ops)} device operations, "
              f"{sum(o.batch is not None for o in t.ops)} attributed to "
              f"{len(t.batches)} marked calls", file=sys.stderr)
    print(f"img_latency_p95_ms over {len(run.latencies_s)} images; "
          f"{len(kept)} images compared in "
          f"{time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    result["checks"] = compared
    extra = {"numbers": numbers, "parts": parts, "images_compared": len(kept),
             "control": ctrl, "witness": wit}
    return result, extra


def judge_all(ref, sd, arrays, cfg, traffic, pool, kept, device,
              control: bool, witness: bool = False):
    """The judge's per-image parts over the kept results, in blocks: each
    gap's worst image, and mask.mismatch as the share (%) of images; for
    the program and, with `control`, for the control."""
    check = traffic["check"]
    parents = seeded.SMPL_PARENTS
    per: Dict[str, List[torch.Tensor]] = {}
    per_ctrl: Dict[str, List[torch.Tensor]] = {}
    per_wit: Dict[str, List[torch.Tensor]] = {}
    fetch = traffic.get("fetch_person", 0)
    lower = {"float32": "bfloat16", "bfloat16": "float8"}[
        cfg["compute_dtype"]]
    with torch.no_grad(), no_tf32():
        for i in range(0, len(kept), check["block"]):
            part = kept[i:i + check["block"]]
            imgs = torch.from_numpy(pool[[p for p, _ in part]]).to(device)
            prog = _stack([r for _, r in part], device)
            for k, v in ref.judge(sd, arrays, seeded.SMPL_PARENTS, imgs, prog,
                                  cfg).items():
                per.setdefault(k, []).append(v.cpu())
            if control:
                out = ref.outputs(sd, arrays, parents, imgs, cfg, lower,
                                  fetch)
                for k, v in ref.judge(sd, arrays, parents, imgs, out,
                                      cfg).items():
                    per_ctrl.setdefault(k, []).append(v.cpu())
            if witness:
                with torch.backends.cudnn.flags(enabled=True,
                                                allow_tf32=True):
                    out = ref.outputs(sd, arrays, parents, imgs, cfg,
                                      cfg["compute_dtype"], fetch)
                for k, v in ref.judge(sd, arrays, parents, imgs, out,
                                      cfg).items():
                    per_wit.setdefault(k, []).append(v.cpu())

    def reduce(d):
        parts = {}
        for k, vs in d.items():
            v = torch.cat(vs)
            parts[k] = (float(v.mean()) * 100.0 if k == "mask.mismatch"
                        else float(v.max()))
        return parts

    return (reduce(per), reduce(per_ctrl) if control else None,
            reduce(per_wit) if witness else None)


def groups(parts: Dict[str, float]) -> Dict[str, float]:
    """The compared numbers from the judge's parts: each group's worst part
    (`detect_gap` from detect.*, ...), and `mask_mismatch`, the share (%)
    of images whose mask differs from the reference's."""
    out: Dict[str, float] = {}
    for k, v in parts.items():
        g = k.split(".")[0]
        name = "mask_mismatch" if g == "mask" else f"{g}_gap"
        out[name] = max(out.get(name, -math.inf), v)
    return out


def device_info(device, run: Run) -> Dict:
    if device.type != "cuda":
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    else:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": int(run.memory_peak)}
    t = run.trace
    if t is not None and t.chosen:
        # the steady span, on the trace's clock, as idle_share reads it
        info["busy_s"] = t.span_busy_us() / 1e6
        info["window_s"] = (t.span[1] - t.span[0]) / 1e6
    return info


def forbidden_modules() -> List[str]:
    """Modules of JAX, Flax or the JAX package loaded in this process,
    compared by whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})
