"""The traced run: torch.profiler over a stretch of the window, its Chrome
trace read back, device work attributed to the batches the service ran.

While the profiler runs, the harness launches one marker kernel
(`torch.cuda._sleep`, named `MARKER`) on the service's stream at the
start of each `run_batch` call. The stream runs in order, so the device
operations between one marker and the next are that call's batch (the
trace's clock is not the host's, and the profiler records host ranges of
its own thread only). The marked batches less the last, whose work may
outlast the profiler, are the steady span: from the first device operation
of the first to the end of the last one's. Markers count as no work.
"""
from __future__ import annotations

import bisect
import json
import os
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

MARKER = "spin_kernel"      # torch.cuda._sleep's kernel
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NOT_DEVICE_WORK = ("Command Buffer Full",)   # a launch-queue marker
BREAKDOWN_ENTRIES = 10
NAME_CHARS = 160

# kind of device operation -> substrings of its name; the first match wins
KINDS = (
    ("skinning kernel", ("skinning_tf32_kernel",)),
    ("skinning backward kernel", ("skinning_bwd_",)),
    ("deform backward kernel", ("deform_bwd_",)),
    ("deform kernel", ("deform_conv_tf32_kernel", "deform_prep_kernel",
                       "deform_bf16_persistent_kernel")),
    ("chain kernel", ("conv3x3_bn_act_mma_kernel", "ksplit_reduce_kernel",
                      "nchw_to_nhwc_bf16_kernel", "chain_block_bf16_kernel")),
    ("batch norm", ("bn_fw", "batch_norm")),
    ("conv (cuDNN / cuBLAS)", ("conv", "gemm", "xmma", "cutlass", "cudnn",
                               "fft", "pointwise_mult_and_sum_complex")),
    ("copies and casts", ("copy", "Memcpy")),
)
OTHER = "other elementwise / reduce"


def kind_of(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return OTHER


def busy_us(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


@dataclass
class DeviceOp:
    name: str
    cat: str
    start: float     # us, the trace's clock
    end: float
    batch: Optional[int]   # the issuing run_batch call, None if unattributed


@dataclass
class Trace:
    ops: List[DeviceOp]
    batches: List[int]          # the calls that launched a marker
    host: List[Tuple[float, float, str]] = field(default_factory=list)
    # the span's batches (call numbers) and its [start, end] us
    chosen: List[int] = field(default_factory=list)
    span: Tuple[float, float] = (0.0, 0.0)

    @property
    def span_ops(self) -> List[DeviceOp]:
        s, e = self.span
        return [o for o in self.ops if o.start >= s and o.end <= e]

    def span_busy_us(self) -> float:
        return busy_us([(o.start, o.end) for o in self.span_ops])


def start():
    """A running profiler of host and device activity."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def export(prof, path: str, marked: List[int]) -> Trace:
    """Write the stopped profiler's Chrome trace to `path`, read it (see
    `read`), delete it."""
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return read(events, marked)


def read(events: List[Dict], marked: List[int]) -> Trace:
    """Device operations and their batches from Chrome trace events;
    `marked` are the numbers of the calls that launched a marker, in
    order."""
    launches: Dict[int, Tuple[object, float]] = {}
    host: Dict[object, List[Tuple[float, float, str]]] = defaultdict(list)
    raw = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts = e.get("cat", ""), float(e.get("ts", 0.0))
        end = ts + float(e.get("dur", 0.0))
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            if e.get("name") not in NOT_DEVICE_WORK:
                raw.append((ts, end, e["name"], cat, corr))
        elif cat in LAUNCH_CATS:
            if corr is not None:
                launches[corr] = (e.get("tid"), ts)
            host[e.get("tid")].append((ts, end, e.get("name", "")))
    raw.sort()
    ops: List[DeviceOp] = []
    seen = -1
    dispatcher = None
    for ts, end, name, cat, corr in raw:
        if MARKER in name:
            seen += 1
            dispatcher = launches.get(corr, (dispatcher,))[0]
            continue
        batch = marked[seen] if 0 <= seen < len(marked) else None
        ops.append(DeviceOp(name, cat, ts, end, batch))
    trace = Trace(ops=ops, batches=marked,
                  host=sorted(host.get(dispatcher, [])))
    have = sorted({o.batch for o in ops if o.batch is not None})
    if len(have) >= 2:
        trace.chosen = have[:-1]
        first, last = trace.chosen[0], trace.chosen[-1]
        trace.span = (min(o.start for o in ops if o.batch == first),
                      max(o.end for o in ops if o.batch == last))
    return trace


def breakdown(trace: Trace) -> Dict[str, List[List]]:
    """The span's device operations that took most time, and its longest
    idle gaps summed by what the dispatching thread was doing then (its
    runtime call covering the gap's middle, or none), in seconds."""
    ops = trace.span_ops
    by_name: Dict[str, float] = defaultdict(float)
    for o in ops:
        by_name[o.name[:NAME_CHARS]] += (o.end - o.start) / 1e6
    gaps = []
    end = trace.span[0]
    for s, e in sorted((o.start, o.end) for o in ops):
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    starts = [h[0] for h in trace.host]
    by_host: Dict[str, float] = defaultdict(float)
    for a, b in gaps[:200]:
        mid = (a + b) / 2
        j = bisect.bisect_right(starts, mid)
        best = None
        for s, e, name in trace.host[max(0, j - 4000):j]:
            if e >= mid and (best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        label = (best[2][:NAME_CHARS] if best
                 else "no runtime call on the dispatching thread")
        by_host[label] += (b - a) / 1e6

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:BREAKDOWN_ENTRIES]]

    return {"device_ops": top(by_name), "idle_gaps": top(by_host)}


def busy_by_kind(trace: Trace) -> Dict[str, float]:
    """Device seconds of the span by kind of operation (`KINDS`)."""
    out: Dict[str, float] = defaultdict(float)
    for o in trace.span_ops:
        out[kind_of(o.name)] += (o.end - o.start) / 1e6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))
