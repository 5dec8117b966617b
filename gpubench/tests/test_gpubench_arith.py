"""The yardstick's arithmetic: the busy union, the bounds, the skinning
kernel's work count, the trace's batch attribution and the metric
readers, on made-up inputs."""
from __future__ import annotations

import math
from pathlib import Path

import pytest

from gpubench import devtrace, harness, peaks
from gpubench.kernels import skinning

ROOT = Path(__file__).resolve().parents[2]


def test_busy_us_is_the_union():
    assert devtrace.busy_us([]) == 0.0
    assert devtrace.busy_us([(0, 10), (5, 15), (20, 25), (21, 22)]) == 20.0


def test_bound_takes_the_larger_term():
    b = peaks.bound(3.35e9, [(989e9, peaks.BF16_FLOP_PER_S)])
    assert b["bytes_ms"] == pytest.approx(1.0)
    assert b["operations_ms"] == pytest.approx(1.0)
    b = peaks.bound(1.0, [(989e12, peaks.BF16_FLOP_PER_S)])
    assert b["bound_by"] == "operations" and b["bound_ms"] == pytest.approx(
        1e3)


def test_skinning_bytes_bound_at_4096():
    """PERF.md's bytes bound of the skinning kernel: 0.204 ms at N = 4096,
    V = 6890 (A16, W and v_posed read once, verts written once)."""
    nbytes, ops = skinning.launch_work(4096, 6890, 24)
    b = peaks.bound(nbytes, ops)
    assert b["bound_by"] == "bytes"
    assert round(b["bound_ms"], 3) == 0.204


def test_skinning_work_follows_the_cell():
    cfg = {"max_person": 64, "smpl": {"verts": 6890, "joints": 24,
                                      "models": {"adult": 11, "baby": 10}}}
    work = skinning.work(cfg, 64)
    assert len(work) == 2
    assert work[0] == skinning.launch_work(4096, 6890, 24)


def _events():
    """Two threads: the dispatcher (tid 1) launches a marker and two kernels
    a batch, three batches; one kernel before the first marker."""
    ev = []

    def launch(corr, ts, tid=1):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunch",
                   "ts": ts, "dur": 1.0, "tid": tid,
                   "args": {"correlation": corr}})

    def op(corr, name, ts, dur, cat="kernel"):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                   "tid": 7, "args": {"correlation": corr}})

    op(1, "tail_of_earlier_batch", 0.0, 50.0)
    corr = 10
    for b in range(3):
        t = 100.0 + 1000.0 * b
        launch(corr, t - 50)
        op(corr, devtrace.MARKER, t, 1.0)
        launch(corr + 1, t - 40)
        op(corr + 1, "conv_kernel", t + 10, 300.0)
        launch(corr + 2, t - 30)
        op(corr + 2, "skinning_tf32_kernel", t + 400, 100.0)
        op(corr + 3, "Memcpy DtoH", t + 600, 200.0, "gpu_memcpy")
        corr += 10
    ev.append({"ph": "i", "name": "marker event without duration"})
    return ev


def test_trace_attributes_device_work_by_markers():
    t = devtrace.read(_events(), marked=[5, 6, 7])
    assert t.chosen == [5, 6]              # the last marked batch is cut
    assert t.span == (110.0, 1900.0)
    assert {o.batch for o in t.ops} == {None, 5, 6, 7}
    assert not any(devtrace.MARKER in o.name for o in t.ops)
    assert t.span_busy_us() == pytest.approx(2 * 600.0)
    br = devtrace.breakdown(t)
    assert br["device_ops"][0][0] == "conv_kernel"
    assert br["device_ops"][0][1] == pytest.approx(600e-6)
    assert br["idle_gaps"] and br["idle_gaps"][0][1] > 0


def _run(trace=None, **kw):
    run = harness.Run(root=ROOT, cell="x", traffic={"max_batch": 64},
                      config={"max_person": 64, "smpl": {
                          "verts": 6890, "joints": 24, "models": {"s": 10}}})
    run.seconds = 10.0
    run.latencies_s = [0.1] * 96 + [0.5] * 4
    run.counters = (10, 640, 20, 1200)
    run.dispatch = [(1.0, 0.02), (5.0, 0.03), (9.0, 0.04)]
    run.calls = [(64, 64)] * 8
    run.memory_peak = 2 ** 31
    run.trace = trace
    for k, v in kw.items():
        setattr(run, k, v)
    return run


def _metric(name, run):
    return harness.metric_reader(ROOT, name)(run)


def test_end_to_end_readers():
    run = _run()
    assert _metric("img_per_s", run) == pytest.approx(10.0)
    assert _metric("img_latency_p95_ms", run) == pytest.approx(100.0)
    assert _metric("peak_mem_gib", run) == pytest.approx(2.0)
    assert _metric("batch_fill", run) == pytest.approx(100.0 * 560 / 640)
    assert _metric("dispatch_ms", run) == pytest.approx(30.0)
    assert _metric("dispatch_ms", _run(profiled=(4.0, 6.0))) == pytest.approx(
        30.0)
    for name in ("device_ms_per_batch", "kernels_per_batch", "idle_share",
                 "mfu", "skinning_roofline"):
        assert _metric(name, run) is None      # no trace: nothing to read


def test_trace_readers():
    trace = devtrace.read(_events(), marked=[5, 6, 7])
    run = _run(trace, flops_per_image=1e9)
    assert _metric("device_ms_per_batch", run) == pytest.approx(0.6)
    assert _metric("kernels_per_batch", run) == pytest.approx(2.0)
    assert _metric("idle_share", run) == pytest.approx(
        100.0 * (1 - 1200.0 / 1790.0))
    assert _metric("mfu", run) == pytest.approx(
        100.0 * 1e9 * 128 / (1790e-6 * peaks.BF16_FLOP_PER_S))
    least_ms = peaks.bound(*skinning.launch_work(4096, 6890, 24))["bound_ms"]
    assert _metric("skinning_roofline", run) == pytest.approx(
        100.0 * 2 * least_ms * 1e3 / 200.0)
    assert math.isfinite(_metric("skinning_roofline", run))
