"""dispatch_ms: host time of the service's run_batch (staging copy, every
launch, the copy-back's enqueue) a batch, over the window's batches issued
while no profiler ran, started or stopped."""


def read(run):
    p0, p1 = run.profiled or (0.0, 0.0)
    times = [d for t, d in run.dispatch if not p0 <= t <= p1]
    return 1e3 * sum(times) / len(times) if times else None
