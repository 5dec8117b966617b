"""img_latency_p95_ms: the 95th percentile, over every image completed in
the window, of the time from its submit to its future's result."""
import numpy as np


def read(run):
    if not run.latencies_s:
        return None
    return float(np.percentile(np.asarray(run.latencies_s), 95.0)) * 1e3
