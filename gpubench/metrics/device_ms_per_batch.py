"""device_ms_per_batch: the union of device operations' intervals over the
traced steady span of whole batches, over those batches."""


def read(run):
    t = run.trace
    if t is None or not t.chosen:
        return None
    return t.span_busy_us() / 1e3 / len(t.chosen)
