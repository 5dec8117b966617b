"""kernels_per_batch: device kernels over the traced steady span of whole
batches, over those batches."""


def read(run):
    t = run.trace
    if t is None or not t.chosen:
        return None
    return sum(1 for o in t.span_ops if o.cat == "kernel") / len(t.chosen)
