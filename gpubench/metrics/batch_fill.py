"""batch_fill: the batcher's items over its batches times max_batch, from
its counters (`MicroBatcher.items_run`, `batches_run`) over the window."""


def read(run):
    b0, i0, b1, i1 = run.counters
    if b1 <= b0:
        return None
    return 100.0 * (i1 - i0) / ((b1 - b0) * run.traffic["max_batch"])
