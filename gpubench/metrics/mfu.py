"""mfu: model FLOPs per image (the reference's shapes, gpubench/harness.py
`flops_per_image`) times the images of the traced steady span's batches,
over the span's length times the card's bf16 dense peak, in %."""
from gpubench.peaks import BF16_FLOP_PER_S


def read(run):
    t = run.trace
    if t is None or not t.chosen or not run.flops_per_image:
        return None
    images = sum(run.calls[s][1] for s in t.chosen)
    wall_s = (t.span[1] - t.span[0]) / 1e6
    return 100.0 * run.flops_per_image * images / (wall_s * BF16_FLOP_PER_S)
