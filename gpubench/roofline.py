"""A kernel's share of its roofline over the traced steady span: the
least time of the span's launches (gpubench/kernels/<kernel>.py's work at
the card's peaks) over the device time of the kernels of that name."""
from __future__ import annotations

from typing import Optional

from gpubench.peaks import bound


def kernel_roofline(run, kernel: str) -> Optional[float]:
    from gpubench.harness import kernel_of
    t = run.trace
    if t is None or not t.chosen:
        return None
    k = kernel_of(run.root, kernel)
    chosen = set(t.chosen)
    device_us = sum(o.end - o.start for o in t.ops if o.batch in chosen
                    and any(n in o.name for n in k.NAMES))
    if device_us <= 0:
        return None
    least_ms = sum(bound(nbytes, ops)["bound_ms"]
                   for s in t.chosen
                   for nbytes, ops in k.work(run.config, run.calls[s][0]))
    return 100.0 * least_ms * 1e3 / device_us
