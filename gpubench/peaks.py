"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet: dense rates, at the
700 W power limit) and the least time a piece of work could take on it.
A card set below 700 W runs slower under load: the harness prints the
limit beside every run."""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12


def bound(nbytes: float, ops: Iterable[Tuple[float, float]] = ()) -> Dict:
    """The least time for `nbytes` moved (each input read once, each output
    written once) and `ops`, each (flops, peak rate of its type): the larger
    of the two, in ms, with which one binds."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(flops / rate for flops, rate in ops) * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes_ms=t_bytes, operations_ms=t_ops)
