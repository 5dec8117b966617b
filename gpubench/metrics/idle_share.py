"""idle_share: 1 - busy / wall over the traced steady span, in %."""


def read(run):
    t = run.trace
    if t is None or not t.chosen:
        return None
    wall = t.span[1] - t.span[0]
    return 100.0 * (1.0 - t.span_busy_us() / wall) if wall > 0 else None
