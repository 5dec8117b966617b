"""img_per_s: images whose results reached the host in the window, over
the window's length (host clock)."""


def read(run):
    return len(run.latencies_s) / run.seconds if run.seconds > 0 else None
