"""peak_mem_gib: torch.cuda.max_memory_allocated() over the window (the
counter is reset when set-up ends), in GiB."""


def read(run):
    return run.memory_peak / 2 ** 30 if run.memory_peak else None
