"""setup_s: from the process's start to the window's: imports, CUDA, the
kernel library (built on a checkout's first run), the seeded weights and
their calibration, the service, its warm-up of every padded batch size and
the closed loop's first batches."""


def read(run):
    return run.setup_s
