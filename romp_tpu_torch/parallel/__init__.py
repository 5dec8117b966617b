"""Data parallelism over processes (counterpart of `romp_tpu/parallel/`)."""
