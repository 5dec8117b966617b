"""The benchmark of romp_tpu_torch: `python3 gpubench/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>` (see README.md)."""
