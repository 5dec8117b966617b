"""`trace2` CLI of the port — TRACE temporal video 3D recovery.

    python -m romp_tpu_torch.cli.trace -i frames_dir -o out --GPU 0

Same flags and defaults as `romp_tpu/cli/trace.py`; `--GPU N` (default 0)
runs on `cuda:N` and raises when that card does not exist, `--GPU -1` runs
on the CPU. With the RAFT weights file present (`--raft_model_path`) the
optical flow comes from RAFT, else it is zero, as in the JAX CLI.
`--show_items world` also writes the global-view renders, the top-down
trajectory and an HTML viewer under `<save_path>/world_vis`.
"""
from __future__ import annotations

import argparse
import os.path as osp
import sys

from romp_tpu_torch.cli.common import DEFAULT_HOME, add_common_flags


def trace_settings(input_args=None):
    parser = argparse.ArgumentParser(
        description="romp_tpu_torch TRACE: temporal multi-person 5D "
                    "regression (PyTorch + CUDA)")
    add_common_flags(parser, "trace")
    parser.add_argument("--center_thresh", type=float, default=0.1)
    parser.add_argument("--show_items", type=str, default="mesh")
    parser.add_argument("--temp_clip_length", type=int, default=8)
    parser.add_argument("--subject_num", type=int, default=-1,
                        help="lock onto the first-frame subjects (>0)")
    parser.add_argument("--smpl_path", type=str,
                        default=osp.join(DEFAULT_HOME, "SMPLA_NEUTRAL.pth"))
    parser.add_argument("--smil_path", type=str,
                        default=osp.join(DEFAULT_HOME, "smil_packed_info.pth"))
    parser.add_argument("--model_path", type=str,
                        default=osp.join(DEFAULT_HOME, "TRACE.pth"))
    parser.add_argument("--raft_model_path", type=str,
                        default=osp.join(DEFAULT_HOME, "raft-things.pth"),
                        help="RAFT optical-flow weights (torch layout); "
                             "without the file TRACE runs with zero flow "
                             "(pass '' to skip RAFT)")
    parser.add_argument("--raft_iters", type=int, default=20)
    parser.add_argument("--flow_size", type=int, default=512)
    parser.add_argument("--flow_dtype", type=str, default="bfloat16",
                        choices=("float32", "bfloat16"))
    parser.add_argument("--corr_dtype", type=str, default="float32",
                        choices=("float32", "bfloat16"))
    parser.add_argument("--frontend_batch", type=int, default=1,
                        help="run the backbone over this many consecutive "
                             "clips in one call (dispatch_clips); results "
                             "are the same, latency grows by one clip per "
                             "increment")
    args = parser.parse_args(input_args)
    args.calc_smpl = True
    return args


def main(input_args=None):
    settings = trace_settings(input_args)
    from romp_tpu_torch.cli.trace_impl import run_trace

    return run_trace(settings)


if __name__ == "__main__":
    sys.exit(main())
