"""Pack official SMPL/SMIL model pickles into native .npz assets (the
port's counterpart of `romp_tpu/tools/prepare_smpl.py`, on the port's own
`smpl/assets.py`).

Equivalent of the reference console tools `romp.prepare_smpl` /
`bev.prepare_smil` (`simple_romp/romp/pack_smpl_info.py:56`,
`simple_romp/bev/pack_smil_info.py:56`): reads the license-gated official
model release the user downloaded, writes a flat tensor archive to
~/.romp_tpu/, which both packages read.

    python -m romp_tpu_torch.tools.prepare_smpl --source_dir <dir>
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import sys

from romp_tpu_torch.smpl.assets import DEFAULT_ASSET_DIR, pack_official_smpl


def main(input_args=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--source_dir", type=str, required=True,
                        help="dir containing SMPL_NEUTRAL.pkl (or SMIL pkl)")
    parser.add_argument("--name", type=str, default="SMPL_NEUTRAL",
                        help="basename of the pkl to pack")
    parser.add_argument("--out_dir", type=str, default=DEFAULT_ASSET_DIR)
    parser.add_argument("--extra9_regressor", type=str, default=None)
    parser.add_argument("--h36m17_regressor", type=str, default=None)
    args = parser.parse_args(input_args)

    pkl = osp.join(args.source_dir, args.name + ".pkl")
    if not osp.exists(pkl):
        print(f"model file not found: {pkl}", file=sys.stderr)
        return 1
    assets = pack_official_smpl(pkl, args.extra9_regressor,
                                args.h36m17_regressor)
    os.makedirs(args.out_dir, exist_ok=True)
    out = osp.join(args.out_dir, args.name + ".npz")
    assets.save(out)
    print(f"packed {pkl} -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
