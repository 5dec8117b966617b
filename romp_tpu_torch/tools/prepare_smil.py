"""Pack the official SMIL (infant) model — thin alias of prepare_smpl with
SMIL defaults (`simple_romp/bev/pack_smil_info.py:56`; the port's
counterpart of `romp_tpu/tools/prepare_smil.py`)."""
from __future__ import annotations

import sys

from romp_tpu_torch.tools.prepare_smpl import main as _main


def main(input_args=None) -> int:
    args = list(input_args) if input_args is not None else sys.argv[1:]
    if not any(a.startswith("--name") for a in args):
        args += ["--name", "smil_web"]
    return _main(args)


if __name__ == "__main__":
    sys.exit(main())
