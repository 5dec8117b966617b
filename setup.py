"""romp_tpu packaging — console scripts mirror the reference's
(`simple_romp/setup.py:18-84`: romp, bev, trace2, romp.prepare_smpl,
bev.prepare_smil)."""
from setuptools import find_packages, setup

setup(
    name="romp_tpu",
    version="0.1.0",
    description=("TPU-native multi-person 3D human mesh recovery "
                 "(ROMP / BEV / TRACE capabilities, JAX/XLA/Pallas)"),
    packages=find_packages(include=["romp_tpu", "romp_tpu.*",
                                    "romp_tpu_torch", "romp_tpu_torch.*"]),
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "optax"],
    extras_require={
        "io": ["opencv-python"],
        "train": ["orbax-checkpoint", "pyyaml"],
        "torch": ["torch"],     # romp_tpu_torch: the PyTorch + CUDA port
    },
    package_data={"romp_tpu.vis": ["native/*.cpp"],
                  "romp_tpu_torch": ["csrc/*.cu"],
                  "romp_tpu_torch.vis": ["native/*.cpp"]},
    entry_points={
        "console_scripts": [
            "romp=romp_tpu.cli.romp:main",
            "bev=romp_tpu.cli.bev:main",
            "trace2=romp_tpu.cli.trace:main",
            "romp.prepare_smpl=romp_tpu.tools.prepare_smpl:main",
            "bev.prepare_smil=romp_tpu.tools.prepare_smil:main",
            "romp.convert_checkpoint=romp_tpu.tools.convert_checkpoint:main",
            "romp.serve=romp_tpu.serve:main",
            "romp_torch=romp_tpu_torch.cli.romp:main",
            "bev_torch=romp_tpu_torch.cli.bev:main",
            "trace2_torch=romp_tpu_torch.cli.trace:main",
            "romp_torch.prepare_smpl=romp_tpu_torch.tools.prepare_smpl:main",
            "bev_torch.prepare_smil=romp_tpu_torch.tools.prepare_smil:main",
            "romp_torch.export=romp_tpu_torch.tools.export_program:main",
            "romp_torch.serve=romp_tpu_torch.serve:main",
            "romp_torch.train=romp_tpu_torch.train.launch:main",
            "romp_torch.pretrain=romp_tpu_torch.train.pretrain:main",
            "romp_torch.eval_collect=romp_tpu_torch.eval.collectors:main",
        ],
    },
)
