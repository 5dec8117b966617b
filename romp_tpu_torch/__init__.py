"""romp_tpu_torch — the ROMP image path in PyTorch, with hand-written CUDA
kernels for Hopper (sm_90a) where the JAX package `romp_tpu` has Pallas ones.

Layout mirrors `romp_tpu` (ops/, smpl/, models/, pipeline/, cli/, utils/),
plus csrc/ for the CUDA sources, built at first use. Imports torch, never
jax; numpy-only modules of `romp_tpu` (SMPL assets, image IO, the video
tracker, the CLI mode loops) are shared rather than copied.
"""

__version__ = "0.1.0"
