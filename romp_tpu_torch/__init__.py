"""romp_tpu_torch — the ROMP image path and the TRACE video path in PyTorch,
with hand-written CUDA kernels for Hopper (sm_90a) where the JAX package
`romp_tpu` has Pallas ones.

Layout mirrors `romp_tpu` (ops/, smpl/, models/, pipeline/, cli/, utils/,
tracker/, vis/), plus csrc/ for the CUDA sources, built at first use.
Imports torch, never jax, and nothing of `romp_tpu`: the numpy-only modules
it needs (SMPL assets, image IO, the trackers, the CLI mode loops, the
renderer) are its own copies.
"""

__version__ = "0.1.0"
