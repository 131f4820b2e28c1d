"""historian-tpu on PyTorch and CUDA: the port of the JAX package.

The `recon -fast` merge path runs here on an NVIDIA Hopper card: the
column fill and the trace walk are hand-written CUDA kernels
(`csrc/`), the surrounding tensor code is PyTorch, and the host data
model (profiles, pair HMM, envelope, trees, models) is imported from
the jax-free modules of `historian_tpu`.  Nothing in this package
imports jax.
"""

__version__ = "0.1.0"
