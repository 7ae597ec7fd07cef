"""Numerical building blocks: rmsnorm, rope, attention, sampling, and the
hand-written CUDA kernels under `kernels/`."""
