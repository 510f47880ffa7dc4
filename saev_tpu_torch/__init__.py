"""saev_tpu_torch: the PyTorch and CUDA port of saev_tpu.

The JAX package `saev_tpu` stays the reference. This package holds the
production SAE train step (TopK + Matryoshka + AuxK, in its warm-up, dense
and dead-subspace forms), the router that picks one of them for each step of
the loop, and the log-step metrics, on plain PyTorch tensors, with the six
TPU Pallas kernels of that path written again as CUDA C++ for Hopper
(`csrc/`, built by `ops/_build.py`). It imports `torch` and never `jax`.
"""
