"""saev_tpu_torch: the PyTorch and CUDA port of saev_tpu.

The JAX package `saev_tpu` stays the reference. This package holds the
production SAE train step (TopK + Matryoshka, warm-up phase, without AuxK) on
plain PyTorch tensors, with the four TPU Pallas kernels of that step written
again as CUDA C++ for Hopper (`csrc/`, built by `ops/_build.py`). It imports
`torch` and never `jax`.
"""
