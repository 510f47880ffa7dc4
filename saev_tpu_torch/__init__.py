"""saev_tpu_torch: the PyTorch and CUDA port of saev_tpu.

The JAX package `saev_tpu` stays the reference. This package holds the
production SAE train step (TopK + Matryoshka + AuxK, in its warm-up, dense
and dead-subspace forms), the router that picks one of them for each step of
the loop, the log-step metrics, and the training job around them
(`framework.train`: the shard protocol and shuffled loader of `data/`,
datapoint init, step checkpoints, eval on the multi-prefix decode, SAE files),
inference (`framework.inference`) and activation extraction
(`framework.shards`: the ViT engine and model families of `models/`, the
datasets and the extraction worker of `data/`), on plain PyTorch tensors,
with the TPU's Pallas kernels written again as CUDA C++ for Hopper (`csrc/`,
built by `ops/_build.py`). It imports `torch` and never `jax`.
"""

__version__ = "0.1.0"
