"""Kernels and the custom-gradient operations built on them.

- `topk`: exact k-th-largest thresholds, plain and column-masked, the
  batch-global one of BatchTopK, and the fused TopK statistics;
  `cuda_topk` wraps kernel K1, `cuda_kth` kernels K5 and K6.
- `matryoshka`: the Matryoshka prefix-MSE with its hand-derived backward;
  `cuda_matryoshka` wraps kernels K2-K4 and K7.
- `_build`: compiles `csrc/*.cu` with nvcc and loads it with ctypes.
"""

from .topk import TopKStats, batch_global_kth_value, exact_kth_value, exact_kth_value_masked, topk_stats

__all__ = ["TopKStats", "batch_global_kth_value", "exact_kth_value", "exact_kth_value_masked", "topk_stats"]
