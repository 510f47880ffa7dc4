"""Kernels and the custom-gradient operations built on them.

- `topk`: exact k-th-largest thresholds and the fused TopK statistics;
  `cuda_topk` wraps kernel K1.
- `matryoshka`: the Matryoshka prefix-MSE with its hand-derived backward;
  `cuda_matryoshka` wraps kernels K2-K4.
- `_build`: compiles `csrc/*.cu` with nvcc and loads it with ctypes.
"""

from .topk import TopKStats, exact_kth_value, topk_stats

__all__ = ["TopKStats", "exact_kth_value", "topk_stats"]
