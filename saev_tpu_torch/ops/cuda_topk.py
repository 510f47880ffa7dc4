"""Wrapper of kernel K1, the fused TopK statistics (csrc/topk_stats.cu).

Counterpart of saev_tpu/ops/pallas_topk.py `topk_stats_pallas`. A CUDA tensor
launches the kernel; a CPU tensor takes the plain version,
`ops.topk._topk_stats_plain`. There is no fallback from one to the other.
"""

import torch

from . import _build
from .topk import TopKStats, _topk_stats_plain

# The kernel stages a row in registers: at most 64 keys a thread, 512 threads.
MAX_D_SAE = 512 * 64


def topk_stats_cuda(h: torch.Tensor, k: int) -> TopKStats:
    """(kth, f bf16, live bool (S,), l0, l1) of a (B, S) f32 batch, in one
    read of h."""
    if h.device.type != "cuda":
        return _topk_stats_plain(h, k)
    if h.dtype != torch.float32 or h.ndim != 2 or not h.is_contiguous():
        raise ValueError(
            f"topk_stats wants a contiguous (B, S) float32 tensor, got "
            f"{tuple(h.shape)} {h.dtype} contiguous={h.is_contiguous()}"
        )
    b, s = h.shape
    k = min(k, s)
    if not (1 <= k and 1 <= s <= MAX_D_SAE and b >= 1):
        raise ValueError(f"topk_stats: unsupported shape {tuple(h.shape)} with k={k}")
    dev = h.device
    kth = torch.empty((b, 1), dtype=torch.float32, device=dev)
    f = torch.empty((b, s), dtype=torch.bfloat16, device=dev)
    live = torch.zeros((s,), dtype=torch.int32, device=dev)
    l0 = torch.empty((b, 1), dtype=torch.float32, device=dev)
    l1 = torch.empty((b, 1), dtype=torch.float32, device=dev)
    code = _build.lib().saev_topk_stats(
        h.data_ptr(), b, s, k, kth.data_ptr(), f.data_ptr(), live.data_ptr(),
        l0.data_ptr(), l1.data_ptr(), _build.stream_ptr(h),
    )
    _build.check(code, "topk_stats")
    topk_stats_cuda.launches += 1
    return TopKStats(kth=kth, f=f, live=live != 0, l0=l0, l1=l1)


topk_stats_cuda.launches = 0
