"""Wrappers of kernel K1, the fused TopK statistics (csrc/topk_stats.cu,
csrc/topk_row.cuh; rows wider than NARROW_S csrc/kth_wide.cu), and of its
threshold entry, K1 with the select skipped (a latent-sharded row's kth is
found over its shards).

Counterpart of saev_tpu/ops/pallas_topk.py `topk_stats_pallas`. A CUDA tensor
launches the kernel; a CPU tensor takes the plain version,
`ops.topk._topk_stats_plain`. There is no fallback from one to the other.
"""

import torch

from . import _build
from .topk import TopKStats, _topk_stats_plain

# The narrow kernels stage a row in registers: at most 64 keys a thread, 512
# threads. A wider row takes csrc/kth_wide.cu: K1 a thread block cluster a
# row (its threshold entry too), K5 its unmasked columns, K6 a chunked walk.
NARROW_S = 512 * 64


def topk_stats_cuda(h: torch.Tensor, k: int, fallback: torch.Tensor | None = None) -> TopKStats:
    """(kth, f bf16, live bool (S,), l0, l1) of a (B, S) f32 batch, in one
    read of h.

    `fallback`, a (1,) int32 tensor on h's device, gains the number of rows
    whose candidate filter overflowed and took the whole-row bisection (a
    measurement; the step passes none)."""
    if h.device.type != "cuda":
        return _topk_stats_plain(h, k)
    if h.dtype != torch.float32 or h.ndim != 2 or not h.is_contiguous():
        raise ValueError(
            f"topk_stats wants a contiguous (B, S) float32 tensor, got "
            f"{tuple(h.shape)} {h.dtype} contiguous={h.is_contiguous()}"
        )
    b, s = h.shape
    k = min(k, s)
    if not (1 <= k and 1 <= s and b >= 1):
        raise ValueError(f"topk_stats: unsupported shape {tuple(h.shape)} with k={k}")
    if fallback is not None and (fallback.dtype != torch.int32 or fallback.numel() != 1
                                 or fallback.device != h.device):
        raise ValueError(f"topk_stats wants a (1,) int32 fallback count on {h.device}")
    dev = h.device
    kth = torch.empty((b, 1), dtype=torch.float32, device=dev)
    f = torch.empty((b, s), dtype=torch.bfloat16, device=dev)
    live = torch.zeros((s,), dtype=torch.int32, device=dev)
    l0 = torch.empty((b, 1), dtype=torch.float32, device=dev)
    l1 = torch.empty((b, 1), dtype=torch.float32, device=dev)
    entry = _build.lib().saev_topk_stats if s <= NARROW_S else _build.lib().saev_topk_stats_wide
    code = entry(
        h.data_ptr(), b, s, k, kth.data_ptr(), f.data_ptr(), live.data_ptr(),
        l0.data_ptr(), l1.data_ptr(), None if fallback is None else fallback.data_ptr(),
        _build.stream_ptr(h),
    )
    _build.check(code, "topk_stats")
    topk_stats_cuda.launches += 1
    return TopKStats(kth=kth, f=f, live=live != 0, l0=l0, l1=l1)


topk_stats_cuda.launches = 0


def topk_stats_given_cuda(h: torch.Tensor, kth: torch.Tensor) -> TopKStats:
    """K1's outputs of a (B, S) f32 batch from a given (B, 1) f32 threshold
    (the kth returned is that tensor): f = bf16(where(h >= kth, h, 0)),
    live, l0 and l1 as K1 forms them, in one read of h."""
    if h.device.type != "cuda":
        return _topk_stats_plain(h, None, kth)
    if h.dtype != torch.float32 or h.ndim != 2 or not h.is_contiguous() or h.numel() == 0:
        raise ValueError(
            f"topk_stats_given wants a contiguous non-empty (B, S) float32 tensor, got "
            f"{tuple(h.shape)} {h.dtype} contiguous={h.is_contiguous()}"
        )
    b, s = h.shape
    if kth.dtype != torch.float32 or tuple(kth.shape) != (b, 1) or kth.device != h.device:
        raise ValueError(f"topk_stats_given wants a ({b}, 1) float32 kth on {h.device}")
    dev = h.device
    kth = kth.contiguous()
    f = torch.empty((b, s), dtype=torch.bfloat16, device=dev)
    live = torch.zeros((s,), dtype=torch.int32, device=dev)
    l0 = torch.empty((b, 1), dtype=torch.float32, device=dev)
    l1 = torch.empty((b, 1), dtype=torch.float32, device=dev)
    entry = _build.lib().saev_topk_stats_given if s <= NARROW_S else _build.lib().saev_topk_stats_given_wide
    code = entry(h.data_ptr(), b, s, kth.data_ptr(), f.data_ptr(), live.data_ptr(), l0.data_ptr(),
                 l1.data_ptr(), _build.stream_ptr(h))
    _build.check(code, "topk_stats_given")
    topk_stats_given_cuda.launches += 1
    return TopKStats(kth=kth, f=f, live=live != 0, l0=l0, l1=l1)


topk_stats_given_cuda.launches = 0
