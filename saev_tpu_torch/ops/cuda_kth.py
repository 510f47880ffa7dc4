"""Wrappers of kernels K6 and K5, the exact per-row k-th largest value, plain
(csrc/kth.cu, on K1's select in csrc/topk_row.cuh) and with a column mask
(csrc/kth_masked.cu); both take rows wider than NARROW_S through
csrc/kth_wide.cu (K6 its chunked walk, K5 its unmasked columns alone).

Counterparts of saev_tpu/ops/pallas_topk.py `exact_kth_value_pallas` (K6) and
`exact_kth_value_masked_pallas` (K5). A CUDA tensor launches the kernel; a
CPU tensor takes the plain version, `ops.topk._kth_plain` or
`ops.topk._kth_masked_plain`. There is no fallback from one to the other.

`kth_candidates_cuda` (csrc/kth_shard.cu) is the step between them on a
latent-sharded row (ops/topk.py `_sharded_kth`): a shard's values above a
bound, padded with it; its plain version is `ops.topk._kth_candidates_plain`.
"""

import torch

from . import _build
from .cuda_topk import NARROW_S
from .topk import _kth_candidates_plain, _kth_masked_plain, _kth_plain


def _check_h(h: torch.Tensor, k: int, what: str) -> int:
    if h.dtype != torch.float32 or h.ndim != 2 or not h.is_contiguous():
        raise ValueError(
            f"{what} wants a contiguous (B, S) float32 tensor, got "
            f"{tuple(h.shape)} {h.dtype} contiguous={h.is_contiguous()}"
        )
    b, s = h.shape
    k = min(k, s)
    if not (1 <= k and 1 <= s and b >= 1):
        raise ValueError(f"{what}: unsupported shape {tuple(h.shape)} with k={k}")
    return k


def kth_value_cuda(h: torch.Tensor, k: int, fallback: torch.Tensor | None = None) -> torch.Tensor:
    """(B, 1) exact k-th largest of each row of a (B, S) f32 batch.

    `fallback`, a (1,) int32 tensor on h's device, gains the number of rows
    whose candidate filter overflowed, or whose k exceeds the threads that
    hold a column, and which took the whole-row bisection (a measurement;
    the callers of the main path pass none)."""
    if h.device.type != "cuda":
        return _kth_plain(h, min(k, h.shape[-1]))
    k = _check_h(h, k, "kth_value")
    if fallback is not None and (fallback.dtype != torch.int32 or fallback.numel() != 1
                                 or fallback.device != h.device):
        raise ValueError(f"kth_value wants a (1,) int32 fallback count on {h.device}")
    out = torch.empty((h.shape[0], 1), dtype=torch.float32, device=h.device)
    entry = _build.lib().saev_kth if h.shape[1] <= NARROW_S else _build.lib().saev_kth_wide
    code = entry(
        h.data_ptr(), h.shape[0], h.shape[1], k, out.data_ptr(),
        None if fallback is None else fallback.data_ptr(), _build.stream_ptr(h),
    )
    _build.check(code, "kth_value")
    kth_value_cuda.launches += 1
    return out


def kth_value_masked_cuda(h: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """(B, 1) exact k-th largest of where(mask, h, -inf) per row; `mask` is a
    (S,) bool column mask shared by every row. -inf where a row has fewer
    than k unmasked columns."""
    if h.device.type != "cuda":
        return _kth_masked_plain(h, mask, min(k, h.shape[-1]))
    k = _check_h(h, k, "kth_value_masked")
    if mask.dtype != torch.bool or tuple(mask.shape) != (h.shape[1],) or mask.device != h.device:
        raise ValueError(
            f"kth_value_masked wants a ({h.shape[1]},) bool mask on {h.device}, got "
            f"{tuple(mask.shape)} {mask.dtype} on {mask.device}"
        )
    mask = mask.contiguous()
    b, s = h.shape
    out = torch.empty((b, 1), dtype=torch.float32, device=h.device)
    if s <= NARROW_S:
        code = _build.lib().saev_kth_masked(h.data_ptr(), mask.data_ptr(), b, s, k, out.data_ptr(),
                                            _build.stream_ptr(h))
    else:
        # The wide route's list of unmasked columns (s ints) and its length.
        cols = torch.empty((s + 1,), dtype=torch.int32, device=h.device)
        code = _build.lib().saev_kth_masked_wide(h.data_ptr(), mask.data_ptr(), b, s, k, out.data_ptr(),
                                                 cols.data_ptr(), cols[s:].data_ptr(), _build.stream_ptr(h))
    _build.check(code, "kth_value_masked")
    kth_value_masked_cuda.launches += 1
    return out


kth_value_cuda.launches = 0
kth_value_masked_cuda.launches = 0


def kth_candidates_cuda(h: torch.Tensor, mask: torch.Tensor | None, t0: torch.Tensor, k: int) -> torch.Tensor:
    """(B, k) f32: each row's values of a (B, S) f32 batch (at the columns
    where the (S,) bool `mask`, when given, is set) whose order key is above
    that of the row's bound t0 (B, 1), then copies of t0. The caller's t0 is
    at least the row's k-th largest key, so fewer than k values lie above
    it."""
    if h.device.type != "cuda":
        return _kth_candidates_plain(h, mask, t0, k)
    b, s = h.shape
    if h.dtype != torch.float32 or h.ndim != 2 or not h.is_contiguous():
        raise ValueError(f"kth_candidates wants a contiguous (B, S) float32 tensor, got {tuple(h.shape)} {h.dtype}")
    if t0.dtype != torch.float32 or tuple(t0.shape) != (b, 1) or t0.device != h.device:
        raise ValueError(f"kth_candidates wants a ({b}, 1) float32 bound on {h.device}")
    if mask is not None and (mask.dtype != torch.bool or tuple(mask.shape) != (s,) or mask.device != h.device):
        raise ValueError(f"kth_candidates wants a ({s},) bool mask on {h.device}")
    t0 = t0.contiguous()
    if s == 0:
        return t0.expand(b, k).contiguous()
    mask = None if mask is None else mask.contiguous()
    out = torch.empty((b, k), dtype=torch.float32, device=h.device)
    code = _build.lib().saev_kth_candidates(
        h.data_ptr(), None if mask is None else mask.data_ptr(), b, s, k, t0.data_ptr(), out.data_ptr(),
        _build.stream_ptr(h),
    )
    _build.check(code, "kth_candidates")
    kth_candidates_cuda.launches += 1
    return out


kth_candidates_cuda.launches = 0
