"""Exact k-th-largest thresholds and the fused TopK statistics
(counterpart of saev_tpu/ops/topk.py).

TopK in this package is a threshold mask, `h >= kth`, with kth the exact k-th
largest value of the row: ties at the boundary are all kept, as in the JAX
package (torch.topk's mask keeps exactly k and is not used for selection).

`topk_stats` is the train step's one pass over the pre-activations. On a CUDA
tensor it launches kernel K1 (ops/cuda_topk.py, csrc/topk_stats.cu); on a CPU
tensor it runs `_topk_stats_plain`, the same outputs composed from plain
torch operations.
"""

import typing

import torch


class TopKStats(typing.NamedTuple):
    """TopK activation plus the per-step statistics the train loop consumes."""

    kth: torch.Tensor  # (B, 1) f32 exact k-th largest per row (non-differentiable)
    f: torch.Tensor  # (B, S) bf16 where(h >= kth, h, 0), differentiable
    live: torch.Tensor  # (S,) bool: latent fired this batch (bf16 resolution)
    l0: torch.Tensor  # (B, 1) f32 per-row count of kept nonzeros (non-differentiable)
    l1: torch.Tensor  # (B, 1) f32 per-row sum |f|, differentiable


def _kth_plain(h: torch.Tensor, k: int) -> torch.Tensor:
    """k-th largest value along the last axis, keepdim. Only the value is
    used, so torch.topk's tie order does not matter."""
    return torch.topk(h, k, dim=-1, sorted=True).values[..., -1:]


def exact_kth_value(h: torch.Tensor, k: int) -> torch.Tensor:
    """Exact k-th largest along the last axis, (B, ..., 1). Plain torch only:
    the CUDA kernel for it (K6) is not ported yet."""
    if h.is_cuda:
        raise NotImplementedError("K6 not ported yet")
    return _kth_plain(h, min(k, h.shape[-1]))


def _topk_stats_plain(h: torch.Tensor, k: int) -> TopKStats:
    """The plain version of K1 (counterpart of `_topk_stats_xla`)."""
    kth = _kth_plain(h.detach(), min(k, h.shape[-1]))
    mask = h >= kth
    f32f = torch.where(mask, h, torch.zeros((), dtype=h.dtype, device=h.device))
    f = f32f.to(torch.bfloat16)
    live = torch.any(f != 0, dim=0)
    l0 = (mask & (h != 0)).to(torch.float32).sum(dim=1, keepdim=True)
    l1 = f32f.abs().sum(dim=1, keepdim=True)
    return TopKStats(kth=kth, f=f, live=live, l0=l0, l1=l1)


class _TopKStatsFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, k):
        from . import cuda_topk

        st = cuda_topk.topk_stats_cuda(h, k)
        ctx.save_for_backward(h, st.kth)
        ctx.mark_non_differentiable(st.kth, st.live, st.l0)
        ctx.set_materialize_grads(False)
        return tuple(st)

    @staticmethod
    def backward(ctx, _g_kth, g_f, _g_live, _g_l0, g_l1):
        # f = where(mask, h, 0) -> dh += t_f * mask; l1 = sum |f| -> dh +=
        # t_l1 * sign(h) * mask (saev_tpu/ops/topk.py:104-112).
        h, kth = ctx.saved_tensors
        t = torch.zeros_like(h) if g_f is None else g_f.to(h.dtype)
        if g_l1 is not None:
            t = t + g_l1 * torch.sign(h)
        return torch.where(h >= kth, t, torch.zeros((), dtype=h.dtype, device=h.device)), None


def topk_stats(h: torch.Tensor, k: int) -> TopKStats:
    """TopK threshold activation with fused statistics; (B, S) f32 input.

    Differentiable in `f` and `l1`; `kth`, `live` and `l0` carry no gradient.
    """
    return TopKStats(*_TopKStatsFn.apply(h, min(k, h.shape[-1])))
