"""Exact k-th-largest thresholds and the fused TopK statistics
(counterpart of saev_tpu/ops/topk.py).

TopK in this package is a threshold mask, `h >= kth`, with kth the exact k-th
largest value of the row: ties at the boundary are all kept, as in the JAX
package (torch.topk's mask keeps exactly k and is not used for selection).

`batch_global_kth_value` is BatchTopK's threshold over a whole batch, in
plain torch on both devices.

`topk_stats` is the train step's one pass over the pre-activations. On a CUDA
tensor it launches kernel K1 (ops/cuda_topk.py, csrc/topk_stats.cu); on a CPU
tensor it runs `_topk_stats_plain`, the same outputs composed from plain
torch operations. `exact_kth_value` (K6) and `exact_kth_value_masked` (K5,
the AuxK threshold among dead latents) dispatch the same way
(ops/cuda_kth.py; csrc/kth.cu and csrc/kth_masked.cu).
"""

import typing

import torch

from .. import parallel

# Candidates a row per row's share of the batch-global top-k in
# `batch_global_kth_value`: the JAX package's default `row_oversample`.
_ROW_OVERSAMPLE = 4


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


def _kth_masked_plain(h: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """The plain version of K5: the k-th largest of where(mask, h, -inf)."""
    neg_inf = torch.full((), float("-inf"), dtype=h.dtype, device=h.device)
    return _kth_plain(torch.where(mask[None, :], h, neg_inf), k)


def exact_kth_value(h: torch.Tensor, k: int) -> torch.Tensor:
    """Exact k-th largest along the last axis, (B, 1) of a (B, S) batch.

    Carries no gradient (the threshold is piecewise constant in h). A CUDA
    tensor launches kernel K6 (ops/cuda_kth.py), which takes a contiguous 2-D
    f32 batch and raises on anything else; a CPU tensor takes `_kth_plain`,
    which also takes (B, ..., S).
    """
    from . import cuda_kth

    return cuda_kth.kth_value_cuda(h.detach(), k)


def exact_kth_value_masked(h: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """Exact k-th largest of where(mask, h, -inf), (B, 1); `mask` is a (S,)
    bool column mask shared by every row (counterpart of
    saev_tpu/ops/topk.py `exact_kth_value_masked`). Rows with fewer than k
    unmasked columns give -inf.

    Carries no gradient. A CUDA tensor launches kernel K5 (ops/cuda_kth.py),
    which never builds the masked tensor; a CPU tensor takes
    `_kth_masked_plain`.
    """
    from . import cuda_kth

    return cuda_kth.kth_value_masked_cuda(h.detach(), mask, k)


def batch_global_kth_value(
    h: torch.Tensor, k_total: int, *, exact: bool = False, group: parallel.Group | None = None
) -> torch.Tensor:
    """The k_total-th largest value over the whole (B, S) batch, a 0-d
    tensor: BatchTopK's flattened global top-k (counterpart of
    saev_tpu/ops/topk.py `batch_global_kth_value`).

    The exact route takes the k_total largest of the flat batch. The default
    gathers each row's m_row = _ROW_OVERSAMPLE * ceil(k_total / B) largest
    values first, then the k_total-th largest of those candidates: exact
    unless a row holds more than m_row of the global winners, and then the
    threshold is lower (more entries kept). The JAX package takes the
    candidates with `lax.approx_max_k`, which is exact on JAX-CPU; here they
    are exact everywhere (torch.topk). Plain torch on either device: the JAX
    package reaches no Pallas kernel here. Carries no gradient.

    With a data `group` (saev_tpu_torch.parallel), `h` is this rank's rows
    of a batch split evenly over the group and k_total counts the whole
    batch: B and m_row are the whole batch's, the candidates of every rank
    are gathered, and every rank returns the same value, the one the JAX
    package's global view gives.
    """
    h = h.detach()
    b, s = h.shape
    b_all = b * (1 if group is None else group.size)
    k_total = min(k_total, b_all * s)
    m_row = min(max(-(-k_total // b_all) * _ROW_OVERSAMPLE, 1), s)
    if exact or m_row >= s:
        cand = h.reshape(-1)
    else:
        cand = torch.topk(h, m_row, dim=1, sorted=False).values.reshape(-1)
    cand = parallel.gather_rows(cand, group)
    return torch.topk(cand, min(k_total, cand.shape[0]), sorted=True).values[-1]


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
