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

Over a latent-sharded row (a feature `group` of saev_tpu_torch.parallel,
each member holding S / F of its columns) the threshold is the exact k-th
largest of the whole row, bit for bit the one-rank value (`_sharded_kth`):
K6 (or K5) on each shard, the largest of those over the group, each shard's
values above it padded with it (csrc/kth_shard.cu), gathered, and K6 on the
(B, F k) candidates. `topk_stats` then writes each shard's f, live, L0 and
L1 from that threshold with K1's threshold entry, and sums L0 and L1 over
the group.
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


def _kth_candidates_plain(h: torch.Tensor, mask: torch.Tensor | None, t0: torch.Tensor, k: int) -> torch.Tensor:
    """The plain version of csrc/kth_shard.cu: (B, k), each row's values
    (at the columns where `mask` is set) whose order key is above t0's, then
    copies of t0 (B, 1); fewer than k values may lie above t0."""
    b = h.shape[0]
    above = _keys(h) > _keys(t0)
    if mask is not None:
        above &= mask[None, :]
    # Each value above t0 to its rank among the row's, the rest to slot k.
    slot = torch.where(above, torch.cumsum(above, dim=1) - 1, k)
    out = t0.expand(b, k + 1).clone()
    out.scatter_(1, slot, h)
    return out[:, :k].contiguous()


def _keys(t: torch.Tensor) -> torch.Tensor:
    """int32 keys of f32 values whose signed order is the values' order,
    -0.0 below +0.0 (csrc/order_key.cuh's order)."""
    i = t.contiguous().view(torch.int32)
    return i ^ ((i >> 31) & 0x7FFFFFFF)


def _from_keys(key: torch.Tensor) -> torch.Tensor:
    return (key ^ ((key >> 31) & 0x7FFFFFFF)).view(torch.float32)


def _sharded_kth(h: torch.Tensor, mask: torch.Tensor | None, k: int, group: parallel.Group) -> torch.Tensor:
    """The exact k-th largest of each whole row of a batch whose columns are
    split over `group` (this member's (B, s) part of it, s possibly 0, and
    the (s,) mask of its columns), (B, 1), the same on every member: -inf
    where fewer than k unmasked columns exist. A shard of at least k columns
    takes its k-th largest key (K6, or K5 among the unmasked); t0, the
    largest over the group, is at most the whole row's, since its shard
    holds k keys at or above it. Every shard holds fewer than k keys above
    t0: its values above t0, padded with t0 to k (csrc/kth_shard.cu), hold
    every key of the whole row above t0 and enough copies of t0, so the
    k-th largest of the (B, F k) candidates is the whole row's, bit for
    bit."""
    from . import cuda_kth

    b, s = h.shape
    if s >= k:
        local = cuda_kth.kth_value_cuda(h, k) if mask is None else cuda_kth.kth_value_masked_cuda(h, mask, k)
    else:
        local = torch.full((b, 1), float("-inf"), dtype=torch.float32, device=h.device)
    t0 = _from_keys(parallel.all_reduce(_keys(local), "max", group))
    cand = cuda_kth.kth_candidates_cuda(h, mask, t0, k)
    return cuda_kth.kth_value_cuda(parallel.gather_cols(cand, group), k)


def exact_kth_value(h: torch.Tensor, k: int, *, group: parallel.Group | None = None) -> torch.Tensor:
    """Exact k-th largest along the last axis, (B, 1) of a (B, S) batch.

    Carries no gradient (the threshold is piecewise constant in h). A CUDA
    tensor launches kernel K6 (ops/cuda_kth.py), which takes a contiguous 2-D
    f32 batch and raises on anything else; a CPU tensor takes `_kth_plain`,
    which also takes (B, ..., S). With a feature `group`, `h` is this
    member's columns of each row and the value is the whole row's
    (`_sharded_kth`).
    """
    from . import cuda_kth

    if group is not None:
        return _sharded_kth(h.detach(), None, k, group)
    return cuda_kth.kth_value_cuda(h.detach(), k)


def exact_kth_value_masked(
    h: torch.Tensor, mask: torch.Tensor, k: int, *, group: parallel.Group | None = None
) -> torch.Tensor:
    """Exact k-th largest of where(mask, h, -inf), (B, 1); `mask` is a (S,)
    bool column mask shared by every row (counterpart of
    saev_tpu/ops/topk.py `exact_kth_value_masked`). Rows with fewer than k
    unmasked columns give -inf.

    Carries no gradient. A CUDA tensor launches kernel K5 (ops/cuda_kth.py),
    which never builds the masked tensor; a CPU tensor takes
    `_kth_masked_plain`. With a feature `group`, as `exact_kth_value`.
    """
    from . import cuda_kth

    if group is not None:
        return _sharded_kth(h.detach(), mask, k, group)
    return cuda_kth.kth_value_masked_cuda(h.detach(), mask, k)


def batch_global_kth_value(
    h: torch.Tensor, k_total: int, *, exact: bool = False, group: parallel.Group | None = None,
    feature: parallel.Group | None = None,
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

    With a `feature` group as well, `h` holds this member's columns of its
    rows: m_row is counted on the whole row, each shard gives its own m_row
    largest of each row, and the candidates are gathered over both groups.
    Whenever no row holds more than m_row of the global winners the value is
    the one-rank value, bit for bit (a shard's candidates are a superset of
    its part of the row's).
    """
    h = h.detach()
    b, s = h.shape
    b_all = b * (1 if group is None else group.size)
    s_all = s * (1 if feature is None else feature.size)
    k_total = min(k_total, b_all * s_all)
    m_row = min(max(-(-k_total // b_all) * _ROW_OVERSAMPLE, 1), s_all)
    if exact or m_row >= s:
        cand = h.reshape(-1)
    else:
        cand = torch.topk(h, m_row, dim=1, sorted=False).values.reshape(-1)
    cand = parallel.gather_rows(parallel.gather_rows(cand, feature), group)
    return torch.topk(cand, min(k_total, cand.shape[0]), sorted=True).values[-1]


def _topk_stats_plain(h: torch.Tensor, k: int | None, kth: torch.Tensor | None = None) -> TopKStats:
    """The plain version of K1 (counterpart of `_topk_stats_xla`), and of
    its threshold entry where `kth` (B, 1) is given."""
    if kth is None:
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
    def forward(ctx, h, k, kth):
        from . import cuda_topk

        # A given kth is an input: the output is a copy of it.
        st = cuda_topk.topk_stats_cuda(h, k) if kth is None else cuda_topk.topk_stats_given_cuda(h, kth.clone())
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
        return torch.where(h >= kth, t, torch.zeros((), dtype=h.dtype, device=h.device)), None, None


def topk_stats(h: torch.Tensor, k: int, *, group: parallel.Group | None = None) -> TopKStats:
    """TopK threshold activation with fused statistics; (B, S) f32 input.

    Differentiable in `f` and `l1`; `kth`, `live` and `l0` carry no gradient.

    With a feature `group`, `h` is this member's columns of each row and k
    counts the whole row: kth is the whole row's (`_sharded_kth`), f and
    live this member's (K1's threshold entry), L0 and L1 the whole row's
    sums over the group (L1's gradient passes to each member's part).
    """
    if group is None:
        return TopKStats(*_TopKStatsFn.apply(h, min(k, h.shape[-1]), None))
    kth = _sharded_kth(h.detach(), None, k, group)
    st = TopKStats(*_TopKStatsFn.apply(h, k, kth))
    return st._replace(l0=parallel.all_reduce(st.l0, "sum", group), l1=parallel.sum_over(st.l1, group))
