"""Matryoshka prefix-MSE with a hand-derived backward pass
(counterpart of saev_tpu/ops/matryoshka.py).

The loss is mean_j mean_bd (xhat_j - x)^2 over J ascending latent prefixes,
computed scale-stabilized. With Ebar_j = 2/(B J D) (xhat_j - x), the group
cotangent dA_G = sum_j [G < m_j] Ebar_j serves both parameter gradients:

    df_G = dA_G @ W_G^T + remainder term
    dW_G = f_G^T @ dA_G + remainder term

Two paths, chosen by `_use_kernels` on the latents' tensor:

- **Kernel path (CUDA)**: f and W_dec are cast to bf16 and the three
  products run as kernels K2-K4 (ops/cuda_matryoshka.py). E is kept in bf16;
  df comes back in the primal dtype of f (bf16 on the TopK stats path). A
  batch that is not a multiple of the kernels' 128-row tile is padded with
  rows whose error is exactly 0, a group that is not a multiple of their
  128-latent tile with latents that are exactly 0, a d_model that is not a
  multiple of their 128-column tile with columns whose error is exactly 0,
  and the results are cut back to the true rows, latents and columns.
- **Plain path (CPU)**: the same algebra in f32 with static slices.

The second output is the full reconstruction xhat_J. It carries no gradient:
callers detach it.

Over a feature group (saev_tpu_torch.parallel; each member holds the
latents [o, o + S / F) of f and W_dec), each member forms its partial
products base_j = f[:, :p'_j] @ W[:p'_j] on its own latents, with the local
cuts p'_j = clip(p_j - o, 0, S / F), in groups of gcd(g, S / F): on the
kernel path kernel K7 (f32 base), on the plain path the same algebra in f32.
One all-reduce (sum) of base (J, B, D) over the group gives every member
the whole E_j = base_j + (b_dec - x) (rounded to bf16 on the kernel path, as
K2 rounds it) and the same loss; the backward runs K3 and K4 (or the plain
algebra) on the member's latents with that E and the local cuts, and
b_dec's gradient, from E, is the same on every member.
"""

import math

import torch
import torch.nn.functional as F

from .. import parallel
from . import cuda_matryoshka as _cm

_BF16 = torch.bfloat16


def _use_kernels(t: torch.Tensor) -> bool:
    """The bf16 kernel path runs for tensors on a CUDA device, the plain f32
    algebra elsewhere (counterpart of `_use_pallas`). Tests monkeypatch this to
    run the kernel path's algebra on the CPU, where each kernel wrapper then
    takes its plain version because its tensors lie on the CPU."""
    return t.is_cuda


def _upper(x: torch.Tensor, x_abs_max: torch.Tensor | None) -> torch.Tensor:
    """The scale of the stabilized reduction: max|x|, or the given one."""
    return torch.clamp(x.abs().max() if x_abs_max is None else x_abs_max, min=1e-12)


def _loss_from_e(e: torch.Tensor, upper: torch.Tensor) -> torch.Tensor:
    """Scale-stabilized reduction (saev_tpu/ops/matryoshka.py:119-122)."""
    return torch.mean((e.float() / upper) ** 2) * upper * upper


def _fwd_plain(w_dec, b_dec, f_x, x, ms, rs, g, upper):
    base, xhat_nobias = _base_plain(w_dec, f_x, ms, rs, g)
    e = base + (b_dec - x)[None]
    return _loss_from_e(e, upper), xhat_nobias + b_dec, e


def _base_plain(w_dec, f_x, ms, rs, g):
    """(base (J, B, D), f @ W (B, D)), base_j = f[:, :p_j] @ W[:p_j], in f32
    by groups of g."""
    n_groups = f_x.shape[1] // g
    a = torch.stack(
        [f_x[:, i * g : (i + 1) * g] @ w_dec[i * g : (i + 1) * g] for i in range(n_groups)]
    )  # (G, B, D)
    mask = (
        torch.arange(n_groups, device=f_x.device)[:, None]
        < torch.tensor(ms, device=f_x.device)[None, :]
    ).to(f_x.dtype)  # (G, J)
    base = torch.einsum("Gbd,GJ->Jbd", a, mask)
    lane = torch.arange(g, device=f_x.device)
    rems = []
    for mj, rj in zip(ms, rs):
        mc = min(mj, n_groups - 1)  # a cut at d_sae has r = 0: nothing to add
        f_m = torch.where(lane < rj, f_x[:, mc * g : (mc + 1) * g], 0.0)
        rems.append(f_m @ w_dec[mc * g : (mc + 1) * g])
    return base + torch.stack(rems), a.sum(dim=0)


def _bwd_plain(f, w, e, ms, rs, g, scale):
    j_n, b, d_model = e.shape
    d_sae = f.shape[1]
    n_groups = d_sae // g
    dev = f.device
    mt = torch.tensor(ms, device=dev)
    mask = (torch.arange(n_groups, device=dev)[None, :] < mt[:, None]).to(e.dtype)  # (J, G)
    da = torch.einsum("jbd,jG->bGd", e, mask * scale)  # (B, G, D)
    lane = torch.arange(g, device=dev)
    df = torch.stack(
        [da[:, i] @ w[i * g : (i + 1) * g].T for i in range(n_groups)], dim=1
    )  # (B, G, g)
    dw = torch.stack(
        [f[:, i * g : (i + 1) * g].T @ da[:, i] for i in range(n_groups)]
    )  # (G, g, D)
    for j, (mj, rj) in enumerate(zip(ms, rs)):
        if mj >= n_groups:  # the full prefix has no remainder
            continue
        lane_mask = (lane < rj).to(e.dtype)
        w_m = w[mj * g : (mj + 1) * g]
        f_m = f[:, mj * g : (mj + 1) * g]
        ebar = e[j] * scale
        df[:, mj] += (ebar @ w_m.T) * lane_mask
        dw[mj] += (f_m * lane_mask).T @ ebar
    return df.reshape(b, d_sae), dw.reshape(d_sae, d_model)


class _PrefixMSE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w_dec, b_dec, f_x, x, prefixes, group_size, x_abs_max, feature):
        b, d_sae = f_x.shape
        p32 = prefixes.to(torch.int32)
        if feature is None:
            g = min(group_size, d_sae)
            if d_sae % g:
                raise ValueError(f"d_sae {d_sae} must divide into groups of {g}")
        else:
            # This member's latents [o, o + d_sae) of the whole row, and its cuts.
            g = math.gcd(min(group_size, d_sae * feature.size), d_sae)
            p32 = torch.clamp(p32 - feature.index * d_sae, 0, d_sae)
        m = torch.div(p32, g, rounding_mode="floor")
        r = p32 - m * g
        ctx.g = g
        ctx.f_dtype = f_x.dtype
        ctx.kernel = _use_kernels(f_x)
        if ctx.kernel:
            # The kernels take whole 128-latent tiles: each group of g
            # latents gets zero f columns and zero W rows at its end, up to
            # gp latents. They add nothing to any prefix, and a cut keeps its
            # (m, r), now at m * gp + r.
            n_groups = d_sae // g
            gp = g + (-g % _cm.TILE)
            fb = f_x.to(_BF16).contiguous()
            wb = w_dec.to(_BF16).contiguous()
            if gp != g:
                fb = F.pad(fb.reshape(b, n_groups, g), (0, gp - g)).reshape(b, n_groups * gp)
                wb = F.pad(wb.reshape(n_groups, g, -1), (0, 0, 0, gp - g)).reshape(n_groups * gp, -1)
            # Whole 128-column tiles: W, b_dec and x get zero columns, whose
            # E columns are exactly 0.
            d_model = x.shape[1]
            dpad = -d_model % _cm.TILE
            xp, bp = x, b_dec
            if dpad:
                wb = F.pad(wb, (0, dpad))
                xp, bp = F.pad(x, (0, dpad)), F.pad(b_dec, (0, dpad))
            # And whole 128-row tiles: pad with f rows of 0 and x rows equal
            # to b_dec, whose E rows are exactly 0, so the padded rows add
            # nothing to the loss or to dW. The divisors keep the true batch
            # and d_model.
            pad = -b % _cm.TILE
            if pad:
                fb = torch.cat([fb, fb.new_zeros((pad, fb.shape[1]))])
                xp = torch.cat([xp, bp.expand(pad, -1)])
            upper = _upper(x, x_abs_max)
            if feature is None:
                e, xhat_nb, loss_sum = _cm.grouped_prefix_err(
                    fb, wb, xp.contiguous(), bp.contiguous(), 1.0 / upper,
                    m.contiguous(), r.contiguous(), group_size=gp,
                )
            else:
                # K2's E and loss from the whole base: bf16(base_j + (b_dec
                # - x)), sum (f32(E_j) / upper)^2.
                base, _ = _cm.grouped_prefix_base(fb, wb, m.contiguous(), r.contiguous(), group_size=gp)
                parallel.all_reduce(base, "sum", feature)
                e = (base + (bp - xp)[None]).to(_BF16)
                loss_sum = ((e.float() * (1.0 / upper)) ** 2).sum()
                xhat_nb = base[-1]
            loss = loss_sum / (m.shape[0] * b * d_model) * upper * upper
            xhat = xhat_nb[:b, :d_model] + b_dec
            ctx.b, ctx.gp, ctx.d_model = b, gp, d_model
            ctx.save_for_backward(fb, wb, e, m, r)
        else:
            ms, rs = m.tolist(), r.tolist()
            if feature is None:
                loss, xhat, e = _fwd_plain(w_dec, b_dec, f_x, x, ms, rs, g, _upper(x, x_abs_max))
            else:
                base, _ = _base_plain(w_dec, f_x, ms, rs, g)
                parallel.all_reduce(base, "sum", feature)
                e = base + (b_dec - x)[None]
                loss, xhat = _loss_from_e(e, _upper(x, x_abs_max)), base[-1] + b_dec
            ctx.cuts = (ms, rs)
            ctx.save_for_backward(f_x, w_dec, e)
        ctx.mark_non_differentiable(xhat)
        return loss, xhat

    @staticmethod
    def backward(ctx, t_loss, _t_xhat):
        # The xhat cotangent is dropped: the full reconstruction carries no
        # gradient (module doc).
        g = ctx.g
        if ctx.kernel:
            fb, wb, e, m, r = ctx.saved_tensors
            j_n, _, dp = e.shape
            b, gp, d_model = ctx.b, ctx.gp, ctx.d_model
            n_groups = fb.shape[1] // gp
            scale = (t_loss.float() * 2.0 / (b * j_n * d_model)).reshape(1)
            db_dec = torch.sum(e, dim=(0, 1), dtype=torch.float32)[:d_model] * scale
            df, da = _cm.grouped_matmul_dgrad(
                wb, e, m, r, scale, group_size=gp, df_dtype=ctx.f_dtype
            )
            df = df[:b].reshape(b, n_groups, gp)[:, :, :g].reshape(b, n_groups * g)
            dw = _cm.grouped_matmul_wgrad(fb, da, e, m, r, scale, group_size=gp)
            dw = dw.reshape(n_groups, gp, dp)[:, :g, :d_model].reshape(n_groups * g, d_model)
        else:
            f, w, e = ctx.saved_tensors
            j_n, b, d_model = e.shape
            scale = t_loss * 2.0 / (b * j_n * d_model)
            db_dec = e.sum(dim=(0, 1)) * scale
            df, dw = _bwd_plain(f, w, e, *ctx.cuts, g, scale)
        return dw, db_dec, df.to(ctx.f_dtype), None, None, None, None, None


def prefix_mse(w_dec, b_dec, f_x, x, prefixes, group_size: int = 1024, x_abs_max=None, feature=None):
    """(scale-stabilized mean prefix MSE, full reconstruction).

    w_dec (d_sae, d_model), b_dec (d_model,), f_x (batch, d_sae) latents,
    x (batch, d_model) targets (no gradient), prefixes (J,) ascending int cut
    points with the last equal to d_sae. d_sae must divide by group_size.
    `x_abs_max` replaces max|x| as the reduction's scale (a data-parallel
    step passes the whole batch's); it moves only the loss's rounding.

    With a `feature` group, w_dec and f_x hold this member's latents of the
    whole dictionary, the prefixes count the whole one, and the loss and
    reconstruction are the whole one's on every member (module doc).
    """
    return _PrefixMSE.apply(w_dec, b_dec, f_x, x, prefixes, group_size, x_abs_max, feature)
