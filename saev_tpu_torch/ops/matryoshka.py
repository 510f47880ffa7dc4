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
  df comes back in the primal dtype of f (bf16 on the TopK stats path).
- **Plain path (CPU)**: the same algebra in f32 with static slices.

The second output is the full reconstruction xhat_J. It carries no gradient:
callers detach it.
"""

import torch

from . import cuda_matryoshka as _cm

_BF16 = torch.bfloat16


def _use_kernels(t: torch.Tensor) -> bool:
    """The bf16 kernel path runs for tensors on a CUDA device, the plain f32
    algebra elsewhere (counterpart of `_use_pallas`). Tests monkeypatch this to
    run the kernel path's algebra on the CPU, where each kernel wrapper then
    takes its plain version because its tensors lie on the CPU."""
    return t.is_cuda


def _loss_from_e(e: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Scale-stabilized reduction (saev_tpu/ops/matryoshka.py:119-122)."""
    upper = torch.clamp(x.abs().max(), min=1e-12)
    return torch.mean((e.float() / upper) ** 2) * upper * upper


def _fwd_plain(w_dec, b_dec, f_x, x, ms, rs, g):
    n_groups = f_x.shape[1] // g
    a = torch.stack(
        [f_x[:, i * g : (i + 1) * g] @ w_dec[i * g : (i + 1) * g] for i in range(n_groups)]
    )  # (G, B, D)
    xhat_full = a.sum(dim=0) + b_dec
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
    e = base + torch.stack(rems) + (b_dec - x)[None]
    return _loss_from_e(e, x), xhat_full, e


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
    def forward(ctx, w_dec, b_dec, f_x, x, prefixes, group_size):
        b, d_sae = f_x.shape
        g = min(group_size, d_sae)
        if d_sae % g:
            raise ValueError(f"d_sae {d_sae} must divide into groups of {g}")
        p32 = prefixes.to(torch.int32)
        m = torch.div(p32, g, rounding_mode="floor")
        r = p32 - m * g
        ctx.g = g
        ctx.f_dtype = f_x.dtype
        ctx.kernel = _use_kernels(f_x)
        if ctx.kernel:
            fb = f_x.to(_BF16).contiguous()
            wb = w_dec.to(_BF16).contiguous()
            upper = torch.clamp(x.abs().max(), min=1e-12)
            e, xhat_nb, loss_sum = _cm.grouped_prefix_err(
                fb, wb, x.contiguous(), b_dec.contiguous(), 1.0 / upper,
                m.contiguous(), r.contiguous(), group_size=g,
            )
            loss = loss_sum / (m.shape[0] * b * x.shape[1]) * upper * upper
            xhat = xhat_nb + b_dec
            ctx.save_for_backward(fb, wb, e, m, r)
        else:
            ms, rs = m.tolist(), r.tolist()
            loss, xhat, e = _fwd_plain(w_dec, b_dec, f_x, x, ms, rs, g)
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
            j_n, b, d_model = e.shape
            scale = (t_loss.float() * 2.0 / (b * j_n * d_model)).reshape(1)
            db_dec = torch.sum(e, dim=(0, 1), dtype=torch.float32) * scale
            df, da = _cm.grouped_matmul_dgrad(
                wb, e, m, r, scale, group_size=g, df_dtype=ctx.f_dtype
            )
            dw = _cm.grouped_matmul_wgrad(fb, da, e, m, r, scale, group_size=g)
        else:
            f, w, e = ctx.saved_tensors
            j_n, b, d_model = e.shape
            scale = t_loss * 2.0 / (b * j_n * d_model)
            db_dec = e.sum(dim=(0, 1)) * scale
            df, dw = _bwd_plain(f, w, e, *ctx.cuts, g, scale)
        return dw, db_dec, df.to(ctx.f_dtype), None, None, None


def prefix_mse(w_dec, b_dec, f_x, x, prefixes, group_size: int = 1024):
    """(scale-stabilized mean prefix MSE, full reconstruction).

    w_dec (d_sae, d_model), b_dec (d_model,), f_x (batch, d_sae) latents,
    x (batch, d_model) targets (no gradient), prefixes (J,) ascending int cut
    points with the last equal to d_sae. d_sae must divide by group_size.
    """
    return _PrefixMSE.apply(w_dec, b_dec, f_x, x, prefixes, group_size)
