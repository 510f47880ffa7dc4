"""Matryoshka training objective on PyTorch tensors (counterpart of
saev_tpu/nn/objectives.py).

The dead-latent counter `toks_since_active` is explicit state, as in the JAX
package. Prefix cuts are sampled host-side with numpy (`sample_prefixes`, a
jax-free copy of the original) and passed in as a small int32 tensor.

Ported: the fused training path (`use_fused`), with the TopK statistics pass
on CUDA (`use_stats`), and AuxK in its dense and dead-subspace forms, whose
dead-latent threshold is kernel K5 on CUDA. Their products take the JAX
package's `precision` (modeling.matmul: "default" is bf16 operands with f32
results on the card, f32 on the CPU; "high" is bf16x3 on the card, f32 on
the CPU; None is modeling.MATMUL_PRECISION, "highest"). The
autodiff-through-decode path, which eval, one prefix, a d_sae that is not a
multiple of 1024 and "high" and "highest" training take, runs the
multi-prefix `modeling.decode` with `scale_stabilized_mse`.
"""

import dataclasses
import typing as tp

import numpy as np
import torch

from .. import ops
from ..ops import matryoshka as _fused
from . import modeling

# Cap for the tokens-since-active counter so int32 never overflows.
_TOKS_CAP = 1 << 30


@dataclasses.dataclass(frozen=True)
class Matryoshka:
    """Config for the Matryoshka loss."""

    n_prefixes: int = 10
    """Number of random length prefixes to use for loss calculation."""
    dead_threshold_tokens: int = 10_000_000
    """Tokens without activation before a latent is considered dead."""


ObjectiveConfig = Matryoshka


class MatryoshkaLoss(tp.NamedTuple):
    """Composite loss terms for a training batch."""

    mse: torch.Tensor
    sparsity: torch.Tensor
    l0: torch.Tensor
    l1: torch.Tensor
    aux: torch.Tensor
    n_dead: torch.Tensor

    @property
    def loss(self) -> torch.Tensor:
        return self.mse + self.sparsity + self.aux


ObjectiveState = dict[str, torch.Tensor]
# {"toks_since_active": int32 (d_sae,)}


def init_state(sae_cfg: modeling.SparseAutoencoderConfig, device="cuda") -> ObjectiveState:
    return {"toks_since_active": torch.zeros((sae_cfg.d_sae,), dtype=torch.int32, device=device)}


def sample_prefixes(
    d_sae: int,
    n_prefixes: int,
    *,
    min_prefix_length: int = 1,
    pareto_power: float = 0.5,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Sample ascending prefix lengths from a Pareto-ish distribution favoring
    short prefixes. Host-side numpy; the same draws as
    saev_tpu.nn.objectives.sample_prefixes for the same generator state.

    Returns a sorted int32 array of length n_prefixes ending in d_sae.
    """
    if n_prefixes <= 1:
        return np.array([d_sae], dtype=np.int32)
    if n_prefixes > d_sae:
        raise ValueError(f"n_prefixes {n_prefixes} > d_sae {d_sae}")
    if rng is None:
        rng = np.random.default_rng()

    lengths = np.arange(1, d_sae)
    pareto_cdf = 1.0 - (min_prefix_length / lengths.astype(np.float64)) ** pareto_power
    pareto_pdf = np.concatenate([pareto_cdf[:1], np.diff(pareto_cdf)])
    p = pareto_pdf / pareto_pdf.sum()

    sampled = rng.choice(lengths.shape[0], size=n_prefixes - 1, replace=False, p=p)
    prefixes = np.concatenate([lengths[sampled], [d_sae]])
    prefixes.sort()
    return prefixes.astype(np.int32)


def scale_stabilized_mse(x_hat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Elementwise MSE normalized by max|x| before squaring."""
    upper = torch.clamp(x.abs().max(), min=1e-12)
    return ((x_hat / upper - x / upper) ** 2) * upper * upper


def _aux_mse(
    aux_cfg: modeling.AuxK, aux_recon: torch.Tensor, residual: torch.Tensor,
    n_dead: torch.Tensor, alpha: torch.Tensor | float | None,
) -> torch.Tensor:
    """alpha * mean((aux_recon - residual)^2), or 0 when no latent is dead."""
    alpha = aux_cfg.alpha if alpha is None else alpha
    loss = alpha * torch.mean((aux_recon - residual) ** 2)
    return torch.where(n_dead > 0, loss, torch.zeros((), dtype=loss.dtype, device=loss.device))


def _aux_loss(
    aux_cfg: modeling.AuxK,
    sae_cfg: modeling.SparseAutoencoderConfig,
    params: modeling.Params,
    x: torch.Tensor,
    h_x: torch.Tensor,
    x_hat_full: torch.Tensor,
    dead_mask: torch.Tensor,
    alpha: torch.Tensor | float | None = None,
    precision: str | None = None,
) -> torch.Tensor:
    """AuxK dead-latent loss, dense form (saev_tpu/nn/objectives.py:131-167),
    its decode at `precision`.

    The k_aux largest pre-activations among dead latents reconstruct the
    detached residual of the main reconstruction. With kth the k_aux-th
    largest of where(dead, h, -inf) (kernel K5 on the card), the kept set
    {h >= kth and dead} is the top-min(k_aux, n_dead): a row with fewer dead
    latents than k_aux thresholds at -inf and keeps them all.

    `h_x` must be the same tensor the main TopK reads, so both gradients sum
    into the one encoder backward.
    """
    residual = (x - x_hat_full).detach()
    k_aux = min(aux_cfg.k_aux, sae_cfg.d_sae)
    kth = ops.exact_kth_value_masked(h_x, dead_mask, k_aux)
    keep = (h_x >= kth) & dead_mask[None, :]
    aux_acts = torch.where(keep, h_x, torch.zeros((), dtype=h_x.dtype, device=h_x.device))
    aux_recon = modeling.decode(sae_cfg, params, aux_acts, precision=precision)[:, -1, :]
    return _aux_mse(aux_cfg, aux_recon, residual, dead_mask.sum(), alpha)


def default_subspace_cap(d_sae: int, k_aux: int) -> int:
    """Default dead-subspace width: a quarter of the dictionary, at least
    4x k_aux, rounded up to a multiple of 128, capped at d_sae."""
    cap = max(d_sae // 4, 4 * k_aux)
    cap = -(-cap // 128) * 128
    return min(cap, d_sae)


def subspace_cap_ladder(d_sae: int, k_aux: int) -> list[int]:
    """Ascending subspace caps for the train loop's AuxK routing: a tight cap
    (d_sae/16, the few-percent-dead steady state) and the d_sae/4 default.
    n_dead above the top rung routes to the dense step."""
    tight = min(-(-max(d_sae // 16, 2 * k_aux) // 128) * 128, d_sae)
    wide = default_subspace_cap(d_sae, k_aux)
    return sorted({c for c in (tight, wide) if c < d_sae})


def stalest_columns(toks: torch.Tensor, cap: int) -> torch.Tensor:
    """Indices of the `cap` largest staleness counters, ties in ascending
    index order, as `lax.top_k` orders them (counters tie constantly: every
    latent that fired this step has counter 0)."""
    return torch.sort(toks, descending=True, stable=True).indices[:cap]


def _aux_loss_subspace(
    aux_cfg: modeling.AuxK,
    sae_cfg: modeling.SparseAutoencoderConfig,
    params: modeling.Params,
    x: torch.Tensor,
    x_hat_full: torch.Tensor,
    toks: torch.Tensor,
    dead_threshold: int,
    cap: int,
    alpha: torch.Tensor | float | None = None,
    precision: str | None = None,
) -> torch.Tensor:
    """AuxK loss in the gathered subspace of the `cap` stalest latents
    (saev_tpu/nn/objectives.py:190-250), its two products at `precision`
    (None: "highest", as in `decode`; the JAX package's dots take the
    backend's default there).

    Every dead latent sorts above every live one, so whenever n_dead <= cap
    the subspace holds all dead latents and this loss and its gradients equal
    `_aux_loss`; callers guarantee n_dead <= cap (the step router). The
    subspace pre-activations are recomputed as x @ W_enc[:, idx] + b_enc[idx];
    the gradients scatter back through the same indices. At "default" the
    gathered columns are rounded to bf16, the same bits as gathering the
    rounded matrices.
    """
    precision = precision or modeling.MATMUL_PRECISION
    residual = (x - x_hat_full).detach()
    cap = min(cap, sae_cfg.d_sae)
    k_aux = min(aux_cfg.k_aux, cap)
    idx = stalest_columns(toks, cap)
    dead_sub = toks[idx] >= dead_threshold
    h_sub = modeling.matmul(x, params["W_enc"][:, idx], precision) + params["b_enc"][idx]
    kth = ops.exact_kth_value_masked(h_sub, dead_sub, k_aux)
    keep = (h_sub >= kth) & dead_sub[None, :]
    aux_acts = torch.where(keep, h_sub, torch.zeros((), dtype=h_sub.dtype, device=h_sub.device))
    aux_recon = modeling.matmul(aux_acts, params["W_dec"][idx], precision) + params["b_dec"]
    return _aux_mse(aux_cfg, aux_recon, residual, dead_sub.sum(), alpha)


def matryoshka_loss(
    obj_cfg: Matryoshka,
    sae_cfg: modeling.SparseAutoencoderConfig,
    params: modeling.Params,
    sae_state: modeling.State,
    obj_state: ObjectiveState,
    x: torch.Tensor,
    prefixes: torch.Tensor,
    *,
    training: bool,
    hp: dict[str, torch.Tensor] | None = None,
    precision: str | None = None,
    any_dead: bool | None = None,
    aux_subspace_cap: int | None = None,
) -> tuple[MatryoshkaLoss, modeling.Output, modeling.State, ObjectiveState]:
    """One objective forward (saev_tpu/nn/objectives.py:253-441). Returns
    the loss terms, the SAE forward's outputs, the SAE state (BatchTopK's
    threshold, moved by a training forward) and the objective state, whose
    dead-latent counters only a training forward updates.

    `hp` optionally overrides "sparsity_coeff", "aux_alpha" and "momentum"
    (BatchTopK's) with per-SAE scalars. `any_dead` gates AuxK statically: None or True computes it,
    False leaves it out, as the train loop does during warm-up, where no
    latent can be dead yet. (The JAX package's traced `lax.cond` gate is
    TPU-only; a tensor here raises TypeError.)

    `aux_subspace_cap` computes AuxK in the dead-subspace form, exact iff
    n_dead <= cap: the caller's contract (the step router keeps it).

    Two paths, picked as the JAX package picks them:
    - fused: training at `precision` None or "default" with more than one
      prefix and a d_sae that is a multiple of min(1024, d_sae). The
      prefix MSE (`ops.matryoshka.prefix_mse`) never builds the per-prefix
      reconstructions; `Output.x_hats` holds only the full one, detached.
      On the kernel path its TopK comes from one statistics pass (kernel
      K1), and `Output.f_x` is that pass's bf16 latents: the f32 ones are
      not built (XLA drops them in the JAX package, which the train step
      never reads either).
    - decode: everything else (eval, one prefix, any other d_sae, "high",
      "highest"):
      `encode`, the multi-prefix `decode` and `scale_stabilized_mse` over
      every prefix, autodiff through all of it, every product at
      `precision` (None: modeling.MATMUL_PRECISION, "highest").
    """
    if any_dead is not None and not isinstance(any_dead, bool):
        raise TypeError(f"any_dead must be None or a bool, got {type(any_dead).__name__}")
    hp = hp or {}
    use_fused = (
        training
        and prefixes is not None
        and prefixes.shape[0] > 1
        and sae_cfg.d_sae % min(1024, sae_cfg.d_sae) == 0
        and precision in (None, "default")
    )
    # The TopK statistics pass (kernel K1) runs on the fused kernel path only.
    use_stats = use_fused and isinstance(sae_cfg.activation, modeling.TopK) and _fused._use_kernels(x)
    if use_stats:
        h_x = modeling._linear_bias(x, params["W_enc"], params["b_enc"], precision or modeling.MATMUL_PRECISION)
        st = ops.topk_stats(h_x, sae_cfg.activation.top_k)
        enc = modeling.EncodeOut(h_x=h_x, f_x=st.f)
    else:
        st = None
        enc, sae_state = modeling.encode(
            sae_cfg, params, sae_state, x, training=training, momentum=hp.get("momentum"), precision=precision
        )
    bsz = x.shape[0]

    new_obj_state, dead_mask = obj_state, None
    if training:
        toks = obj_state["toks_since_active"]
        # Liveness at bf16 resolution, as in the JAX package.
        active = st.live if st is not None else torch.any(enc.f_x.to(torch.bfloat16) != 0, dim=0)
        toks = torch.clamp(toks + bsz, max=_TOKS_CAP)
        toks = torch.where(active, torch.zeros((), dtype=toks.dtype, device=toks.device), toks)
        dead_mask = toks >= obj_cfg.dead_threshold_tokens
        new_obj_state = {**obj_state, "toks_since_active": toks}

    if use_fused:
        mse, xhat_full = _fused.prefix_mse(
            params["W_dec"], params["b_dec"], enc.f_x, x, prefixes, min(1024, sae_cfg.d_sae)
        )
        xhat_full = xhat_full.detach()
        x_hats = xhat_full[:, None, :]
    else:
        x_hats = modeling.decode(sae_cfg, params, enc.f_x, prefixes, precision=precision)
        mse = scale_stabilized_mse(x_hats, x[:, None, :].expand_as(x_hats)).mean()
        xhat_full = x_hats[:, -1, :]
    out = modeling.Output(h_x=enc.h_x, f_x=enc.f_x, x_hats=x_hats)

    aux_cfg = sae_cfg.activation.aux
    if training and isinstance(aux_cfg, modeling.AuxK) and any_dead is not False:
        alpha = hp.get("aux_alpha")
        if aux_subspace_cap is not None and aux_subspace_cap < sae_cfg.d_sae:
            aux = _aux_loss_subspace(
                aux_cfg, sae_cfg, params, x, xhat_full, new_obj_state["toks_since_active"],
                obj_cfg.dead_threshold_tokens, aux_subspace_cap, alpha=alpha, precision=precision,
            )
        else:
            aux = _aux_loss(aux_cfg, sae_cfg, params, x, enc.h_x, xhat_full, dead_mask, alpha=alpha,
                            precision=precision)
    else:
        aux = torch.zeros((), dtype=x.dtype, device=x.device)
    n_dead = (
        dead_mask.sum().to(torch.int32) if dead_mask is not None
        else torch.zeros((), dtype=torch.int32, device=x.device)
    )

    if st is not None:
        l1_full = st.l1[:, 0].mean(dim=0)
        l0_full = st.l0[:, 0].to(x.dtype).mean(dim=0)
    else:
        l1_full = enc.f_x.abs().sum(dim=1).mean(dim=0)
        l0_full = (enc.f_x != 0).to(x.dtype).sum(dim=1).mean(dim=0)
    sparsity_cfg = sae_cfg.activation.sparsity
    if hp.get("sparsity_coeff") is not None and isinstance(sparsity_cfg, modeling.L1Sparsity):
        sparsity = l1_full * hp["sparsity_coeff"]
    elif isinstance(sparsity_cfg, modeling.NoSparsity):
        # Its loss reads no latent: the f32 latents are not built (XLA drops
        # them in the JAX package, saev_tpu/nn/objectives.py:330-332).
        sparsity = torch.zeros((), dtype=x.dtype, device=x.device)
    else:
        # The f32 latents, as the JAX package's Output.f_x on either path.
        f_api = enc.f_x if st is None else torch.where(h_x >= st.kth, h_x, 0.0)
        sparsity = sparsity_cfg.loss(f_api)

    loss = MatryoshkaLoss(
        mse=mse, sparsity=sparsity, l0=l0_full, l1=l1_full, aux=aux, n_dead=n_dead
    )
    return loss, out, sae_state, new_obj_state
