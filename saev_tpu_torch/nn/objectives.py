"""Matryoshka training objective on PyTorch tensors (counterpart of
saev_tpu/nn/objectives.py).

The dead-latent counter `toks_since_active` is explicit state, as in the JAX
package. Prefix cuts are sampled host-side with numpy (`sample_prefixes`, a
jax-free copy of the original) and passed in as a small int32 tensor.

Ported: the fused training path (`use_fused`), with the TopK statistics pass
on CUDA (`use_stats`). Not ported yet: AuxK (it needs kernel K5) and the
autodiff-through-decode path that eval and high-precision training take.
Both raise NotImplementedError rather than being skipped.
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


def init_state(sae_cfg: modeling.SparseAutoencoderConfig, device="cpu") -> ObjectiveState:
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
    any_dead: bool | None = None,
) -> tuple[MatryoshkaLoss, modeling.State, ObjectiveState]:
    """One objective forward. Returns the loss terms, the SAE state and the
    updated objective state (dead-latent counters).

    `hp` optionally overrides "sparsity_coeff" with a per-SAE scalar.
    `any_dead=False` leaves AuxK out, as the JAX package's static gate does
    during warm-up, where no latent can be dead yet; any other value asks for
    AuxK, which is not ported yet.
    """
    hp = hp or {}
    use_fused = (
        training
        and prefixes is not None
        and prefixes.shape[0] > 1
        and sae_cfg.d_sae % min(1024, sae_cfg.d_sae) == 0
    )
    if not use_fused:
        raise NotImplementedError(
            "the autodiff-through-decode path (eval, single prefix) is not ported yet"
        )
    # The TopK statistics pass (kernel K1) runs on the kernel path only.
    use_stats = isinstance(sae_cfg.activation, modeling.TopK) and _fused._use_kernels(x)
    if use_stats:
        h_x = modeling._linear_bias(x, params["W_enc"], params["b_enc"])
        st = ops.topk_stats(h_x, sae_cfg.activation.top_k)
        f_x = st.f
    else:
        st = None
        enc, _ = modeling.encode(sae_cfg, params, sae_state, x, training=training)
        f_x = enc.f_x
    bsz = x.shape[0]

    toks = obj_state["toks_since_active"]
    # Liveness at bf16 resolution, as in the JAX package.
    active = st.live if st is not None else torch.any(f_x.to(torch.bfloat16) != 0, dim=0)
    toks = torch.clamp(toks + bsz, max=_TOKS_CAP)
    toks = torch.where(active, torch.zeros((), dtype=toks.dtype, device=toks.device), toks)
    dead_mask = toks >= obj_cfg.dead_threshold_tokens
    new_obj_state = {**obj_state, "toks_since_active": toks}

    mse, _xhat_full = _fused.prefix_mse(
        params["W_dec"], params["b_dec"], f_x, x, prefixes, min(1024, sae_cfg.d_sae)
    )

    aux_cfg = sae_cfg.activation.aux
    if isinstance(aux_cfg, modeling.AuxK) and any_dead is not False:
        raise NotImplementedError("AuxK (K5) not ported yet")
    aux = torch.zeros((), dtype=x.dtype, device=x.device)
    n_dead = dead_mask.sum().to(torch.int32)

    if st is not None:
        l1_full = st.l1[:, 0].mean(dim=0)
        l0_full = st.l0[:, 0].to(x.dtype).mean(dim=0)
    else:
        l1_full = f_x.abs().sum(dim=1).mean(dim=0)
        l0_full = (f_x != 0).to(x.dtype).sum(dim=1).mean(dim=0)
    if hp.get("sparsity_coeff") is not None and isinstance(
        sae_cfg.activation.sparsity, modeling.L1Sparsity
    ):
        sparsity = l1_full * hp["sparsity_coeff"]
    else:
        # The f32 latents, as the JAX package's Output.f_x on either path.
        f_api = f_x if st is None else torch.where(h_x >= st.kth, h_x, 0.0)
        sparsity = sae_cfg.activation.sparsity.loss(f_api)

    loss = MatryoshkaLoss(
        mse=mse, sparsity=sparsity, l0=l0_full, l1=l1_full, aux=aux, n_dead=n_dead
    )
    return loss, sae_state, new_obj_state
