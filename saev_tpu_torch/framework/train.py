"""The SAE train step on PyTorch tensors (counterpart of
saev_tpu/framework/train.py `make_train_step`).

A sweep of SAEs trains on one shared batch. Its state is stacked along a
leading n_sae axis, with the JAX package's layout and key names (`SweepState`),
so a JAX sweep state carries over with `sweep_state_from_numpy`. The step
loops over the sweep's SAEs in Python: each SAE's forward and backward runs
on its own and only its gradients are kept, then the decoder-norm constraints,
the per-SAE gradient clip, the warmup-cosine learning rate and Adam are
applied to the stacked state.

Ported: the warm-up variant of the step (`aux_enabled=False`), which the
JAX train loop runs for the first `dead_threshold_tokens` of training, with
Adam at `matmul_precision="default"`. The AuxK step, Muon and the other
precisions raise NotImplementedError.
"""

import typing as tp

import numpy as np
import torch

from ..nn import modeling, objectives
from ..utils import scheduling

# Steps ahead that stats["aux_risk"] bounds n_dead for (train loop routing).
AUX_RISK_HORIZON = 2


class SweepState(tp.NamedTuple):
    """Stacked train state for one cohort (leading axis = SAE sweep)."""

    params: modeling.Params
    sae_state: modeling.State
    obj_state: objectives.ObjectiveState
    opt_state: dict[str, tp.Any]
    step: torch.Tensor  # int32 scalar


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _index(tree: dict, i: int) -> dict:
    """SAE i of a stacked sweep dict."""
    return {k: v[i] for k, v in tree.items()}


def _stack(trees: list[dict]) -> dict:
    return {k: (_stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
                else torch.stack([t[k] for t in trees])) for k in trees[0]}


def sweep_state_from_numpy(ts, device) -> SweepState:
    """Carry a whole JAX `SweepState` (its leaves as numpy arrays) across."""
    def conv(a):
        return torch.tensor(np.asarray(a), device=device)

    return SweepState(*(_tree_map(conv, getattr(ts, f)) for f in SweepState._fields))


def init_sweep_state(
    sae_cfg: modeling.SparseAutoencoderConfig, n_sae: int,
    generator: torch.Generator | None = None, device="cpu",
) -> SweepState:
    """A fresh stacked sweep: `modeling.init` for each SAE, zero counters,
    zero Adam moments, step 0."""
    inits = [modeling.init(sae_cfg, generator, device) for _ in range(n_sae)]
    params = _stack([p for p, _ in inits])
    return SweepState(
        params=params,
        sae_state=_stack([s for _, s in inits]),
        obj_state=_stack([objectives.init_state(sae_cfg, device) for _ in range(n_sae)]),
        opt_state=_adam_init(params),
        step=torch.zeros((), dtype=torch.int32, device=device),
    )


# ---------------------------------------------------------------------------
# Optimizer (per-SAE learning rates)
# ---------------------------------------------------------------------------


def _adam_init(params) -> dict[str, tp.Any]:
    device = next(iter(params.values())).device
    return {
        "m": {k: torch.zeros_like(v) for k, v in params.items()},
        "v": {k: torch.zeros_like(v) for k, v in params.items()},
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def _adam_update(grads, opt_state, lr_per_sae, *, b1=0.9, b2=0.999, eps=1e-8):
    """torch.optim.Adam's elementwise update with bias correction; lr is a
    (n_sae,) tensor broadcast over each stacked leaf's leading axis."""
    count = opt_state["count"] + 1
    t = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)
    m = {k: b1 * opt_state["m"][k] + (1 - b1) * g for k, g in grads.items()}
    v = {k: b2 * opt_state["v"][k] + (1 - b2) * g * g for k, g in grads.items()}

    def upd(mk, vk):
        lr = lr_per_sae.reshape((-1,) + (1,) * (mk.ndim - 1))
        return -lr * (mk / bc1) / (torch.sqrt(vk / bc2) + eps)

    updates = {k: upd(m[k], v[k]) for k in grads}
    return updates, {"m": m, "v": v, "count": count}


def _per_sae_global_norm(grads) -> torch.Tensor:
    """L2 norm over all of each SAE's params: (n_sae,). Leaves in sorted key
    order, as jax.tree.leaves walks a dict."""
    sq = [torch.sum(grads[k].reshape(grads[k].shape[0], -1) ** 2, dim=1) for k in sorted(grads)]
    return torch.sqrt(sum(sq))


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------


def make_train_step(
    sae_cfg: modeling.SparseAutoencoderConfig,
    obj_cfg: objectives.Matryoshka,
    n_steps: int,
    optim: str = "adam",
    matmul_precision: str = "default",
    aux_enabled: bool = False,
):
    """Build the train step for one cohort.

    Signature: step(sweep_state, x, prefixes, hp) -> (sweep_state, stats)
      x:        (batch, d_model) f32 on the device of the state
      prefixes: (n_sae, n_prefixes) int32, sampled host-side per step
      hp:       per-SAE (n_sae,) f32 tensors "lr", "n_lr_warmup",
                "grad_clip", "sparsity_coeff" (others are ignored)
      stats:    per-SAE loss terms, grad_norm, lr and aux_risk, (n_sae,)

    `aux_enabled=False` is the warm-up step: AuxK is left out, which is exact
    while no latent can be dead yet (the first dead_threshold_tokens).
    """
    if aux_enabled:
        raise NotImplementedError("AuxK (K5) not ported yet")
    if optim == "muon":
        raise NotImplementedError("Muon not ported yet")
    if optim != "adam":
        raise ValueError(f"Unknown optimizer: {optim}")
    if matmul_precision in ("high", "highest"):
        raise NotImplementedError(
            f"matmul_precision={matmul_precision!r} takes the decode path, not ported yet"
        )
    if matmul_precision != "default":
        raise ValueError(f"Unknown matmul precision: {matmul_precision}")

    def grad_one(params_i, sae_state_i, obj_state_i, x, prefixes_i, coeff):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params_i.items()}
        loss, _, obj_state_i = objectives.matryoshka_loss(
            obj_cfg, sae_cfg, leaves, sae_state_i, obj_state_i, x, prefixes_i,
            training=True, hp={"sparsity_coeff": coeff}, any_dead=False,
        )
        keys = sorted(leaves)
        grads = torch.autograd.grad(loss.loss, [leaves[k] for k in keys])
        detached = objectives.MatryoshkaLoss(*(t.detach() for t in loss))
        return detached, dict(zip(keys, grads)), obj_state_i

    def step(ts: SweepState, x: torch.Tensor, prefixes: torch.Tensor, hp: dict):
        # Normalize W_dec rows before the forward.
        params = modeling.normalize_w_dec(sae_cfg, ts.params)
        n_sae = params["W_dec"].shape[0]
        losses, grads, obj_states = [], [], []
        for i in range(n_sae):
            loss_i, grads_i, obj_i = grad_one(
                _index(params, i), _index(ts.sae_state, i), _index(ts.obj_state, i), x,
                prefixes[i], hp["sparsity_coeff"][i],
            )
            losses.append(loss_i)
            grads.append(grads_i)
            obj_states.append(obj_i)
        grads = modeling.remove_parallel_grads(sae_cfg, params, _stack(grads))

        # Per-SAE global-norm clip (torch.nn.utils.clip_grad_norm_ semantics).
        grad_norm = _per_sae_global_norm(grads)
        clip_coef = torch.clamp(hp["grad_clip"] / (grad_norm + 1e-6), max=1.0)
        grads = {
            k: g * clip_coef.reshape((-1,) + (1,) * (g.ndim - 1)) for k, g in grads.items()
        }

        # lr at step t = WarmupCosine after t scheduler steps (0 at t = 0).
        lr = scheduling.warmup_cosine(
            ts.step, 0.0, hp["n_lr_warmup"], hp["lr"], float(n_steps), 0.0
        )
        updates, opt_state = _adam_update(grads, ts.opt_state, lr)
        new_params = {k: params[k] + updates[k] for k in params}
        obj_state = _stack(obj_states)

        # Upper bound on n_dead over the next AUX_RISK_HORIZON steps.
        risk_floor = obj_cfg.dead_threshold_tokens - AUX_RISK_HORIZON * x.shape[0]
        aux_risk = torch.sum(
            obj_state["toks_since_active"] >= risk_floor, dim=-1
        ).to(torch.int32)

        terms = objectives.MatryoshkaLoss(*(torch.stack(t) for t in zip(*losses)))
        stats = {
            "mse": terms.mse,
            "sparsity": terms.sparsity,
            "l0": terms.l0,
            "l1": terms.l1,
            "aux": terms.aux,
            "n_dead": terms.n_dead,
            "loss": terms.loss,
            "grad_norm": grad_norm,
            "lr": lr,
            "aux_risk": aux_risk,
        }
        new_ts = SweepState(
            params=new_params,
            sae_state=ts.sae_state,
            obj_state=obj_state,
            opt_state=opt_state,
            step=ts.step + 1,
        )
        return new_ts, stats

    return step
