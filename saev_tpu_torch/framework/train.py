"""SAE training on PyTorch tensors (counterpart of saev_tpu/framework/train.py):
the train step, its router and metrics, and the whole job around them.

A sweep of SAEs trains on one shared batch. Its state is stacked along a
leading n_sae axis, with the JAX package's layout and key names (`SweepState`),
so a JAX sweep state carries over with `sweep_state_from_numpy`. The step
loops over the sweep's SAEs in Python: each SAE's forward and backward runs
on its own and only its gradients are kept, then the decoder-norm constraints,
the per-SAE gradient clip, the warmup-cosine learning rate and the optimizer
are applied to the stacked state.

The step, for Relu, TopK and BatchTopK SAEs (whose moved EMA threshold it
returns in the new state), with Adam or Muon (`_muon_update`: Newton-Schulz
on the stacked 2-D leaves in f32 with TF32 off, Adam on the 1-D ones) at
`matmul_precision="default"` (bf16 operands with f32 accumulation on the
card, f32 on the CPU: nn/modeling.py), "high" (bf16x3 on the card, f32 on
the CPU) or "highest" (f32), the last two through the decode path, in its
three forms (warm-up without AuxK, AuxK dense, AuxK in a dead subspace);
the router that picks one for each step of the loop (`StepRouter`,
`make_step_router`); the log-step metrics (`make_metrics_fn`).

The job (`main` -> `worker_fn` -> `train`, `evaluate`): the shuffled loader
reads content-addressed shards from disk, `make_saes` datapoint-initializes
each cohort (SAEs that share one step function), the loop trains them all on
one stream, copies each batch to the device ahead of its step
(`parallel.prefetch_to_device`), logs every `log_every` steps and writes step
checkpoints (`framework/checkpoints.py`) it can resume from; `evaluate` runs
`matryoshka_loss(training=False)` on the validation shards at "highest", and
`worker_fn` writes one schema-5 SAE file per config (`nn/serialize.py`).
The sweep is looped in Python.

Multi-GPU (`torchrun --nproc-per-node N -m saev_tpu_torch.framework.train
...`): one process a card on a (data, sweep, feature) grid of ranks
(`parallel.Mesh`). Each rank loads global_batch / world rows from its own
shard partition (`_partitioned_data_cfg`); the ranks of one data index
gather their rows, and each trains n_sae / sweep_parallel SAEs on them (its
sweep index's), of each the d_sae / feature_parallel latents of its feature
index (`parallel.shard_features`), with every kernel of the step; the
members of a feature group combine what spans the latents (the exact TopK
and AuxK thresholds, the prefix MSE's partial products, n_dead, L0, L1, the
gradient's norm and Muon's Gram matrices: nn/objectives.py and `_muon_update`),
and the ranks of a data group hold the same latents of the same SAEs and
average their gradients in one collective a step, before the clip. Rank 0
writes the run, the checkpoints and the SAE files, from whole arrays; a
checkpoint resumes under any layout.
"""

import collections
import dataclasses
import hashlib
import itertools
import logging
import os
import pathlib
import time
import typing as tp

import numpy as np
import torch

from .. import configs, disk, guards, helpers, parallel
from ..data import ShuffledConfig, ShuffledDataLoader
from ..nn import modeling, objectives, serialize
from ..utils import scheduling, statistics
from ..utils.monitoring import DataloaderMonitor
from ..utils.wandb import NullParallelRun, ParallelWandbRun
from . import checkpoints

logger = logging.getLogger("train")

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
    generator: torch.Generator | None = None, device="cuda", optim: str = "adam",
) -> SweepState:
    """A fresh stacked sweep: `modeling.init` for each SAE, zero counters,
    the zero state of `optim` ("adam" or "muon"), step 0."""
    inits = [modeling.init(sae_cfg, generator, device) for _ in range(n_sae)]
    params = _stack([p for p, _ in inits])
    return SweepState(
        params=params,
        sae_state=_stack([s for _, s in inits]),
        obj_state=_stack([objectives.init_state(sae_cfg, device) for _ in range(n_sae)]),
        opt_state=_opt_init(optim, params),
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


# The latent axis of each param leaf (modeling's layout, stacked or not):
# what `parallel.shard_features` slices. b_dec is whole on every rank.
_PARAM_LATENT = {"W_enc": -1, "W_dec": -2, "b_enc": -1}


def _check_feature_parallel(sae_cfg: modeling.SparseAutoencoderConfig, feature_parallel: int) -> None:
    """The JAX package's check that d_sae divides over the feature axis
    (saev_tpu/framework/train.py:560-564), with its message; and d_model !=
    d_sae, by which `parallel.shard_features` tells the latent dim apart."""
    if sae_cfg.d_sae % feature_parallel:
        raise ValueError(
            f"d_sae={sae_cfg.d_sae} must divide over feature_parallel="
            f"{feature_parallel}; otherwise GSPMD silently replicates the latent "
            "dimension and the sharding saves no memory."
        )
    if feature_parallel > 1 and sae_cfg.d_model == sae_cfg.d_sae:
        raise ValueError(
            f"feature_parallel={feature_parallel} needs d_model != d_sae (both {sae_cfg.d_sae}): the latent "
            "dim of a leaf is told apart by its size"
        )


def _newton_schulz(
    g: torch.Tensor, steps: int = 5, eps: float = 1e-7, feature: parallel.Group | None = None,
    latent_axis: int | None = None,
) -> torch.Tensor:
    """Orthogonalize the last two axes by the quintic Newton-Schulz
    iteration (saev_tpu/framework/train.py:358-370; torch.optim.Muon's
    _zeropower_via_newtonschulz), on stacked (n_sae, a, b) tensors, each
    SAE's matrix scaled by its own Frobenius norm. The iteration runs in
    float32 with TF32 off, as the JAX package keeps it (torch.optim.Muon
    runs it in bf16): batched products, one per term and iteration.

    With a `feature` group, `g` is this member's part of each whole matrix
    along `latent_axis` (-1 or -2), and its part of the whole iteration's
    result comes back: whether to transpose is decided on the whole shape;
    where the latents are then the columns, the Frobenius norm's square and
    the Gram matrix x x^T (the short side squared) are summed over the
    group, so each part iterates as the whole matrix's columns do; else the
    whole matrix is gathered, iterated and sliced."""
    a, b, c = 3.4445, -4.7750, 2.0315
    if feature is not None:
        whole = list(g.shape)
        whole[latent_axis] *= feature.size
        transpose = whole[-2] > whole[-1]
        if (latent_axis == -2) != transpose:  # the latents would be x's rows
            n = g.shape[latent_axis]
            every = parallel.gather_rows(g.movedim(latent_axis, 0), feature).movedim(0, latent_axis)
            return _newton_schulz(every, steps, eps).narrow(latent_axis, feature.index * n, n)
        x = g.mT if transpose else g
        sq = parallel.all_reduce(torch.sum(x * x, dim=(-2, -1), keepdim=True), "sum", feature)
        x = x / torch.clamp(torch.sqrt(sq), min=eps)
        with modeling._f32_products():
            for _ in range(steps):
                gram = parallel.all_reduce(x @ x.mT, "sum", feature)
                x = a * x + (b * gram + c * gram @ gram) @ x
        return x.mT if transpose else x
    transpose = g.shape[-2] > g.shape[-1]
    x = g.mT if transpose else g
    x = x / torch.clamp(torch.linalg.norm(x, dim=(-2, -1), keepdim=True), min=eps)
    with modeling._f32_products():
        for _ in range(steps):
            gram = x @ x.mT
            x = a * x + (b * gram + c * gram @ gram) @ x
    return x.mT if transpose else x


def _muon_init(params) -> dict[str, tp.Any]:
    device = next(iter(params.values())).device
    return {
        "mu": {k: torch.zeros_like(v) for k, v in params.items()},
        "adam": _adam_init(params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def _opt_init(optim: str, params) -> dict[str, tp.Any]:
    if optim == "adam":
        return _adam_init(params)
    if optim == "muon":
        return _muon_init(params)
    raise ValueError(f"Unknown optimizer: {optim}")


def _muon_update(params, grads, opt_state, lr_per_sae, *, beta=0.95, weight_decay=0.1, feature=None):
    """torch.optim.Muon's update on the stacked 2-D leaves (3-D here), Adam
    on the rest (saev_tpu/framework/train.py:380-409): EMA momentum (mu =
    beta mu + (1 - beta) g), the Nesterov blend (1 - beta) g + beta mu,
    Newton-Schulz, lr scaled by sqrt(max(1, rows / cols)), and decoupled
    weight decay on `params` at the unscaled lr. The Adam state advances for
    every leaf, as the JAX package's does. With a `feature` group the
    matrices are this member's latents of the whole ones: Newton-Schulz runs
    over the group and the scale takes the whole shape."""
    mu = {k: beta * opt_state["mu"][k] + (1.0 - beta) * g for k, g in grads.items()}
    adam_updates, adam_state = _adam_update(grads, opt_state["adam"], lr_per_sae)
    updates = {}
    for k, g in grads.items():
        if mu[k].ndim < 3:
            updates[k] = adam_updates[k]
            continue
        latent = None if feature is None else _PARAM_LATENT.get(k)
        ortho = _newton_schulz((1.0 - beta) * g + beta * mu[k], feature=None if latent is None else feature,
                               latent_axis=latent)
        whole = list(mu[k].shape)
        if latent is not None:
            whole[latent] *= feature.size
        # An f32 square root, as jnp.sqrt takes the ratio.
        scale = float(np.sqrt(np.float32(max(1.0, whole[-2] / whole[-1]))))
        lr = lr_per_sae.reshape((-1,) + (1,) * (mu[k].ndim - 1))
        updates[k] = -lr * weight_decay * params[k] - lr * scale * ortho
    return updates, {"mu": mu, "adam": adam_state, "count": opt_state["count"] + 1}


def _per_sae_global_norm(grads, feature: parallel.Group | None = None) -> torch.Tensor:
    """L2 norm over all of each SAE's params: (n_sae,). Leaves in sorted key
    order, as jax.tree.leaves walks a dict. Each SAE's sums are reductions
    of their own, whose order does not depend on the sweep's size: an SAE
    gets the same bits in a sweep split over processes (sweep_parallel) as
    in the whole sweep. The latent-sharded leaves' sum of squares is summed
    over a `feature` group, and the whole leaves' (b_dec) added once."""
    n_sae = grads[next(iter(grads))].shape[0]
    keys = sorted(grads)
    sharded = [k for k in keys if k in _PARAM_LATENT]
    whole = [k for k in keys if k not in _PARAM_LATENT]
    sq = torch.stack([sum(torch.sum(grads[k][i] ** 2) for k in sharded) for i in range(n_sae)])
    sq = parallel.all_reduce(sq, "sum", feature)
    return torch.sqrt(sq + torch.stack([sum(torch.sum(grads[k][i] ** 2) for k in whole) for i in range(n_sae)]))


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------


def make_train_step(
    sae_cfg: modeling.SparseAutoencoderConfig,
    obj_cfg: objectives.Matryoshka,
    n_steps: int,
    optim: str = "adam",
    matmul_precision: str = "default",
    aux_enabled: bool = True,
    aux_subspace_cap: int | None = None,
    mesh: parallel.Mesh | None = None,
):
    """Build the train step for one cohort.

    Signature: step(sweep_state, x, prefixes, hp) -> (sweep_state, stats)
      x:        (batch, d_model) f32 on the device of the state
      prefixes: (n_sae, n_prefixes) int32, sampled host-side per step
      hp:       per-SAE (n_sae,) f32 tensors "lr", "n_lr_warmup",
                "grad_clip", "sparsity_coeff" and, optionally, "aux_alpha"
                (AuxK.alpha when absent) and "momentum" (BatchTopK's
                momentum when absent); others are ignored
      stats:    per-SAE loss terms, grad_norm, lr and aux_risk, (n_sae,)

    `aux_enabled=False` is the warm-up step: AuxK is left out, which is exact
    while no latent can be dead yet (the first dead_threshold_tokens).
    `aux_subspace_cap` computes AuxK in the dead-subspace form, exact iff
    n_dead <= cap at the step; `StepRouter` picks the variant that is.

    Under a `mesh` with a data group, `x` is this rank's share of the batch
    and the state holds this rank's SAEs: the loss takes the whole batch's
    statistics (`objectives.matryoshka_loss(group=...)`), the gradients and
    the loss terms are averaged over the data group (one flat buffer, one
    collective) before the parallel-gradient removal and the clip, and the
    counters count the whole batch.

    Under a `mesh` with a feature group, the state holds this rank's latents
    of its SAEs (`parallel.shard_features`) and every term is the whole
    dictionary's (`objectives.matryoshka_loss(feature=...)`): the loss terms,
    n_dead, the gradient's norm (`_per_sae_global_norm`) and aux_risk are the
    same on every member, and Muon runs over the group (`_muon_update`).
    """
    if optim not in ("adam", "muon"):
        raise ValueError(f"Unknown optimizer: {optim}")
    if matmul_precision not in modeling.PRECISIONS:
        raise ValueError(f"Unknown matmul precision: {matmul_precision}")

    # Static gate: None computes AuxK, False leaves it out (warm-up).
    any_dead = None if aux_enabled else False
    group = None if mesh is None else mesh.data
    n_data = 1 if group is None else group.size
    feature = None if mesh is None else mesh.feature
    if feature is not None:
        _check_feature_parallel(sae_cfg, feature.size)

    def grad_one(params_i, sae_state_i, obj_state_i, x, x_abs_max, prefixes_i, coeff, alpha, momentum):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params_i.items()}
        loss, _, sae_state_i, obj_state_i = objectives.matryoshka_loss(
            obj_cfg, sae_cfg, leaves, sae_state_i, obj_state_i, x, prefixes_i,
            training=True, hp={"sparsity_coeff": coeff, "aux_alpha": alpha, "momentum": momentum},
            precision=matmul_precision, any_dead=any_dead, aux_subspace_cap=aux_subspace_cap, group=group,
            x_abs_max=x_abs_max, feature=feature,
        )
        keys = sorted(leaves)
        grads = torch.autograd.grad(loss.loss, [leaves[k] for k in keys])
        detached = objectives.MatryoshkaLoss(*(t.detach() for t in loss))
        return detached, dict(zip(keys, grads)), sae_state_i, obj_state_i

    def step(ts: SweepState, x: torch.Tensor, prefixes: torch.Tensor, hp: dict):
        # Normalize W_dec rows before the forward.
        params = modeling.normalize_w_dec(sae_cfg, ts.params)
        n_sae = params["W_dec"].shape[0]
        alphas, momenta = hp.get("aux_alpha"), hp.get("momentum")
        # The whole batch's max|x|, once for the sweep (None single-process).
        x_abs_max = None if group is None else parallel.all_reduce(x.abs().max(), "max", group)
        losses, grads, sae_states, obj_states = [], [], [], []
        for i in range(n_sae):
            loss_i, grads_i, sae_i, obj_i = grad_one(
                _index(params, i), _index(ts.sae_state, i), _index(ts.obj_state, i), x, x_abs_max,
                prefixes[i], hp["sparsity_coeff"][i], None if alphas is None else alphas[i],
                None if momenta is None else momenta[i],
            )
            losses.append(loss_i)
            grads.append(grads_i)
            sae_states.append(sae_i)
            obj_states.append(obj_i)
        grads = _stack(grads)
        keys = sorted(grads)
        terms = objectives.MatryoshkaLoss(*(torch.stack(t) for t in zip(*losses)))
        # The gradients and this rank's loss means -> the batch's, in one
        # collective (n_dead is the batch's already).
        means = ("mse", "sparsity", "l0", "l1", "aux")
        reduced = parallel.all_reduce_mean([grads[k] for k in keys] + [getattr(terms, m) for m in means], group)
        grads = dict(zip(keys, reduced))
        terms = terms._replace(**dict(zip(means, reduced[len(keys):])))
        grads = modeling.remove_parallel_grads(sae_cfg, params, grads)

        # Per-SAE global-norm clip (torch.nn.utils.clip_grad_norm_ semantics).
        grad_norm = _per_sae_global_norm(grads, feature)
        clip_coef = torch.clamp(hp["grad_clip"] / (grad_norm + 1e-6), max=1.0)
        grads = {
            k: g * clip_coef.reshape((-1,) + (1,) * (g.ndim - 1)) for k, g in grads.items()
        }

        # lr at step t = WarmupCosine after t scheduler steps (0 at t = 0).
        lr = scheduling.warmup_cosine(
            ts.step, 0.0, hp["n_lr_warmup"], hp["lr"], float(n_steps), 0.0
        )
        if optim == "adam":
            updates, opt_state = _adam_update(grads, ts.opt_state, lr)
        else:
            updates, opt_state = _muon_update(params, grads, ts.opt_state, lr, feature=feature)
        new_params = {k: params[k] + updates[k] for k in params}
        obj_state = _stack(obj_states)

        # Upper bound on n_dead over the next AUX_RISK_HORIZON steps.
        risk_floor = obj_cfg.dead_threshold_tokens - AUX_RISK_HORIZON * x.shape[0] * n_data
        aux_risk = parallel.all_reduce(torch.sum(
            obj_state["toks_since_active"] >= risk_floor, dim=-1
        ).to(torch.int32), "sum", feature)

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
            # The loss's state: BatchTopK's threshold moved by this step.
            sae_state=_stack(sae_states),
            obj_state=obj_state,
            opt_state=opt_state,
            step=ts.step + 1,
        )
        return new_ts, stats

    return step


# ---------------------------------------------------------------------------
# Log-step metrics
# ---------------------------------------------------------------------------


def dictionary_coherence(w: torch.Tensor, block: int = 1024, feature: parallel.Group | None = None) -> torch.Tensor:
    """max off-diagonal |<w_i/|w_i|, w_j/|w_j|>| over decoder rows, in row
    blocks so the (d_sae, d_sae) Gram matrix is never built. With a
    `feature` group, `w` is this member's rows: each member takes its rows
    against all of them (gathered), and the max over the group."""
    wn = w / torch.linalg.norm(w, dim=1, keepdim=True)
    every = parallel.gather_rows(wn, feature)
    offset = 0 if feature is None else feature.index * w.shape[0]
    block = min(block, w.shape[0])
    ids = torch.arange(every.shape[0], device=w.device)
    coh = torch.zeros((), dtype=torch.float32, device=w.device)
    for start in range(0, w.shape[0], block):
        rows = wn[start : start + block]
        gram = torch.abs(rows @ every.T)
        off_diag = ids[offset + start : offset + start + rows.shape[0], None] != ids[None, :]
        coh = torch.maximum(coh, torch.where(off_diag, gram, 0.0).max())
    return parallel.all_reduce(coh, "max", feature)


def make_metrics_fn(sae_cfg: modeling.SparseAutoencoderConfig, mesh: parallel.Mesh | None = None):
    """The heavy per-SAE metrics the loop computes every log_every steps:
    explained variance, dead %, coherence, SSE terms, from a fresh forward on
    the current params, at "highest" (as the JAX package's, whose `encode`
    and `decode` take no precision there). Its forward is in training mode,
    as the JAX package's: a TopK threshold is kernel K6 on the card, a
    BatchTopK SAE's the batch-global k-th value (its moved threshold is
    not kept).

    Under a `mesh` with a data group, `x` is this rank's share of the batch
    and the metrics are the whole batch's: sums (in f64 where they make a
    variance) and fired counts are summed over the group, and BatchTopK
    takes the whole batch's threshold. With a feature group, the params are
    this rank's latents and every metric is the whole dictionary's.

    Signature: metrics(sweep_state, x, prefixes) -> {name: (n_sae,) tensor}
    (`prefixes` is accepted for the JAX package's signature and not read).
    """
    group = None if mesh is None else mesh.data
    feature = None if mesh is None else mesh.feature

    def one(params, sae_state, x):
        enc, _ = modeling.encode(sae_cfg, params, sae_state, x, training=True, group=group, feature=feature)
        x_hat = modeling.decode(sae_cfg, params, enc.f_x, feature=feature)[:, -1, :]
        residual = x - x_hat
        fired = (torch.abs(enc.f_x) > 1e-12).sum(dim=0)
        if group is None:
            sse = torch.sum(residual**2)
            explained = 1.0 - torch.var(residual, correction=0) / torch.var(x, correction=0)
        else:
            parallel.all_reduce(fired, "sum", group)
            r64, x64 = residual.double(), x.double()
            sums = torch.stack([r64.sum(), (r64**2).sum(), x64.sum(), (x64**2).sum()])
            parallel.all_reduce(sums, "sum", group)
            n = x.numel() * group.size
            sse = sums[1].float()
            explained = (1.0 - (sums[1] - sums[0] ** 2 / n) / (sums[3] - sums[2] ** 2 / n)).float()
        row_norms = torch.linalg.norm(params["W_dec"], dim=1)
        if feature is None:
            dead_pct, avg_norm = (fired == 0).to(torch.float32).mean(), row_norms.mean()
        else:
            sums = parallel.all_reduce(torch.stack([(fired == 0).sum().to(torch.float32), row_norms.sum()]),
                                       "sum", feature)
            dead_pct, avg_norm = sums[0] / sae_cfg.d_sae, sums[1] / sae_cfg.d_sae
        return {
            "sse_sae": sse,
            "explained_variance": explained,
            "dead_unit_pct": dead_pct,
            "dictionary_coherence": dictionary_coherence(params["W_dec"], feature=feature),
            "avg_decoder_row_norm": avg_norm,
        }

    @torch.no_grad()
    def metrics(ts: SweepState, x: torch.Tensor, prefixes: torch.Tensor):
        sum_vec = torch.sum(x, dim=0)
        sum_sq = torch.sum(x * x)
        n_rows = x.shape[0]
        if group is not None:
            sums = parallel.all_reduce(torch.cat([sum_vec, sum_sq[None]]), "sum", group)
            sum_vec, sum_sq, n_rows = sums[:-1], sums[-1], n_rows * group.size
        sse_baseline = sum_sq - torch.dot(sum_vec, sum_vec) / n_rows
        n_sae = ts.params["W_dec"].shape[0]
        per = [one(_index(ts.params, i), _index(ts.sae_state, i), x) for i in range(n_sae)]
        out = {k: torch.stack([p[k] for p in per]) for k in per[0]}
        out["sse_baseline"] = sse_baseline.expand(n_sae)
        out["normalized_mse"] = out["sse_sae"] / sse_baseline
        return out

    return metrics


# ---------------------------------------------------------------------------
# Step routing
# ---------------------------------------------------------------------------


class StepRouter:
    """Picks the step variant for each step of the train loop (counterpart of
    saev_tpu/framework/train.py `_CohortRuntime.step_fn_at` and
    `record_stats`).

    Steps before `aux_from_step` cannot see a dead latent and run the warm
    step (AuxK left out). After that, the narrowest dead-subspace step whose
    cap the lagged stats["aux_risk"] proves wide enough runs; the dense step
    is the fallback while no readout exists or no rung is wide enough.
    `step_fn_subs` is [(cap, step_fn), ...] ascending by cap.

    With a `group` (every process of a multi-GPU job), a step's bound is the
    max over the group, so that every rank takes the variant that one
    process holding the whole cohort would, and all ranks enter the same
    kernels and collectives.
    """

    def __init__(self, step_fn, *, step_fn_warm=None, aux_from_step: int = 0, step_fn_subs=(),
                 group: parallel.Group | None = None):
        self.step_fn = step_fn
        self.group = group
        self.step_fn_warm = step_fn_warm
        self.aux_from_step = aux_from_step
        self.step_fn_subs = list(step_fn_subs)
        # [(global_step, max aux_risk, event or None)] awaiting readout, and
        # the newest proven bound on n_dead (None: unknown, run dense).
        self.pending: list[tuple[int, torch.Tensor, tp.Any]] = []
        self.risk: int | None = None

    def step_fn_at(self, global_step: int):
        if self.step_fn_warm is not None and global_step < self.aux_from_step:
            return self.step_fn_warm
        if not self.step_fn_subs:
            return self.step_fn
        # Read the bounds of steps AUX_RISK_HORIZON or more steps old: the
        # wait ends when that step's kernels have, while newer steps are
        # already queued behind it.
        while self.pending and self.pending[0][0] <= global_step - AUX_RISK_HORIZON:
            _, risk, done = self.pending.pop(0)
            if done is not None:
                done.synchronize()
            self.risk = int(risk)
        if self.risk is not None:
            for cap, fn in self.step_fn_subs:
                if self.risk <= cap:
                    return fn
        return self.step_fn

    def record_stats(self, global_step: int, stats: dict) -> None:
        # Stats before (aux_from_step - horizon) would never be read.
        if not self.step_fn_subs or global_step < self.aux_from_step - AUX_RISK_HORIZON:
            return
        risk, done = parallel.all_reduce(stats["aux_risk"].max(), "max", self.group), None
        if risk.is_cuda:
            # Copy to pinned host memory behind this step's kernels; reading
            # it later waits on this event, not on the steps queued since.
            host = torch.empty((), dtype=risk.dtype, pin_memory=True)
            host.copy_(risk, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            risk = host
        self.pending.append((global_step, risk, done))


def make_step_router(
    sae_cfg: modeling.SparseAutoencoderConfig,
    obj_cfg: objectives.Matryoshka,
    n_steps: int,
    batch_size: int,
    optim: str = "adam",
    matmul_precision: str = "default",
    mesh: parallel.Mesh | None = None,
) -> StepRouter:
    """The step variants of one cohort and their router, as the JAX train
    loop builds them (saev_tpu/framework/train.py:1057-1103); `batch_size`
    is the global batch. Under a `mesh` the steps are its (`make_train_step`)
    and the router reads the bound of the whole job's cohort.

    Steps [0, aux_from_step) cannot produce a dead latent: within 0-based
    step i the counters reach at most (i + 1) * batch_size, and dead needs
    dead_threshold_tokens, so the first step that can see one is
    ceil(threshold / batch_size) - 1.
    """
    has_aux = isinstance(sae_cfg.activation.aux, modeling.AuxK)
    aux_from_step = (
        max(0, -(-obj_cfg.dead_threshold_tokens // batch_size) - 1) if has_aux else n_steps + 1
    )
    caps = objectives.subspace_cap_ladder(sae_cfg.d_sae, sae_cfg.activation.aux.k_aux) if has_aux else []

    def make(**kwargs):
        return make_train_step(sae_cfg, obj_cfg, n_steps, optim, matmul_precision, mesh=mesh, **kwargs)

    return StepRouter(
        make(),
        step_fn_warm=make(aux_enabled=False) if has_aux and aux_from_step > 0 else None,
        aux_from_step=aux_from_step,
        step_fn_subs=[(cap, make(aux_subspace_cap=cap)) for cap in caps],
        group=None if mesh is None else parallel.world_group(),
    )


# ---------------------------------------------------------------------------
# The job's configuration (saev_tpu/framework/train.py:60-157)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Config:
    """Configuration for training an SAE on ViT activations (reference
    train.py:52-105). The JAX package's field names and defaults, but for two
    fields: `device` names "cuda" or "cpu" and says where the job runs, and
    `profile_dir` takes a torch.profiler trace."""

    train_data: ShuffledConfig = ShuffledConfig()
    """Training data."""
    val_data: ShuffledConfig = ShuffledConfig()
    """Validation data."""
    n_train: int = 100_000_000
    """Number of SAE training samples."""
    n_val: int = 10_000_000
    """Number of SAE evaluation samples."""
    sae: modeling.SparseAutoencoderConfig = modeling.SparseAutoencoderConfig()
    """SAE configuration."""
    objective: objectives.Matryoshka = objectives.Matryoshka()
    """SAE objective configuration."""
    n_sparsity_warmup: int = 0
    """Number of sparsity coefficient warmup steps."""
    optim: tp.Literal["adam", "muon"] = "adam"
    """Optimizer for training."""
    lr: float = 0.0004
    """Learning rate."""
    n_lr_warmup: int = 500
    """Number of learning rate warmup steps."""
    grad_clip: float = 1.0
    """Maximum gradient norm across all SAE parameters."""
    sweep_parallel: int = 1
    """Split the sweep over this many processes (one card each): each trains
    n_sae / sweep_parallel whole SAEs. It must divide the job's processes,
    and the cohort."""
    sweep_vmap_width: int = 1
    """SAEs per vmap chunk in the JAX package's step; here the sweep is looped
    in Python one SAE at a time, and the field only splits cohorts as there."""
    feature_parallel: int = 1
    """Shard the latent dimension (d_sae) over this many processes (one card
    each): each holds d_sae / feature_parallel latents of its SAEs, for
    dictionaries too wide for one card. sweep_parallel * feature_parallel
    must divide the job's processes, and feature_parallel d_sae."""
    matmul_precision: tp.Literal["highest", "high", "default"] = "default"
    """Train-step matmul precision: default = bf16 operands with f32
    accumulation on the card (f32 on the CPU), highest = f32 with TF32 off,
    high = bf16x3 on the card (f32 on the CPU). Eval always runs at highest."""
    ckpt_every: int = 0
    """Save the full train state (params + optimizer + counters) every N steps
    under runs_root/.train_state (0 disables)."""
    resume: bool = False
    """Resume from the latest saved train state if one exists. The data stream
    restarts reshuffled; optimizer state and step counters are restored."""
    profile_dir: pathlib.Path | None = None
    """Capture a torch.profiler trace of steps [10, 20) into this directory
    (a Chrome trace, `trace.json`)."""

    # Logging
    track: bool = True
    """Whether to track with WandB (falls back to a local JSONL recorder offline)."""
    wandb_project: str = "saev"
    """WandB project name."""
    tags: tuple[str, ...] = ()
    """Tags to add to WandB run."""
    log_every: int = 25
    """How often to log metrics."""
    runs_root: pathlib.Path = pathlib.Path("$SAEV_NFS/saev/runs")
    """Root directory for runs."""

    device: tp.Literal["cuda", "cpu"] = "cuda"
    """Where the job runs: the card unless "cpu" is asked for."""
    seed: int = 42
    """Random seed."""
    slurm_acct: str = ""
    """Slurm account string. Empty means to not use Slurm."""
    slurm_partition: str = ""
    """Slurm partition."""
    n_hours: float = 24.0
    """Slurm job length in hours."""
    mem_gb: int = 128
    """Node memory in GB."""
    log_to: str = os.path.join(".", "logs")
    """Where to log job stdout/stderr."""


# ---------------------------------------------------------------------------
# Sweep cohorts: SAEs that can share one step function
# ---------------------------------------------------------------------------


def _static_key(cfg: Config) -> tuple:
    """Everything that changes the step's computation (shapes, static ints,
    branch structure). SAEs with equal keys train in one cohort; float knobs
    are per-SAE tensors and do not split cohorts."""
    act = cfg.sae.activation
    act_static: tuple = (type(act).__name__,)
    if isinstance(act, (modeling.TopK, modeling.BatchTopK)):
        act_static += (act.top_k,)
    aux = act.aux
    if isinstance(aux, modeling.AuxK):
        act_static += ("auxk", aux.k_aux)
    else:
        act_static += ("no-aux",)
    act_static += (type(act.sparsity).__name__,)
    return (
        cfg.sae.d_model,
        cfg.sae.d_sae,
        act_static,
        cfg.sae.normalize_w_dec,
        cfg.sae.remove_parallel_grads,
        cfg.objective.n_prefixes,
        cfg.objective.dead_threshold_tokens,
        cfg.optim,
        cfg.matmul_precision,
        cfg.sweep_vmap_width,
    )


class Cohort(tp.NamedTuple):
    """A sub-sweep sharing one step function."""

    indices: list[int]  # positions in the original cfgs list
    cfgs: list[Config]


def make_cohorts(cfgs: list[Config]) -> list[Cohort]:
    groups: dict[tuple, list[int]] = collections.defaultdict(list)
    for i, cfg in enumerate(cfgs):
        groups[_static_key(cfg)].append(i)
    return [Cohort(indices=idxs, cfgs=[cfgs[i] for i in idxs]) for idxs in sorted(groups.values())]


def _hp_arrays(cfgs: list[Config]) -> dict[str, np.ndarray]:
    """Per-SAE float hyperparameters as (n_sae,) float32 arrays."""
    def f32(vals):
        return np.asarray(vals, dtype=np.float32)

    sparsity_coeff, aux_alpha, momentum = [], [], []
    for cfg in cfgs:
        act = cfg.sae.activation
        sp = act.sparsity
        sparsity_coeff.append(sp.coeff if isinstance(sp, modeling.L1Sparsity) else 0.0)
        aux = act.aux
        aux_alpha.append(aux.alpha if isinstance(aux, modeling.AuxK) else 0.0)
        momentum.append(act.momentum if isinstance(act, modeling.BatchTopK) else 0.0)
    return {
        "lr": f32([c.lr for c in cfgs]),
        "n_lr_warmup": f32([c.n_lr_warmup for c in cfgs]),
        "grad_clip": f32([c.grad_clip for c in cfgs]),
        "sparsity_coeff": f32(sparsity_coeff),
        "aux_alpha": f32(aux_alpha),
        "momentum": f32(momentum),
    }


# ---------------------------------------------------------------------------
# Datapoint initialization (saev_tpu/framework/train.py:242-332)
# ---------------------------------------------------------------------------


def make_saes(
    cfgs: list[Config], dl: tp.Any, *, seed: int = 0, device: torch.device | str = "cuda",
) -> tuple[modeling.Params, modeling.State, objectives.ObjectiveState]:
    """Build and (datapoint-)initialize a stacked sweep of SAEs on `device`.

    As the JAX package (reference train.py:109-189): W_enc columns are
    initialized from max(d_sae, 65536) zero-centered real activations blended
    with Kaiming noise at `reinit_blend`; optionally W_dec = W_enc^T; W_dec
    re-normalized; W_enc synced to the normalized W_dec^T. Host numpy with
    the JAX package's draws, so at `reinit_blend > 0` (with
    `reinit_enc_dec_tranpose`) W_enc and W_dec are bit for bit the JAX
    package's on the same batches. An SAE at blend 0 keeps `modeling.init`'s
    Kaiming weights, whose random stream is torch's, not JAX's.

    In a job of several processes each reads max(d_sae, 65536 // world) rows
    of its own partition, and every process takes rank 0's weights
    (`parallel.broadcast_from_primary`), as the JAX package does.
    """
    assert cfgs, "Need at least one SAE to initialize."
    sae_cfg0 = cfgs[0].sae
    d_sae, d_model = sae_cfg0.d_sae, sae_cfg0.d_model
    assert all(c.sae.d_sae == d_sae and c.sae.d_model == d_model for c in cfgs), (
        "All SAEs in a cohort must share d_sae/d_model."
    )

    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    inits = [modeling.init(c.sae, gen, "cpu") for c in cfgs]
    params_list = [{k: v.numpy() for k, v in p.items()} for p, _ in inits]

    if any(c.sae.reinit_blend > 0 for c in cfgs):
        n_samples = max(d_sae, 65_536)
        if parallel.process_count() > 1:
            n_samples = max(d_sae, n_samples // parallel.process_count())
        if hasattr(dl, "n_samples"):
            assert dl.n_samples >= d_sae, (
                f"Need {d_sae} samples for datapoint init; dataloader has {dl.n_samples}."
            )
            n_samples = min(n_samples, dl.n_samples)

        batches, n_seen = [], 0
        for batch in dl:
            act = np.asarray(batch["act"])
            batches.append(act)
            n_seen += len(act)
            if n_seen >= n_samples:
                break
        assert n_seen >= n_samples, (
            f"Datapoint init requested {n_samples} samples but saw {n_seen}."
        )
        acts = np.concatenate(batches, axis=0)[:n_samples]
        acts = acts[rng.permutation(n_samples)]
        acts_mean = acts.mean(axis=0, keepdims=True)
        zero_centered = (acts[:d_sae] - acts_mean).astype(np.float32)
        bound = np.sqrt(6.0 / d_model)
        kaiming = rng.uniform(-bound, bound, size=zero_centered.shape).astype(np.float32)

        for cfg, params in zip(cfgs, params_list):
            blend = cfg.sae.reinit_blend
            assert 0.0 <= blend <= 1.0, f"reinit_blend must be in [0, 1], got {blend}."
            if blend == 0:
                continue
            idx = rng.permutation(d_sae)
            enc_rows = blend * zero_centered[idx] + (1 - blend) * kaiming[idx]
            params["W_enc"] = enc_rows.T.copy()
            if cfg.sae.reinit_enc_dec_tranpose:
                params["W_dec"] = enc_rows.copy()
            if cfg.sae.normalize_w_dec:
                params["W_dec"] = params["W_dec"] / np.linalg.norm(
                    params["W_dec"], axis=1, keepdims=True
                )
            # Unconditional sync, matching the reference (train.py:185): W_enc
            # always ends as the normalized W_dec transpose.
            params["W_enc"] = params["W_dec"].T.copy()

        mean_p = sum(c.sae.reinit_blend for c in cfgs) / len(cfgs)
        logger.info("Initialized %d SAEs with avg(p)=%.2f", len(cfgs), mean_p)
        params_list = parallel.broadcast_from_primary(params_list)

    params = {k: torch.from_numpy(np.stack([p[k] for p in params_list])).to(device) for k in params_list[0]}
    sae_state = _stack([modeling.init_state(c.sae, device) for c in cfgs])
    obj_state = _stack([objectives.init_state(c.sae, device) for c in cfgs])
    return params, sae_state, obj_state


# ---------------------------------------------------------------------------
# The train loop (saev_tpu/framework/train.py:964-1289)
# ---------------------------------------------------------------------------


class _CohortRuntime(tp.NamedTuple):
    cohort: Cohort
    ts: SweepState  # this rank's SAEs of the cohort, its latents of each
    # The cohort's step variants (warm, dense, subspace rungs) and the
    # routing state that picks one a step.
    router: StepRouter
    metrics_fn: tp.Any
    hp: dict[str, torch.Tensor]
    prefix_rng: np.random.Generator
    mesh: parallel.Mesh
    axes: SweepState | None = None  # the latent axis of each leaf of ts (`parallel.latent_axes`)


def _device_mesh(batch_size: int, sweep: int = 1, feature: int = 1) -> parallel.Mesh:
    """The (data, sweep, feature) grid over every process of the job (counterpart of
    the JAX package's `_device_mesh`, which shrinks its data axis until it
    divides the batch; here a process cannot be left out, so
    `_check_full_mesh` raises instead)."""
    mesh = parallel.make_mesh(sweep=sweep, feature=feature)
    _check_full_mesh(mesh, batch_size)
    return mesh


def _partitioned_data_cfg(data_cfg: ShuffledConfig, what: str) -> ShuffledConfig:
    """This process's loader: 1/world of the global batch rows off its
    disjoint shard partition (identity single-process). drop_last, because a
    short local batch at one rank's epoch boundary would leave the ranks
    with unequal rows to gather and reduce; BatchLimiter cycles epochs, so
    no data is lost. The trainer sets rank and world: a config that sets
    them itself raises."""
    world = parallel.process_count()
    if (data_cfg.rank, data_cfg.world) != (0, 1):
        raise ValueError(
            f"{what}_data has rank={data_cfg.rank}, world={data_cfg.world}: the trainer partitions the loader "
            f"over the job's {world} process(es) itself; leave them at 0 and 1"
        )
    if world == 1:
        return data_cfg
    if data_cfg.batch_size % world:
        raise ValueError(
            f"Global {what} batch_size={data_cfg.batch_size} does not divide over the job's {world} processes."
        )
    return dataclasses.replace(
        data_cfg, batch_size=data_cfg.batch_size // world, rank=parallel.process_index(), world=world,
        drop_last=True,
    )


def _check_full_mesh(mesh: parallel.Mesh, batch_size: int) -> None:
    """The global batch must split evenly over the data axis: every process
    takes part, and a rank with fewer rows would stall the gathers and
    reductions."""
    if batch_size % mesh.n_data:
        raise ValueError(
            f"Global batch_size={batch_size} must be a multiple of the data-axis extent {mesh.n_data}; "
            "multi-process batch assembly needs every process in the mesh."
        )


def _group_key(cfg: Config) -> str:
    """A key of the training group that every process computes alike
    (sha256 of a repr whose frozensets are sorted: Python's hash(), and so
    a frozenset's order, is randomized per process)."""
    def canonical(x):
        if isinstance(x, frozenset):
            return ("frozenset", sorted((canonical(v) for v in x), key=repr))
        if isinstance(x, tuple):
            return tuple(canonical(v) for v in x)
        return x

    # A checkpoint holds whole arrays: it resumes under any layout.
    layout_free = dataclasses.replace(cfg, sweep_parallel=1, feature_parallel=1)
    return hashlib.sha256(repr(canonical(_parallel_key(layout_free))).encode()).hexdigest()[:16]


def _cohort_for_primary(mesh: parallel.Mesh, tree, axes):
    """The whole cohort as numpy on rank 0, for its writes; None elsewhere.
    `parallel.to_host` is a collective over a sweep group (and, with the
    tree's latent `axes`, over a feature group first), so the ranks of rank
    0's data index (d = 0) take part; the others copy nothing."""
    return parallel.to_host(mesh, tree, axes) if mesh.d == 0 else None


def _sample_prefixes(rt: _CohortRuntime, device) -> torch.Tensor:
    """This step's prefix cuts for this rank's SAEs: every rank draws the
    whole cohort's from the same seeded generator, as one process would,
    and keeps its slice."""
    c0 = rt.cohort.cfgs[0]
    cuts = np.stack([
        objectives.sample_prefixes(c0.sae.d_sae, c0.objective.n_prefixes, rng=rt.prefix_rng)
        for _ in rt.cohort.cfgs
    ])
    return torch.from_numpy(parallel.shard_sweep(rt.mesh, cuts)).to(device)


class _Profile:
    """torch.profiler over steps [10, 20) into `profile_dir`, as the JAX
    package's jax.profiler window."""

    def __init__(self, profile_dir: pathlib.Path | None):
        self.dir, self.prof = profile_dir, None

    def after_step(self, global_step: int) -> None:
        if self.dir is None:
            return
        if global_step == 10:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=activities)
            self.prof.__enter__()
            logger.info("Started torch.profiler trace -> %s", self.dir)
        elif global_step == 20 and self.prof is not None:
            self.prof.__exit__(None, None, None)
            pathlib.Path(self.dir).mkdir(parents=True, exist_ok=True)
            self.prof.export_chrome_trace(str(pathlib.Path(self.dir) / "trace.json"))
            self.prof = None
            logger.info("Stopped torch.profiler trace.")


def train(cfgs: list[Config]) -> tuple[list[_CohortRuntime], ParallelWandbRun, int]:
    """Train a parallel sweep of SAEs on one shared data stream
    (reference train.py:239-462)."""
    if len(split_cfgs(cfgs)) != 1:
        raise ValueError(f"Configs are not parallelizeable: {cfgs}.")

    logger.info("Parallelizing %d runs.", len(cfgs))
    cfg = cfgs[0]
    device = torch.device(cfg.device)

    # Multi-process: this process loads 1/world of each global batch from its
    # disjoint shard partition; its sweep group gathers the rows it trains on
    # (parallel.shard_batch). Host-side writes happen on rank 0.
    mesh = _device_mesh(cfg.train_data.batch_size, cfg.sweep_parallel, cfg.feature_parallel)
    world = parallel.process_count()
    dataloader = ShuffledDataLoader(_partitioned_data_cfg(cfg.train_data, "train"))
    metadata = dataloader.metadata
    if metadata.d_model != cfg.sae.d_model:
        raise guards.GuardError(
            f"sae.d_model={cfg.sae.d_model} does not match the shards' "
            f"d_model={metadata.d_model} ({cfg.train_data.shards}); the SAE "
            "must be configured for the model family the shards were "
            "extracted from."
        )
    limited = scheduling.BatchLimiter(dataloader, cfg.n_train // world)
    # Every process runs the same number of collective-bearing steps.
    n_steps = int(parallel.global_min(len(limited)))
    bsz = cfg.train_data.batch_size
    logger.info("Mesh: %d process(es), data %d x sweep %d x feature %d.", world, mesh.n_data, mesh.n_sweep,
                mesh.n_feature)

    runtimes: list[_CohortRuntime] = []
    for ci, cohort in enumerate(make_cohorts(cfgs)):
        if len(cohort.cfgs) % mesh.n_sweep:
            raise ValueError(
                f"Cohort of {len(cohort.cfgs)} SAEs is not divisible by sweep_parallel={mesh.n_sweep}."
            )
        c0 = cohort.cfgs[0]
        _check_feature_parallel(c0.sae, mesh.n_feature)
        whole = make_saes(cohort.cfgs, limited, seed=cfg.seed + ci, device=device)
        # The latent axes, from the whole cohort's shapes (the optimizer's on the meta device).
        meta = {k: torch.empty(v.shape, device="meta") for k, v in whole[0].items()}
        axes = parallel.latent_axes(SweepState(*whole, _opt_init(c0.optim, meta), None), c0.sae.d_sae)
        params, sae_state, obj_state = parallel.shard_features(mesh, whole, c0.sae.d_sae)
        del whole
        ts = SweepState(
            params=params,
            sae_state=sae_state,
            obj_state=obj_state,
            opt_state=_opt_init(c0.optim, params),
            step=torch.zeros((), dtype=torch.int32, device=device),
        )
        runtimes.append(
            _CohortRuntime(
                cohort=cohort,
                ts=ts,
                axes=axes,
                router=make_step_router(
                    c0.sae, c0.objective, n_steps, bsz, c0.optim, c0.matmul_precision, mesh=mesh
                ),
                metrics_fn=make_metrics_fn(c0.sae, mesh),
                hp={k: torch.from_numpy(v).to(device)
                    for k, v in parallel.shard_sweep(mesh, _hp_arrays(cohort.cfgs)).items()},
                prefix_rng=np.random.default_rng(cfg.seed + 1000 + ci),
                mesh=mesh,
            )
        )

    group_key = _group_key(cfg)
    start_step = 0
    if cfg.resume:
        # The latest step SHARED by every cohort: per-cohort saves are
        # sequential, so a crash can land between them.
        step_sets = [
            set(checkpoints.available_steps(cfg.runs_root, f"{group_key}_c{ci}"))
            for ci in range(len(runtimes))
        ]
        common = set.intersection(*step_sets) if step_sets else set()
        # Every process resumes from rank 0's choice.
        latest = int(parallel.broadcast_from_primary(np.asarray(max(common) if common else -1)))
        if latest >= 0:
            for ci, rt in enumerate(runtimes):
                restored = checkpoints.restore(cfg.runs_root, f"{group_key}_c{ci}", latest, rt.ts, mesh=mesh,
                                               d_sae=rt.cohort.cfgs[0].sae.d_sae)
                runtimes[ci] = rt._replace(ts=restored)
            start_step = latest
            logger.info("Resuming training from step %d.", start_step)
        else:
            logger.info("No saved train state found; starting fresh.")

    mode = "online" if cfg.track else "disabled"
    metadata_dict = dataclasses.asdict(metadata)
    wandb_configs = []
    for c in cfgs:
        cfg_dict = dataclasses.asdict(c)
        cfg_dict["train_data"]["metadata"] = metadata_dict
        wandb_configs.append(cfg_dict)
    run = (
        ParallelWandbRun(cfg.wandb_project, wandb_configs, mode, list(cfg.tags))
        if parallel.is_primary()
        else NullParallelRun()
    )
    slurm_job_id = os.environ.get("SLURM_JOB_ID")
    if slurm_job_id:
        run.set_summary("slurm_job_id", slurm_job_id)

    dl_monitor = DataloaderMonitor(dataloader)
    profile = _Profile(cfg.profile_dir)
    global_step, n_patches_seen = start_step, start_step * bsz

    batches = helpers.progress(limited, every=cfg.log_every, desc="train")
    if start_step:
        # The stream restarts reshuffled on resume; only consume the remaining
        # step budget.
        batches = itertools.islice(iter(batches), max(n_steps - start_step, 0))

    # Batches i+1 and i+2 are fetched by a thread, and copied to the device, while step i runs.
    for x, batch in parallel.prefetch_to_device(batches, device, depth=2):
        x = parallel.shard_batch(mesh, x)
        n_patches_seen += x.shape[0] * mesh.n_data
        log_now = (global_step + 1) % cfg.log_every == 0
        all_metrics: list[dict[str, object]] = [None] * len(cfgs)

        for ri, rt in enumerate(runtimes):
            prefixes = _sample_prefixes(rt, device)
            new_ts, stats = rt.router.step_fn_at(global_step)(rt.ts, x, prefixes, rt.hp)
            rt.router.record_stats(global_step, stats)

            if log_now:
                heavy = rt.metrics_fn(new_ts, x, prefixes)
                stats_np = parallel.to_host(mesh, stats)
                heavy_np = parallel.to_host(mesh, heavy)
                dl_metrics = dl_monitor.compute()
                dl_metrics.update(
                    statistics.calc_batch_entropy(
                        batch["example_idx"],
                        batch["token_idx"],
                        metadata.n_examples,
                        metadata.content_tokens_per_example,
                    )
                )
                for si, gi in enumerate(rt.cohort.indices):
                    all_metrics[gi] = {
                        "loss/loss": float(stats_np["loss"][si]),
                        "loss/mse": float(stats_np["mse"][si]),
                        "loss/l0": float(stats_np["l0"][si]),
                        "loss/l1": float(stats_np["l1"][si]),
                        "loss/sparsity": float(stats_np["sparsity"][si]),
                        "loss/aux": float(stats_np["aux"][si]),
                        "loss/n_dead": int(stats_np["n_dead"][si]),
                        "progress/n_patches_seen": n_patches_seen,
                        "progress/learning_rate": float(stats_np["lr"][si]),
                        "metrics/explained_variance": float(heavy_np["explained_variance"][si]),
                        "metrics/dead_unit_pct": float(heavy_np["dead_unit_pct"][si]),
                        "metrics/dictionary_coherence": float(heavy_np["dictionary_coherence"][si]),
                        "metrics/avg_decoder_row_norm": float(heavy_np["avg_decoder_row_norm"][si]),
                        "metrics/grad_norm": float(stats_np["grad_norm"][si]),
                        "metrics/sse_sae": float(heavy_np["sse_sae"][si]),
                        "metrics/sse_baseline": float(heavy_np["sse_baseline"][si]),
                        "metrics/normalized_mse": float(heavy_np["normalized_mse"][si]),
                        **dl_metrics,
                    }

            runtimes[ri] = rt._replace(ts=new_ts)

        if log_now:
            run.log(all_metrics, step=global_step)
            m0 = all_metrics[0]
            logger.info(", ".join(f"{k.split('/')[-1]}: {v:.5f}" for k, v in m0.items() if k.startswith("loss/")))

        global_step += 1
        profile.after_step(global_step)

        if cfg.ckpt_every and global_step % cfg.ckpt_every == 0:
            # Prune only once EVERY cohort saved this step: a crash between
            # the sequential saves must leave a previous step restorable for
            # all cohorts.
            for ci, rt in enumerate(runtimes):
                checkpoints.save(
                    cfg.runs_root, f"{group_key}_c{ci}", global_step, _cohort_for_primary(mesh, rt.ts, rt.axes),
                    prune=False,
                )
            for ci in range(len(runtimes)):
                checkpoints.prune_below(cfg.runs_root, f"{group_key}_c{ci}", global_step)

    return runtimes, run, global_step


# ---------------------------------------------------------------------------
# Evaluation (saev_tpu/framework/train.py:1292-1473)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EvalMetrics:
    """Results of evaluating a trained SAE on a dataset (reference train.py:467-507)."""

    l0: float
    l1: float
    mse: float
    normalized_mse: float
    sse_sae: float
    sse_baseline: float
    n_dead: int
    n_almost_dead: int
    n_dense: int
    freqs: np.ndarray
    mean_values: np.ndarray
    almost_dead_threshold: float
    dense_threshold: float

    def for_wandb(self) -> dict[str, object]:
        dct = dataclasses.asdict(self)
        dct["freqs"] = dct["freqs"].tolist()
        dct["mean_values"] = dct["mean_values"].tolist()
        return {f"eval/{key}": value for key, value in dct.items()}


@torch.no_grad()
def _eval_one(c0: Config, params, sae_state, obj_state, x, prefixes, feature=None) -> dict[str, torch.Tensor]:
    """One SAE's eval forward on one batch, at "highest" (its latents of the
    SAE with a `feature` group: the firing stats are its latents')."""
    loss, out, _, _ = objectives.matryoshka_loss(
        c0.objective, c0.sae, params, sae_state, obj_state, x, prefixes, training=False, feature=feature
    )
    residual = x - out.x_hats[:, -1, :]
    return {
        "l0": loss.l0,
        "l1": loss.l1,
        "mse": loss.mse,
        "sse": torch.sum(residual**2),
        "n_fired": torch.sum(out.f_x > 0, dim=0).to(torch.float32),
        "values": torch.sum(out.f_x, dim=0),
    }


def evaluate(cfgs: list[Config], runtimes: list[_CohortRuntime]) -> list[EvalMetrics]:
    """Eval pass over the val loader: L0/L1/MSE, normalized MSE vs mean baseline,
    per-feature firing stats, dead/almost-dead/dense counts. Host sums in
    float64, as in the JAX package.

    Multi-process: each process reads its partition of the val shards, as in
    training; each rank sums its own SAEs' outputs on its data index's rows
    and the x statistics of its own rows, and the sums cross processes once
    at the end (`parallel.global_sum`): each rank's firing stats at its
    latents, the loss terms (the whole dictionary's on every member of a
    feature group) from feature index 0 alone."""
    if len(split_cfgs(cfgs)) != 1:
        raise ValueError(f"Configs are not parallelizeable: {cfgs}.")

    cfg = cfgs[0]
    device = torch.device(cfg.device)
    almost_dead_lim, dense_lim = 1e-7, 1e-2
    mesh = runtimes[0].mesh
    _check_full_mesh(mesh, cfg.val_data.batch_size)
    world = parallel.process_count()

    dataloader = ShuffledDataLoader(_partitioned_data_cfg(cfg.val_data, "val"))
    # Shard partitions can be uneven; every process runs the same number of
    # (collective-bearing) eval batches.
    n_val = int(parallel.global_min(min(dataloader.n_samples, cfg.n_val // world)))
    limited = scheduling.BatchLimiter(dataloader, n_val)

    n_cfgs = len(cfgs)
    d_sae = cfgs[0].sae.d_sae
    n_fired = np.zeros((n_cfgs, d_sae), dtype=np.float64)
    values = np.zeros((n_cfgs, d_sae), dtype=np.float64)
    total_l0 = np.zeros(n_cfgs, dtype=np.float64)
    total_l1 = np.zeros(n_cfgs, dtype=np.float64)
    total_mse = np.zeros(n_cfgs, dtype=np.float64)
    total_sse = np.zeros(n_cfgs, dtype=np.float64)
    sum_sq, n_tokens = 0.0, 0
    sum_vec = np.zeros(cfgs[0].sae.d_model, dtype=np.float64)

    batches = helpers.progress(limited, desc="eval", every=cfg.log_every)
    for x, batch in parallel.prefetch_to_device(batches, device, depth=2):
        x64 = np.asarray(batch["act"]).astype(np.float64)
        sum_sq += float(np.sum(x64 * x64))
        sum_vec += x64.sum(axis=0)
        n_tokens += x64.shape[0]
        x = parallel.shard_batch(mesh, x)
        bsz = x.shape[0]

        for rt in runtimes:
            c0 = rt.cohort.cfgs[0]
            prefixes = _sample_prefixes(rt, device)
            n_local = prefixes.shape[0]
            # The sweep is looped: one SAE's forward at a time.
            for si in range(n_local):
                gi = rt.cohort.indices[mesh.s * n_local + si]
                out = _eval_one(
                    c0, _index(rt.ts.params, si), _index(rt.ts.sae_state, si),
                    _index(rt.ts.obj_state, si), x, prefixes[si], mesh.feature,
                )
                out = {k: v.cpu().numpy() for k, v in out.items()}
                if mesh.f == 0:
                    total_l0[gi] += float(out["l0"]) * bsz
                    total_l1[gi] += float(out["l1"]) * bsz
                    total_mse[gi] += float(out["mse"]) * bsz
                    total_sse[gi] += float(out["sse"])
                mine = slice(mesh.f * len(out["n_fired"]), (mesh.f + 1) * len(out["n_fired"]))
                n_fired[gi, mine] += out["n_fired"]
                values[gi, mine] += out["values"]

    if world > 1:
        n_tokens = int(parallel.global_sum(np.asarray(n_tokens, np.int64)))
        sum_sq = float(parallel.global_sum(np.asarray(sum_sq)))
        sum_vec, n_fired, values = (parallel.global_sum(a) for a in (sum_vec, n_fired, values))
        total_l0, total_l1, total_mse, total_sse = (
            parallel.global_sum(a) for a in (total_l0, total_l1, total_mse, total_sse)
        )
    assert n_tokens > 0, "Validation dataloader yielded zero tokens."
    sse_baseline = sum_sq - float(sum_vec @ sum_vec) / n_tokens
    assert sse_baseline > 0, (
        f"Validation baseline variance non-positive: sse_baseline={sse_baseline:.6e}"
    )

    with np.errstate(divide="ignore", invalid="ignore"):
        mean_values = values / n_fired
    freqs = n_fired / n_tokens

    return [
        EvalMetrics(
            l0=float(total_l0[i] / n_tokens),
            l1=float(total_l1[i] / n_tokens),
            mse=float(total_mse[i] / n_tokens),
            normalized_mse=float(total_sse[i] / sse_baseline),
            sse_sae=float(total_sse[i]),
            sse_baseline=sse_baseline,
            n_dead=int((freqs[i] == 0).sum()),
            n_almost_dead=int((freqs[i] < almost_dead_lim).sum()),
            n_dense=int((freqs[i] > dense_lim).sum()),
            freqs=freqs[i],
            mean_values=mean_values[i],
            almost_dead_threshold=almost_dead_lim,
            dense_threshold=dense_lim,
        )
        for i in range(n_cfgs)
    ]


# ---------------------------------------------------------------------------
# Worker + parallel grouping + main (saev_tpu/framework/train.py:1476-1653)
# ---------------------------------------------------------------------------


def worker_fn(cfgs: list[Config]) -> list[str]:
    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s",
    )
    runtimes, run, steps = train(cfgs)
    eval_metrics = evaluate(cfgs, runtimes)
    run.log([m.for_wandb() for m in eval_metrics], step=steps)
    ids = run.finish()

    # Unstack the trained sweep back into per-config checkpoints, written on
    # rank 0 only (run.finish gives no ids elsewhere).
    flat: dict[int, tuple[Config, modeling.Params, modeling.State]] = {}
    for rt in runtimes:
        params_np = _cohort_for_primary(rt.mesh, rt.ts.params, rt.axes.params)
        state_np = _cohort_for_primary(rt.mesh, rt.ts.sae_state, rt.axes.sae_state)
        if params_np is None:
            continue
        for si, gi in enumerate(rt.cohort.indices):
            flat[gi] = (rt.cohort.cfgs[si], _index(params_np, si), _index(state_np, si))

    for gi, id in enumerate(ids):
        cfg, params, state = flat[gi]
        metric = eval_metrics[gi]
        logger.info(
            "Checkpoint %s: %d dense, %d dead, %d almost-dead features.",
            id, metric.n_dense, metric.n_dead, metric.n_almost_dead,
        )
        run_dir = disk.Run.new(
            id,
            train_shards_dir=cfg.train_data.shards,
            val_shards_dir=cfg.val_data.shards,
            runs_root=cfg.runs_root,
        )
        serialize.dump(run_dir.ckpt, cfg.sae, params, state)
        logger.info("Dumped checkpoint to '%s'.", run_dir.ckpt)
        with open(run_dir.run_dir / "checkpoint" / "config.json", "wb") as fd:
            helpers.jdump(cfg, fd, indent=2)

    parallel.sync()
    return ids


CANNOT_PARALLELIZE = set([
    "sweep_parallel",
    "feature_parallel",
    "train_data",
    "val_data",
    "n_train",
    "n_val",
    "track",
    "wandb_project",
    "tags",
    "log_every",
    "runs_root",
    "device",
    "slurm_acct",
    "slurm_partition",
    "n_hours",
    "log_to",
    "sae.d_sae",
    "sae.d_model",
    "sae.reinit_blend",
    "sae.reinit_enc_dec_tranpose",
])


def _parallel_key(cfg: Config) -> tuple:
    """Grouping key ignoring dataloader seeds but respecting all other
    non-parallelizable fields (reference train.py:649-666)."""
    d = dataclasses.asdict(cfg)
    for field in ("train_data", "val_data"):
        sub = dict(d[field])
        sub["seed"] = "IGNORED_FOR_PARALLEL"
        d[field] = sub
    return tuple(
        (key, helpers.make_hashable(helpers.get(d, key)))
        for key in sorted(CANNOT_PARALLELIZE)
    )


def split_cfgs(cfgs: list[Config]) -> list[list[Config]]:
    """Split configs into groups that can train on one shared data stream
    (reference train.py:670-695)."""
    groups = collections.defaultdict(list)
    for cfg in cfgs:
        groups[_parallel_key(cfg)].append(cfg)
    return [
        [
            dataclasses.replace(
                cfg,
                train_data=dataclasses.replace(cfg.train_data, seed=cfg.seed),
                val_data=dataclasses.replace(cfg.val_data, seed=cfg.seed),
            )
            for cfg in group
        ]
        for _, group in sorted(groups.items())
    ]


def _split_by_cap(group: list[Config], cap: int) -> list[list[Config]]:
    assert cap > 0, "max_parallel must be > 0"
    return [group[start:end] for start, end in helpers.batched_idx(len(group), cap)]


def main(
    cfg: Config,
    sweep: pathlib.Path | None = None,
    max_parallel: int | None = None,
):
    """Train SAEs, optionally as a parallel grid search (reference train.py:706-797).

    Jobs run inline by default; with slurm_acct set and submitit available, they
    are submitted as Slurm batch jobs. Under torchrun (WORLD_SIZE above 1)
    every process joins the job's process group first (NCCL on "cuda", gloo
    on "cpu"; one card a process) and runs the same jobs.
    """
    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s",
    )
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and not torch.distributed.is_initialized():
        parallel.init_distributed(cfg.device)

    if sweep is not None:
        sweep_dcts = configs.load_sweep(sweep)
        if not sweep_dcts:
            logger.error("No valid sweeps found in '%s'.", sweep)
            raise SystemExit(1)
        cfgs, errs = configs.load_cfgs(cfg, default=Config(), sweep_dcts=sweep_dcts)
        if errs:
            for err in errs:
                logger.warning("Error in config: %s", err)
            return []
    else:
        cfgs = [cfg]

    groups = split_cfgs(cfgs)
    if max_parallel:
        groups = [sub for group in groups for sub in _split_by_cap(group, max_parallel)]

    logger.info("Running %d training jobs.", len(groups))
    cfg = groups[0][0]

    if cfg.slurm_acct:
        try:
            import submitit
        except ImportError as err:
            raise RuntimeError(
                "slurm_acct set but submitit is not installed; run without Slurm."
            ) from err
        executor = submitit.SlurmExecutor(folder=cfg.log_to)
        executor.update_parameters(
            job_name="sae-train",
            time=int(cfg.n_hours * 60),
            partition=cfg.slurm_partition,
            ntasks_per_node=1,
            mem=f"{cfg.mem_gb}GB",
            stderr_to_stdout=True,
            account=cfg.slurm_acct,
        )
        with executor.batch():
            jobs = [executor.submit(worker_fn, group) for group in groups]
        time.sleep(5.0)
        ids = []
        for j, job in enumerate(jobs):
            try:
                ids.extend(job.result())
                logger.info("Job %d/%d finished.", j + 1, len(jobs))
            except Exception:
                logger.warning("Job %s (%d) did not finish.", job.job_id, j)
        return ids

    ids = []
    for group in groups:
        ids.extend(worker_fn(group))
    logger.info("Jobs done.")
    return ids


if __name__ == "__main__":
    import sys

    from saev_tpu_torch.framework import train as _train
    from saev_tpu_torch.utils import cli

    cli.run({"train": _train.main}, ["train", *sys.argv[1:]])
