"""The SAE train step on PyTorch tensors (counterpart of
saev_tpu/framework/train.py `make_train_step`).

A sweep of SAEs trains on one shared batch. Its state is stacked along a
leading n_sae axis, with the JAX package's layout and key names (`SweepState`),
so a JAX sweep state carries over with `sweep_state_from_numpy`. The step
loops over the sweep's SAEs in Python: each SAE's forward and backward runs
on its own and only its gradients are kept, then the decoder-norm constraints,
the per-SAE gradient clip, the warmup-cosine learning rate and Adam are
applied to the stacked state.

Ported, with Adam at `matmul_precision="default"` (bf16 operands with f32
accumulation on the card, f32 on the CPU: nn/modeling.py): the step in its three
forms (warm-up without AuxK, AuxK dense, AuxK in a dead subspace), the
router that picks one for each step of the loop (`StepRouter`,
`make_step_router`), and the log-step metrics (`make_metrics_fn`). Muon and
the other precisions raise NotImplementedError.
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
    generator: torch.Generator | None = None, device="cuda",
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
    aux_enabled: bool = True,
    aux_subspace_cap: int | None = None,
):
    """Build the train step for one cohort.

    Signature: step(sweep_state, x, prefixes, hp) -> (sweep_state, stats)
      x:        (batch, d_model) f32 on the device of the state
      prefixes: (n_sae, n_prefixes) int32, sampled host-side per step
      hp:       per-SAE (n_sae,) f32 tensors "lr", "n_lr_warmup",
                "grad_clip", "sparsity_coeff" and, optionally, "aux_alpha"
                (AuxK.alpha when absent); others are ignored
      stats:    per-SAE loss terms, grad_norm, lr and aux_risk, (n_sae,)

    `aux_enabled=False` is the warm-up step: AuxK is left out, which is exact
    while no latent can be dead yet (the first dead_threshold_tokens).
    `aux_subspace_cap` computes AuxK in the dead-subspace form, exact iff
    n_dead <= cap at the step; `StepRouter` picks the variant that is.
    """
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

    # Static gate: None computes AuxK, False leaves it out (warm-up).
    any_dead = None if aux_enabled else False

    def grad_one(params_i, sae_state_i, obj_state_i, x, prefixes_i, coeff, alpha):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params_i.items()}
        loss, _, obj_state_i = objectives.matryoshka_loss(
            obj_cfg, sae_cfg, leaves, sae_state_i, obj_state_i, x, prefixes_i,
            training=True, hp={"sparsity_coeff": coeff, "aux_alpha": alpha},
            precision=matmul_precision, any_dead=any_dead, aux_subspace_cap=aux_subspace_cap,
        )
        keys = sorted(leaves)
        grads = torch.autograd.grad(loss.loss, [leaves[k] for k in keys])
        detached = objectives.MatryoshkaLoss(*(t.detach() for t in loss))
        return detached, dict(zip(keys, grads)), obj_state_i

    def step(ts: SweepState, x: torch.Tensor, prefixes: torch.Tensor, hp: dict):
        # Normalize W_dec rows before the forward.
        params = modeling.normalize_w_dec(sae_cfg, ts.params)
        n_sae = params["W_dec"].shape[0]
        alphas = hp.get("aux_alpha")
        losses, grads, obj_states = [], [], []
        for i in range(n_sae):
            loss_i, grads_i, obj_i = grad_one(
                _index(params, i), _index(ts.sae_state, i), _index(ts.obj_state, i), x,
                prefixes[i], hp["sparsity_coeff"][i], None if alphas is None else alphas[i],
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


# ---------------------------------------------------------------------------
# Log-step metrics
# ---------------------------------------------------------------------------


def dictionary_coherence(w: torch.Tensor, block: int = 1024) -> torch.Tensor:
    """max off-diagonal |<w_i/|w_i|, w_j/|w_j|>| over decoder rows, in row
    blocks so the (d_sae, d_sae) Gram matrix is never built."""
    d_sae = w.shape[0]
    wn = w / torch.linalg.norm(w, dim=1, keepdim=True)
    block = min(block, d_sae)
    ids = torch.arange(d_sae, device=w.device)
    coh = torch.zeros((), dtype=torch.float32, device=w.device)
    for start in range(0, d_sae, block):
        rows = wn[start : start + block]
        gram = torch.abs(rows @ wn.T)
        off_diag = ids[start : start + rows.shape[0], None] != ids[None, :]
        coh = torch.maximum(coh, torch.where(off_diag, gram, 0.0).max())
    return coh


def make_metrics_fn(sae_cfg: modeling.SparseAutoencoderConfig):
    """The heavy per-SAE metrics the loop computes every log_every steps:
    explained variance, dead %, coherence, SSE terms, from a fresh forward on
    the current params, at "highest" (as the JAX package's, whose `encode`
    and `decode` take no precision there). Its TopK threshold is kernel K6 on
    the card.

    Signature: metrics(sweep_state, x, prefixes) -> {name: (n_sae,) tensor}
    (`prefixes` is accepted for the JAX package's signature and not read).
    """

    def one(params, sae_state, x):
        enc, _ = modeling.encode(sae_cfg, params, sae_state, x, training=True)
        x_hat = modeling.decode(sae_cfg, params, enc.f_x)[:, -1, :]
        residual = x - x_hat
        return {
            "sse_sae": torch.sum(residual**2),
            "explained_variance": 1.0 - torch.var(residual, correction=0) / torch.var(x, correction=0),
            "dead_unit_pct": ((torch.abs(enc.f_x) > 1e-12).sum(dim=0) == 0).to(torch.float32).mean(),
            "dictionary_coherence": dictionary_coherence(params["W_dec"]),
            "avg_decoder_row_norm": torch.linalg.norm(params["W_dec"], dim=1).mean(),
        }

    @torch.no_grad()
    def metrics(ts: SweepState, x: torch.Tensor, prefixes: torch.Tensor):
        sum_vec = torch.sum(x, dim=0)
        sse_baseline = torch.sum(x * x) - torch.dot(sum_vec, sum_vec) / x.shape[0]
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
    """

    def __init__(self, step_fn, *, step_fn_warm=None, aux_from_step: int = 0, step_fn_subs=()):
        self.step_fn = step_fn
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
        risk, done = stats["aux_risk"].max(), None
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
) -> StepRouter:
    """The step variants of one cohort and their router, as the JAX train
    loop builds them (saev_tpu/framework/train.py:1057-1103).

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
        return make_train_step(sae_cfg, obj_cfg, n_steps, optim, matmul_precision, **kwargs)

    return StepRouter(
        make(),
        step_fn_warm=make(aux_enabled=False) if has_aux and aux_from_step > 0 else None,
        aux_from_step=aux_from_step,
        step_fn_subs=[(cap, make(aux_subspace_cap=cap)) for cap in caps],
    )
