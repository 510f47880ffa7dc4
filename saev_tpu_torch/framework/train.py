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
The sweep is looped in Python. `sweep_parallel`, `feature_parallel` and more
than one process raise NotImplementedError: multi-GPU is not ported yet.
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
from ..utils.wandb import ParallelWandbRun
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


def _newton_schulz(g: torch.Tensor, steps: int = 5, eps: float = 1e-7) -> torch.Tensor:
    """Orthogonalize the last two axes by the quintic Newton-Schulz
    iteration (saev_tpu/framework/train.py:358-370; torch.optim.Muon's
    _zeropower_via_newtonschulz), on stacked (n_sae, a, b) tensors, each
    SAE's matrix scaled by its own Frobenius norm. The iteration runs in
    float32 with TF32 off, as the JAX package keeps it (torch.optim.Muon
    runs it in bf16): batched products, one per term and iteration."""
    a, b, c = 3.4445, -4.7750, 2.0315
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


def _muon_update(params, grads, opt_state, lr_per_sae, *, beta=0.95, weight_decay=0.1):
    """torch.optim.Muon's update on the stacked 2-D leaves (3-D here), Adam
    on the rest (saev_tpu/framework/train.py:380-409): EMA momentum (mu =
    beta mu + (1 - beta) g), the Nesterov blend (1 - beta) g + beta mu,
    Newton-Schulz, lr scaled by sqrt(max(1, rows / cols)), and decoupled
    weight decay on `params` at the unscaled lr. The Adam state advances for
    every leaf, as the JAX package's does."""
    mu = {k: beta * opt_state["mu"][k] + (1.0 - beta) * g for k, g in grads.items()}
    adam_updates, adam_state = _adam_update(grads, opt_state["adam"], lr_per_sae)
    updates = {}
    for k, g in grads.items():
        if mu[k].ndim < 3:
            updates[k] = adam_updates[k]
            continue
        ortho = _newton_schulz((1.0 - beta) * g + beta * mu[k])
        # An f32 square root, as jnp.sqrt takes the ratio.
        scale = float(np.sqrt(np.float32(max(1.0, mu[k].shape[-2] / mu[k].shape[-1]))))
        lr = lr_per_sae.reshape((-1,) + (1,) * (mu[k].ndim - 1))
        updates[k] = -lr * weight_decay * params[k] - lr * scale * ortho
    return updates, {"mu": mu, "adam": adam_state, "count": opt_state["count"] + 1}


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
                (AuxK.alpha when absent) and "momentum" (BatchTopK's
                momentum when absent); others are ignored
      stats:    per-SAE loss terms, grad_norm, lr and aux_risk, (n_sae,)

    `aux_enabled=False` is the warm-up step: AuxK is left out, which is exact
    while no latent can be dead yet (the first dead_threshold_tokens).
    `aux_subspace_cap` computes AuxK in the dead-subspace form, exact iff
    n_dead <= cap at the step; `StepRouter` picks the variant that is.
    """
    if optim not in ("adam", "muon"):
        raise ValueError(f"Unknown optimizer: {optim}")
    if matmul_precision not in modeling.PRECISIONS:
        raise ValueError(f"Unknown matmul precision: {matmul_precision}")

    # Static gate: None computes AuxK, False leaves it out (warm-up).
    any_dead = None if aux_enabled else False

    def grad_one(params_i, sae_state_i, obj_state_i, x, prefixes_i, coeff, alpha, momentum):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params_i.items()}
        loss, _, sae_state_i, obj_state_i = objectives.matryoshka_loss(
            obj_cfg, sae_cfg, leaves, sae_state_i, obj_state_i, x, prefixes_i,
            training=True, hp={"sparsity_coeff": coeff, "aux_alpha": alpha, "momentum": momentum},
            precision=matmul_precision, any_dead=any_dead, aux_subspace_cap=aux_subspace_cap,
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
        losses, grads, sae_states, obj_states = [], [], [], []
        for i in range(n_sae):
            loss_i, grads_i, sae_i, obj_i = grad_one(
                _index(params, i), _index(ts.sae_state, i), _index(ts.obj_state, i), x,
                prefixes[i], hp["sparsity_coeff"][i], None if alphas is None else alphas[i],
                None if momenta is None else momenta[i],
            )
            losses.append(loss_i)
            grads.append(grads_i)
            sae_states.append(sae_i)
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
        if optim == "adam":
            updates, opt_state = _adam_update(grads, ts.opt_state, lr)
        else:
            updates, opt_state = _muon_update(params, grads, ts.opt_state, lr)
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
    and `decode` take no precision there). Its forward is in training mode,
    as the JAX package's: a TopK threshold is kernel K6 on the card, a
    BatchTopK SAE's the batch-global k-th value (its moved threshold is
    not kept).

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
    """Shard the sweep over this many devices. Not ported yet: above 1 raises."""
    sweep_vmap_width: int = 1
    """SAEs per vmap chunk in the JAX package's step; here the sweep is looped
    in Python one SAE at a time, and the field only splits cohorts as there."""
    feature_parallel: int = 1
    """Shard d_sae over this many devices. Not ported yet: above 1 raises."""
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

    params = {k: torch.from_numpy(np.stack([p[k] for p in params_list])).to(device) for k in params_list[0]}
    sae_state = _stack([modeling.init_state(c.sae, device) for c in cfgs])
    obj_state = _stack([objectives.init_state(c.sae, device) for c in cfgs])
    return params, sae_state, obj_state


# ---------------------------------------------------------------------------
# The train loop (saev_tpu/framework/train.py:964-1289)
# ---------------------------------------------------------------------------


class _CohortRuntime(tp.NamedTuple):
    cohort: Cohort
    ts: SweepState
    # The cohort's step variants (warm, dense, subspace rungs) and the
    # routing state that picks one a step.
    router: StepRouter
    metrics_fn: tp.Any
    hp: dict[str, torch.Tensor]
    prefix_rng: np.random.Generator


def _check_single_process(cfg: Config) -> None:
    """Multi-GPU training (ROADMAP item 9) is not ported yet."""
    for name in ("sweep_parallel", "feature_parallel"):
        if getattr(cfg, name) != 1:
            raise NotImplementedError(
                f"{name}={getattr(cfg, name)}: multi-GPU training is not ported yet (ROADMAP §1 item 9)"
            )
    for name in ("train_data", "val_data"):
        if getattr(cfg, name).world != 1:
            raise NotImplementedError(
                f"{name}.world={getattr(cfg, name).world}: training over more than one process is not "
                "ported yet (ROADMAP §1 item 9)"
            )


def _group_key(cfg: Config) -> str:
    """A stable key of the training group (sha256; Python's hash() is
    randomized per process)."""
    return hashlib.sha256(repr(_parallel_key(cfg)).encode()).hexdigest()[:16]


def _to_host(tree) -> tp.Any:
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


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
    _check_single_process(cfg)
    device = torch.device(cfg.device)

    dataloader = ShuffledDataLoader(cfg.train_data)
    metadata = dataloader.metadata
    if metadata.d_model != cfg.sae.d_model:
        raise guards.GuardError(
            f"sae.d_model={cfg.sae.d_model} does not match the shards' "
            f"d_model={metadata.d_model} ({cfg.train_data.shards}); the SAE "
            "must be configured for the model family the shards were "
            "extracted from."
        )
    limited = scheduling.BatchLimiter(dataloader, cfg.n_train)
    n_steps = len(limited)
    bsz = cfg.train_data.batch_size

    runtimes: list[_CohortRuntime] = []
    for ci, cohort in enumerate(make_cohorts(cfgs)):
        params, sae_state, obj_state = make_saes(cohort.cfgs, limited, seed=cfg.seed + ci, device=device)
        c0 = cohort.cfgs[0]
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
                router=make_step_router(
                    c0.sae, c0.objective, n_steps, bsz, c0.optim, c0.matmul_precision
                ),
                metrics_fn=make_metrics_fn(c0.sae),
                hp={k: torch.from_numpy(v).to(device) for k, v in _hp_arrays(cohort.cfgs).items()},
                prefix_rng=np.random.default_rng(cfg.seed + 1000 + ci),
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
        latest = max(common) if common else None
        if latest is not None:
            for ci, rt in enumerate(runtimes):
                restored = checkpoints.restore(cfg.runs_root, f"{group_key}_c{ci}", latest, rt.ts)
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
    run = ParallelWandbRun(cfg.wandb_project, wandb_configs, mode, list(cfg.tags))
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
        n_patches_seen += x.shape[0]
        log_now = (global_step + 1) % cfg.log_every == 0
        all_metrics: list[dict[str, object]] = [None] * len(cfgs)

        for ri, rt in enumerate(runtimes):
            n_sae = len(rt.cohort.cfgs)
            n_prefixes = rt.cohort.cfgs[0].objective.n_prefixes
            d_sae = rt.cohort.cfgs[0].sae.d_sae
            prefixes = torch.from_numpy(np.stack([
                objectives.sample_prefixes(d_sae, n_prefixes, rng=rt.prefix_rng)
                for _ in range(n_sae)
            ])).to(device)
            new_ts, stats = rt.router.step_fn_at(global_step)(rt.ts, x, prefixes, rt.hp)
            rt.router.record_stats(global_step, stats)

            if log_now:
                heavy = rt.metrics_fn(new_ts, x, prefixes)
                stats_np = _to_host(stats)
                heavy_np = _to_host(heavy)
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
                checkpoints.save(cfg.runs_root, f"{group_key}_c{ci}", global_step, rt.ts, prune=False)
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
def _eval_one(c0: Config, params, sae_state, obj_state, x, prefixes) -> dict[str, torch.Tensor]:
    """One SAE's eval forward on one batch, at "highest"."""
    loss, out, _, _ = objectives.matryoshka_loss(
        c0.objective, c0.sae, params, sae_state, obj_state, x, prefixes, training=False
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
    float64, as in the JAX package."""
    if len(split_cfgs(cfgs)) != 1:
        raise ValueError(f"Configs are not parallelizeable: {cfgs}.")

    cfg = cfgs[0]
    _check_single_process(cfg)
    device = torch.device(cfg.device)
    almost_dead_lim, dense_lim = 1e-7, 1e-2

    dataloader = ShuffledDataLoader(cfg.val_data)
    n_val = min(dataloader.n_samples, cfg.n_val)
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
        bsz = x.shape[0]
        sum_sq += float(np.sum(x64 * x64))
        sum_vec += x64.sum(axis=0)
        n_tokens += bsz

        for rt in runtimes:
            c0 = rt.cohort.cfgs[0]
            n_sae = len(rt.cohort.cfgs)
            prefixes = torch.from_numpy(np.stack([
                objectives.sample_prefixes(d_sae, c0.objective.n_prefixes, rng=rt.prefix_rng)
                for _ in range(n_sae)
            ])).to(device)
            # The sweep is looped: one SAE's forward at a time.
            for si, gi in enumerate(rt.cohort.indices):
                out = _to_host(_eval_one(
                    c0, _index(rt.ts.params, si), _index(rt.ts.sae_state, si),
                    _index(rt.ts.obj_state, si), x, prefixes[si],
                ))
                total_l0[gi] += float(out["l0"]) * bsz
                total_l1[gi] += float(out["l1"]) * bsz
                total_mse[gi] += float(out["mse"]) * bsz
                total_sse[gi] += float(out["sse"])
                n_fired[gi] += out["n_fired"]
                values[gi] += out["values"]

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

    # Unstack the trained sweep back into per-config checkpoints.
    flat: dict[int, tuple[Config, modeling.Params, modeling.State]] = {}
    for rt in runtimes:
        for si, gi in enumerate(rt.cohort.indices):
            flat[gi] = (rt.cohort.cfgs[si], _index(rt.ts.params, si), _index(rt.ts.sae_state, si))

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
    are submitted as Slurm batch jobs.
    """
    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s",
    )

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
