"""Closed-loop training of a sweep of SAEs on one stream, as the port's
`framework.train.train` loop drives it: each cohort's `make_step_router`
variants, called back to back on a ring of batches made on the device, with
host-drawn Matryoshka prefixes, `record_stats`, and every `log_every` steps
`make_metrics_fn` and the copies of the stats to the host.

The traffic file gives the sweep (`top_ks` x `lrs`: one cohort a k), the
share of latents pinned dead and their bias, the step the loop starts at
(past `aux_from_step`, so the warm step is not in the window), the ring's
batches, and `fault` for the correctness tests.

Set-up builds each cohort's state from the seed, computes the first log
step's metrics on it, and drives it through its first three steps (the
router's dense, dense, then tight variant) on three distinct batches; the
readings of those steps are kept, and the same state goes on into the
window. After the window, with the program's state freed, the reference
follows the same three steps from the same inputs, and the checks compare
each step's loss and n_dead, the first gradient's norm by leaf (from Adam's
first moment), the change of the parameters by leaf after the three steps,
and the log step's metrics.
"""

import time

import numpy as np
import torch

from perfbench.lib import data, result, trace as tracing, work
from perfbench.reference import sae as ref

LEAVES = ref.LEAVES
B1 = 0.9  # Adam's first-moment decay, the port's and the reference's
N_CHECKED = 3  # steps the reference follows
METRICS_COMPARED = ("explained_variance", "dictionary_coherence", "avg_decoder_row_norm", "sse_sae",
                    "sse_baseline", "normalized_mse")


class _Cohort:
    def __init__(self, ci, k, lrs, cfg, tr, seed, device, n_steps):
        from saev_tpu_torch import parallel
        from saev_tpu_torch.framework import train
        from saev_tpu_torch.nn import modeling, objectives

        self.ci, self.k, self.lrs, self.n = ci, k, list(lrs), len(lrs)
        s, n = cfg["d_sae"], len(lrs)
        self.sae_cfg = modeling.SparseAutoencoderConfig(
            d_model=cfg["d_model"], d_sae=s,
            activation=modeling.TopK(top_k=k, aux=modeling.AuxK(k_aux=cfg["k_aux"], alpha=cfg["aux_alpha"])),
            reinit_blend=cfg["reinit_blend"], reinit_enc_dec_tranpose=cfg["reinit_enc_dec_tranpose"],
            remove_parallel_grads=cfg["remove_parallel_grads"], normalize_w_dec=cfg["normalize_w_dec"])
        obj_cfg = objectives.Matryoshka(n_prefixes=cfg["n_prefixes"],
                                        dead_threshold_tokens=cfg["dead_threshold_tokens"])
        self.mesh = parallel.make_mesh()
        self.router = train.make_step_router(self.sae_cfg, obj_cfg, n_steps, cfg["batch_size"], cfg["optim"],
                                             cfg["matmul_precision"], mesh=self.mesh)
        self.metrics_fn = train.make_metrics_fn(self.sae_cfg, self.mesh)
        ts = train.init_sweep_state(self.sae_cfg, n, data.generator(seed, device, 50 + ci), device, cfg["optim"])
        self.ts = ts._replace(
            params=init_params(cfg, tr, n, seed, ci, device),
            obj_state={"toks_since_active": data.dead_counters(s, n, tr["dead_share"], device)},
            step=torch.tensor(tr["start_step"], dtype=torch.int32, device=device))
        f32 = dict(dtype=torch.float32, device=device)
        self.hp = {"lr": torch.tensor(self.lrs, **f32), "n_lr_warmup": torch.full((n,), cfg["n_lr_warmup"], **f32),
                   "grad_clip": torch.full((n,), cfg["grad_clip"], **f32), "sparsity_coeff": torch.zeros(n, **f32),
                   "aux_alpha": torch.full((n,), cfg["aux_alpha"], **f32), "momentum": torch.zeros(n, **f32)}
        self.rng = data.numpy_rng(seed, 1000 + ci)

    def prefixes(self, cfg, device) -> torch.Tensor:
        """This step's cuts, drawn on the host as the train loop draws them."""
        cuts = np.stack([data.sample_prefixes(cfg["d_sae"], cfg["n_prefixes"], self.rng) for _ in range(self.n)])
        return torch.from_numpy(cuts).to(device)


def init_params(cfg, tr, n, seed, ci, device):
    return data.datapoint_init(cfg, n, seed + 101 * (ci + 1), device, tr["dead_share"], tr["dead_bias"])


def _norms(tree: dict, scale: float = 1.0) -> dict[str, list[float]]:
    return {leaf: [float(v) * scale for v in torch.linalg.norm(tree[leaf].flatten(1), dim=1)] for leaf in LEAVES}


def _change(new: dict, old: dict, normalize: bool) -> dict[str, list[float]]:
    new = dict(new)
    if normalize:
        new["W_dec"] = new["W_dec"] / torch.linalg.norm(new["W_dec"], dim=-1, keepdim=True)
    return _norms({leaf: new[leaf] - old[leaf] for leaf in LEAVES})


def run(cell, seed: int, seconds: float, trace: bool, device: str, t0: float) -> result.Run:
    from saev_tpu_torch import parallel

    cfg, tr = cell.config, cell.traffic
    b, s, d = cfg["batch_size"], cfg["d_sae"], cfg["d_model"]
    n_steps = cfg["n_train"] // b
    log_every = cfg["log_every"]
    out = result.Run(cell=cell)
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    ring = data.batches(cfg["assumed"]["activations"], d, b, tr["ring"], seed, dev)
    cohorts = [_Cohort(ci, k, tr["lrs"], cfg, tr, seed, dev, n_steps) for ci, k in enumerate(tr["top_ks"])]
    fault = tr.get("fault")
    half = slice(0, b // 2)
    host = tracing.Spans()

    def call(c, g, x, clock=None):
        """One cohort's step at global step g, as the train loop calls it."""
        with host.span("prefixes"):
            prefixes = c.prefixes(cfg, dev)
        fn = c.router.step_fn_at(g)
        t = time.perf_counter()
        xs = x[half] if fault == "half_batch" else x  # a planted fault: half the batch left out
        with host.span(f"cohort{c.ci}"):
            new_ts, stats = fn(c.ts, xs, prefixes, c.hp)
            if fault == "unchanged":  # a fault the correctness tests plant: the state comes back as it was
                new_ts = c.ts
            c.router.record_stats(g, stats)
        if clock is not None:
            clock["enqueue"] += time.perf_counter() - t
        return new_ts, stats, prefixes

    def log_step(c, new_ts, stats, x, prefixes, events=None):
        with host.span("metrics"):
            if events is not None:
                e0 = torch.cuda.Event(enable_timing=True)
                e0.record()
            heavy = c.metrics_fn(new_ts, x, prefixes)
            if events is not None:
                e1 = torch.cuda.Event(enable_timing=True)
                e1.record()
                events.append((e0, e1))
        with host.span("to_host"):
            return parallel.to_host(c.mesh, stats), parallel.to_host(c.mesh, heavy)

    def one_step(g, clock=None, events=None) -> bool:
        """Every cohort's step g on the ring's batch, and the log step's work
        where g is one; returns whether it was."""
        x = ring[(g - start) % len(ring)]
        log_now = (g + 1) % log_every == 0
        for c in cohorts:
            new_ts, stats, prefixes = call(c, g, x, clock)
            if log_now:
                log_step(c, new_ts, stats, x, prefixes, events)
            c.ts = new_ts
        return log_now

    def checked_steps() -> dict:
        """Set-up's readings: the first log step's metrics on the initial
        state, then three steps' loss terms, the first step's gradient norms
        (Adam's first moment over 1 - b1) and the three steps' change."""
        prog = {"metrics": [], "terms": [], "grad": [], "change": []}
        for c in cohorts:
            heavy = parallel.to_host(c.mesh, c.metrics_fn(c.ts, ring[0], c.prefixes(cfg, dev)))
            prog["metrics"].append({m: [float(v) for v in heavy[m]] for m in METRICS_COMPARED})
        params0 = [dict(c.ts.params) for c in cohorts]
        prog["terms"] = [[] for _ in cohorts]
        for t in range(N_CHECKED):
            for c in cohorts:
                new_ts, stats, _ = call(c, start + t, ring[t % len(ring)])
                got = parallel.to_host(c.mesh, stats)
                prog["terms"][c.ci].append({"loss": [float(v) for v in got["loss"]],
                                            "n_dead": [int(v) for v in got["n_dead"]]})
                if t == 0:
                    prog["grad"].append(_norms(new_ts.opt_state["m"], 1.0 / (1.0 - B1)))
                c.ts = new_ts
        for c, p0 in zip(cohorts, params0):
            prog["change"].append(_change(c.ts.params, p0, cfg["normalize_w_dec"]))
        return prog

    start = tr["start_step"]
    prog = checked_steps()

    # The window: every step back to back, a log step every log_every.
    g = start + N_CHECKED
    clock = {"enqueue": 0.0}
    events: list = []
    steps = logs = 0
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    out.end_to_end["setup_s"] = time.perf_counter() - t0
    w0 = time.perf_counter()
    while True:
        logs += one_step(g, clock if trace else None, events if trace and on_card else None)
        g += 1
        steps += 1
        if time.perf_counter() - w0 >= seconds:
            break
    if on_card:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - w0
    out.attempted = steps
    out.end_to_end["train_patches_per_s"] = steps * b / window_s
    if on_card:
        out.memory_peak_bytes = torch.cuda.max_memory_allocated()
    out.end_to_end["peak_mem_gib"] = out.memory_peak_bytes / 2**30
    n_dead = data.n_dead(s, tr["dead_share"])
    per_sae = [work.train_step_model_s(b, d, s, c.k, n_dead, cfg["k_aux"]) for c in cohorts
               for _ in range(c.n)]
    per_log = [work.log_step_model_s(b, d, s, c.k) for c in cohorts for _ in range(c.n)]
    out.counts.update(steps=steps, logs=logs, window_s=window_s, batch=b, d_sae=s, d_model=d,
                      k=min(c.k for c in cohorts), k_aux=cfg["k_aux"],
                      k_by_span={f"perfbench.cohort{c.ci}": c.k for c in cohorts})
    out.model_s.update(
        step_model=sum(m["model"] for m in per_sae), log_model=sum(m["model"] for m in per_log),
        step_matryoshka=sum(m["matryoshka"] for m in per_sae), step_select=sum(m["select"] for m in per_sae),
        log_select=sum(m["select"] for m in per_log))
    if trace:
        out.host_s["enqueue_per_step"] = clock["enqueue"] / steps
        if events:
            out.event_ms["metrics_call"] = sum(e0.elapsed_time(e1) for e0, e1 in events) / max(logs, 1)
        if on_card:
            def segment():
                # log_every steps in a row hold one log step.
                nonlocal g
                for _ in range(log_every):
                    one_step(g)
                    g += 1

            out.trace = tracing.profile(segment, host)
            out.counts.update(profiled_steps=log_every, profiled_logs=1)

    # The reference, after the window, with the program's state freed.
    del cohorts, ring
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    refr = reference_readings(cfg, tr, seed, dev)
    for name, value in compare(prog, refr).items():
        out.check(name, value)
    return out


def checked_cuts(cfg, tr, seed) -> list[list[np.ndarray]]:
    """Each cohort's prefix cuts of the checked steps, drawn from the seed as
    `run` draws them (the first draw is the set-up's log step's)."""
    out = []
    for ci in range(len(tr["top_ks"])):
        rng = data.numpy_rng(seed, 1000 + ci)
        draws = [np.stack([data.sample_prefixes(cfg["d_sae"], cfg["n_prefixes"], rng) for _ in tr["lrs"]])
                 for _ in range(1 + N_CHECKED)]
        out.append(draws[1:])
    return out


def reference_readings(cfg, tr, seed, dev, mode="f32", rows=None):
    """The reference's readings of every SAE of the sweep, from the inputs
    made again from the seed: the first log step's metrics on the initial
    state, each checked step's loss and n_dead, the first clipped gradient's
    norm by leaf, and the change of the parameters by leaf after the checked
    steps. `mode` is the products' precision (the control's is lower);
    `rows` keeps part of each batch (a fault's reading)."""
    b, s, d = cfg["batch_size"], cfg["d_sae"], cfg["d_model"]
    cuts_by_cohort = checked_cuts(cfg, tr, seed)
    ring = data.batches(cfg["assumed"]["activations"], d, b, tr["ring"], seed, dev)
    out = {"metrics": [], "terms": [], "grad": [], "change": []}
    for ci, k in enumerate(tr["top_ks"]):
        n = len(tr["lrs"])
        stacked = init_params(cfg, tr, n, seed, ci, dev)
        toks = data.dead_counters(s, n, tr["dead_share"], dev)
        metrics = {m: [] for m in METRICS_COMPARED}
        terms = [{"loss": [], "n_dead": []} for _ in range(N_CHECKED)]
        grad = {leaf: [] for leaf in LEAVES}
        change = {leaf: [] for leaf in LEAVES}
        for i, lr in enumerate(tr["lrs"]):
            p0 = {leaf: stacked[leaf][i] for leaf in LEAVES}
            m = ref.log_metrics(cfg, p0, ring[0], k, mode)
            for key in METRICS_COMPARED:
                metrics[key].append(m[key])
            sae = {"params": p0, "toks": toks[i], "count": 0, "hp": {"lr": lr, "top_k": k},
                   "m": {leaf: torch.zeros_like(v) for leaf, v in p0.items()},
                   "v": {leaf: torch.zeros_like(v) for leaf, v in p0.items()}}
            for t in range(N_CHECKED):
                cuts = [int(p) for p in cuts_by_cohort[ci][t][i]]
                sae, st, grads = ref.train_step({**cfg, "n_steps": cfg["n_train"] // b}, sae,
                                                ring[t % len(ring)], cuts, tr["start_step"] + t, mode, rows)
                terms[t]["loss"].append(st["loss"])
                terms[t]["n_dead"].append(st["n_dead"])
                if t == 0:
                    for leaf in LEAVES:
                        grad[leaf].append(float(torch.linalg.norm(grads[leaf])))
                del grads
            new = dict(sae["params"])
            if cfg["normalize_w_dec"]:
                new["W_dec"] = ref.normalize_rows(new["W_dec"])
            for leaf in LEAVES:
                change[leaf].append(float(torch.linalg.norm(new[leaf] - p0[leaf])))
            del sae, new, p0
        out["metrics"].append(metrics)
        out["terms"].append(terms)
        out["grad"].append(grad)
        out["change"].append(change)
        del stacked, toks
    return out


def compare(prog: dict, refr: dict) -> dict[str, float]:
    """The numbers compared: the worst relative gap of a checked step's loss
    ("loss_gap"), n_dead's largest difference ("dead_gap"), the worst leaf's
    gap of the first gradient's norm ("grad_gap") and of the parameters'
    change after the checked steps ("change_gap", leaves whose reference
    gradient is under a thousandth of the median leaf's left out), and the
    worst relative gap of the log step's metrics ("metrics_gap")."""
    loss = dead = grad = change = metrics = 0.0
    for ci in range(len(refr["terms"])):
        for tp, tr_ in zip(prog["terms"][ci], refr["terms"][ci]):
            for a, b in zip(tp["loss"], tr_["loss"]):
                loss = max(loss, result.rel_gap(a, b))
            for a, b in zip(tp["n_dead"], tr_["n_dead"]):
                dead = max(dead, abs(a - b))
        rg = refr["grad"][ci]
        grad = max(grad, result.norm_gap(prog["grad"][ci], rg))
        skip = set()
        for i in range(len(rg["W_enc"])):
            median = sorted(rg[leaf][i] for leaf in rg)[len(rg) // 2]
            skip |= {(leaf, i) for leaf in rg if rg[leaf][i] < 1e-3 * median}
        change = max(change, result.norm_gap(prog["change"][ci], refr["change"][ci], skip))
        for key in METRICS_COMPARED:
            for a, b in zip(prog["metrics"][ci][key], refr["metrics"][ci][key]):
                metrics = max(metrics, result.rel_gap(a, b))
    return {"loss_gap": loss, "dead_gap": dead, "grad_gap": grad, "change_gap": change, "metrics_gap": metrics}
