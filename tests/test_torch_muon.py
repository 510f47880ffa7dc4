"""Muon in the port (saev_tpu_torch/framework/train.py) against the JAX
package's (saev_tpu/framework/train.py:358-409) on the CPU, from the same
numpy inputs:

- `_newton_schulz` on stacked (3, 64, 256) and (3, 256, 64) Gaussian
  matrices (both branches of the transpose): rtol 1e-5, atol 1e-6;
- `_muon_update` over 4 updates of a dict with a 3-D and a 1-D leaf: every
  update and every leaf of the state (mu, Adam's m, v and both counts)
  within rtol 1e-5, atol 1e-6;
- 3 steps of `make_train_step(optim="muon")` from one JAX sweep state
  carried across (d_model 64, d_sae 2048, batch 64, TopK 8, Matryoshka 4,
  two SAEs with different learning rates): the warm-up step, and the AuxK
  step in its dead-subspace form (cap 128) with 1/16 of the latents pinned
  dead. Every stat within rtol 1e-4 (tighter than the 1e-2 that bf16
  against f32 needs: both sides are f32 here), l0 and n_dead equal, each
  SAE's params and Muon momentum within rel-norm 1e-4;
- a Muon `worker_fn` job, 4 steps, then resumed from its step-4 checkpoint
  for 4 more, equal bit for bit to the same job run 8 steps straight: the
  SAE files, every leaf of the final sweep state and the eval metrics. The
  data stream is not checkpointed (framework/checkpoints.py), so the
  resumed job is handed the batches and prefix cuts the straight job drew
  at steps 4-7. Nor is the step router's readout of aux_risk: a resumed
  job runs the dense AuxK step until its first readout, two steps on,
  where the straight job runs a subspace rung, the same loss to rounding
  but not bit for bit. So the job's AuxK (k_aux 128 of 256 latents) leaves
  the ladder empty and every AuxK step is dense in both jobs.
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saev_tpu.framework import train as jtrain
from saev_tpu.nn import modeling as jmod
from saev_tpu.nn import objectives as jobj
from saev_tpu_torch.data import shards, shuffled
from saev_tpu_torch.framework import checkpoints, train
from saev_tpu_torch.nn import modeling, objectives, serialize

D_MODEL, D_SAE, BATCH, K, J, N_SAE, N_STEPS = 64, 2048, 64, 8, 4, 2, 3
K_AUX, CAP = 64, 128
N_DEAD = D_SAE // 16


def rel_norm(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("shape", [(3, 64, 256), (3, 256, 64)])
def test_newton_schulz_matches_jax(shape):
    g = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    got = train._newton_schulz(torch.from_numpy(g)).numpy()
    want = np.asarray(jtrain._newton_schulz(jnp.asarray(g)))
    assert got.shape == want.shape == shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # Near-orthogonal rows (or columns): the quintic's singular values stay
    # in about [0.7, 1.2] rather than converging to 1.
    x = got if shape[1] <= shape[2] else np.swapaxes(got, 1, 2)
    sv = np.linalg.svd(x.astype(np.float64), compute_uv=False)
    assert 0.5 < sv.min() and sv.max() < 1.3, (sv.min(), sv.max())


def test_muon_update_matches_jax():
    rng = np.random.default_rng(1)
    params = {"W": rng.normal(size=(2, 32, 96)).astype(np.float32),
              "b": rng.normal(size=(2, 96)).astype(np.float32)}
    lr = np.asarray([1e-3, 3e-3], np.float32)
    jstate = jtrain._muon_init({k: jnp.asarray(v) for k, v in params.items()})
    state = train._muon_init({k: torch.from_numpy(v) for k, v in params.items()})
    for _ in range(4):
        grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
        jup, jstate = jtrain._muon_update({k: jnp.asarray(v) for k, v in params.items()},
                                          {k: jnp.asarray(v) for k, v in grads.items()}, jstate, jnp.asarray(lr))
        up, state = train._muon_update({k: torch.from_numpy(v) for k, v in params.items()},
                                       {k: torch.from_numpy(v) for k, v in grads.items()}, state, torch.from_numpy(lr))
        for k in params:
            np.testing.assert_allclose(up[k].numpy(), np.asarray(jup[k]), rtol=1e-5, atol=1e-6, err_msg=k)
            np.testing.assert_allclose(state["mu"][k].numpy(), np.asarray(jstate["mu"][k]), rtol=1e-5, atol=1e-6)
            for mom in ("m", "v"):
                np.testing.assert_allclose(state["adam"][mom][k].numpy(), np.asarray(jstate["adam"][mom][k]),
                                           rtol=1e-5, atol=1e-6, err_msg=f"{mom}[{k}]")
            params[k] = params[k] + np.asarray(jup[k])
        assert int(state["count"]) == int(jstate["count"])
        assert int(state["adam"]["count"]) == int(jstate["adam"]["count"])
    assert int(state["count"]) == 4


def _setup(n_dead: int):
    jcfg = jmod.SparseAutoencoderConfig(
        d_model=D_MODEL, d_sae=D_SAE, activation=jmod.TopK(top_k=K, aux=jmod.AuxK(k_aux=K_AUX))
    )
    inits = [jmod.init(jcfg, key) for key in jax.random.split(jax.random.key(0), N_SAE)]
    stack = lambda trees: jax.tree.map(lambda *xs: jnp.stack(xs), *trees)  # noqa: E731
    params = stack([p for p, _ in inits])
    rng = np.random.default_rng(0)
    b_enc = (rng.normal(size=(N_SAE, D_SAE)) * 0.05).astype(np.float32)
    toks = np.zeros((N_SAE, D_SAE), np.int32)
    b_enc[:, :n_dead] = -1e6  # dead latents pinned as bench.py pins them
    toks[:, :n_dead] = 1 << 30
    params["b_enc"] = jnp.asarray(b_enc)
    ts = jtrain.SweepState(
        params=params,
        sae_state=stack([s for _, s in inits]),
        obj_state={"toks_since_active": jnp.asarray(toks)},
        opt_state=jtrain._muon_init(params),
        step=jnp.zeros((), jnp.int32),
    )
    hp = {
        "lr": np.asarray([1e-3, 3e-3], np.float32),
        "n_lr_warmup": np.ones(N_SAE, np.float32),
        "grad_clip": np.ones(N_SAE, np.float32),
        "sparsity_coeff": np.zeros(N_SAE, np.float32),
        "aux_alpha": np.asarray([1 / 32, 1 / 8], np.float32),
        "momentum": np.zeros(N_SAE, np.float32),
    }
    xs = [rng.normal(size=(BATCH, D_MODEL)).astype(np.float32) for _ in range(N_STEPS)]
    prefixes = np.stack([jobj.sample_prefixes(D_SAE, J, rng=rng) for _ in range(N_SAE)])
    cfg = modeling.SparseAutoencoderConfig(
        d_model=D_MODEL, d_sae=D_SAE, activation=modeling.TopK(top_k=K, aux=modeling.AuxK(k_aux=K_AUX))
    )
    # Copies: the JAX step donates its input state.
    return jcfg, cfg, ts, jax.tree.map(np.array, ts), hp, xs, prefixes


@pytest.mark.parametrize("variant", ["warm-up", "subspace"])
def test_muon_train_step_matches_jax(variant):
    n_dead = 0 if variant == "warm-up" else N_DEAD
    kw = dict(aux_enabled=False) if variant == "warm-up" else dict(aux_subspace_cap=CAP)
    jcfg, cfg, jts, ts_np, hp, xs, prefixes = _setup(n_dead)
    jstep = jtrain.make_train_step(jcfg, jobj.Matryoshka(n_prefixes=J), n_steps=10, optim="muon", **kw)
    step = train.make_train_step(cfg, objectives.Matryoshka(n_prefixes=J), n_steps=10, optim="muon", **kw)
    ts = train.sweep_state_from_numpy(ts_np, "cpu")
    assert set(ts.opt_state) == {"mu", "adam", "count"}
    hp_t = {k: torch.from_numpy(v) for k, v in hp.items()}
    for x in xs:
        jts, jstats = jstep(jts, jnp.asarray(x), jnp.asarray(prefixes), {k: jnp.asarray(v) for k, v in hp.items()})
        ts, stats = step(ts, torch.from_numpy(x), torch.from_numpy(prefixes), hp_t)
        assert set(stats) == set(jstats)
        for k in jstats:
            np.testing.assert_allclose(stats[k].numpy(), np.asarray(jstats[k]), rtol=1e-4, atol=0, err_msg=k)
        for k in ("l0", "n_dead"):
            np.testing.assert_array_equal(stats[k].numpy(), np.asarray(jstats[k]), err_msg=k)
        for k in ts.params:
            for i in range(N_SAE):
                assert rel_norm(ts.params[k][i].numpy(), jts.params[k][i]) <= 1e-4, (k, i)
                assert rel_norm(ts.opt_state["mu"][k][i].numpy(), jts.opt_state["mu"][k][i]) <= 1e-4, (k, i)
        assert int(ts.opt_state["count"]) == int(jts.opt_state["count"])
        assert int(ts.opt_state["adam"]["count"]) == int(jts.opt_state["adam"]["count"])
    assert stats["n_dead"].tolist() == [n_dead] * N_SAE
    assert bool((stats["aux"] > 0).all()) == (n_dead > 0)
    assert float(stats["lr"][0]) > 0


# --- a Muon job, resumed ---

JOB_D_MODEL, JOB_D_SAE, JOB_BATCH, TOKENS, JOB_STEPS = 32, 256, 64, 16, 8


def _batches(n, seed):
    rng = np.random.default_rng(seed)
    basis = rng.normal(size=(8, JOB_D_MODEL))
    out = []
    for b in range(n):
        act = (rng.normal(size=(JOB_BATCH, 8)) @ basis + 0.1 * rng.normal(size=(JOB_BATCH, JOB_D_MODEL)))
        idx = np.arange(b * JOB_BATCH, (b + 1) * JOB_BATCH)
        out.append({"act": act.astype(np.float32), "example_idx": idx // TOKENS, "token_idx": idx % TOKENS})
    return out


class FixedLoader:
    """Stands in for a ShuffledDataLoader: the given batches, in order,
    every epoch."""

    drop_last = False

    def __init__(self, cfg, batches):
        self.cfg, self.batches, self.batch_size = cfg, batches, cfg.batch_size
        self.n_samples = len(batches) * cfg.batch_size
        self.metadata = shards.Metadata(
            family="clip", ckpt="random", layers=(0,), content_tokens_per_example=TOKENS, cls_token=False,
            d_model=JOB_D_MODEL, n_examples=self.n_samples // TOKENS, max_tokens_per_shard=TOKENS * 8,
            data="e30=", dataset=pathlib.Path("/data/images"),
        )

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        for b in self.batches:
            yield {k: v.copy() for k, v in b.items()}


def _job_cfgs(runs_root, **kw):
    data = dict(layer=0, batch_size=JOB_BATCH, n_threads=2, batch_timeout_s=5.0)
    base = train.Config(
        train_data=shuffled.Config(shards=pathlib.Path("train"), **data),
        val_data=shuffled.Config(shards=pathlib.Path("val"), **data),
        n_train=JOB_STEPS * JOB_BATCH, n_val=2 * JOB_BATCH,
        sae=modeling.SparseAutoencoderConfig(
            d_model=JOB_D_MODEL, d_sae=JOB_D_SAE, activation=modeling.TopK(top_k=4, aux=modeling.AuxK(k_aux=128))
        ),
        objective=objectives.Matryoshka(n_prefixes=3, dead_threshold_tokens=3 * JOB_BATCH),
        optim="muon", n_lr_warmup=2, log_every=4, ckpt_every=4, track=False, runs_root=runs_root,
        device="cpu", seed=5, **kw,
    )
    return [base, dataclasses.replace(base, lr=1e-3)]


def _run_job(monkeypatch, runs_root, train_batches, val_batches, prefixes, *, resume=False, crash_at=None):
    """worker_fn with the loaders replaced and `sample_prefixes` either
    recording its draws (`prefixes` an empty list) or serving the given
    ones in order. Returns (SAE files, the final sweep state, eval metrics)."""
    cfgs = _job_cfgs(runs_root, resume=resume)
    loaders = {"train": FixedLoader(cfgs[0].train_data, train_batches),
               "val": FixedLoader(cfgs[0].val_data, val_batches)}
    monkeypatch.setattr(train, "ShuffledDataLoader", lambda cfg: loaders[str(cfg.shards)])
    real_sample, served = objectives.sample_prefixes, iter(list(prefixes))
    record = not prefixes

    def sample(d_sae, n_prefixes, **kw):
        if record:
            prefixes.append(real_sample(d_sae, n_prefixes, **kw))
            return prefixes[-1]
        return next(served)

    monkeypatch.setattr(objectives, "sample_prefixes", sample)
    if crash_at is not None:
        real_save = checkpoints.save

        def crashing_save(root, key, step, state, **kw):
            out = real_save(root, key, step, state, **kw)
            if step == crash_at:
                raise RuntimeError("simulated preemption")
            return out

        monkeypatch.setattr(checkpoints, "save", crashing_save)
    seen = {}
    real_train, real_eval = train.train, train.evaluate
    monkeypatch.setattr(train, "train", lambda c: seen.setdefault("train", real_train(c)))
    monkeypatch.setattr(train, "evaluate", lambda c, r: seen.setdefault("eval", real_eval(c, r)))
    try:
        ids = train.worker_fn(cfgs)
    finally:
        monkeypatch.undo()
    (rt,) = seen["train"][0]
    return [runs_root / i / "checkpoint" / "sae.pt" for i in ids], rt.ts, seen["eval"]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}")
    else:
        yield prefix, tree


def test_muon_job_resumes_bit_for_bit(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the local run recorder writes under ./.wandb
    batches, val = _batches(JOB_STEPS, seed=7), _batches(2, seed=8)
    drawn: list[np.ndarray] = []
    files, ts, metrics = _run_job(monkeypatch, tmp_path / "straight" / "saev" / "runs", batches, val, drawn)
    monkeypatch.chdir(tmp_path)
    assert int(ts.step) == JOB_STEPS and set(ts.opt_state) == {"mu", "adam", "count"}
    assert objectives.subspace_cap_ladder(JOB_D_SAE, 128) == []

    # Crash right after the step-4 checkpoint, then resume from it on the
    # straight job's batches and cuts of steps 4-7 (and its eval's cuts).
    root = tmp_path / "resumed" / "saev" / "runs"
    with pytest.raises(RuntimeError, match="simulated preemption"):
        _run_job(monkeypatch, root, batches, val, drawn[: 4 * N_SAE], crash_at=4)
    monkeypatch.chdir(tmp_path)
    (group,) = (root / ".train_state").iterdir()
    assert [p.name for p in group.iterdir()] == ["step_00000004"]
    rest = batches[4:] + batches[:4]  # the resumed loop reads the first 4
    files2, ts2, metrics2 = _run_job(monkeypatch, root, rest, val, drawn[4 * N_SAE:], resume=True)
    assert int(ts2.step) == JOB_STEPS

    for field in ts._fields:
        mine, theirs = dict(_leaves(getattr(ts2, field))), dict(_leaves(getattr(ts, field)))
        assert mine.keys() == theirs.keys()
        for k in theirs:
            assert torch.equal(mine[k], theirs[k]), f"{field}{k}"
    assert float(ts.opt_state["mu"]["W_dec"].abs().max()) > 0
    for a, b in zip(files2, files):
        _, pa, _ = serialize.load(a, device="cpu")
        _, pb, _ = serialize.load(b, device="cpu")
        assert all(torch.equal(pa[k], pb[k]) for k in pb)
    for ma, mb in zip(metrics2, metrics):
        for f in dataclasses.fields(mb):
            va, vb = getattr(ma, f.name), getattr(mb, f.name)
            if isinstance(vb, np.ndarray):
                np.testing.assert_array_equal(va, vb, err_msg=f.name)
            else:
                assert va == vb, f.name
