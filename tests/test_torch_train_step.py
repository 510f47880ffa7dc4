"""The port's warm-up train step (saev_tpu_torch/framework/train.py) against
saev_tpu.framework.train.make_train_step, from one JAX sweep state carried
across with `sweep_state_from_numpy`: d_model 64, d_sae 2048, batch 64, TopK
k=8, Matryoshka J=4, two SAEs with different learning rates, 3 steps.

- Plain f32 path on both sides: every stat to rel 1e-4 at every step, params
  and Adam moments to atol 1e-5.
- Kernel path (the port's predicate patched on, so the kernel wrappers run
  their plain versions on the CPU; JAX with its Pallas kernels interpreted):
  bf16 operands on both sides, loss terms to rel 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saev_tpu.framework import train as jtrain
from saev_tpu.nn import modeling as jmod
from saev_tpu.nn import objectives as jobj
from saev_tpu.ops import shmap
from saev_tpu_torch.framework import train
from saev_tpu_torch.nn import modeling, objectives
from saev_tpu_torch.ops import matryoshka as tmat

D_MODEL, D_SAE, BATCH, K, J, N_SAE, N_STEPS = 64, 2048, 64, 8, 4, 2, 3


def _setup():
    jcfg = jmod.SparseAutoencoderConfig(d_model=D_MODEL, d_sae=D_SAE, activation=jmod.TopK(top_k=K))
    inits = [jmod.init(jcfg, key) for key in jax.random.split(jax.random.key(0), N_SAE)]
    stack = lambda trees: jax.tree.map(lambda *xs: jnp.stack(xs), *trees)  # noqa: E731
    params = stack([p for p, _ in inits])
    rng = np.random.default_rng(0)
    params["b_enc"] = jnp.asarray(rng.normal(size=(N_SAE, D_SAE)).astype(np.float32) * 0.05)
    ts = jtrain.SweepState(
        params=params,
        sae_state=stack([s for _, s in inits]),
        obj_state=stack([jobj.init_state(jcfg)] * N_SAE),
        opt_state=jtrain._adam_init(params),
        step=jnp.zeros((), jnp.int32),
    )
    hp = {
        "lr": np.asarray([1e-3, 3e-3], np.float32),
        "n_lr_warmup": np.ones(N_SAE, np.float32),
        "grad_clip": np.ones(N_SAE, np.float32),
        "sparsity_coeff": np.zeros(N_SAE, np.float32),
        "aux_alpha": np.full(N_SAE, 1 / 32, np.float32),
        "momentum": np.zeros(N_SAE, np.float32),
    }
    xs = [rng.normal(size=(BATCH, D_MODEL)).astype(np.float32) for _ in range(N_STEPS)]
    prefixes = np.stack([jobj.sample_prefixes(D_SAE, J, rng=rng) for _ in range(N_SAE)])
    prefixes[0, 0] = 5  # a cut inside group 0 (m = 0)
    prefixes[1, 1] = 1024  # a cut on the group boundary (r = 0)
    prefixes.sort(axis=1)
    # Copies: the JAX step donates its input state.
    ts_np = jax.tree.map(np.array, ts)
    cfg = modeling.SparseAutoencoderConfig(d_model=D_MODEL, d_sae=D_SAE, activation=modeling.TopK(top_k=K))
    return jcfg, cfg, ts, ts_np, hp, xs, prefixes


def _run_both(monkeypatch=None):
    jcfg, cfg, jts, ts_np, hp, xs, prefixes = _setup()
    jstep = jtrain.make_train_step(jcfg, jobj.Matryoshka(n_prefixes=J), n_steps=10,
                                   optim="adam", aux_enabled=False)
    step = train.make_train_step(cfg, objectives.Matryoshka(n_prefixes=J), n_steps=10,
                                 optim="adam", aux_enabled=False)
    ts = train.sweep_state_from_numpy(ts_np, "cpu")
    hp_t = {k: torch.from_numpy(v) for k, v in hp.items()}
    pf_t = torch.from_numpy(prefixes)
    for x in xs:
        jts, jstats = jstep(jts, jnp.asarray(x), jnp.asarray(prefixes), {k: jnp.asarray(v) for k, v in hp.items()})
        ts, stats = step(ts, torch.from_numpy(x), pf_t, hp_t)
        yield jts, jstats, ts, stats


def test_plain_path_matches_jax():
    for jts, jstats, ts, stats in _run_both():
        assert set(stats) == set(jstats)
        for k in jstats:
            np.testing.assert_allclose(
                stats[k].numpy(), np.asarray(jstats[k]), rtol=1e-4, atol=0, err_msg=k
            )
        for k in ts.params:
            np.testing.assert_allclose(ts.params[k].numpy(), np.asarray(jts.params[k]), rtol=0, atol=1e-5, err_msg=k)
            for mom in ("m", "v"):
                np.testing.assert_allclose(
                    ts.opt_state[mom][k].numpy(), np.asarray(jts.opt_state[mom][k]),
                    rtol=0, atol=1e-5, err_msg=f"{mom}[{k}]",
                )
        np.testing.assert_array_equal(
            ts.obj_state["toks_since_active"].numpy(), np.asarray(jts.obj_state["toks_since_active"])
        )
        assert int(ts.step) == int(jts.step) and int(ts.opt_state["count"]) == int(jts.opt_state["count"])
    assert float(stats["lr"][0]) > 0  # the updates were not zero


def test_kernel_path_matches_jax_interpret(monkeypatch):
    monkeypatch.setattr(shmap, "INTERPRET", True)
    monkeypatch.setattr(tmat, "_use_kernels", lambda t: True)
    for _jts, jstats, _ts, stats in _run_both():
        for k in ("mse", "loss", "l0", "l1"):
            np.testing.assert_allclose(
                stats[k].numpy(), np.asarray(jstats[k]), rtol=1e-2, atol=0, err_msg=k
            )


def test_unported_variants_raise():
    cfg = modeling.SparseAutoencoderConfig(d_model=8, d_sae=64)
    obj = objectives.Matryoshka(n_prefixes=2)
    with pytest.raises(NotImplementedError, match="K5"):
        train.make_train_step(cfg, obj, 10, aux_enabled=True)
    with pytest.raises(NotImplementedError, match="Muon"):
        train.make_train_step(cfg, obj, 10, optim="muon")
    step = train.make_train_step(cfg, obj, 10)
    ts = train.init_sweep_state(cfg, 1, torch.Generator().manual_seed(0))
    hp = {"lr": torch.ones(1), "n_lr_warmup": torch.ones(1), "grad_clip": torch.ones(1),
          "sparsity_coeff": torch.zeros(1)}
    x = torch.zeros((8, 8))
    with pytest.raises(NotImplementedError, match="K5"):
        objectives.matryoshka_loss(
            obj, cfg, {k: v[0] for k, v in ts.params.items()}, {}, {"toks_since_active": ts.obj_state["toks_since_active"][0]},
            x, torch.tensor([3, 64]), training=True, any_dead=None,
        )
    ts, stats = step(ts, x + 1.0, torch.tensor([[3, 64]], dtype=torch.int32), hp)
    assert bool(torch.isfinite(stats["loss"]).all())
