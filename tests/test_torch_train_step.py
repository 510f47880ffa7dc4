"""The port's train step (saev_tpu_torch/framework/train.py) against
saev_tpu.framework.train.make_train_step, from one JAX sweep state carried
across with `sweep_state_from_numpy`: d_model 64, d_sae 2048, batch 64, TopK
k=8, Matryoshka J=4, two SAEs with different learning rates, 3 steps.

The warm-up step (AuxK left out), and the steady-state step with AuxK
(k_aux 64, per-SAE alpha) in its dense and its dead-subspace form (cap 128),
from a state with dead latents planted as bench.py plants them (encoder bias
-1e6, counters at 1 << 30): 100 in one SAE, 60 (fewer than k_aux) in the other.

- Plain f32 path on both sides: every stat to rel 1e-4 at every step, params
  and Adam moments to atol 1e-5, counters and n_dead exact.
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
K_AUX, N_DEAD = 64, (100, 60)
STEADY = {"dense": None, "subspace": 128}  # aux_subspace_cap of each form


def _setup(n_dead=(0, 0), k_aux=512):
    jcfg = jmod.SparseAutoencoderConfig(
        d_model=D_MODEL, d_sae=D_SAE, activation=jmod.TopK(top_k=K, aux=jmod.AuxK(k_aux=k_aux))
    )
    inits = [jmod.init(jcfg, key) for key in jax.random.split(jax.random.key(0), N_SAE)]
    stack = lambda trees: jax.tree.map(lambda *xs: jnp.stack(xs), *trees)  # noqa: E731
    params = stack([p for p, _ in inits])
    rng = np.random.default_rng(0)
    params["b_enc"] = jnp.asarray(rng.normal(size=(N_SAE, D_SAE)).astype(np.float32) * 0.05)
    b_enc = np.array(params["b_enc"])
    toks = np.zeros((N_SAE, D_SAE), np.int32)
    for i, n in enumerate(n_dead):  # dead latents pinned as bench.py pins them
        b_enc[i, :n] = -1e6
        toks[i, :n] = 1 << 30
    params["b_enc"] = jnp.asarray(b_enc)
    ts = jtrain.SweepState(
        params=params,
        sae_state=stack([s for _, s in inits]),
        obj_state={"toks_since_active": jnp.asarray(toks)},
        opt_state=jtrain._adam_init(params),
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
    prefixes[0, 0] = 5  # a cut inside group 0 (m = 0)
    prefixes[1, 1] = 1024  # a cut on the group boundary (r = 0)
    prefixes.sort(axis=1)
    # Copies: the JAX step donates its input state.
    ts_np = jax.tree.map(np.array, ts)
    cfg = modeling.SparseAutoencoderConfig(
        d_model=D_MODEL, d_sae=D_SAE, activation=modeling.TopK(top_k=K, aux=modeling.AuxK(k_aux=k_aux))
    )
    return jcfg, cfg, ts, ts_np, hp, xs, prefixes


def _run_both(aux_enabled=False, aux_subspace_cap=None, **setup):
    jcfg, cfg, jts, ts_np, hp, xs, prefixes = _setup(**setup)
    variant = dict(aux_enabled=aux_enabled, aux_subspace_cap=aux_subspace_cap)
    jstep = jtrain.make_train_step(jcfg, jobj.Matryoshka(n_prefixes=J), n_steps=10,
                                   optim="adam", **variant)
    step = train.make_train_step(cfg, objectives.Matryoshka(n_prefixes=J), n_steps=10,
                                 optim="adam", **variant)
    ts = train.sweep_state_from_numpy(ts_np, "cpu")
    # The planted state carries over unchanged.
    for k, v in ts_np.params.items():
        np.testing.assert_array_equal(ts.params[k].numpy(), v)
    np.testing.assert_array_equal(ts.obj_state["toks_since_active"].numpy(), ts_np.obj_state["toks_since_active"])
    hp_t = {k: torch.from_numpy(v) for k, v in hp.items()}
    pf_t = torch.from_numpy(prefixes)
    for x in xs:
        jts, jstats = jstep(jts, jnp.asarray(x), jnp.asarray(prefixes), {k: jnp.asarray(v) for k, v in hp.items()})
        ts, stats = step(ts, torch.from_numpy(x), pf_t, hp_t)
        yield jts, jstats, ts, stats


def _assert_plain_matches(jts, jstats, ts, stats) -> None:
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


def test_plain_path_matches_jax():
    for jts, jstats, ts, stats in _run_both():
        _assert_plain_matches(jts, jstats, ts, stats)
    assert float(stats["lr"][0]) > 0  # the updates were not zero


@pytest.mark.parametrize("variant", STEADY)
def test_steady_state_plain_path_matches_jax(variant):
    for jts, jstats, ts, stats in _run_both(True, STEADY[variant], n_dead=N_DEAD, k_aux=K_AUX):
        _assert_plain_matches(jts, jstats, ts, stats)
        assert stats["n_dead"].tolist() == list(N_DEAD)
        assert bool((stats["aux"] > 0).all()) and bool(torch.isfinite(stats["loss"]).all())
    assert float(stats["lr"][0]) > 0


def test_steady_state_none_dead_matches_jax():
    """AuxK on with no dead latent: every row's threshold is -inf over an
    all-masked mask, aux is exactly 0 and carries no NaN into the grads."""
    for jts, jstats, ts, stats in _run_both(True, None):
        _assert_plain_matches(jts, jstats, ts, stats)
        assert stats["aux"].tolist() == [0.0, 0.0] and stats["n_dead"].tolist() == [0, 0]
        assert all(bool(torch.isfinite(v).all()) for v in ts.params.values())


def test_kernel_path_matches_jax_interpret(monkeypatch):
    monkeypatch.setattr(shmap, "INTERPRET", True)
    monkeypatch.setattr(tmat, "_use_kernels", lambda t: True)
    for _jts, jstats, _ts, stats in _run_both():
        for k in ("mse", "loss", "l0", "l1"):
            np.testing.assert_allclose(
                stats[k].numpy(), np.asarray(jstats[k]), rtol=1e-2, atol=0, err_msg=k
            )


@pytest.mark.parametrize("variant", STEADY)
def test_steady_state_kernel_path_matches_jax_interpret(monkeypatch, variant):
    monkeypatch.setattr(shmap, "INTERPRET", True)
    monkeypatch.setattr(tmat, "_use_kernels", lambda t: True)
    for _jts, jstats, _ts, stats in _run_both(True, STEADY[variant], n_dead=N_DEAD, k_aux=K_AUX):
        for k in ("mse", "aux", "loss", "l0", "l1"):
            np.testing.assert_allclose(
                stats[k].numpy(), np.asarray(jstats[k]), rtol=1e-2, atol=0, err_msg=k
            )
        np.testing.assert_array_equal(stats["n_dead"].numpy(), np.asarray(jstats["n_dead"]))


def test_unported_variants_raise():
    """What still raises: a traced-style (tensor) AuxK gate, an unknown
    optimizer and an unknown precision. Muon and "high" (bf16x3), which
    raised before they were ported, run a finite step, and so do the AuxK
    step and the multi-prefix decode."""
    cfg = modeling.SparseAutoencoderConfig(d_model=8, d_sae=64)
    obj = objectives.Matryoshka(n_prefixes=2)
    with pytest.raises(ValueError, match="Unknown optimizer"):
        train.make_train_step(cfg, obj, 10, optim="sgd")
    with pytest.raises(ValueError, match="Unknown matmul precision"):
        train.make_train_step(cfg, obj, 10, matmul_precision="bf16")
    hp = {"lr": torch.ones(1), "n_lr_warmup": torch.ones(1), "grad_clip": torch.ones(1),
          "sparsity_coeff": torch.zeros(1)}
    x = torch.zeros((8, 8))
    ts = train.init_sweep_state(cfg, 1, torch.Generator().manual_seed(0), device="cpu")
    params0 = {k: v[0] for k, v in ts.params.items()}
    assert modeling.decode(cfg, params0, torch.zeros((8, 64)), torch.tensor([3, 64])).shape == (8, 2, 8)
    with pytest.raises(TypeError, match="any_dead"):
        objectives.matryoshka_loss(
            obj, cfg, params0, {}, {"toks_since_active": ts.obj_state["toks_since_active"][0]},
            x, torch.tensor([3, 64]), training=True, any_dead=torch.tensor(True),
        )
    for optim, precision in (("adam", "default"), ("muon", "default"), ("adam", "high"), ("muon", "high")):
        step = train.make_train_step(cfg, obj, 10, optim=optim, matmul_precision=precision, aux_enabled=True)
        ts = train.init_sweep_state(cfg, 1, torch.Generator().manual_seed(0), device="cpu", optim=optim)
        assert ("mu" in ts.opt_state) == (optim == "muon")
        ts, stats = step(ts, x + 1.0, torch.tensor([[3, 64]], dtype=torch.int32), hp)
        ts, stats = step(ts, x + 1.0, torch.tensor([[3, 64]], dtype=torch.int32), hp)
        assert bool(torch.isfinite(stats["loss"]).all()), (optim, precision)
        assert all(bool(torch.isfinite(v).all()) for v in ts.params.values()), (optim, precision)
        assert int(ts.opt_state["count"]) == 2


def test_init_sweep_state_defaults_to_the_card(monkeypatch):
    """With no device given the sweep state is built on CUDA: on a card it
    lies there; without one the call raises at its first allocation, which
    asked for the card, and builds nothing on the CPU."""
    cfg = modeling.SparseAutoencoderConfig(d_model=8, d_sae=64)
    asked = []
    empty = torch.empty

    def spy(*args, **kwargs):
        asked.append(torch.device(kwargs.get("device", "cpu")).type)
        return empty(*args, **kwargs)

    monkeypatch.setattr(torch, "empty", spy)
    if torch.cuda.is_available():
        ts = train.init_sweep_state(cfg, 1)
        assert all(v.is_cuda for v in ts.params.values()) and ts.step.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            train.init_sweep_state(cfg, 1)
        assert asked == ["cuda"]
