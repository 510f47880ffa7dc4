"""The port's autodiff-through-decode path against the JAX package at HIGHEST,
from the same numpy inputs, on the CPU (JAX-CPU through its XLA paths):

- the multi-prefix `decode` (groups of 1024, the batched group product, the
  (J, G) mask contraction and one masked remainder product a prefix) on
  sampled cuts with a cut inside group 0 and one on a group boundary, one
  prefix, a d_sae that is not a multiple of 1024, a d_sae under one group
  and a group size of 256: every prefix's reconstruction to relative error
  (rel-norm) 1e-5;
- `forward` (h_x, f_x, x_hats) and `matryoshka_loss(training=False)` (mse,
  l0, l1 to rel 1e-5; aux and n_dead 0; counters untouched), and the
  decode path in training (one prefix, d_sae 1500, "highest"): loss terms
  and every parameter's gradient to rel-norm 1e-5;
- the "highest" train step (warm-up and AuxK dense with planted dead
  latents, two SAEs): every step's loss to rel 1e-5 and the parameters
  after 3 steps to rel-norm 1e-5;
- "highest" runs its products with TF32 off whatever the caller's setting,
  and puts the caller's setting back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saev_tpu.framework import train as jtrain
from saev_tpu.nn import modeling as jmod
from saev_tpu.nn import objectives as jobj
from saev_tpu_torch.framework import train
from saev_tpu_torch.nn import modeling, objectives

D_MODEL, BATCH, K = 64, 64, 8
REL = 1e-5

# name: (d_sae, number of prefixes or None, group_size)
CASES = {
    "sampled-cuts": (2048, 10, 1024),
    "one-prefix": (2048, 1, 1024),
    "d_sae-1500": (1500, 5, 1024),
    "d_sae-640": (640, 4, 1024),
    "group-256": (2048, 6, 256),
    "no-prefixes": (1024, None, 1024),
}


def rel_norm(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _cfgs(d_sae, k_aux=512):
    jcfg = jmod.SparseAutoencoderConfig(
        d_model=D_MODEL, d_sae=d_sae, activation=jmod.TopK(top_k=K, aux=jmod.AuxK(k_aux=k_aux))
    )
    cfg = modeling.SparseAutoencoderConfig(
        d_model=D_MODEL, d_sae=d_sae, activation=modeling.TopK(top_k=K, aux=modeling.AuxK(k_aux=k_aux))
    )
    return jcfg, cfg


def _inputs(d_sae, n_prefixes, seed=0):
    rng = np.random.default_rng(seed)
    params = {
        "W_enc": (rng.normal(size=(D_MODEL, d_sae)) / np.sqrt(D_MODEL)).astype(np.float32),
        "b_enc": (rng.normal(size=(d_sae,)) * 0.05).astype(np.float32),
        "W_dec": (rng.normal(size=(d_sae, D_MODEL)) / np.sqrt(D_MODEL)).astype(np.float32),
        "b_dec": (rng.normal(size=(D_MODEL,)) * 0.1).astype(np.float32),
    }
    x = rng.normal(size=(BATCH, D_MODEL)).astype(np.float32)
    prefixes = None
    if n_prefixes is not None:
        prefixes = jobj.sample_prefixes(d_sae, n_prefixes, rng=rng)
        if n_prefixes >= 4 and d_sae > 1024:
            # A cut inside group 0 and one on a group boundary, in place of
            # the largest sampled cuts.
            keep = {5, 1024, d_sae}
            rest = sorted(set(prefixes.tolist()) - keep)[: n_prefixes - len(keep)]
            prefixes = np.asarray(sorted(keep | set(rest)), np.int32)
            assert len(prefixes) == n_prefixes
    return params, x, prefixes


def _t(params):
    return {k: torch.from_numpy(v.copy()) for k, v in params.items()}


def _j(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("case", CASES.values(), ids=CASES.keys())
def test_decode_matches_jax(case):
    d_sae, n_prefixes, group = case
    jcfg, cfg = _cfgs(d_sae)
    params, _, prefixes = _inputs(d_sae, n_prefixes)
    # Latents with TopK-like sparsity: 8 nonzeros a row.
    rng = np.random.default_rng(1)
    f = np.zeros((BATCH, d_sae), np.float32)
    for row in f:
        row[rng.choice(d_sae, K, replace=False)] = rng.exponential(size=K)
    want = np.asarray(jmod.decode(
        jcfg, _j(params), jnp.asarray(f), None if prefixes is None else jnp.asarray(prefixes),
        group_size=group, precision=jax.lax.Precision.HIGHEST,
    ))
    got = modeling.decode(
        cfg, _t(params), torch.from_numpy(f), None if prefixes is None else torch.from_numpy(prefixes),
        group_size=group, precision="highest",
    ).numpy()
    assert got.shape == want.shape
    for j in range(want.shape[1]):
        assert rel_norm(got[:, j], want[:, j]) <= REL, (j, rel_norm(got[:, j], want[:, j]))


@pytest.mark.parametrize("case", ["sampled-cuts", "one-prefix", "d_sae-1500", "d_sae-640"])
def test_forward_matches_jax(case):
    d_sae, n_prefixes, _ = CASES[case]
    jcfg, cfg = _cfgs(d_sae)
    params, x, prefixes = _inputs(d_sae, n_prefixes)
    jout, _ = jmod.forward(jcfg, _j(params), jmod.init_state(jcfg), jnp.asarray(x),
                           prefixes=jnp.asarray(prefixes))
    out, _ = modeling.forward(cfg, _t(params), modeling.init_state(cfg, "cpu"), torch.from_numpy(x),
                              prefixes=torch.from_numpy(prefixes))
    assert isinstance(out, modeling.Output) and out._fields == jout._fields
    for name in out._fields:
        got, want = getattr(out, name).numpy(), np.asarray(getattr(jout, name))
        assert got.shape == want.shape, name
        assert rel_norm(got, want) <= REL, (name, rel_norm(got, want))
    # TopK keeps k a row on continuous inputs.
    assert (np.count_nonzero(out.f_x.numpy(), axis=1) == K).all()


def _losses(case, training, precision=None, seed=0):
    d_sae, n_prefixes, _ = CASES[case]
    jcfg, cfg = _cfgs(d_sae, k_aux=32)
    params, x, prefixes = _inputs(d_sae, n_prefixes, seed)
    toks = np.zeros((d_sae,), np.int32)
    toks[: d_sae // 8] = 1 << 20  # dead latents, for AuxK in training
    obj = dict(n_prefixes=len(prefixes), dead_threshold_tokens=1 << 19)
    jprec = jmod.PRECISIONS[precision] if precision else None

    def jloss(p):
        loss, out, _, state = jobj.matryoshka_loss(
            jobj.Matryoshka(**obj), jcfg, p, jmod.init_state(jcfg), {"toks_since_active": jnp.asarray(toks)},
            jnp.asarray(x), jnp.asarray(prefixes), training=training, precision=jprec,
        )
        return loss.loss, (loss, out, state)

    (_, (jl, jout, jstate)), jgrads = jax.value_and_grad(jloss, has_aux=True)(_j(params))
    leaves = {k: v.requires_grad_(True) for k, v in _t(params).items()}
    tl, tout, _, tstate = objectives.matryoshka_loss(
        objectives.Matryoshka(**obj), cfg, leaves, modeling.init_state(cfg, "cpu"),
        {"toks_since_active": torch.from_numpy(toks)}, torch.from_numpy(x), torch.from_numpy(prefixes),
        training=training, precision=precision,
    )
    tl.loss.backward()
    return (jl, jout, jstate, jgrads), (tl, tout, tstate, {k: v.grad for k, v in leaves.items()})


@pytest.mark.parametrize("case", ["sampled-cuts", "one-prefix", "d_sae-1500"])
def test_eval_loss_matches_jax(case):
    (jl, jout, jstate, _), (tl, tout, tstate, _) = _losses(case, training=False)
    for name in ("mse", "l0", "l1"):
        got, want = float(getattr(tl, name)), float(getattr(jl, name))
        assert abs(got - want) <= REL * abs(want), (name, got, want)
    assert float(tl.aux) == float(jl.aux) == 0.0 and int(tl.n_dead) == int(jl.n_dead) == 0
    # Eval leaves the dead-latent counters as they were.
    np.testing.assert_array_equal(tstate["toks_since_active"].numpy(), np.asarray(jstate["toks_since_active"]))
    assert rel_norm(tout.x_hats.detach().numpy(), jout.x_hats) <= REL


@pytest.mark.parametrize("case,precision", [("one-prefix", None), ("d_sae-1500", None), ("sampled-cuts", "highest")])
def test_decode_path_training_matches_jax(case, precision):
    """The reference's routes into the decode path in training: one prefix,
    a d_sae that is not a multiple of 1024, and "highest"."""
    (jl, _, jstate, jgrads), (tl, _, tstate, tgrads) = _losses(case, training=True, precision=precision)
    for name in ("mse", "l0", "l1", "aux", "loss"):
        got, want = float(getattr(tl, name)), float(getattr(jl, name))
        assert abs(got - want) <= REL * abs(want), (name, got, want)
    assert float(tl.aux) > 0 and int(tl.n_dead) == int(jl.n_dead) > 0
    np.testing.assert_array_equal(tstate["toks_since_active"].numpy(), np.asarray(jstate["toks_since_active"]))
    for k in tgrads:
        assert rel_norm(tgrads[k].numpy(), jgrads[k]) <= REL, (k, rel_norm(tgrads[k].numpy(), jgrads[k]))


@pytest.mark.parametrize("aux_enabled", [False, True], ids=["warm", "dense"])
def test_highest_train_step_matches_jax(aux_enabled):
    from test_torch_train_step import N_DEAD, _setup

    n_dead = N_DEAD if aux_enabled else (0, 0)
    jcfg, cfg, jts, ts_np, hp, xs, prefixes = _setup(n_dead=n_dead, k_aux=64)
    j = prefixes.shape[1]
    jstep = jtrain.make_train_step(jcfg, jobj.Matryoshka(n_prefixes=j), n_steps=10,
                                   matmul_precision="highest", aux_enabled=aux_enabled)
    step = train.make_train_step(cfg, objectives.Matryoshka(n_prefixes=j), n_steps=10,
                                 matmul_precision="highest", aux_enabled=aux_enabled)
    ts = train.sweep_state_from_numpy(ts_np, "cpu")
    hp_t = {k: torch.from_numpy(v) for k, v in hp.items()}
    for x in xs:
        jts, jstats = jstep(jts, jnp.asarray(x), jnp.asarray(prefixes), {k: jnp.asarray(v) for k, v in hp.items()})
        ts, stats = step(ts, torch.from_numpy(x), torch.from_numpy(prefixes), hp_t)
        np.testing.assert_allclose(stats["loss"].numpy(), np.asarray(jstats["loss"]), rtol=REL, atol=0)
        assert stats["n_dead"].tolist() == np.asarray(jstats["n_dead"]).tolist() == list(n_dead)
    for k in ts.params:
        assert rel_norm(ts.params[k].numpy(), jts.params[k]) <= REL, k
    assert float(stats["lr"][0]) > 0


@pytest.mark.parametrize("caller", ["high", "medium", "highest"])
def test_highest_products_ignore_the_global_tf32_setting(monkeypatch, caller):
    """Inside a "highest" product TF32 is off whatever the caller set: the
    per-backend switches read "ieee" (the global precision "highest" on a
    torch without them); after it, the caller's setting."""
    prev = torch.get_float32_matmul_precision()
    seen = []
    real = torch.Tensor.__matmul__
    switches = modeling._matmul_switches()
    f32 = "highest" if switches is None else ("ieee", "ieee")

    def spy(a, b):
        seen.append(torch.get_float32_matmul_precision() if switches is None
                    else tuple(s.fp32_precision for s in switches))
        return real(a, b)

    try:
        torch.set_float32_matmul_precision(caller)
        monkeypatch.setattr(torch.Tensor, "__matmul__", spy)
        a = torch.randn(8, 8, requires_grad=True)
        out = modeling.matmul(a, torch.randn(8, 8), "highest")
        out.sum().backward()
        modeling._linear_bias(torch.randn(4, 8), torch.randn(8, 8), torch.randn(8), "highest")
        assert torch.get_float32_matmul_precision() == caller
    finally:
        monkeypatch.undo()
        torch.set_float32_matmul_precision(prev)
    assert len(seen) >= 3 and set(seen) == {f32}, seen
