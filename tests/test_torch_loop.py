"""The train loop's pieces that need no loader, against the JAX package:

- the step router (`StepRouter.step_fn_at` / `record_stats`) picks the same
  variant as `saev_tpu.framework.train._CohortRuntime` (built with
  placeholder step functions) over scripted aux_risk sequences;
- `make_step_router` builds the variants as the JAX train loop does;
- the log-step metrics (`make_metrics_fn`, `dictionary_coherence`) match JAX
  to rel 1e-5, with JAX's TopK threshold from lax.top_k or from its Pallas
  kernel in interpret mode.
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

SUBS = [(128, "tight"), (512, "wide")]
# aux_risk of steps 0, 1, ...: nothing at risk, then rungs up and down.
RISKS = [0] * 6 + [50, 100, 129, 600, 512, 513, 128, 0, 90, 7, 300, 1000, 3, 3]
SCRIPTS = {
    "warm-then-rungs": dict(aux_from_step=6, subs=SUBS, warm=True, start=0),
    "from-aux_from_step-1": dict(aux_from_step=6, subs=SUBS, warm=True, start=5),
    "from-aux_from_step-2": dict(aux_from_step=6, subs=SUBS, warm=True, start=4),
    "no-warm-step": dict(aux_from_step=0, subs=SUBS, warm=False, start=0),
    "dense-only": dict(aux_from_step=3, subs=[], warm=True, start=0),
    "one-rung": dict(aux_from_step=2, subs=SUBS[1:], warm=True, start=1),
}


@pytest.mark.parametrize("script", SCRIPTS.values(), ids=SCRIPTS.keys())
def test_router_picks_what_jax_picks(script):
    subs = script["subs"]
    warm = "warm" if script["warm"] else None
    jrt = jtrain._CohortRuntime(
        cohort=None, ts=None, step_fn="dense", metrics_fn=None, hp=None, prefix_rng=None,
        step_fn_warm=warm, aux_from_step=script["aux_from_step"], step_fn_subs=list(subs),
        pending=[], risk=[None],
    )
    router = train.StepRouter(
        "dense", step_fn_warm=warm, aux_from_step=script["aux_from_step"], step_fn_subs=subs
    )
    picks = []
    for g in range(script["start"], len(RISKS)):
        want = jrt.step_fn_at(g)
        assert router.step_fn_at(g) == want, (g, picks)
        picks.append(want)
        risk = np.asarray([RISKS[g], RISKS[g] // 2], np.int32)  # two SAEs
        jrt.record_stats(g, {"aux_risk": jnp.asarray(risk)})
        router.record_stats(g, {"aux_risk": torch.from_numpy(risk)})
        assert len(router.pending) == len(jrt.pending)
    assert len(set(picks)) > 1 or not subs


@pytest.mark.parametrize("threshold,batch", [(10_000_000, 16384), (1000, 64), (64, 64), (100, 1000)])
def test_make_step_router_matches_jax_construction(threshold, batch):
    cfg = modeling.SparseAutoencoderConfig(d_model=16, d_sae=2048, activation=modeling.TopK(aux=modeling.AuxK(k_aux=64)))
    obj = objectives.Matryoshka(dead_threshold_tokens=threshold)
    router = train.make_step_router(cfg, obj, n_steps=100, batch_size=batch)
    aux_from_step = max(0, -(-threshold // batch) - 1)  # saev_tpu/framework/train.py:1064
    assert router.aux_from_step == aux_from_step
    assert (router.step_fn_warm is None) == (aux_from_step == 0)
    assert [c for c, _ in router.step_fn_subs] == jobj.subspace_cap_ladder(2048, 64) == [128, 512]
    no_aux = modeling.SparseAutoencoderConfig(d_model=16, d_sae=2048, activation=modeling.TopK(aux=modeling.NoAux()))
    plain = train.make_step_router(no_aux, obj, n_steps=100, batch_size=batch)
    assert plain.aux_from_step == 101 and plain.step_fn_warm is None and plain.step_fn_subs == []
    assert plain.step_fn_at(5) is plain.step_fn


D_MODEL, D_SAE, BATCH, N_SAE = 32, 512, 64, 2


def _planted_state():
    jcfg = jmod.SparseAutoencoderConfig(d_model=D_MODEL, d_sae=D_SAE, activation=jmod.TopK(top_k=8))
    inits = [jmod.init(jcfg, key) for key in jax.random.split(jax.random.key(1), N_SAE)]
    params = jax.tree.map(lambda *xs: jnp.stack(xs), *[p for p, _ in inits])
    rng = np.random.default_rng(1)
    b_enc = (rng.normal(size=(N_SAE, D_SAE)) * 0.1).astype(np.float32)
    b_enc[0, :40] = -1e6  # dead latents pinned as bench.py pins them
    b_enc[1, 100:110] = -1e6
    w_dec = np.array(params["W_dec"]) * rng.uniform(0.5, 2.0, size=(N_SAE, D_SAE, 1)).astype(np.float32)
    params = {**params, "b_enc": jnp.asarray(b_enc), "W_dec": jnp.asarray(w_dec)}
    ts = jtrain.SweepState(
        params=params,
        sae_state=jax.tree.map(lambda *xs: jnp.stack(xs), *[s for _, s in inits]),
        obj_state={"toks_since_active": jnp.zeros((N_SAE, D_SAE), jnp.int32)},
        opt_state=jtrain._adam_init(params),
        step=jnp.zeros((), jnp.int32),
    )
    x = rng.normal(size=(BATCH, D_MODEL)).astype(np.float32)
    prefixes = np.stack([jobj.sample_prefixes(D_SAE, 4, rng=rng) for _ in range(N_SAE)])
    return jcfg, jax.tree.map(np.array, ts), x, prefixes


@pytest.mark.parametrize("interpret", [False, True], ids=["lax", "pallas-interpret"])
def test_metrics_match_jax(monkeypatch, interpret):
    monkeypatch.setattr(shmap, "INTERPRET", interpret)
    jcfg, ts_np, x, prefixes = _planted_state()
    want = jtrain.make_metrics_fn(jcfg)(
        jax.tree.map(jnp.asarray, ts_np), jnp.asarray(x), jnp.asarray(prefixes)
    )
    cfg = modeling.SparseAutoencoderConfig(d_model=D_MODEL, d_sae=D_SAE, activation=modeling.TopK(top_k=8))
    got = train.make_metrics_fn(cfg)(
        train.sweep_state_from_numpy(ts_np, "cpu"), torch.from_numpy(x), torch.from_numpy(prefixes)
    )
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == (N_SAE,), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=0, err_msg=k)
    assert got["dead_unit_pct"][0] >= 40 / D_SAE and got["dead_unit_pct"][1] >= 10 / D_SAE


@pytest.mark.parametrize("d_sae,block", [(300, 128), (512, 1024), (2048, 512), (1000, 1)])
def test_dictionary_coherence_matches_jax(d_sae, block):
    rng = np.random.default_rng(d_sae + block)
    w = rng.normal(size=(d_sae, 24)).astype(np.float32) * rng.uniform(0.5, 2.0, size=(d_sae, 1)).astype(np.float32)
    w[7] = -2.5 * w[3]  # an exactly (anti-)parallel pair
    want = jtrain.dictionary_coherence(jnp.asarray(w), block)
    got = train.dictionary_coherence(torch.from_numpy(w), block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=0)
