"""Relu and BatchTopK in the port (saev_tpu_torch) against the JAX package, on
the CPU, from the same numpy inputs:

- `ops.batch_global_kth_value` bit for bit with JAX's, on its exact and its
  per-row candidates route, on rows with ties, at k_total >= B * S, and with
  a row that holds more than m_row of the global winners (where both routes
  of both packages keep more than k_total);
- `modeling.encode` for Relu and BatchTopK, in train and eval mode, at
  "highest": f to rel-norm 1e-6, BatchTopK's moved EMA threshold equal to
  JAX's, and unchanged where no kept value is positive; JumpReLU at a
  threshold <= 0 is ReLU;
- the train step (`make_train_step`) on a 2-SAE sweep for 3 steps against
  JAX's, from one JAX sweep state, at "highest" and "default" (both f32 on
  the CPU; "highest" takes the decode path, "default" the fused prefix
  MSE): Relu with per-SAE L1 coefficients (4e-4, 1e-3), and BatchTopK with
  AuxK (k_aux 64; 100 and 60 latents planted dead) and per-SAE momenta
  (0.1, 0.3). Held as tests/test_torch_train_step.py holds TopK: every stat
  to rel 1e-4, params and Adam moments to atol 1e-5, the dead-latent
  counters and n_dead exact, and here also BatchTopK's threshold to rel 1e-4
  after each step. The threshold check pins that the step returns the
  loss's moved `sae_state` (it kept the old state before BatchTopK ran).

The encoder's f32 products of torch and XLA differ in their last bits (about
1e-6 of a pre-activation against the float64 product at d_model 64). A
latent's selection could differ between the packages where a pre-activation
lies that close to its cut (0 for Relu, the batch's k * B-th value for
BatchTopK), and among the 131k Relu pre-activations of a step some do.
Before each step the test checks that both packages' encoder products keep
the same latents (`_selections`), which they do on these inputs, so the
comparison of the step's outputs is not one of two different selections.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saev_tpu.framework import train as jtrain
from saev_tpu.nn import modeling as jmod
from saev_tpu.nn import objectives as jobj
from saev_tpu.ops import topk as jtopk
from saev_tpu_torch import ops
from saev_tpu_torch.framework import train
from saev_tpu_torch.nn import modeling, objectives

D_MODEL, D_SAE, BATCH, K, J, N_SAE, N_STEPS = 64, 2048, 64, 8, 4, 2, 3
K_AUX, N_DEAD = 64, (100, 60)


def rel_norm(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# --- the batch-global k-th value -------------------------------------------


def _kth_inputs(name):
    rng = np.random.default_rng(1)
    h = rng.normal(size=(32, 300)).astype(np.float32)
    if name == "ties":
        h = np.round(h * 4) / 4  # a few dozen distinct values: ties everywhere
    elif name == "hot-row":
        h[5] += 10.0  # row 5 holds every global winner: more than m_row
    return h


KTH_CASES = {
    "candidates": ("gauss", 32 * 8, False),
    "exact": ("gauss", 32 * 8, True),
    "ties": ("ties", 32 * 8, False),
    "ties-exact": ("ties", 32 * 8, True),
    "k-total-past-the-batch": ("gauss", 32 * 300 + 7, False),
    "m-row-past-the-row": ("gauss", 32 * 80, False),  # m_row = 4 * 80 > 300: the flat route
    "hot-row": ("hot-row", 32 * 8, False),
    "hot-row-exact": ("hot-row", 32 * 8, True),
}


@pytest.mark.parametrize("case", KTH_CASES.values(), ids=KTH_CASES.keys())
def test_batch_global_kth_value_matches_jax(case):
    name, k_total, exact = case
    h = _kth_inputs(name)
    got = ops.batch_global_kth_value(torch.from_numpy(h), k_total, exact=exact)
    want = np.asarray(jtopk.batch_global_kth_value(jnp.asarray(h), k_total, exact=exact))
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    if name == "hot-row":
        # The candidates route keeps more than k_total: m_row = 32 from row 5.
        exact_kth = np.sort(h.reshape(-1))[::-1][k_total - 1]
        assert (float(got) < exact_kth) != exact and (h >= float(got)).sum() >= k_total


# --- encode ----------------------------------------------------------------


def _params(rng, d_model=32, d_sae=512, b_shift=0.0):
    p = {
        "W_enc": rng.normal(size=(d_model, d_sae)) / np.sqrt(d_model),
        "b_enc": rng.normal(size=d_sae) * 0.1 + b_shift,
        "W_dec": rng.normal(size=(d_sae, d_model)),
        "b_dec": np.zeros(d_model),
    }
    return {k: v.astype(np.float32) for k, v in p.items()}


ENCODE_CASES = {
    "relu-train": ("relu", True, 0.0, 0.0),
    "relu-eval": ("relu", False, 0.0, 0.0),
    "batch-topk-train": ("batch-topk", True, 0.0, 0.25),
    "batch-topk-train-no-positive": ("batch-topk", True, -50.0, 0.25),
    "batch-topk-eval": ("batch-topk", False, 0.0, 0.25),
    "batch-topk-eval-negative-threshold": ("batch-topk", False, 0.0, -0.5),
}


@pytest.mark.parametrize("case", ENCODE_CASES.values(), ids=ENCODE_CASES.keys())
def test_encode_matches_jax(case):
    name, training, b_shift, threshold = case
    rng = np.random.default_rng(2)
    acts = {"relu": (modeling.Relu(), jmod.Relu()),
            "batch-topk": (modeling.BatchTopK(top_k=8), jmod.BatchTopK(top_k=8))}[name]
    cfg = modeling.SparseAutoencoderConfig(d_model=32, d_sae=512, activation=acts[0])
    jcfg = jmod.SparseAutoencoderConfig(d_model=32, d_sae=512, activation=acts[1])
    p = _params(rng, b_shift=b_shift)
    x = rng.normal(size=(64, 32)).astype(np.float32)
    enc, state = modeling.encode(
        cfg, {k: torch.from_numpy(v) for k, v in p.items()}, {"threshold": torch.tensor(threshold)},
        torch.from_numpy(x), training=training, momentum=0.3,
    )
    jenc, jstate = jmod.encode(
        jcfg, {k: jnp.asarray(v) for k, v in p.items()}, {"threshold": jnp.float32(threshold)}, jnp.asarray(x),
        training=training, momentum=0.3, precision=jax.lax.Precision.HIGHEST,
    )
    f, jf = enc.f_x.numpy(), np.asarray(jenc.f_x)
    np.testing.assert_array_equal(f != 0, jf != 0)
    assert rel_norm(f, jf) <= 1e-6 and rel_norm(enc.h_x.numpy(), np.asarray(jenc.h_x)) <= 1e-6
    np.testing.assert_array_equal(state["threshold"].numpy().view(np.int32),
                                  np.asarray(jstate["threshold"]).view(np.int32))
    kept = f[f != 0]
    if name == "batch-topk" and training:
        assert (f != 0).sum() >= 8 * 64
        if b_shift < 0:
            assert (kept < 0).all() and float(state["threshold"]) == threshold  # unchanged
        else:
            want = np.float32(0.7) * np.float32(threshold) + np.float32(0.3) * kept[kept > 0].min()
            np.testing.assert_allclose(float(state["threshold"]), want, rtol=1e-6)
    elif name == "batch-topk":
        assert float(kept.min()) > max(threshold, 0.0)
        if threshold <= 0:
            np.testing.assert_array_equal(f, np.maximum(enc.h_x.numpy(), 0))
    else:
        assert (kept > 0).all() and float(state["threshold"]) == threshold


# --- the train step ---------------------------------------------------------


def _activation(mod, name):
    if name == "relu":
        return mod.Relu()
    return mod.BatchTopK(top_k=K, aux=mod.AuxK(k_aux=K_AUX))


def _setup(name):
    jcfg = jmod.SparseAutoencoderConfig(d_model=D_MODEL, d_sae=D_SAE, activation=_activation(jmod, name))
    inits = [jmod.init(jcfg, key) for key in jax.random.split(jax.random.key(0), N_SAE)]
    stack = lambda trees: jax.tree.map(lambda *xs: jnp.stack(xs), *trees)  # noqa: E731
    params = stack([p for p, _ in inits])
    rng = np.random.default_rng(0)
    b_enc = rng.normal(size=(N_SAE, D_SAE)).astype(np.float32) * 0.05
    toks = np.zeros((N_SAE, D_SAE), np.int32)
    if name == "batch-topk":
        for i, n in enumerate(N_DEAD):  # dead latents pinned as bench.py pins them
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
        "sparsity_coeff": np.asarray([4e-4, 1e-3] if name == "relu" else [0.0, 0.0], np.float32),
        "aux_alpha": np.asarray([0.0, 0.0] if name == "relu" else [1 / 32, 1 / 8], np.float32),
        "momentum": np.asarray([0.0, 0.0] if name == "relu" else [0.1, 0.3], np.float32),
    }
    xs = [rng.normal(size=(BATCH, D_MODEL)).astype(np.float32) for _ in range(N_STEPS)]
    prefixes = np.stack([jobj.sample_prefixes(D_SAE, J, rng=rng) for _ in range(N_SAE)])
    cfg = modeling.SparseAutoencoderConfig(d_model=D_MODEL, d_sae=D_SAE, activation=_activation(modeling, name))
    return jcfg, cfg, ts, jax.tree.map(np.array, ts), hp, xs, prefixes


def _selections(name, ts, x) -> tuple[np.ndarray, np.ndarray]:
    """The latents each package's f32 encoder product keeps (torch's, and
    XLA's at HIGHEST) on the state the step reads: its W_enc and b_enc, which
    the step does not normalize."""
    kept = []
    for i in range(N_SAE):
        w, b = ts.params["W_enc"][i].numpy(), ts.params["b_enc"][i].numpy()
        with torch.no_grad():
            h_t = modeling._linear_bias(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), "highest")
        h_j = jnp.dot(x, w, precision=jax.lax.Precision.HIGHEST) + b
        if name == "relu":
            kept.append((h_t.numpy() > 0, np.asarray(h_j) > 0))
        else:
            kth_t = ops.batch_global_kth_value(h_t, K * BATCH)
            kth_j = jtopk.batch_global_kth_value(h_j, K * BATCH)
            kept.append(((h_t >= kth_t).numpy(), np.asarray(h_j >= kth_j)))
    return np.stack([t for t, _ in kept]), np.stack([j for _, j in kept])


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("name", ["relu", "batch-topk"])
def test_train_step_matches_jax(name, precision):
    jcfg, cfg, jts, ts_np, hp, xs, prefixes = _setup(name)
    variant = dict(optim="adam", matmul_precision=precision)
    jstep = jtrain.make_train_step(jcfg, jobj.Matryoshka(n_prefixes=J), n_steps=10, **variant)
    step = train.make_train_step(cfg, objectives.Matryoshka(n_prefixes=J), n_steps=10, **variant)
    ts = train.sweep_state_from_numpy(ts_np, "cpu")
    hp_t = {k: torch.from_numpy(v) for k, v in hp.items()}
    thresholds = []
    for x in xs:
        mine, theirs = _selections(name, ts, x)
        np.testing.assert_array_equal(mine, theirs)  # module doc
        jts, jstats = jstep(jts, jnp.asarray(x), jnp.asarray(prefixes), {k: jnp.asarray(v) for k, v in hp.items()})
        ts, stats = step(ts, torch.from_numpy(x), torch.from_numpy(prefixes), hp_t)
        assert set(stats) == set(jstats)
        for k in jstats:
            np.testing.assert_allclose(stats[k].numpy(), np.asarray(jstats[k]), rtol=1e-4, atol=0, err_msg=k)
        for k in ts.params:
            np.testing.assert_allclose(ts.params[k].numpy(), np.asarray(jts.params[k]), rtol=0, atol=1e-5,
                                       err_msg=k)
            for mom in ("m", "v"):
                np.testing.assert_allclose(ts.opt_state[mom][k].numpy(), np.asarray(jts.opt_state[mom][k]),
                                           rtol=0, atol=1e-5, err_msg=f"{mom}[{k}]")
        np.testing.assert_array_equal(ts.obj_state["toks_since_active"].numpy(),
                                      np.asarray(jts.obj_state["toks_since_active"]))
        np.testing.assert_allclose(ts.sae_state["threshold"].numpy(), np.asarray(jts.sae_state["threshold"]),
                                   rtol=1e-4, atol=0)
        thresholds.append(ts.sae_state["threshold"].numpy())
        assert int(ts.step) == int(jts.step)
    if name == "relu":
        assert (stats["sparsity"] > 0).all() and (stats["aux"] == 0).all()
        assert float(stats["sparsity"][1] / stats["l1"][1]) == pytest.approx(1e-3, rel=1e-6)
        assert all((t == 0).all() for t in thresholds)
    else:
        assert stats["n_dead"].tolist() == list(N_DEAD) and (stats["aux"] > 0).all()
        # Mean L0 is k: the batch keeps its k * B largest, ties aside.
        assert all(K <= v <= K + 4 / BATCH for v in stats["l0"].tolist())
        # The threshold moved every step, the second SAE's (momentum 0.3) faster.
        assert all((t > 0).all() for t in thresholds) and not np.array_equal(thresholds[0], thresholds[1])
        assert thresholds[0][1] > thresholds[0][0]
