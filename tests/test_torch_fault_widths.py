"""Fault ROADMAP §3.6: the shapes the card refused and the reference trains,
d_sae above 32768 and more than 64 Matryoshka prefixes, on the card's route
forced on the CPU (the train step's bf16 products through
`modeling._bf16_operands`, the Matryoshka kernel path through
`matryoshka._use_kernels`; the kernel wrappers take their plain versions on
a CPU tensor), against the JAX package's `matryoshka_loss` on the CPU (XLA
path, f32): the loss terms within 1e-2 (bf16 against f32, the gate of
scripts/check_tpu_kernels.py:180), L0 equal. The inputs are the review's:
d_sae 65536 at d_model 16, k 8, batch 8, 10 prefixes; and d_sae 2048 with
65 prefixes.

Also the prefix-MSE's kernel path at 65 and 130 cuts against the JAX op
(XLA path; loss rel 1e-3, gradients rel-norm 1e-2), with every cut reaching
the three wrappers in one call each, and the wrappers' shape check taking
any number of cuts the kernels' shared-memory tables hold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saev_tpu.nn import modeling as jmod
from saev_tpu.nn import objectives as jobj
from saev_tpu.ops import matryoshka as jmat
from saev_tpu_torch.nn import modeling, objectives
from saev_tpu_torch.ops import cuda_matryoshka as cm
from saev_tpu_torch.ops import matryoshka as tmat


@pytest.fixture
def card_route(monkeypatch):
    monkeypatch.setattr(modeling, "_bf16_operands", lambda t: True)
    monkeypatch.setattr(tmat, "_use_kernels", lambda t: True)


def _loss_both(d_sae: int, n_prefixes: int, seed: int):
    d_model, k, batch = 16, 8, 8
    rng = np.random.default_rng(seed)
    params = {
        "W_enc": (rng.normal(size=(d_model, d_sae)) / np.sqrt(d_model)).astype(np.float32),
        "b_enc": (rng.normal(size=(d_sae,)) * 0.01).astype(np.float32),
        "W_dec": (rng.normal(size=(d_sae, d_model)) / np.sqrt(d_sae)).astype(np.float32),
        "b_dec": (rng.normal(size=(d_model,)) * 0.1).astype(np.float32),
    }
    x = rng.normal(size=(batch, d_model)).astype(np.float32)
    prefixes = objectives.sample_prefixes(d_sae, n_prefixes, rng=rng)
    assert len(prefixes) == n_prefixes and prefixes[-1] == d_sae

    jcfg = jmod.SparseAutoencoderConfig(d_model=d_model, d_sae=d_sae, activation=jmod.TopK(top_k=k))
    jl, *_ = jobj.matryoshka_loss(
        jobj.Matryoshka(n_prefixes=n_prefixes), jcfg, {n: jnp.asarray(v) for n, v in params.items()},
        jmod.init_state(jcfg), jobj.init_state(jcfg), jnp.asarray(x), jnp.asarray(prefixes), training=True,
    )
    cfg = modeling.SparseAutoencoderConfig(d_model=d_model, d_sae=d_sae, activation=modeling.TopK(top_k=k))
    tl, *_ = objectives.matryoshka_loss(
        objectives.Matryoshka(n_prefixes=n_prefixes), cfg, modeling.params_from_numpy(params, "cpu"),
        modeling.init_state(cfg, "cpu"), objectives.init_state(cfg, "cpu"), torch.from_numpy(x),
        torch.from_numpy(prefixes), training=True, precision="default",
    )
    return tl, jl


@pytest.mark.parametrize("d_sae,n_prefixes", [(65536, 10), (2048, 65)], ids=["d_sae-65536", "65-prefixes"])
def test_matryoshka_loss_at_the_refused_shapes(card_route, d_sae, n_prefixes):
    tl, jl = _loss_both(d_sae, n_prefixes, seed=d_sae + n_prefixes)
    for name in ("mse", "l1", "aux"):
        got, want = float(getattr(tl, name)), float(np.asarray(getattr(jl, name)))
        assert abs(got - want) <= 1e-2 * max(abs(want), 1e-12), (name, got, want)
    assert float(tl.l0) == float(np.asarray(jl.l0)) == 8.0
    assert np.isfinite(float(tl.loss))


@pytest.mark.parametrize("j", [65, 130])
def test_prefix_mse_kernel_path_takes_many_cuts(monkeypatch, j):
    """J cuts on the kernel path, several in one 16-lane step and in one
    group: each wrapper is called once with all J, and the loss and
    gradients are the JAX op's."""
    monkeypatch.setattr(tmat, "_use_kernels", lambda t: True)
    seen = []
    for name in ("grouped_prefix_err", "grouped_matmul_dgrad", "grouped_matmul_wgrad"):
        real = getattr(cm, name)

        def spy(*args, real=real, name=name, **kwargs):
            seen.append((name, int(args[-2].shape[0])))  # m, (J,)
            return real(*args, **kwargs)

        monkeypatch.setattr(cm, name, spy)
    rng = np.random.default_rng(j)
    b, s, d, g = 64, 2048, 32, 512
    w = (rng.normal(size=(s, d)) / np.sqrt(d)).astype(np.float32)
    b_dec = (rng.normal(size=(d,)) * 0.1).astype(np.float32)
    f = (rng.normal(size=(b, s)) * (rng.random((b, s)) < 0.1)).astype(np.float32)
    x = rng.normal(size=(b, d)).astype(np.float32)
    first = np.arange(1, 21)  # twenty cuts in the first 16-lane steps
    rest = rng.choice(np.arange(21, s), size=j - 21, replace=False)
    p = np.sort(np.concatenate([first, rest, [s]])).astype(np.int32)
    assert len(p) == j

    tw, tb = torch.from_numpy(w).requires_grad_(True), torch.from_numpy(b_dec).requires_grad_(True)
    tf = torch.from_numpy(f).to(torch.bfloat16).requires_grad_(True)
    tl, _ = tmat.prefix_mse(tw, tb, tf, torch.from_numpy(x), torch.from_numpy(p), g)
    tl.backward()
    assert seen == [("grouped_prefix_err", j), ("grouped_matmul_dgrad", j), ("grouped_matmul_wgrad", j)]

    def jloss(w_, b_, f_):
        return jmat.prefix_mse(w_, b_, f_, jnp.asarray(x), jnp.asarray(p), g, None)[0]

    jl, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(jnp.asarray(w), jnp.asarray(b_dec), jnp.asarray(f))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-3)
    for got, want in zip((tw.grad, tb.grad, tf.grad), jgrads):
        got, want = got.float().numpy().astype(np.float64), np.asarray(want, np.float64)
        assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)


def test_check_cuts_takes_what_the_tables_hold():
    for j in (1, 64, 65, 130, cm.MAX_PREFIXES):
        cm._check_cuts(j, 128, 2048, 128, 1024)
    for j in (0, cm.MAX_PREFIXES + 1):
        with pytest.raises(ValueError, match="prefixes"):
            cm._check_cuts(j, 128, 2048, 128, 1024)
