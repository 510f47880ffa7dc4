"""matmul_precision "high" in the port (saev_tpu_torch/nn/modeling.py) against
the JAX package's HIGH, and its card route modelled on the CPU.

- On the CPU "high" is an f32 product, as JAX-CPU's HIGH: `matmul` and
  `_linear_bias`, forward and grads, bit for bit "highest"'s.
- The card's route (bf16x3: `_split_bf16`, `_mm_bf16x3`), forced on the CPU
  by patching `modeling._bf16_operands` so each of its three products takes
  `_mm_bf16`'s plain version: `matmul` (2-D and batched 3-D) and
  `_linear_bias`, forward and both grads, within rel-norm 3e-5 of the f64
  product and at least 50x closer to it than "default" on the same Gaussian
  operands; the split is exact (hi = bf16(a), a - hi exact in f32, and
  |a - hi - lo| <= 2^-8 |a - hi|, lo's half ulp).
- A "high" train step (TopK 8, Matryoshka 4, Adam; warm-up, AuxK dense and
  subspace with 1/16 of the latents dead) against JAX-CPU's
  `matmul_precision="high"` step from one sweep state: every stat within
  rtol 1e-5, l0 and n_dead equal.
- `encode`, `decode` and both AuxK forms take "high": on the CPU they give
  "highest"'s bits; on the card's route their outputs lie within 3e-5 of
  "highest"'s, and the step reaches K6 and K5 (`ops.exact_kth_value`,
  `ops.exact_kth_value_masked`) and neither K1 nor the Matryoshka kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saev_tpu.framework import train as jtrain
from saev_tpu.nn import modeling as jmod
from saev_tpu.nn import objectives as jobj
from saev_tpu_torch import ops
from saev_tpu_torch.framework import train
from saev_tpu_torch.nn import modeling, objectives
from saev_tpu_torch.ops import matryoshka as tmat

HIGH_REL = 3e-5  # bf16x3 against f64: ~2^-16 of each operand, f32 sums
GAIN = 50  # at least this much closer to f64 than "default"


def rel_norm(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture
def card_route(monkeypatch):
    monkeypatch.setattr(modeling, "_bf16_operands", lambda t: True)


def _gauss(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _matmul_grads(a, b, g, precision):
    at, bt = (torch.from_numpy(t.copy()).requires_grad_(True) for t in (a, b))
    out = modeling.matmul(at, bt, precision)
    out.backward(torch.from_numpy(g))
    return out.detach(), at.grad, bt.grad


def _linear_bias_grads(x, w, b, dh, precision):
    leaves = [torch.from_numpy(t.copy()).requires_grad_(True) for t in (x, w, b)]
    out = modeling._linear_bias(*leaves, precision)
    out.backward(torch.from_numpy(dh))
    return (out.detach(),) + tuple(t.grad for t in leaves)


@pytest.mark.parametrize("batched", [False, True])
def test_high_is_highest_on_the_cpu(batched):
    rng = np.random.default_rng(0)
    lead = (3,) if batched else ()
    a, b, g = _gauss(rng, *lead, 48, 40), _gauss(rng, *lead, 40, 96), _gauss(rng, *lead, 48, 96)
    for got, want in zip(_matmul_grads(a, b, g, "high"), _matmul_grads(a, b, g, "highest")):
        assert torch.equal(got, want)
    x, w, bias, dh = _gauss(rng, 48, 40), _gauss(rng, 40, 96), _gauss(rng, 96), _gauss(rng, 48, 96)
    for got, want in zip(_linear_bias_grads(x, w, bias, dh, "high"), _linear_bias_grads(x, w, bias, dh, "highest")):
        assert torch.equal(got, want)


def test_bf16x3_split_is_exact():
    rng = np.random.default_rng(1)
    a = np.concatenate([_gauss(rng, 4096), _gauss(rng, 4096, scale=1e-3), _gauss(rng, 4096, scale=1e4)])
    hi, lo = modeling._split_bf16(torch.from_numpy(a))
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi, torch.from_numpy(a).to(torch.bfloat16))
    a64, hi64, lo64 = a.astype(np.float64), hi.double().numpy(), lo.double().numpy()
    # a - hi is exact in f32, and lo is it rounded to bf16 to nearest.
    np.testing.assert_array_equal((torch.from_numpy(a) - hi.float()).double().numpy(), a64 - hi64)
    assert np.all(np.abs(a64 - hi64 - lo64) <= 2.0**-8 * np.abs(a64 - hi64))
    assert rel_norm(hi64 + lo64, a64) <= 2.0**-16


@pytest.mark.parametrize("batched", [False, True])
def test_high_card_route_matmul(card_route, batched):
    rng = np.random.default_rng(2)
    lead = (3,) if batched else ()
    a, b, g = _gauss(rng, *lead, 64, 256), _gauss(rng, *lead, 256, 128), _gauss(rng, *lead, 64, 128)
    a64, b64, g64 = (t.astype(np.float64) for t in (a, b, g))
    exact = (a64 @ b64, g64 @ np.swapaxes(b64, -1, -2), np.swapaxes(a64, -1, -2) @ g64)
    high, default = _matmul_grads(a, b, g, "high"), _matmul_grads(a, b, g, "default")
    for what, h, d, e in zip(("out", "da", "db"), high, default, exact):
        r_high, r_default = rel_norm(h.numpy(), e), rel_norm(d.numpy(), e)
        assert r_high <= HIGH_REL, (what, r_high)
        assert r_default >= GAIN * r_high, (what, r_high, r_default)


def test_high_card_route_linear_bias(card_route):
    rng = np.random.default_rng(3)
    x, w, bias, dh = _gauss(rng, 96, 64), _gauss(rng, 64, 512, scale=0.25), _gauss(rng, 512), _gauss(rng, 96, 512)
    x64, w64, dh64 = (t.astype(np.float64) for t in (x, w, dh))
    exact = (x64 @ w64 + bias, dh64 @ w64.T, x64.T @ dh64, dh64.sum(axis=0))
    high = _linear_bias_grads(x, w, bias, dh, "high")
    default = _linear_bias_grads(x, w, bias, dh, "default")
    for what, h, d, e in zip(("h", "dx", "dW", "db"), high, default, exact):
        r_high, r_default = rel_norm(h.numpy(), e), rel_norm(d.numpy(), e)
        assert r_high <= HIGH_REL, (what, r_high)
        assert r_default >= GAIN * r_high, (what, r_high, r_default)


D_MODEL, D_SAE, BATCH, K, J, N_SAE, N_STEPS, K_AUX, CAP = 64, 2048, 64, 8, 4, 2, 3, 64, 128
VARIANTS = {"warm-up": (0, dict(aux_enabled=False)), "dense": (D_SAE // 16, {}),
            "subspace": (D_SAE // 16, dict(aux_subspace_cap=CAP))}


def _setup(n_dead):
    jcfg = jmod.SparseAutoencoderConfig(
        d_model=D_MODEL, d_sae=D_SAE, activation=jmod.TopK(top_k=K, aux=jmod.AuxK(k_aux=K_AUX))
    )
    inits = [jmod.init(jcfg, key) for key in jax.random.split(jax.random.key(1), N_SAE)]
    stack = lambda trees: jax.tree.map(lambda *xs: jnp.stack(xs), *trees)  # noqa: E731
    params = stack([p for p, _ in inits])
    rng = np.random.default_rng(4)
    b_enc = (rng.normal(size=(N_SAE, D_SAE)) * 0.05).astype(np.float32)
    toks = np.zeros((N_SAE, D_SAE), np.int32)
    b_enc[:, :n_dead] = -1e6
    toks[:, :n_dead] = 1 << 30
    params["b_enc"] = jnp.asarray(b_enc)
    ts = jtrain.SweepState(params=params, sae_state=stack([s for _, s in inits]),
                           obj_state={"toks_since_active": jnp.asarray(toks)},
                           opt_state=jtrain._adam_init(params), step=jnp.zeros((), jnp.int32))
    hp = {"lr": np.asarray([1e-3, 3e-3], np.float32), "n_lr_warmup": np.ones(N_SAE, np.float32),
          "grad_clip": np.ones(N_SAE, np.float32), "sparsity_coeff": np.zeros(N_SAE, np.float32),
          "aux_alpha": np.asarray([1 / 32, 1 / 8], np.float32), "momentum": np.zeros(N_SAE, np.float32)}
    xs = [rng.normal(size=(BATCH, D_MODEL)).astype(np.float32) for _ in range(N_STEPS)]
    prefixes = np.stack([jobj.sample_prefixes(D_SAE, J, rng=rng) for _ in range(N_SAE)])
    cfg = modeling.SparseAutoencoderConfig(
        d_model=D_MODEL, d_sae=D_SAE, activation=modeling.TopK(top_k=K, aux=modeling.AuxK(k_aux=K_AUX))
    )
    return jcfg, cfg, ts, jax.tree.map(np.array, ts), hp, xs, prefixes


@pytest.mark.parametrize("variant", VARIANTS)
def test_high_train_step_matches_jax(variant):
    n_dead, kw = VARIANTS[variant]
    jcfg, cfg, jts, ts_np, hp, xs, prefixes = _setup(n_dead)
    jstep = jtrain.make_train_step(jcfg, jobj.Matryoshka(n_prefixes=J), n_steps=10, matmul_precision="high", **kw)
    step = train.make_train_step(cfg, objectives.Matryoshka(n_prefixes=J), n_steps=10, matmul_precision="high", **kw)
    ts = train.sweep_state_from_numpy(ts_np, "cpu")
    hp_t = {k: torch.from_numpy(v) for k, v in hp.items()}
    for x in xs:
        jts, jstats = jstep(jts, jnp.asarray(x), jnp.asarray(prefixes), {k: jnp.asarray(v) for k, v in hp.items()})
        ts, stats = step(ts, torch.from_numpy(x), torch.from_numpy(prefixes), hp_t)
        assert set(stats) == set(jstats)
        for k in jstats:
            np.testing.assert_allclose(stats[k].numpy(), np.asarray(jstats[k]), rtol=1e-5, atol=0, err_msg=k)
        for k in ("l0", "n_dead"):
            np.testing.assert_array_equal(stats[k].numpy(), np.asarray(jstats[k]), err_msg=k)
    assert stats["n_dead"].tolist() == [n_dead] * N_SAE
    assert bool((stats["aux"] > 0).all()) == (n_dead > 0 and variant != "warm-up")


def _model_inputs(seed=5):
    rng = np.random.default_rng(seed)
    params = {"W_enc": _gauss(rng, D_MODEL, D_SAE, scale=0.25), "b_enc": _gauss(rng, D_SAE, scale=0.1),
              "W_dec": _gauss(rng, D_SAE, D_MODEL, scale=0.25), "b_dec": _gauss(rng, D_MODEL, scale=0.1)}
    x = torch.from_numpy(_gauss(rng, BATCH, D_MODEL))
    cfg = modeling.SparseAutoencoderConfig(
        d_model=D_MODEL, d_sae=D_SAE, activation=modeling.TopK(top_k=K, aux=modeling.AuxK(k_aux=K_AUX))
    )
    toks = torch.zeros(D_SAE, dtype=torch.int32)
    toks[:100] = 1 << 30
    return cfg, modeling.params_from_numpy(params, "cpu"), x, toks


def _forms(cfg, p, x, toks, precision):
    """encode's h, the multi-prefix decode, and AuxK dense and subspace."""
    enc, _ = modeling.encode(cfg, p, {}, x, training=True, precision=precision)
    prefixes = torch.tensor([5, 700, 1024, D_SAE])
    x_hats = modeling.decode(cfg, p, enc.f_x, prefixes, precision=precision)
    xhat = x_hats[:, -1, :]
    dead = toks >= 1000
    aux = objectives._aux_loss(cfg.activation.aux, cfg, p, x, enc.h_x, xhat, dead, precision=precision)
    sub = objectives._aux_loss_subspace(cfg.activation.aux, cfg, p, x, xhat, toks, 1000, CAP, precision=precision)
    return enc.h_x, x_hats, aux, sub


def test_encode_decode_and_aux_take_high(monkeypatch):
    cfg, p, x, toks = _model_inputs()
    highest = _forms(cfg, p, x, toks, "highest")
    for got, want in zip(_forms(cfg, p, x, toks, "high"), highest):
        assert torch.equal(got, want)
    monkeypatch.setattr(modeling, "_bf16_operands", lambda t: True)
    high, default = _forms(cfg, p, x, toks, "high"), _forms(cfg, p, x, toks, "default")
    for what, h, d, want in zip(("h", "x_hats", "aux", "aux subspace"), high, default, highest):
        r_high, r_default = rel_norm(h.detach().numpy(), want), rel_norm(d.detach().numpy(), want)
        assert r_high <= HIGH_REL, (what, r_high)
        assert r_default > r_high, (what, r_high, r_default)
    assert float(high[2]) > 0 and float(high[3]) > 0


def test_high_step_reaches_k6_and_k5_only(monkeypatch):
    """On the card's route with the kernel path on, the "high" step's TopK
    threshold is K6's wrapper and AuxK's K5's; K1 (`ops.topk_stats`) and the
    Matryoshka kernels (`prefix_mse`) do not run. "default" takes them."""
    cfg, _, x, _ = _model_inputs()
    obj = objectives.Matryoshka(n_prefixes=J)
    monkeypatch.setattr(modeling, "_bf16_operands", lambda t: True)
    monkeypatch.setattr(tmat, "_use_kernels", lambda t: True)
    calls = []
    for mod, name in ((ops, "exact_kth_value"), (ops, "exact_kth_value_masked"), (ops, "topk_stats"),
                      (tmat, "prefix_mse")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _real=real, _name=name, **k: calls.append(_name) or _real(*a, **k))
    hp = {"lr": torch.full((2,), 1e-3), "n_lr_warmup": torch.ones(2), "grad_clip": torch.ones(2),
          "sparsity_coeff": torch.zeros(2), "aux_alpha": torch.full((2,), 1 / 32)}
    pf = torch.from_numpy(np.stack([objectives.sample_prefixes(D_SAE, J, rng=np.random.default_rng(i))
                                    for i in range(2)]))
    for precision, want in (("high", ["exact_kth_value", "exact_kth_value_masked"] * 2),
                            ("default", ["topk_stats", "prefix_mse", "exact_kth_value_masked"] * 2)):
        ts = train.init_sweep_state(cfg, 2, torch.Generator().manual_seed(0), device="cpu")
        ts.obj_state["toks_since_active"][:, :100] = 1 << 30
        ts.params["b_enc"][:, :100] = -1e6
        calls.clear()
        _, stats = train.make_train_step(cfg, obj, 10, matmul_precision=precision)(ts, x, pf, hp)
        assert calls == want, (precision, calls)
        assert stats["n_dead"].tolist() == [100, 100] and bool(torch.isfinite(stats["loss"]).all())
