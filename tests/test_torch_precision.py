"""The port's matmul precisions (saev_tpu_torch/nn/modeling.py `matmul`,
`_linear_bias`) against the JAX package.

- The card's "default" route (bf16 operands, f32 accumulation and result),
  forced on the CPU through its plain version by patching
  `modeling._bf16_operands`, against the TPU's DEFAULT algebra written in
  JAX on the CPU as jnp.dot(bf16(a), bf16(b), preferred_element_type=f32):
  the encoder's forward, dW, db and dx in the layout of `_linear_bias` and
  `_linear_bias_bwd`, the dense AuxK decode and its backward, and the AuxK
  losses, dense and subspace, built from those products. Tolerance: 1e-6
  relative (norm of the difference over the reference's), which allows only
  for summation order: the products of two bf16 values are exact in f32.
- "default" on the CPU, unpatched, is an f32 product, as JAX-CPU's DEFAULT.
- `encode`, `decode` and `make_metrics_fn` run at "highest" unless told.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saev_tpu.nn import modeling as jmod
from saev_tpu.ops import topk as jtopk
from saev_tpu_torch.framework import train
from saev_tpu_torch.nn import modeling, objectives

BF16, F32 = jnp.bfloat16, jnp.float32
REL = 1e-6


def jdot(a, b):
    """The TPU's DEFAULT product: bf16 operands, f32 accumulation."""
    return jnp.dot(jnp.asarray(a).astype(BF16), jnp.asarray(b).astype(BF16), preferred_element_type=F32)


def assert_rel(got, want, rel: float = REL, what: str = "") -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert err <= rel, f"{what}: rel-norm {err:.3g} > {rel}"


@pytest.fixture
def card_route(monkeypatch):
    """The card's "default" route on the CPU: bf16 operands through
    `_mm_bf16`'s plain version."""
    monkeypatch.setattr(modeling, "_bf16_operands", lambda t: True)


def _operands(seed: int, b: int = 48, d: int = 40, s: int = 96):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, d)).astype(np.float32)
    w = (rng.normal(size=(d, s)) / 4).astype(np.float32)
    bias = rng.normal(size=(s,)).astype(np.float32)
    dh = rng.normal(size=(b, s)).astype(np.float32)
    return x, w, bias, dh


def _torch_linear_bias(x, w, bias, dh, precision: str):
    leaves = [torch.from_numpy(t.copy()).requires_grad_(True) for t in (x, w, bias)]
    h = modeling._linear_bias(*leaves, precision)
    h.backward(torch.from_numpy(dh))
    return h.detach().numpy(), *(t.grad.numpy() for t in leaves)


@pytest.mark.parametrize("seed,d", [(0, 40), (1, 64), (2, 7)])
def test_encoder_card_route_matches_tpu_default_algebra(card_route, seed, d):
    """h = bf16(x) @ bf16(W) + b, d[W; b] = bf16([x; 1])^T @ bf16(dh) and dx
    = bf16(dh) @ bf16(W)^T, all with f32 results (d 7: [x; 1] padded to 8)."""
    x, w, bias, dh = _operands(seed, d=d)
    h, dx, dw, db = _torch_linear_bias(x, w, bias, dh, "default")
    xa = np.concatenate([x, np.ones((x.shape[0], 1), np.float32)], axis=1)
    dwb = jax.lax.dot_general(jnp.asarray(xa).astype(BF16), jnp.asarray(dh).astype(BF16),
                              (((0,), (0,)), ((), ())), preferred_element_type=F32)
    want_dx = jax.lax.dot_general(jnp.asarray(dh).astype(BF16), jnp.asarray(w).astype(BF16),
                                  (((1,), (1,)), ((), ())), preferred_element_type=F32)
    assert_rel(h, jdot(x, w) + bias, what="h")
    assert_rel(dw, dwb[:-1], what="dW")
    assert_rel(db, dwb[-1], what="db")
    assert_rel(dx, want_dx, what="dx")
    # and not the f32 product: the operands were rounded
    with pytest.raises(AssertionError):
        assert_rel(h, x @ w + bias, rel=1e-4)


def test_encoder_default_on_cpu_is_jax_cpu_default():
    """Unpatched, "default" on a CPU tensor is the f32 product, as JAX-CPU's
    DEFAULT: forward and the three gradients against the JAX package's
    `_linear_bias` and its hand-written backward."""
    x, w, bias, dh = _operands(3)
    got = _torch_linear_bias(x, w, bias, dh, "default")
    prec = jmod.PRECISIONS["default"]
    h, vjp = jax.vjp(lambda a, b_, c: jmod._linear_bias(a, b_, c, prec), x, w, bias)
    for name, g, want in zip(("h", "dx", "dW", "db"), got, (h, *vjp(jnp.asarray(dh)))):
        assert_rel(g, want, what=name)
    np.testing.assert_array_equal(got[0], _torch_linear_bias(x, w, bias, dh, "highest")[0])


def test_matmul_card_route_matches_tpu_default_algebra(card_route):
    """The dense AuxK decode's product f @ W_dec and its backward: d f =
    bf16(g) @ bf16(W)^T, dW = bf16(f)^T @ bf16(g), f32 results, as the
    transpose of a DEFAULT dot on the TPU."""
    rng = np.random.default_rng(4)
    f = (rng.normal(size=(64, 256)) * (rng.random((64, 256)) < 0.1)).astype(np.float32)
    w = rng.normal(size=(256, 32)).astype(np.float32)
    g = rng.normal(size=(64, 32)).astype(np.float32)
    ft, wt = (torch.from_numpy(t.copy()).requires_grad_(True) for t in (f, w))
    out = modeling.matmul(ft, wt, "default")
    out.backward(torch.from_numpy(g))
    assert out.dtype == torch.float32
    assert_rel(out.detach(), jdot(f, w), what="f @ W")
    assert_rel(ft.grad, jdot(g, w.T), what="df")
    assert_rel(wt.grad, jdot(f.T, g), what="dW")


def test_precision_names_match_jax():
    """Every precision the JAX package names runs ("high" too, which raised
    before it was ported); an unknown name raises."""
    assert set(modeling.PRECISIONS) == set(jmod.PRECISIONS)
    assert jmod.PRECISIONS[modeling.MATMUL_PRECISION] == jmod.MATMUL_PRECISION
    a, b = torch.randn((4, 8), generator=torch.Generator().manual_seed(0)), torch.eye(8)
    for precision in modeling.PRECISIONS:
        assert torch.equal(modeling.matmul(a, b, precision), a), precision
        assert torch.equal(modeling._linear_bias(a, b, torch.zeros(8), precision), a), precision
    with pytest.raises(ValueError, match="Unknown matmul precision"):
        modeling.matmul(torch.zeros((2, 2)), torch.zeros((2, 2)), "bf16")


# --- AuxK at "default" ---

D_MODEL, D_SAE, BATCH, K_AUX, CAP, THRESHOLD = 32, 512, 64, 16, 128, 100


def _aux_inputs(seed: int = 5):
    """Dead latents by counter only (biases not pinned near -1e6, where the
    order of an f32 sum could move a value across a tie)."""
    rng = np.random.default_rng(seed)
    params = {
        "W_enc": (rng.normal(size=(D_MODEL, D_SAE)) / 4).astype(np.float32),
        "b_enc": (rng.normal(size=(D_SAE,)) * 0.1).astype(np.float32),
        "W_dec": (rng.normal(size=(D_SAE, D_MODEL)) / 4).astype(np.float32),
        "b_dec": (rng.normal(size=(D_MODEL,)) * 0.1).astype(np.float32),
    }
    x = rng.normal(size=(BATCH, D_MODEL)).astype(np.float32)
    xhat = (x + rng.normal(size=x.shape) * 0.3).astype(np.float32)
    toks = rng.integers(0, THRESHOLD, size=D_SAE).astype(np.int32)
    toks[rng.choice(D_SAE, 40, replace=False)] = 1 << 30
    return params, x, xhat, toks


def _jax_aux(params, x, xhat, toks, subspace: bool):
    """The AuxK loss of the JAX package (objectives.py:131-250) with its
    products written as the TPU's DEFAULT algebra."""
    p = {k: jnp.asarray(v) for k, v in params.items()}
    residual = jnp.asarray(x - xhat)
    t = jnp.asarray(toks)
    if subspace:
        idx = jax.lax.top_k(t, CAP)[1]
        dead = t[idx] >= THRESHOLD
        h = jdot(x, p["W_enc"][:, idx]) + p["b_enc"][idx]
        w_dec = p["W_dec"][idx]
    else:
        dead = t >= THRESHOLD
        h = jdot(x, p["W_enc"]) + p["b_enc"]
        w_dec = p["W_dec"]
    kth = jtopk.exact_kth_value_masked(h, dead, K_AUX)
    acts = jnp.where((h >= kth) & dead[None, :], h, 0.0)
    recon = jdot(acts, w_dec) + p["b_dec"]
    return float(jnp.mean((recon - residual) ** 2) / 32)


@pytest.mark.parametrize("subspace", [False, True], ids=["dense", "subspace"])
def test_aux_losses_card_route_match_tpu_default_algebra(card_route, subspace):
    params, x, xhat, toks = _aux_inputs()
    cfg = modeling.SparseAutoencoderConfig(
        d_model=D_MODEL, d_sae=D_SAE, activation=modeling.TopK(top_k=8, aux=modeling.AuxK(k_aux=K_AUX))
    )
    p = modeling.params_from_numpy(params, "cpu")
    xt, xh, tt = torch.from_numpy(x), torch.from_numpy(xhat), torch.from_numpy(toks)
    aux = cfg.activation.aux
    if subspace:
        got = objectives._aux_loss_subspace(aux, cfg, p, xt, xh, tt, THRESHOLD, CAP, precision="default")
    else:
        h = modeling._linear_bias(xt, p["W_enc"], p["b_enc"], "default")
        got = objectives._aux_loss(aux, cfg, p, xt, h, xh, tt >= THRESHOLD, precision="default")
    want = _jax_aux(params, x, xhat, toks, subspace)
    assert_rel(float(got), want, what="aux")
    f32 = objectives._aux_loss_subspace(aux, cfg, p, xt, xh, tt, THRESHOLD, CAP, precision="highest")
    assert abs(float(f32) - want) > 1e-6 * abs(want)  # the bf16 operands moved it


# --- defaults: "highest" outside the train step ---


def _small_cfg():
    return modeling.SparseAutoencoderConfig(d_model=D_MODEL, d_sae=D_SAE, activation=modeling.TopK(top_k=8))


def test_encode_and_decode_default_to_highest(monkeypatch):
    """With the card's route forced, `encode` and `decode` given no
    precision still compute the f32 products, bit for bit; at "default"
    they round."""
    params, x, _, _ = _aux_inputs(6)
    cfg, p, xt = _small_cfg(), modeling.params_from_numpy(params, "cpu"), torch.from_numpy(x)
    f32_enc, _ = modeling.encode(cfg, p, {}, xt, training=True)
    f32_dec = modeling.decode(cfg, p, f32_enc.f_x)
    monkeypatch.setattr(modeling, "_bf16_operands", lambda t: True)
    enc, _ = modeling.encode(cfg, p, {}, xt, training=True)
    assert torch.equal(enc.h_x, f32_enc.h_x)
    assert torch.equal(modeling.decode(cfg, p, enc.f_x), f32_dec)
    enc_d, _ = modeling.encode(cfg, p, {}, xt, training=True, precision="default")
    assert not torch.equal(enc_d.h_x, f32_enc.h_x)
    assert_rel(enc_d.h_x, jdot(x, params["W_enc"]) + params["b_enc"], what="encode at default")
    assert not torch.equal(modeling.decode(cfg, p, enc.f_x, precision="default"), f32_dec)


def test_metrics_fn_runs_at_highest(monkeypatch):
    cfg = _small_cfg()
    ts = train.init_sweep_state(cfg, 2, torch.Generator().manual_seed(0), device="cpu")
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(BATCH, D_MODEL)).astype(np.float32))
    metrics = train.make_metrics_fn(cfg)
    want = metrics(ts, x, None)
    monkeypatch.setattr(modeling, "_bf16_operands", lambda t: True)
    got = metrics(ts, x, None)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_train_step_card_route(monkeypatch):
    """The train step at "default" with the card's route forced: its encoder
    output is the bf16 algebra of its operands, and its loss and grad_norm
    stay within 1e-2 of the f32 step's (the card's gate against the CPU)."""
    cfg = modeling.SparseAutoencoderConfig(
        d_model=D_MODEL, d_sae=D_SAE, activation=modeling.TopK(top_k=8, aux=modeling.AuxK(k_aux=K_AUX))
    )
    obj = objectives.Matryoshka(n_prefixes=3)
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(BATCH, D_MODEL)).astype(np.float32))
    pf = torch.from_numpy(np.stack([objectives.sample_prefixes(D_SAE, 3, rng=rng) for _ in range(2)]))
    hp = {"lr": torch.full((2,), 1e-3), "n_lr_warmup": torch.ones(2), "grad_clip": torch.ones(2),
          "sparsity_coeff": torch.zeros(2), "aux_alpha": torch.full((2,), 1 / 32)}
    ts = train.init_sweep_state(cfg, 2, torch.Generator().manual_seed(1), device="cpu")
    ts.obj_state["toks_since_active"][:, :30] = 1 << 30
    stats = {}
    for cap in (None, CAP):
        step = train.make_train_step(cfg, obj, n_steps=10, aux_subspace_cap=cap)
        _, stats["f32"] = step(ts, x, pf, hp)
        seen = []
        real = modeling._linear_bias

        def spy(*args):
            out = real(*args)
            seen.append((args, out.detach()))
            return out

        with monkeypatch.context() as m:
            m.setattr(modeling, "_bf16_operands", lambda t: True)
            m.setattr(modeling, "_linear_bias", spy)
            _, stats["bf16"] = step(ts, x, pf, hp)
        assert len(seen) == 2  # one encoder a SAE
        for (xs, w, b, precision), h in seen:
            assert precision == "default"
            assert_rel(h, jdot(xs.detach().numpy(), w.detach().numpy()) + b.detach().numpy(), what="step encoder")
        for key in ("loss", "grad_norm", "mse", "aux"):
            rel = ((stats["bf16"][key] - stats["f32"][key]).abs() / stats["f32"][key].abs()).max()
            assert float(rel) <= 1e-2, (cap, key, float(rel))
        assert not torch.equal(stats["bf16"]["loss"], stats["f32"]["loss"])
        assert torch.equal(stats["bf16"]["n_dead"], stats["f32"]["n_dead"])


# ---------------------------------------------------------------------------
# "highest" under the caller's TF32 switch: the legacy `allow_tf32`,
# torch.set_float32_matmul_precision, or the per-backend `fp32_precision`
# (ROADMAP §3.10: torch refuses to read a precision that the two APIs set
# differently, and the products used to set it through the legacy one).
# ---------------------------------------------------------------------------


def _read(fn):
    try:
        return fn()
    except RuntimeError as err:
        return f"refused: {str(err)[:60]}"


def _precision_state() -> dict:
    """What each reader of the f32 matmul precision reads now (a refusal
    read as its message)."""
    state = {"matmul_precision": _read(torch.get_float32_matmul_precision),
             "allow_tf32": _read(lambda: torch.backends.cuda.matmul.allow_tf32)}
    if modeling._matmul_switches() is not None:
        state |= {"cuda.matmul": torch.backends.cuda.matmul.fp32_precision,
                  "mkldnn.matmul": torch.backends.mkldnn.matmul.fp32_precision}
    return state


def _set_switch(switch: str, value) -> None:
    if switch == "allow_tf32":
        torch.backends.cuda.matmul.allow_tf32 = value
    elif switch == "matmul_precision":
        torch.set_float32_matmul_precision(value)
    else:
        getattr(torch.backends, switch).matmul.fp32_precision = value


CALLER_SWITCHES = [("allow_tf32", True), ("allow_tf32", False), ("matmul_precision", "high"),
                   ("matmul_precision", "medium"), ("matmul_precision", "highest")]
if modeling._matmul_switches() is not None:
    CALLER_SWITCHES += [("cuda", "tf32"), ("cuda", "ieee"), ("mkldnn", "bf16"), ("mkldnn", "tf32")]


@pytest.fixture
def restore_precision():
    """The process's f32 matmul precision as it was before the test."""
    legacy = torch.get_float32_matmul_precision()
    switches = modeling._matmul_switches()
    prev = [s.fp32_precision for s in switches] if switches is not None else []
    yield
    torch.set_float32_matmul_precision(legacy)
    for s, p in zip(switches or (), prev):
        s.fp32_precision = p


@pytest.mark.parametrize("switch,value", CALLER_SWITCHES, ids=[f"{s}={v}" for s, v in CALLER_SWITCHES])
def test_f32_products_restore_the_callers_switch(restore_precision, switch, value):
    """Under each caller's switch, "highest" products (forward, backward and
    `_linear_bias`) are float32 with the per-backend switches at "ieee"
    inside, within 1e-6 rel-norm of the float64 product; after them every
    reader reads what it read before, a refusal included."""
    _set_switch(switch, value)
    before = _precision_state()
    rng = np.random.default_rng(5)
    a, b, g = (torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in ((64, 96), (96, 48), (64, 48)))
    inside = []
    real = torch.Tensor.__matmul__

    def spy(x, y):
        inside.append(_precision_state())
        return real(x, y)

    leaf = a.clone().requires_grad_(True)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(torch.Tensor, "__matmul__", spy)
        out = modeling.matmul(leaf, b, "highest")
        out.backward(g)
        lin = modeling._linear_bias(a, b, torch.zeros(48), "highest")
    assert _precision_state() == before
    assert len(inside) >= 3
    if modeling._matmul_switches() is not None:
        assert all((s["cuda.matmul"], s["mkldnn.matmul"]) == ("ieee", "ieee") for s in inside), inside
    else:
        assert all(s["matmul_precision"] == "highest" for s in inside), inside
    a64, b64, g64 = a.double(), b.double(), g.double()
    for what, got, want in (("out", out, a64 @ b64), ("da", leaf.grad, g64 @ b64.T), ("linear", lin, a64 @ b64)):
        assert_rel(got.detach().numpy(), want.numpy(), 1e-6, what)


def test_legacy_switch_reads_after_highest_products(restore_precision):
    """ROADMAP §3.10's sequence: the legacy switch on, a "highest" product,
    the switch off again; torch then reads the precision as "highest"
    (it refused before, when the products set it through the other API)."""
    torch.backends.cuda.matmul.allow_tf32 = True
    modeling.matmul(torch.ones(4, 4), torch.ones(4, 4), "highest")
    assert torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32
