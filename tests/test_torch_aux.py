"""The port's AuxK objective (saev_tpu_torch/nn/objectives.py) and its
single-prefix decode (nn/modeling.py) against the JAX package, on the CPU
with the same numpy inputs: d_model 32, d_sae 512, batch 64, k_aux 16.

- `_aux_loss` (dense) and `_aux_loss_subspace` at n_dead 0, below k_aux,
  above k_aux and equal to the cap, and with dead latents pinned at bias -1e6
  (exact f32 ties): loss to rel 1e-5, parameter gradients to rel-norm 1e-4.
- The subspace form equals the dense one whenever n_dead <= cap.
- The stalest-column gather picks the same indices as `lax.top_k` when the
  staleness counters tie.
- `subspace_cap_ladder` and `default_subspace_cap` equal JAX's.
- `decode(prefixes=None)` and the single-prefix decode against JAX at
  HIGHEST precision, to rel 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saev_tpu.nn import modeling as jmod
from saev_tpu.nn import objectives as jobj
from saev_tpu_torch.nn import modeling, objectives

D_MODEL, D_SAE, BATCH, K_AUX, CAP, THRESHOLD = 32, 512, 64, 16, 128, 1000
HIGHEST = jax.lax.Precision.HIGHEST
KEYS = ("W_enc", "b_enc", "W_dec", "b_dec")


def _configs(alpha=1 / 32):
    jcfg = jmod.SparseAutoencoderConfig(
        d_model=D_MODEL, d_sae=D_SAE,
        activation=jmod.TopK(top_k=4, aux=jmod.AuxK(k_aux=K_AUX, alpha=alpha)),
    )
    cfg = modeling.SparseAutoencoderConfig(
        d_model=D_MODEL, d_sae=D_SAE,
        activation=modeling.TopK(top_k=4, aux=modeling.AuxK(k_aux=K_AUX, alpha=alpha)),
    )
    return jcfg, cfg


def _toks(rng, n_dead: int) -> np.ndarray:
    """Staleness counters with heavy ties: live latents at 0, 7 or 14 tokens,
    dead ones (at random positions) at or above the threshold, some at the
    1 << 30 cap."""
    toks = (rng.integers(0, 3, size=D_SAE) * 7).astype(np.int32)
    dead = rng.choice(D_SAE, size=n_dead, replace=False)
    toks[dead] = THRESHOLD + rng.integers(0, 4, size=n_dead) * 100
    toks[dead[: n_dead // 3]] = 1 << 30
    return toks


def _inputs(n_dead: int, pinned: bool = False, seed: int = 0):
    rng = np.random.default_rng(seed + n_dead)
    w_dec = rng.normal(size=(D_SAE, D_MODEL)).astype(np.float32)
    w_dec /= np.linalg.norm(w_dec, axis=1, keepdims=True)
    toks = _toks(rng, n_dead)
    params = {
        "W_enc": (w_dec.T + 0.1 * rng.normal(size=(D_MODEL, D_SAE))).astype(np.float32),
        "b_enc": (rng.normal(size=D_SAE) * 0.1).astype(np.float32),
        "W_dec": w_dec,
        "b_dec": (rng.normal(size=D_MODEL) * 0.1).astype(np.float32),
    }
    if pinned:  # as bench.py pins dead latents: f32 spacing 0.0625 there
        params["b_enc"][toks >= THRESHOLD] = -1e6
    x = rng.normal(size=(BATCH, D_MODEL)).astype(np.float32)
    xhat = (x + 0.3 * rng.normal(size=x.shape)).astype(np.float32)
    return params, x, xhat, toks


def _torch_losses(cfg, params, x, xhat, toks, alpha=None):
    """(dense, subspace) AuxK losses and their parameter grads, torch."""
    xt, xh, tt = torch.from_numpy(x), torch.from_numpy(xhat), torch.from_numpy(toks)
    aux = cfg.activation.aux

    def run(fn):
        p = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in params.items()}
        loss = fn(p)
        grads = torch.autograd.grad(loss, [p[k] for k in KEYS])
        return loss.detach().numpy(), {k: g.numpy() for k, g in zip(KEYS, grads)}

    def dense(p):
        h = modeling._linear_bias(xt, p["W_enc"], p["b_enc"], "highest")
        return objectives._aux_loss(aux, cfg, p, xt, h, xh, tt >= THRESHOLD, alpha=alpha)

    def sub(p):
        return objectives._aux_loss_subspace(aux, cfg, p, xt, xh, tt, THRESHOLD, CAP, alpha=alpha)

    return run(dense), run(sub)


def _jax_losses(jcfg, params, x, xhat, toks, alpha=None):
    jx, jxh, jt = jnp.asarray(x), jnp.asarray(xhat), jnp.asarray(toks)
    aux = jcfg.activation.aux

    def dense(p):
        h = jnp.dot(jx, p["W_enc"], precision=HIGHEST) + p["b_enc"]
        return jobj._aux_loss(aux, jcfg, p, jx, h, jxh, jt >= THRESHOLD, alpha=alpha, precision=HIGHEST)

    def sub(p):
        return jobj._aux_loss_subspace(
            aux, jcfg, p, jx, jxh, jt, THRESHOLD, CAP, alpha=alpha, precision=HIGHEST
        )

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    out = []
    for fn in (dense, sub):
        loss, g = jax.value_and_grad(fn)(jp)
        out.append((np.asarray(loss), {k: np.asarray(g[k]) for k in KEYS}))
    return out


def _assert_close(got, want, what: str) -> None:
    (loss, grads), (jloss, jgrads) = got, want
    np.testing.assert_allclose(loss, jloss, rtol=1e-5, atol=0, err_msg=f"{what} loss")
    for k in KEYS:
        err = np.linalg.norm(grads[k] - jgrads[k])
        assert err <= 1e-4 * np.linalg.norm(jgrads[k]), f"{what} d{k}: rel-norm err {err}"


CASES = {
    "none-dead": (0, False),
    "below-k_aux": (5, False),
    "above-k_aux": (40, False),
    "at-cap": (CAP, False),
    "pinned-ties": (40, True),
}


@pytest.mark.parametrize("n_dead,pinned", CASES.values(), ids=CASES.keys())
def test_aux_losses_match_jax(n_dead, pinned):
    jcfg, cfg = _configs()
    params, x, xhat, toks = _inputs(n_dead, pinned)
    got = _torch_losses(cfg, params, x, xhat, toks)
    want = _jax_losses(jcfg, params, x, xhat, toks)
    _assert_close(got[0], want[0], "dense")
    _assert_close(got[1], want[1], "subspace")
    # n_dead <= cap: the subspace holds every dead latent.
    _assert_close(got[1], got[0], "subspace vs dense")
    if n_dead == 0:
        assert float(got[0][0]) == 0.0 and all(not g.any() for g in got[0][1].values())
    else:
        assert np.isfinite(got[0][0]) and float(got[0][0]) > 0


def test_aux_alpha_override_matches_jax():
    jcfg, cfg = _configs(alpha=1.0)
    params, x, xhat, toks = _inputs(40)
    got = _torch_losses(cfg, params, x, xhat, toks, alpha=torch.tensor(0.25))
    want = _jax_losses(jcfg, params, x, xhat, toks, alpha=jnp.float32(0.25))
    for g, w in zip(got, want):
        _assert_close(g, w, "alpha 0.25")
    default = _torch_losses(cfg, params, x, xhat, toks)
    np.testing.assert_allclose(got[0][0] * 4.0, default[0][0], rtol=1e-6)


@pytest.mark.parametrize("cap", [1, 16, CAP, 300, D_SAE])
def test_stalest_columns_match_lax_top_k(cap):
    toks = _toks(np.random.default_rng(cap), 60)
    want = np.asarray(jax.lax.top_k(jnp.asarray(toks), cap)[1])
    got = objectives.stalest_columns(torch.from_numpy(toks), cap).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "d_sae,k_aux", [(64, 4), (512, 16), (2048, 64), (2048, 512), (4096, 1024), (16384, 32), (16384, 512), (1000, 8)]
)
def test_subspace_caps_match_jax(d_sae, k_aux):
    assert objectives.subspace_cap_ladder(d_sae, k_aux) == jobj.subspace_cap_ladder(d_sae, k_aux)
    assert objectives.default_subspace_cap(d_sae, k_aux) == jobj.default_subspace_cap(d_sae, k_aux)


@pytest.mark.parametrize("prefixes", [None, np.asarray([D_SAE], np.int32)], ids=["none", "single"])
def test_decode_matches_jax(prefixes):
    jcfg, cfg = _configs()
    params, x, _, _ = _inputs(3)
    rng = np.random.default_rng(9)
    f = (rng.normal(size=(BATCH, D_SAE)) * (rng.random((BATCH, D_SAE)) < 0.1)).astype(np.float32)
    want = jmod.decode(
        jcfg, {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(f),
        None if prefixes is None else jnp.asarray(prefixes), precision=HIGHEST,
    )
    got = modeling.decode(
        cfg, modeling.params_from_numpy(params, "cpu"), torch.from_numpy(f),
        None if prefixes is None else torch.from_numpy(prefixes),
    )
    assert got.shape == (BATCH, 1, D_MODEL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="latents"):
        modeling.decode(cfg, modeling.params_from_numpy(params, "cpu"), torch.zeros((4, 8)))
