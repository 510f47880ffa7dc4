"""The port's SAE modules (saev_tpu_torch/nn, utils/scheduling.py) against the
JAX package: jax-free config copies field by field, weight carry-over, the
TopK encoder, the decoder-norm constraints, the learning-rate schedule and
the prefix sampler."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saev_tpu.nn import modeling as jmod
from saev_tpu.nn import objectives as jobj
from saev_tpu.utils import scheduling as jsched
from saev_tpu_torch.nn import modeling, objectives
from saev_tpu_torch.utils import scheduling

CONFIGS = [
    "NoSparsity", "L1Sparsity", "NoAux", "AuxK", "Relu", "TopK", "BatchTopK",
    "SparseAutoencoderConfig",
]


def _plain(v):
    """Dataclass defaults as nested dicts, so copies compare by content."""
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


@pytest.mark.parametrize("name", CONFIGS)
def test_config_fields_match_jax(name):
    ours, theirs = getattr(modeling, name), getattr(jmod, name)
    fo, ft = dataclasses.fields(ours), dataclasses.fields(theirs)
    assert [f.name for f in fo] == [f.name for f in ft]
    assert [_plain(f.default) for f in fo] == [_plain(f.default) for f in ft]
    assert _plain(ours()) == _plain(theirs())


def test_matryoshka_config_matches_jax():
    fo, ft = dataclasses.fields(objectives.Matryoshka), dataclasses.fields(jobj.Matryoshka)
    assert [(f.name, f.default) for f in fo] == [(f.name, f.default) for f in ft]


def _jax_params(seed=0, d_model=16, d_sae=64):
    import jax

    cfg = jmod.SparseAutoencoderConfig(d_model=d_model, d_sae=d_sae, activation=jmod.TopK(top_k=4))
    params, _ = jmod.init(cfg, jax.random.key(seed))
    rng = np.random.default_rng(seed)
    out = {k: np.asarray(v) for k, v in params.items()}
    out["b_enc"] = rng.normal(size=out["b_enc"].shape).astype(np.float32) * 0.1
    out["b_dec"] = rng.normal(size=out["b_dec"].shape).astype(np.float32) * 0.1
    return out


def test_params_from_numpy_round_trips():
    params = _jax_params()
    got = modeling.params_from_numpy(params, "cpu")
    assert set(got) == set(params)
    for k, v in params.items():
        assert got[k].dtype == torch.float32 and got[k].is_contiguous()
        np.testing.assert_array_equal(got[k].numpy(), v)


def test_init_layout_and_norms():
    cfg = modeling.SparseAutoencoderConfig(d_model=16, d_sae=64)
    params, state = modeling.init(cfg, torch.Generator().manual_seed(0))
    assert params["W_enc"].shape == (16, 64) and params["W_dec"].shape == (64, 16)
    torch.testing.assert_close(torch.linalg.norm(params["W_dec"], dim=1), torch.ones(64))
    assert torch.equal(params["W_enc"], params["W_dec"].T)
    assert state["threshold"].shape == ()


def test_encode_topk_matches_jax():
    params = _jax_params(1)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(32, 16)).astype(np.float32)
    jcfg = jmod.SparseAutoencoderConfig(d_model=16, d_sae=64, activation=jmod.TopK(top_k=4))
    cfg = modeling.SparseAutoencoderConfig(d_model=16, d_sae=64, activation=modeling.TopK(top_k=4))
    jout, _ = jmod.encode(jcfg, {k: jnp.asarray(v) for k, v in params.items()},
                          jmod.init_state(jcfg), jnp.asarray(x), training=True)
    out, _ = modeling.encode(cfg, modeling.params_from_numpy(params, "cpu"),
                             modeling.init_state(cfg), torch.from_numpy(x), training=True)
    np.testing.assert_allclose(out.h_x.numpy(), np.asarray(jout.h_x), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.f_x.numpy(), np.asarray(jout.f_x), rtol=1e-5, atol=1e-6)
    assert ((out.f_x != 0).sum(dim=1) == 4).all()


def test_linear_bias_grads_match_autograd():
    rng = np.random.default_rng(3)
    x, w, b, dh = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                   for s in ((8, 5), (5, 7), (7,), (8, 7)))
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    modeling._linear_bias(*leaves).backward(dh)
    ref = [t.clone().requires_grad_(True) for t in (x, w, b)]
    (ref[0] @ ref[1] + ref[2]).backward(dh)
    for a, r in zip(leaves, ref):
        torch.testing.assert_close(a.grad, r.grad, rtol=1e-6, atol=1e-6)


def test_normalize_and_remove_parallel_grads_match_jax():
    params = _jax_params(4)
    rng = np.random.default_rng(5)
    grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
    params["W_dec"] = params["W_dec"] * 3.0  # off the unit sphere
    jcfg, cfg = jmod.SparseAutoencoderConfig(), modeling.SparseAutoencoderConfig()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = modeling.params_from_numpy(params, "cpu")
    jn, tn = jmod.normalize_w_dec(jcfg, jp), modeling.normalize_w_dec(cfg, tp)
    np.testing.assert_allclose(tn["W_dec"].numpy(), np.asarray(jn["W_dec"]), rtol=1e-6, atol=1e-7)
    jg = jmod.remove_parallel_grads(jcfg, jp, {k: jnp.asarray(v) for k, v in grads.items()})
    tg = modeling.remove_parallel_grads(cfg, tp, modeling.params_from_numpy(grads, "cpu"))
    np.testing.assert_allclose(tg["W_dec"].numpy(), np.asarray(jg["W_dec"]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("step", [0, 1, 3, 7, 12, 50])
def test_warmup_cosine_matches_jax(step):
    n_warmup = np.asarray([5.0, 1.0, 0.0], np.float32)
    peak = np.asarray([4e-4, 1e-3, 3e-3], np.float32)
    want = jsched.warmup_cosine(step, 0.0, jnp.asarray(n_warmup), jnp.asarray(peak), 40.0, 0.0)
    got = scheduling.warmup_cosine(
        torch.tensor(step, dtype=torch.int32), 0.0, torch.from_numpy(n_warmup),
        torch.from_numpy(peak), 40.0, 0.0,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-12)
    if step == 0:  # lr = 0 at the first step wherever there is a warm-up
        assert (got[torch.from_numpy(n_warmup) > 0] == 0).all()


@pytest.mark.parametrize("d_sae,n", [(2048, 4), (16384, 10), (64, 1)])
def test_sample_prefixes_identical_to_jax(d_sae, n):
    for seed in range(3):
        want = jobj.sample_prefixes(d_sae, n, rng=np.random.default_rng(seed))
        got = objectives.sample_prefixes(d_sae, n, rng=np.random.default_rng(seed))
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
