"""The port's Matryoshka prefix-MSE (saev_tpu_torch/ops/matryoshka.py) and the
plain versions of kernels K2-K4 (ops/cuda_matryoshka.py) against the JAX
package.

- f32 `prefix_mse` and its gradients against the JAX op's XLA path:
  rel-norm 1e-5.
- The bf16-operand plain versions against the Pallas kernels in interpret
  mode (shapes of tests/test_ops_matryoshka.py): f32 outputs (xhat, loss, dW)
  rel-norm 1e-5; E and dA 1e-3 (one bf16 ulp of summation-order difference);
  df 1e-2, because the JAX kernel rounds df twice on cut groups.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saev_tpu.ops import matryoshka as jmat
from saev_tpu.ops import pallas_matryoshka as pk
from saev_tpu.ops import shmap
from saev_tpu_torch.ops import cuda_matryoshka as cm
from saev_tpu_torch.ops import matryoshka as tmat

B, S, D, G = 128, 2048, 128, 512  # 4 groups


def rel_norm(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _t(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def _tb(x) -> torch.Tensor:
    return _t(np.asarray(x, np.float32)).to(torch.bfloat16)


def _cuts(p):
    p = np.asarray(p, np.int32)
    return p // G, p % G


# m = 0, r = 0, two cuts in one group, and the full prefix p = d_sae.
CUTS = {
    "mid-boundary-mid-full": [300, 512, 1100, S],
    "two-in-group0": [100, 300, 1536, S],
}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    f = rng.normal(size=(B, S)).astype(np.float32)
    w = (rng.normal(size=(S, D)) / 32).astype(np.float32)
    e = rng.normal(size=(len(CUTS["two-in-group0"]), B, D)).astype(np.float32)
    da = rng.normal(size=(B, S // G, D)).astype(np.float32)
    x = rng.normal(size=(B, D)).astype(np.float32)
    b_dec = (rng.normal(size=(D,)) * 0.1).astype(np.float32)
    return f, w, e, da, x, b_dec


@pytest.mark.parametrize("cuts", CUTS.values(), ids=CUTS.keys())
def test_prefix_err_plain_matches_pallas(data, cuts):
    f, w, _, _, x, b_dec = data
    m, r = _cuts(cuts)
    upper = max(float(np.abs(x).max()), 1e-12)
    e, xhat, loss_p = pk.grouped_prefix_err(
        jnp.asarray(f, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), jnp.asarray(x),
        jnp.asarray(b_dec), jnp.asarray(1.0 / upper, jnp.float32),
        jnp.asarray(m), jnp.asarray(r), group_size=G, block_rows=64, interpret=True,
    )
    pe, pxhat, ploss = cm.grouped_prefix_err_plain(
        _tb(f), _tb(w), _t(x), _t(b_dec), torch.tensor(1.0 / upper), _t(m), _t(r),
        group_size=G,
    )
    assert pe.dtype == torch.bfloat16 and pxhat.dtype == torch.float32
    assert rel_norm(pe.float().numpy(), np.asarray(e, np.float32)) <= 1e-3
    assert rel_norm(pxhat.numpy(), np.asarray(xhat)) <= 1e-5
    jloss = float(np.asarray(loss_p)[::8, 0].sum())
    np.testing.assert_allclose(float(ploss), jloss, rtol=1e-5)


@pytest.mark.parametrize("df_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cuts", CUTS.values(), ids=CUTS.keys())
def test_dgrad_plain_matches_pallas(data, cuts, df_dtype):
    _, w, e, _, _, _ = data
    m, r = _cuts(cuts)
    scale = 0.37
    jdt = jnp.bfloat16 if df_dtype == torch.bfloat16 else jnp.float32
    df, da = pk.grouped_matmul_dgrad(
        jnp.asarray(w, jnp.bfloat16), jnp.asarray(e, jnp.bfloat16), jnp.asarray(m),
        jnp.asarray(r), jnp.asarray(scale), group_size=G, block_rows=64,
        df_dtype=jdt, interpret=True,
    )
    pdf, pda = cm.grouped_matmul_dgrad_plain(
        _tb(w), _tb(e), _t(m), _t(r), torch.tensor(scale), group_size=G, df_dtype=df_dtype
    )
    assert pdf.dtype == df_dtype and pda.dtype == torch.bfloat16
    assert rel_norm(pda.float().numpy(), np.asarray(da, np.float32)) <= 1e-3
    assert rel_norm(pdf.float().numpy(), np.asarray(df, np.float32)) <= 1e-2


@pytest.mark.parametrize("cuts", CUTS.values(), ids=CUTS.keys())
def test_wgrad_plain_matches_pallas(data, cuts):
    f, _, e, da, _, _ = data
    m, r = _cuts(cuts)
    scale = 0.21
    dw = pk.grouped_matmul_wgrad(
        jnp.asarray(f, jnp.bfloat16), jnp.asarray(da, jnp.bfloat16),
        jnp.asarray(e, jnp.bfloat16), jnp.asarray(m), jnp.asarray(r), jnp.asarray(scale),
        group_size=G, block_rows=64, interpret=True,
    )
    pdw = cm.grouped_matmul_wgrad_plain(
        _tb(f), _tb(da), _tb(e), _t(m), _t(r), torch.tensor(scale), group_size=G
    )
    assert pdw.dtype == torch.float32
    assert rel_norm(pdw.numpy(), np.asarray(dw)) <= 1e-5


def test_cpu_wrappers_take_plain_versions(data):
    f, w, e, da, x, b_dec = data
    m, r = (_t(v) for v in _cuts(CUTS["two-in-group0"]))
    counts = [fn.launches for fn in (cm.grouped_prefix_err, cm.grouped_matmul_dgrad,
                                     cm.grouped_matmul_wgrad)]
    got = cm.grouped_prefix_err(_tb(f), _tb(w), _t(x), _t(b_dec), torch.tensor(0.5), m, r,
                                group_size=G)
    want = cm.grouped_prefix_err_plain(_tb(f), _tb(w), _t(x), _t(b_dec), torch.tensor(0.5),
                                       m, r, group_size=G)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    cm.grouped_matmul_dgrad(_tb(w), _tb(e), m, r, torch.tensor(0.1), group_size=G)
    cm.grouped_matmul_wgrad(_tb(f), _tb(da), _tb(e), m, r, torch.tensor(0.1), group_size=G)
    assert counts == [fn.launches for fn in (cm.grouped_prefix_err, cm.grouped_matmul_dgrad,
                                             cm.grouped_matmul_wgrad)]


@pytest.mark.parametrize(
    "b,s,d,j,g",
    [
        (16, 64, 8, 3, 1024),  # d_sae < group -> g = d_sae
        (32, 2048, 16, 5, 1024),
        (24, 3072, 8, 4, 1024),  # 3 groups
        (16, 2048, 16, 4, 512),
    ],
)
def test_prefix_mse_f32_matches_jax_xla(b, s, d, j, g):
    """Loss, full reconstruction and all gradients of the plain f32 path."""
    rng = np.random.default_rng(b + s + j)
    w = (rng.normal(size=(s, d)) / np.sqrt(s)).astype(np.float32)
    b_dec = (rng.normal(size=(d,)) * 0.1).astype(np.float32)
    f = (rng.normal(size=(b, s)) * (rng.random((b, s)) < 0.1)).astype(np.float32)
    x = rng.normal(size=(b, d)).astype(np.float32)
    gg = min(g, s)
    # One cut inside group 0, one on a group boundary (when there is one),
    # random others, and d_sae.
    fixed = {3, gg} if gg < s else {3}
    rest = rng.choice(np.setdiff1d(np.arange(1, s), list(fixed)), size=j - 1 - len(fixed), replace=False)
    p = np.sort(np.concatenate([list(fixed), rest, [s]])).astype(np.int32)

    def jloss(w_, b_, f_):
        loss, xhat = jmat.prefix_mse(w_, b_, f_, jnp.asarray(x), jnp.asarray(p), g, None)
        return loss, xhat

    (jl, jxhat), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(w), jnp.asarray(b_dec), jnp.asarray(f)
    )
    tw, tb, tf = (_t(v).clone().requires_grad_(True) for v in (w, b_dec, f))
    tl, txhat = tmat.prefix_mse(tw, tb, tf, _t(x), _t(p), g)
    assert not txhat.requires_grad
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    assert rel_norm(txhat.detach().numpy(), np.asarray(jxhat)) <= 1e-5
    for got, want in zip((tw.grad, tb.grad, tf.grad), jgrads):
        assert rel_norm(got.numpy(), np.asarray(want)) <= 1e-5


def test_prefix_mse_kernel_path_matches_jax_interpret(monkeypatch):
    """The bf16 kernel path of `prefix_mse` (run on the CPU through the plain
    versions) against the JAX op with the Pallas kernels interpreted."""
    monkeypatch.setattr(shmap, "INTERPRET", True)
    monkeypatch.setattr(tmat, "_use_kernels", lambda t: True)
    rng = np.random.default_rng(4)
    b, s, d, g = 64, 2048, 64, 1024
    w = (rng.normal(size=(s, d)) / np.sqrt(d)).astype(np.float32)
    b_dec = (rng.normal(size=(d,)) * 0.1).astype(np.float32)
    f = (rng.normal(size=(b, s)) * (rng.random((b, s)) < 0.05)).astype(np.float32)
    x = rng.normal(size=(b, d)).astype(np.float32)
    p = np.asarray([7, 1024, 1500, s], np.int32)

    def jloss(w_, b_, f_):
        return jmat.prefix_mse(w_, b_, f_, jnp.asarray(x), jnp.asarray(p), g, None)[0]

    jl, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(w), jnp.asarray(b_dec), jnp.asarray(f, jnp.bfloat16)
    )
    tw, tb = _t(w).clone().requires_grad_(True), _t(b_dec).clone().requires_grad_(True)
    tf = _t(f).to(torch.bfloat16).requires_grad_(True)
    tl, _ = tmat.prefix_mse(tw, tb, tf, _t(x), _t(p), g)
    tl.backward()
    assert tf.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    assert rel_norm(tw.grad.numpy(), np.asarray(jgrads[0])) <= 1e-4
    assert rel_norm(tb.grad.numpy(), np.asarray(jgrads[1])) <= 1e-4
    assert rel_norm(tf.grad.float().numpy(), np.asarray(jgrads[2], np.float32)) <= 1e-2
