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
from saev_tpu_torch.ops import _build
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


def _kernel_path_grads(w, b_dec, f, x, p, g):
    tw, tb = _t(w).clone().requires_grad_(True), _t(b_dec).clone().requires_grad_(True)
    tf = _t(f).to(torch.bfloat16).requires_grad_(True)
    tl, txhat = tmat.prefix_mse(tw, tb, tf, _t(x), _t(p), g)
    tl.backward()
    return tl.detach(), txhat, (tw.grad, tb.grad, tf.grad)


def test_prefix_mse_kernel_path_pads_batch_to_tile(monkeypatch):
    """B = 1000 on the kernel path: the wrappers see the batch padded to a
    multiple of 128, and the loss and gradients are those of the JAX op (XLA
    path; bf16 against f32: loss rel 1e-3, gradients rel-norm 1e-2, the gate
    of scripts/check_tpu_kernels.py:180) and of the same algebra unpadded
    (1e-6)."""
    monkeypatch.setattr(tmat, "_use_kernels", lambda t: True)
    seen = []
    real = cm.grouped_prefix_err

    def spy(f, *args, **kwargs):
        seen.append(f.shape[0])
        return real(f, *args, **kwargs)

    monkeypatch.setattr(cm, "grouped_prefix_err", spy)
    rng = np.random.default_rng(5)
    b, s, d, g = 1000, 2048, 64, 1024
    w = (rng.normal(size=(s, d)) / np.sqrt(d)).astype(np.float32)
    b_dec = (rng.normal(size=(d,)) * 0.1).astype(np.float32)
    f = (rng.normal(size=(b, s)) * (rng.random((b, s)) < 0.05)).astype(np.float32)
    x = rng.normal(size=(b, d)).astype(np.float32)
    p = np.asarray([7, 1024, 1500, s], np.int32)

    loss, xhat, grads = _kernel_path_grads(w, b_dec, f, x, p, g)
    assert seen == [1024]
    assert tuple(xhat.shape) == (b, d) and tuple(grads[2].shape) == (b, s)

    def jloss(w_, b_, f_):
        return jmat.prefix_mse(w_, b_, f_, jnp.asarray(x), jnp.asarray(p), g, None)[0]

    jl, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(w), jnp.asarray(b_dec), jnp.asarray(f)
    )
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-3)
    for got, want in zip(grads, jgrads):
        assert rel_norm(got.float().numpy(), np.asarray(want)) <= 1e-2

    monkeypatch.setattr(cm, "TILE", 1)  # no padding: the same algebra at B = 1000
    u_loss, u_xhat, u_grads = _kernel_path_grads(w, b_dec, f, x, p, g)
    assert seen == [1024, 1000]
    np.testing.assert_allclose(loss.item(), u_loss.item(), rtol=1e-6)
    assert rel_norm(xhat.numpy(), u_xhat.numpy()) <= 1e-6
    for got, want in zip(grads, u_grads):
        assert rel_norm(got.float().numpy(), want.float().numpy()) <= 1e-6


def _spy(monkeypatch, name: str, seen: list):
    """Record (f or w rows, group size) of each call of a kernel wrapper."""
    real = getattr(cm, name)

    def spy(first, *args, group_size, **kwargs):
        seen.append((name, first.shape, group_size))
        return real(first, *args, group_size=group_size, **kwargs)

    monkeypatch.setattr(cm, name, spy)


@pytest.mark.parametrize("s,g", [(64, 1024), (384, 192)], ids=["d_sae-64", "g-192"])
def test_prefix_mse_kernel_path_pads_group_to_tile(monkeypatch, s, g):
    """A group that is not a multiple of 128 latents (d_sae 64, so g 64; g
    192) on the kernel path: the wrappers see each group padded to whole
    128-latent tiles, and the loss and gradients are those of the JAX op
    (XLA path; bf16 against f32: loss rel 1e-3, gradients rel-norm 1e-2) and
    of the same algebra unpadded (1e-6)."""
    monkeypatch.setattr(tmat, "_use_kernels", lambda t: True)
    seen = []
    for name in ("grouped_prefix_err", "grouped_matmul_dgrad", "grouped_matmul_wgrad"):
        _spy(monkeypatch, name, seen)
    rng = np.random.default_rng(s + g)
    b, d = 96, 32
    gg = min(g, s)
    w = (rng.normal(size=(s, d)) / np.sqrt(d)).astype(np.float32)
    b_dec = (rng.normal(size=(d,)) * 0.1).astype(np.float32)
    f = (rng.normal(size=(b, s)) * (rng.random((b, s)) < 0.2)).astype(np.float32)
    x = rng.normal(size=(b, d)).astype(np.float32)
    # A cut in group 0, one on a group boundary (when there is one), d_sae.
    p = np.asarray([5, 40, s] if gg == s else [5, 100, gg, gg + 7, s], np.int32)

    loss, xhat, grads = _kernel_path_grads(w, b_dec, f, x, p, g)
    gp = 128 * -(-gg // 128)
    padded = (s // gg) * gp
    assert [(n, tuple(shape), size) for n, shape, size in seen] == [
        ("grouped_prefix_err", (128, padded), gp),
        ("grouped_matmul_dgrad", (padded, 128), gp),  # d_model 32, padded to the tile too
        ("grouped_matmul_wgrad", (128, padded), gp),
    ]
    assert tuple(xhat.shape) == (b, d)
    assert [tuple(t.shape) for t in grads] == [(s, d), (d,), (b, s)]

    def jloss(w_, b_, f_):
        return jmat.prefix_mse(w_, b_, f_, jnp.asarray(x), jnp.asarray(p), g, None)[0]

    jl, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(w), jnp.asarray(b_dec), jnp.asarray(f)
    )
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-3)
    for got, want in zip(grads, jgrads):
        assert rel_norm(got.float().numpy(), np.asarray(want)) <= 1e-2

    monkeypatch.setattr(cm, "TILE", 1)  # no padding: the same algebra unpadded
    u_loss, u_xhat, u_grads = _kernel_path_grads(w, b_dec, f, x, p, g)
    assert seen[-1][1:] == ((b, s), gg)
    np.testing.assert_allclose(loss.item(), u_loss.item(), rtol=1e-6)
    assert rel_norm(xhat.numpy(), u_xhat.numpy()) <= 1e-6
    for got, want in zip(grads, u_grads):
        assert rel_norm(got.float().numpy(), want.float().numpy()) <= 1e-6


# Where each wrapper's d_model is: w (S, D) of K2 and K3, e (J, B, D) of K4.
_D_SEEN = {
    "grouped_prefix_err": lambda args: args[1].shape[1],
    "grouped_matmul_dgrad": lambda args: args[0].shape[1],
    "grouped_matmul_wgrad": lambda args: args[2].shape[2],
}


@pytest.mark.parametrize("d", [64, 192])
def test_prefix_mse_kernel_path_pads_d_model_to_tile(monkeypatch, d):
    """A d_model that is not a multiple of 128 (64, 192) on the kernel path,
    with a batch of 96: the wrappers see d_model padded to whole 128-column
    tiles (W, b_dec and x get zero columns, so E's padded columns are 0),
    and the loss and gradients are those of the JAX op (XLA path; bf16
    against f32: loss rel 1e-3, gradients rel-norm 1e-2) and of the same
    algebra unpadded (1e-6)."""
    monkeypatch.setattr(tmat, "_use_kernels", lambda t: True)
    seen = []
    for name, d_of in _D_SEEN.items():
        real = getattr(cm, name)

        def spy(*args, real=real, name=name, d_of=d_of, **kwargs):
            seen.append((name, d_of(args)))
            return real(*args, **kwargs)

        monkeypatch.setattr(cm, name, spy)
    rng = np.random.default_rng(d)
    b, s, g = 96, 2048, 1024
    w = (rng.normal(size=(s, d)) / np.sqrt(d)).astype(np.float32)
    b_dec = (rng.normal(size=(d,)) * 0.1).astype(np.float32)
    f = (rng.normal(size=(b, s)) * (rng.random((b, s)) < 0.05)).astype(np.float32)
    x = rng.normal(size=(b, d)).astype(np.float32)
    p = np.asarray([7, 1024, 1500, s], np.int32)

    loss, xhat, grads = _kernel_path_grads(w, b_dec, f, x, p, g)
    dp = 128 * -(-d // 128)
    assert seen == [(name, dp) for name in _D_SEEN]
    assert tuple(xhat.shape) == (b, d)
    assert [tuple(t.shape) for t in grads] == [(s, d), (d,), (b, s)]

    def jloss(w_, b_, f_):
        return jmat.prefix_mse(w_, b_, f_, jnp.asarray(x), jnp.asarray(p), g, None)[0]

    jl, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(w), jnp.asarray(b_dec), jnp.asarray(f)
    )
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-3)
    for got, want in zip(grads, jgrads):
        assert rel_norm(got.float().numpy(), np.asarray(want)) <= 1e-2

    monkeypatch.setattr(cm, "TILE", 1)  # no padding: the same algebra unpadded
    u_loss, u_xhat, u_grads = _kernel_path_grads(w, b_dec, f, x, p, g)
    assert seen[-3:] == [(name, d) for name in _D_SEEN]
    np.testing.assert_allclose(loss.item(), u_loss.item(), rtol=1e-6)
    assert rel_norm(xhat.numpy(), u_xhat.numpy()) <= 1e-6
    for got, want in zip(grads, u_grads):
        assert rel_norm(got.float().numpy(), want.float().numpy()) <= 1e-6


def _prefix_err_by_k16(f, w, x, b_dec, inv_upper, m, r, g, step=16):
    """K2's walk (csrc/prefix_fwd.cu) written out in torch: K = d_sae in
    16-lane steps accumulated in f32; each cut, met in ascending p (stable
    in j) in the step that holds it, snapshots acc + the correction
    f[:, k0:p] @ W[k0:p] of the lanes below it (none when p is on a step),
    a cut at p = d_sae the whole sum. Then E = bf16(base + (b_dec - x)) and
    the loss sum. Returns E, xhat, the loss sum and the f32 base (K7's)."""
    ff, wf = f.float(), w.float()
    p = (m * g + r).tolist()
    order = sorted(range(len(p)), key=lambda j: p[j])
    acc = torch.zeros((f.shape[0], w.shape[1]))
    base = [None] * len(p)
    ci = 0
    for k0 in range(0, f.shape[1], step):
        while ci < len(order) and p[order[ci]] < k0 + step:
            pj = p[order[ci]]
            base[order[ci]] = acc + ff[:, k0:pj] @ wf[k0:pj] if pj > k0 else acc
            ci += 1
        acc = acc + ff[:, k0 : k0 + step] @ wf[k0 : k0 + step]
    for j in order[ci:]:
        base[j] = acc
    base = torch.stack(base)
    e = (base + (b_dec - x)).to(torch.bfloat16)
    return e, acc, ((e.float() * inv_upper) ** 2).sum(), base


# Several cuts in one 16-lane step (a small copy of the seed-0 sampled cuts),
# cuts on and beside 16- and 64-lane steps, cuts on group boundaries; each
# ends at d_sae.
# Past 64 cuts (the kernels' tables in dynamic shared memory): every lane of
# the first 16-lane steps cut, and cuts spread over every group.
K16_CUTS = {
    "sampled": [2, 5, 7, 8, 14, 27, 77, 113, 487, S],
    "k16-edges": [1, 15, 16, 17, 63, 64, 65, S],
    "group-boundaries": [G, 2 * G, 2 * G + 1, 3 * G, S],
    "65-cuts": list(range(1, 41)) + list(range(100, S, 80))[:24] + [S],
    "130-cuts": list(range(1, 33)) + list(range(33, S, 15))[:97] + [S],
}


@pytest.mark.parametrize("cuts", K16_CUTS.values(), ids=K16_CUTS.keys())
def test_prefix_err_k16_walk_matches_pallas_and_plain(data, cuts):
    """K2's schedule gives the Pallas kernel's (interpret mode) and the plain
    version's outputs at K2's tolerances: loss rel 1e-5, xhat rel-norm 1e-4,
    E rel-norm 1e-2; and its base gives its own E bit for bit after
    + (b_dec - x), K7's contract."""
    f, w, _, _, x, b_dec = data
    m, r = _cuts(cuts)
    upper = max(float(np.abs(x).max()), 1e-12)
    je, jxhat, jloss_p = pk.grouped_prefix_err(
        jnp.asarray(f, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), jnp.asarray(x),
        jnp.asarray(b_dec), jnp.asarray(1.0 / upper, jnp.float32),
        jnp.asarray(m), jnp.asarray(r), group_size=G, block_rows=64, interpret=True,
    )
    args = (_tb(f), _tb(w), _t(x), _t(b_dec), torch.tensor(1.0 / upper), _t(m), _t(r))
    e, xhat, loss, base = _prefix_err_by_k16(*args, G)
    pe, pxhat, ploss = cm.grouped_prefix_err_plain(*args, group_size=G)
    wants = (
        (np.asarray(je, np.float32), np.asarray(jxhat), float(np.asarray(jloss_p)[::8, 0].sum())),
        (pe.float().numpy(), pxhat.numpy(), float(ploss)),
    )
    for want_e, want_xhat, want_loss in wants:
        assert rel_norm(e.float().numpy(), want_e) <= 1e-2
        assert rel_norm(xhat.numpy(), want_xhat) <= 1e-4
        np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    rebuilt = (base + (_t(b_dec) - _t(x))).to(torch.bfloat16)
    assert torch.equal(rebuilt.view(torch.int16), e.view(torch.int16))


def _wgrad_by_items(f, da, e, m, r, scale, g, tile=128):
    """K4's schedule (csrc/wgrad.cu) written out in torch: a main item per
    (group, latent tile, d tile) stores f_G^T @ dA_G; a remainder slot per
    (cut, latent tile, d tile) is live when m_j < n_groups and r_j > s0 and
    stores its product with the rows at or above r_j zeroed; the combine adds
    scale * (the live partials summed in ascending j) to each dW tile.
    Returns dW and the number of live remainder items."""
    ff, daf, ef = f.float(), da.float(), e.float()
    s, d = f.shape[1], e.shape[2]
    n_groups = s // g
    ms, rs = m.tolist(), r.tolist()
    dw = torch.empty((s, d))
    parts = {}
    for j in range(len(ms)):
        for s0 in range(0, g, tile):
            for d0 in range(0, d, tile):
                if ms[j] < n_groups and rs[j] > s0:
                    fg = ff[:, ms[j] * g + s0 : ms[j] * g + s0 + tile]
                    part = fg.T @ ef[j][:, d0 : d0 + tile]
                    part[rs[j] - s0 :] = 0.0
                    parts[j, s0, d0] = part
    for gi in range(n_groups):
        for s0 in range(0, g, tile):
            for d0 in range(0, d, tile):
                fg = ff[:, gi * g + s0 : gi * g + s0 + tile]
                dw[gi * g + s0 : gi * g + s0 + tile, d0 : d0 + tile] = fg.T @ daf[:, gi, d0 : d0 + tile]
    for gi in range(n_groups):
        for s0 in range(0, g, tile):
            for d0 in range(0, d, tile):
                live = [parts[j, s0, d0] for j in range(len(ms)) if (j, s0, d0) in parts and ms[j] == gi]
                if live:
                    total = live[0]
                    for part in live[1:]:
                        total = total + part
                    rows = slice(gi * g + s0, gi * g + s0 + tile)
                    dw[rows, d0 : d0 + tile] = dw[rows, d0 : d0 + tile] + scale * total
    return dw, len(parts)


@pytest.mark.parametrize("cuts", [[3, 9, 40, 100, 127, 2048], [130, 190, 2048], [37, 1024, 2048], [2048],
                                  [5, 300, 301, 1100, 1536, 2048]])
def test_wgrad_items_match_plain(cuts):
    """K4's equal work items and fixed-order combine give the plain version's
    dW (1e-6: f32 sums over the same terms, blocked per tile)."""
    rng = np.random.default_rng(len(cuts))
    b, s, d, g = 64, 2048, 256, 512
    f = _tb(rng.normal(size=(b, s)) * (rng.random((b, s)) < 0.2))
    da = _tb(rng.normal(size=(b, s // g, d)))
    e = _tb(rng.normal(size=(len(cuts), b, d)))
    m, r = (_t(v) for v in _cuts(cuts))
    dw, n_live = _wgrad_by_items(f, da, e, m, r, 0.37, g)
    want = cm.grouped_matmul_wgrad_plain(f, da, e, m, r, torch.tensor(0.37), group_size=g)
    assert n_live == (d // 128) * sum(-(-int(rv) // 128) for mv, rv in zip(m, r) if mv < s // g)
    assert rel_norm(dw.numpy(), want.numpy()) <= 1e-6


def test_wgrad_items_of_the_production_cuts():
    """At the production shape (d_sae 16384, d_model 1024, groups of 1024) the
    seed-0 sampled cuts give 96 live remainder items and the hand-set cuts of
    chip_smoke.py 288, beside 1024 main items: the count is d_model / 128
    times the sum over the cuts below d_sae of ceil(r_j / 128)."""
    from saev_tpu_torch.nn import objectives

    sampled = objectives.sample_prefixes(16384, 10, rng=np.random.default_rng(0))
    assert sampled.tolist() == [2, 5, 7, 8, 14, 27, 77, 113, 487, 16384]
    hand = [100, 700, 1024, 2048, 5000, 5001, 9000, 12288, 15000, 16384]
    for cuts, want in ((sampled, 96), (hand, 288)):
        m, r = np.asarray(cuts) // 1024, np.asarray(cuts) % 1024
        live = sum(1 for j in range(len(cuts)) for s0 in range(0, 1024, 128) for _ in range(0, 1024, 128)
                   if m[j] < 16 and r[j] > s0)
        assert live == want


K3_SASS = """
	code for sm_90a
		Function : _ZN40_GLOBAL__N__36c64d2c_8_dgrad_cu_f4886f4818dgrad_wgmma_kernelIfEEv14CUtensorMap_st
        /*0000*/                   LDC R1, c[0x0][0x28] ;                           /* 0x00000a00ff017b82 */
        /*0010*/                   UTMALDG.3D [UR8], [UR4] ;                        /* 0x00000008040075b4 */
        /*0020*/              @!P0 UTMALDG.2D [UR16], [UR6] ;                       /* 0x00000010060085b4 */
        /*0030*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], R24 ;  /* 0x00e00008181879f0 */
        /*0040*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR12], R24, gsb0 ;
		Function : _ZN40_GLOBAL__N__36c64d2c_8_dgrad_cu_f4886f4819build_da_vec_kernelEPK13__nv_bfloat16
        /*0000*/                   LDG.E.128 R4, desc[UR4][R2.64] ;                 /* 0x0000000402047981 */
		Function : _ZN43_GLOBAL__N__b24f0e1f_10_kth_ops_cu_07bce94f14kth_ops_kernelILi4ELi64ELi256EEEvPKfiiPf
        /*0000*/                   HMMA.16816.F32.BF16 R8, R12, R16, R8 ;          /* 0x000000100c08723c */
"""


def test_function_opcodes_counts_one_kernels_sass():
    """The SASS count chip_smoke.py holds K3's product to: opcodes of the
    functions whose name holds the fragment, predicates and suffixes dropped."""
    from saev_tpu_torch.ops import _build

    found = _build.function_opcodes(K3_SASS, "dgrad_wgmma_kernel")
    assert list(found.values()) == [{"LDC": 1, "UTMALDG": 2, "HGMMA": 2}]
    assert list(_build.function_opcodes(K3_SASS, "build_da_vec_kernel").values()) == [{"LDG": 1}]
    assert _build.function_opcodes(K3_SASS, "wgrad_kernel") == {}


def test_function_forms_count_each_modifier_set():
    """The SASS forms chip_smoke.py reads P2's multicast TMA load from: each
    full opcode with its modifiers, predicates dropped."""
    from saev_tpu_torch.ops import _build

    sass = K3_SASS + "        /*0050*/                   UTMALDG.2D.MULTICAST [UR8], [UR4], UR5 ;\n"
    found = _build.function_forms(sass, "dgrad_wgmma_kernel")
    assert list(found.values()) == [{"LDC": 1, "UTMALDG.3D": 1, "UTMALDG.2D": 1, "HGMMA.64x128x16.F32.BF16": 2}]
    found = _build.function_forms(sass, "kth_ops_kernel")
    assert list(found.values()) == [{"HMMA.16816.F32.BF16": 1, "UTMALDG.2D.MULTICAST": 1}]
    assert list(_build.function_forms(sass, "build_da_vec_kernel").values()) == [{"LDG.E.128": 1}]


PTXAS_LOG = """
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119prefix_wgmma_kernelILNS_4ModeE0EEEv14CUtensorMap_st' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119prefix_wgmma_kernelILNS_4ModeE0EEEv14CUtensorMap_st
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 104 registers, used 2 barriers, 1064 bytes smem, 592 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118dgrad_wgmma_kernelIfEEv14CUtensorMap_st' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118dgrad_wgmma_kernelIfEEv14CUtensorMap_st
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 90 registers, used 1 barriers, 540 bytes smem, 592 bytes cmem[0]
"""


def test_ptxas_resources_reads_registers_and_spills():
    """The ptxas report chip_smoke.py holds the wgmma products to: each
    kernel's registers, stack frame and spill bytes, found by a fragment of
    its name."""
    from saev_tpu_torch.ops import _build

    found = _build.ptxas_resources(PTXAS_LOG, "prefix_wgmma_kernel")
    assert list(found.values()) == [{"stack_frame": 0, "spill_stores": 0, "spill_loads": 0, "registers": 104}]
    found = _build.ptxas_resources(PTXAS_LOG, "dgrad_wgmma_kernel")
    assert list(found.values()) == [{"stack_frame": 8, "spill_stores": 4, "spill_loads": 12, "registers": 90}]
    assert _build.ptxas_resources(PTXAS_LOG, "wgrad_wgmma_kernel") == {}


def _c_entry_points() -> dict[str, list[str]]:
    """Name -> parameter declarations of each `extern "C"` function in csrc."""
    import re

    found = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        text = src.read_text()
        for m in re.finditer(r'extern "C" \w+ (saev_\w+)\(([^)]*)\)\s*\{', text):
            found[m[1]] = [p.strip() for p in m[2].split(",") if p.strip()]
    return found


def test_every_c_entry_point_is_bound():
    """Each `extern "C"` entry point of the sources has argument types in
    `_build.SIGNATURES`, and each bound name exists in the sources."""
    assert set(_c_entry_points()) == set(_build.SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_c_entry_point_matches_its_signature(name):
    """The ctypes argument types of an entry point match its C parameters:
    a pointer or the stream as void*, an int as int, one for one."""
    import ctypes

    params = _c_entry_points()[name]
    kinds = [ctypes.c_void_p if "*" in p or p.startswith("cudaStream_t") else ctypes.c_int for p in params]
    assert all(p.startswith(("int ", "const ", "float*", "int*", "uint8_t*", "cudaStream_t", "__nv_bfloat16*",
                             "void*")) for p in params), params
    assert kinds == _build.SIGNATURES[name], params
