"""The port's TopK thresholds and statistics (saev_tpu_torch/ops/topk.py)
against the JAX package, on the edge-case rows the CUDA kernels must handle:

- the plain version of kernel K1 against `topk._topk_stats_xla` and against
  the Pallas kernel in interpret mode: kth, f, live and L0 equal, L1 to
  rel 1e-6;
- the plain versions of K6 (`exact_kth_value`) and K5
  (`exact_kth_value_masked`) against the Pallas kernels in interpret mode
  and against the JAX ops, equal, with masks that leave fewer than k columns
  (-inf), mask everything or nothing, and with ties at -1e6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saev_tpu.ops import pallas_topk
from saev_tpu.ops import topk as jtopk
from saev_tpu_torch.ops import cuda_kth, cuda_topk, topk


def _rows(b: int, s: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(b, s)).astype(np.float32)
    h[0] = 0.0  # all tied at zero
    h[1] = -np.abs(h[1])  # all negative
    h[2] = -np.abs(h[2])
    h[2, :3] = [1.0, 2.0, 3.0]  # fewer than k positive values
    h[3, :40] = 7.0  # ties across the boundary
    h[4, ::2] = -0.0  # signed zeros beside a few positives
    h[4, 1::2] = -np.abs(h[4, 1::2])
    h[4, 1:12:2] = 0.5
    h[:, 5:9] = 0.0  # exact zeros in every row (L0 counts h != 0)
    return h


def _check(got: topk.TopKStats, want) -> None:
    kth, f, live, l0, l1 = want
    np.testing.assert_array_equal(got.kth.numpy(), np.asarray(kth))
    np.testing.assert_array_equal(
        got.f.float().numpy(), np.asarray(jnp.asarray(f, jnp.float32))
    )
    np.testing.assert_array_equal(got.live.numpy(), np.asarray(live))
    np.testing.assert_array_equal(got.l0.numpy(), np.asarray(l0))
    np.testing.assert_allclose(got.l1.numpy(), np.asarray(l1), rtol=1e-6)


@pytest.mark.parametrize("b,s,k", [(64, 512, 32), (32, 300, 8), (32, 64, 64)])
def test_plain_matches_jax_xla(b, s, k):
    h = _rows(b, s, b + s + k)
    got = topk._topk_stats_plain(torch.from_numpy(h), k)
    _check(got, jtopk._topk_stats_xla(jnp.asarray(h), k))


@pytest.mark.parametrize("b,s,k", [(64, 512, 32), (32, 256, 256)])
def test_plain_matches_pallas_interpret(b, s, k):
    h = _rows(b, s, 7 + k)
    kth, f, live_p, l0, l1 = pallas_topk.topk_stats_pallas(jnp.asarray(h), k, 32, True)
    got = topk._topk_stats_plain(torch.from_numpy(h), k)
    _check(got, (kth, f, np.asarray(live_p).sum(axis=0) > 0, l0, l1))


def test_cpu_wrapper_takes_plain_version():
    h = torch.from_numpy(_rows(32, 128, 3))
    before = cuda_topk.topk_stats_cuda.launches
    got = cuda_topk.topk_stats_cuda(h, 8)
    want = topk._topk_stats_plain(h, 8)
    assert cuda_topk.topk_stats_cuda.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_exact_kth_value_matches_jax():
    h = _rows(16, 200, 11)
    got = topk.exact_kth_value(torch.from_numpy(h), 17)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jtopk.exact_kth_value(jnp.asarray(h), 17)))


def test_grad_matches_jax_custom_vjp():
    """dh = where(h >= kth, t_f + t_l1 sign(h), 0), the JAX custom VJP."""
    import jax

    h = _rows(32, 256, 5)
    rng = np.random.default_rng(6)
    t_f = rng.normal(size=h.shape).astype(np.float32)
    t_l1 = rng.normal(size=(h.shape[0], 1)).astype(np.float32)

    def jax_obj(hh):
        st = jtopk.topk_stats(hh, 16)
        return jnp.sum(st.f.astype(jnp.float32) * t_f) + jnp.sum(st.l1 * t_l1)

    want = jax.grad(jax_obj)(jnp.asarray(h))
    ht = torch.from_numpy(h).requires_grad_(True)
    st = topk.topk_stats(ht, 16)
    (torch.sum(st.f.float() * torch.from_numpy(t_f)) + torch.sum(st.l1 * torch.from_numpy(t_l1))).backward()
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)



# --- K6 and K5: the plain versions against the Pallas kernels (interpret) ---


@pytest.mark.parametrize("b,s,k", [(64, 512, 32), (32, 300, 8), (32, 64, 64), (32, 1000, 999)])
def test_kth_plain_matches_pallas_interpret(b, s, k):
    h = _rows(b, s, 3 * k + s)
    want = pallas_topk.exact_kth_value_pallas(jnp.asarray(h), k, True)
    got = topk.exact_kth_value(torch.from_numpy(h), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), topk._topk_stats_plain(torch.from_numpy(h), k).kth.numpy())


def _masked_rows(b: int, s: int, seed: int) -> np.ndarray:
    """`_rows` with a twentieth of the columns pinned as bench.py pins dead
    latents: bias -1e6, where f32 values lie 0.0625 apart and tie exactly."""
    h = _rows(b, s, seed)
    n = max(s // 20, 1)
    h[:, :n] = h[:, :n] * 4.0 - 1e6
    return h


def _masks(s: int, k: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {  # test_ops_topk.py's masks, plus none masked and the pinned set
        "half": rng.random(s) < 0.5,
        "fewer-than-k": np.arange(s) < k - 3,
        "all-masked": np.zeros(s, bool),
        "none-masked": np.ones(s, bool),
        "pinned-dead": np.arange(s) < max(s // 20, 1),
    }


@pytest.mark.parametrize("b,s,k", [(64, 512, 16), (32, 1024, 512), (32, 300, 8)])
def test_kth_masked_plain_matches_jax(b, s, k):
    h = _masked_rows(b, s, b + s + k)
    for name, mask in _masks(s, k, s + k).items():
        got = topk.exact_kth_value_masked(torch.from_numpy(h), torch.from_numpy(mask), k).numpy()
        pallas = pallas_topk.exact_kth_value_masked_pallas(
            jnp.asarray(h), jnp.asarray(mask[None, :], jnp.int32), k, True
        )
        np.testing.assert_array_equal(got, np.asarray(pallas), err_msg=name)
        xla = jtopk.exact_kth_value_masked(jnp.asarray(h), jnp.asarray(mask), k)
        np.testing.assert_array_equal(got, np.asarray(xla), err_msg=name)
        if mask.sum() < k:
            assert np.isneginf(got).all(), name


def test_kth_wrappers_take_plain_version_on_cpu():
    h = torch.from_numpy(_masked_rows(32, 128, 4))
    mask = torch.arange(128) < 40
    before = (cuda_kth.kth_value_cuda.launches, cuda_kth.kth_value_masked_cuda.launches)
    assert torch.equal(cuda_kth.kth_value_cuda(h, 8), topk._kth_plain(h, 8))
    assert torch.equal(cuda_kth.kth_value_masked_cuda(h, mask, 8), topk._kth_masked_plain(h, mask, 8))
    assert (cuda_kth.kth_value_cuda.launches, cuda_kth.kth_value_masked_cuda.launches) == before
    # Non-differentiable: the input's graph is cut.
    hg = h.clone().requires_grad_(True)
    assert not topk.exact_kth_value(hg, 8).requires_grad
    assert not topk.exact_kth_value_masked(hg, mask, 8).requires_grad
