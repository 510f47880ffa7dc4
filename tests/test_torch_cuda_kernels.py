"""The four CUDA kernels against their plain versions on the card, at small
shapes with edge cases. Every test here needs a CUDA device and skips
without one. The file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py

(`--noconftest` because tests/conftest.py imports jax.)
"""

import numpy as np
import pytest
import torch

from saev_tpu_torch.ops import cuda_matryoshka as cm
from saev_tpu_torch.ops import cuda_topk, topk
from saev_tpu_torch.ops import matryoshka as tmat

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def rel_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))


def _rows(b: int, s: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(b, s)).astype(np.float32)
    h[0] = 0.0
    h[1] = -np.abs(h[1])
    h[2] = -np.abs(h[2])
    h[2, :3] = [1.0, 2.0, 3.0]
    h[3, : min(40, s)] = 7.0
    h[4, ::2] = -0.0
    h[:, 5:9] = 0.0
    return torch.from_numpy(h)


@pytest.mark.parametrize("b,s,k", [(256, 4096, 32), (64, 100, 100), (33, 16384, 32), (8, 20000, 7)])
def test_topk_stats_kernel_matches_plain(dev, b, s, k):
    h = _rows(b, s, b + s).to(dev)
    before = cuda_topk.topk_stats_cuda.launches
    got = cuda_topk.topk_stats_cuda(h, k)
    want = topk._topk_stats_plain(h, k)
    torch.cuda.synchronize()
    assert cuda_topk.topk_stats_cuda.launches == before + 1
    for name in ("kth", "f", "live", "l0"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    torch.testing.assert_close(got.l1, want.l1, rtol=1e-6, atol=0)


CUTS = {
    "m0-r0-full": ([5, 700, 1024, 2048], 512),
    "two-in-group": ([100, 101, 1536, 2048], 512),
    "single": ([2048], 1024),
    "boundaries": ([1024, 2048], 1024),
}


@pytest.mark.parametrize("cuts,g", CUTS.values(), ids=CUTS.keys())
def test_matryoshka_kernels_match_plain(dev, cuts, g):
    gen = torch.Generator(device=dev).manual_seed(len(cuts) + g)
    b, s, d = 256, 2048, 128
    f = torch.randn((b, s), generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((s, d), generator=gen, device=dev) / 32).to(torch.bfloat16)
    x = torch.randn((b, d), generator=gen, device=dev)
    b_dec = torch.randn((d,), generator=gen, device=dev) * 0.1
    p = torch.tensor(cuts, dtype=torch.int32, device=dev)
    m = torch.div(p, g, rounding_mode="floor").to(torch.int32)
    r = (p - m * g).to(torch.int32)
    iu = 1.0 / x.abs().max()

    e, xhat, loss = cm.grouped_prefix_err(f, w, x, b_dec, iu, m, r, group_size=g)
    e2, _, loss2 = cm.grouped_prefix_err(f, w, x, b_dec, iu, m, r, group_size=g)
    pe, pxhat, ploss = cm.grouped_prefix_err_plain(f, w, x, b_dec, iu, m, r, group_size=g)
    assert torch.equal(loss, loss2) and torch.equal(e, e2)
    assert abs(float(loss) - float(ploss)) <= 1e-5 * abs(float(ploss))
    assert rel_norm(xhat, pxhat) <= 1e-4 and rel_norm(e, pe) <= 1e-2

    scale = torch.tensor([0.37], device=dev)
    for df_dtype in (torch.bfloat16, torch.float32):
        df, da = cm.grouped_matmul_dgrad(w, e, m, r, scale, group_size=g, df_dtype=df_dtype)
        pdf, pda = cm.grouped_matmul_dgrad_plain(w, e, m, r, scale, group_size=g, df_dtype=df_dtype)
        assert df.dtype == df_dtype
        assert rel_norm(da, pda) <= 1e-2 and rel_norm(df, pdf) <= 1e-2

    dw = cm.grouped_matmul_wgrad(f, da, e, m, r, scale, group_size=g)
    pdw = cm.grouped_matmul_wgrad_plain(f, da, e, m, r, scale, group_size=g)
    assert rel_norm(dw, pdw) <= 1e-4


def test_prefix_mse_kernel_path_matches_plain_path(dev):
    """bf16 kernels on the card against the f32 plain algebra on the CPU."""
    gen = torch.Generator().manual_seed(3)
    b, s, d = 128, 2048, 128
    w = torch.randn((s, d), generator=gen) / 32
    b_dec = torch.randn((d,), generator=gen) * 0.1
    f = torch.randn((b, s), generator=gen) * (torch.rand((b, s), generator=gen) < 0.05)
    x = torch.randn((b, d), generator=gen)
    p = torch.tensor([9, 1024, 1500, s], dtype=torch.int32)
    grads = []
    for device in ("cpu", dev):
        leaves = [t.detach().to(device).requires_grad_(True) for t in (w, b_dec, f)]
        loss, _ = tmat.prefix_mse(*leaves, x.to(device), p.to(device), 1024)
        loss.backward()
        grads.append([loss.detach().cpu()] + [t.grad.float().cpu() for t in leaves])
    for got, want in zip(grads[1], grads[0]):
        assert rel_norm(got, want) <= 1e-2


def test_wrappers_refuse_bad_shapes(dev):
    f = torch.zeros((100, 2048), dtype=torch.bfloat16, device=dev)  # batch not a multiple of 128
    w = torch.zeros((2048, 128), dtype=torch.bfloat16, device=dev)
    x = torch.zeros((100, 128), device=dev)
    m = torch.zeros((1,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="batch"):
        cm.grouped_prefix_err(f, w, x, torch.zeros(128, device=dev), torch.ones(1, device=dev), m, m)
    with pytest.raises(ValueError, match="float32"):
        cuda_topk.topk_stats_cuda(torch.zeros((4, 8), dtype=torch.float64, device=dev), 2)
    with pytest.raises(NotImplementedError, match="K6"):
        topk.exact_kth_value(torch.zeros((4, 8), device=dev), 2)
