"""The eleven CUDA kernels against their plain versions on the card, at small
shapes with edge cases, and the train step's products at
matmul_precision="default" (bf16 operands, f32 results) against their
algebra on the CPU. Every test here needs a CUDA device and skips without
one. The file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py

(`--noconftest` because tests/conftest.py imports jax.)
"""

import numpy as np
import pytest
import torch
from encode_stats_model import cap, p1_model
from kth_select_model import (cand_cap, cluster_stats_model, count_loop_model, k1_layout, k1_model, k5_model,
                              k5_wide_model, k6_model, kth_ops_model, wide_model)

from saev_tpu_torch.framework import train
from saev_tpu_torch.nn import modeling, objectives
from saev_tpu_torch.ops import cuda_kth, cuda_topk, topk
from saev_tpu_torch.ops import cuda_matryoshka as cm
from saev_tpu_torch.ops import matryoshka as tmat
from saev_tpu_torch.scripts import microbench_kth, proto_encode_stats, proto_gouter, proto_kth_ops

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


def _k1_select_rows(b: int, s: int, seed: int) -> torch.Tensor:
    """`_rows` with rows that overflow K1's candidate buffer: tied at the
    top over twice its capacity, and all -inf beside one finite value."""
    h = _rows(b, s, seed)
    h[5, : min(2 * cand_cap(), s)] = 3.5
    h[6] = -np.inf
    h[6, s // 2] = 1.0
    return h


# (b, s, k): k just below, at and above T' (the threads that hold a column:
# 256 at s 2048 and 16384), S not a multiple of 4 (scalar loads and stores),
# and the production row width.
K1_SELECT = [(16, 2048, 255), (16, 2048, 256), (16, 2048, 257), (33, 16384, 32), (16, 16384, 257),
             (16, 1001, 32), (8, 16383, 32), (8, 20001, 321), (8, 32765, 32), (8, 30, 8)]


@pytest.mark.parametrize("b,s,k", K1_SELECT)
def test_topk_stats_kernel_select_branches(dev, b, s, k):
    """K1's candidate filter and its fallback against the plain version
    (kth, f, live, L0 bitwise; L1 within 1e-6) and against the model of its
    select (kth_select_model.k1_model): the same rows fall back, and L1 has
    the model's bits (the kernel's reduction order); two calls agree."""
    h = _k1_select_rows(b, s, b + s + k)
    model = k1_model(h, k)
    h = h.to(dev)
    fallback = torch.zeros(1, dtype=torch.int32, device=dev)
    got = cuda_topk.topk_stats_cuda(h, k, fallback)
    again = cuda_topk.topk_stats_cuda(h, k)
    want = topk._topk_stats_plain(h, k)
    torch.cuda.synchronize()
    for name in ("kth", "f", "live", "l0"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    torch.testing.assert_close(got.l1, want.l1, rtol=1e-6, atol=0)
    assert int(fallback) == int(model["fallback"].sum())
    assert torch.equal(got.l1.cpu().view(torch.int32), model["l1"].view(torch.int32))
    for a, b_ in zip(got, again):
        assert torch.equal(a, b_)
    if k == 32 and s >= 2 * cand_cap():
        assert 0 < int(fallback) < b  # both branches ran (rows 0, 5 and 6 fall back)
    if k > min(k1_layout(s)[1], -(-s // 4)):
        assert int(fallback) == b  # no lower bound: every row falls back


def test_topk_stats_fallback_count_is_checked(dev):
    h = torch.zeros((4, 64), device=dev)
    for bad in (torch.zeros(1, dtype=torch.int64, device=dev), torch.zeros(2, dtype=torch.int32, device=dev),
                torch.zeros(1, dtype=torch.int32)):
        with pytest.raises(ValueError, match="fallback"):
            cuda_topk.topk_stats_cuda(h, 2, bad)


CUTS = {
    "m0-r0-full": ([5, 700, 1024, 2048], 512),
    "two-in-group": ([100, 101, 1536, 2048], 512),
    "single": ([2048], 1024),
    "boundaries": ([1024, 2048], 1024),
    # Cuts inside and on K2's 16-lane steps, and a small copy of the seed-0
    # sampled cuts (five in the first 16-lane step).
    "k16-steps": ([1, 2, 15, 16, 17, 63, 64, 65, 2048], 1024),
    "sampled": ([2, 5, 7, 8, 14, 27, 77, 113, 487, 2048], 512),
    # Past 64 cuts (fault ROADMAP §3.6): every lane of the first 16-lane
    # steps cut, then cuts over every group.
    "65-cuts": (list(range(1, 41)) + list(range(100, 2048, 80))[:24] + [2048], 512),
    "128-cuts": (list(range(1, 33)) + list(range(33, 2048, 15))[:95] + [2048], 512),
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
        assert torch.equal(da.view(torch.int16), pda.view(torch.int16))
        assert rel_norm(df, pdf) <= 1e-2

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


def test_prefix_mse_kernel_path_pads_ragged_batch(dev):
    """B = 1000, not a multiple of the kernels' 128-row tile: the kernel path
    pads it, and K2-K4 run, against the f32 plain algebra on the CPU."""
    gen = torch.Generator().manual_seed(4)
    b, s, d = 1000, 2048, 128
    w = torch.randn((s, d), generator=gen) / 32
    b_dec = torch.randn((d,), generator=gen) * 0.1
    f = torch.randn((b, s), generator=gen) * (torch.rand((b, s), generator=gen) < 0.05)
    x = torch.randn((b, d), generator=gen)
    p = torch.tensor([7, 1024, 1500, s], dtype=torch.int32)
    fns = (cm.grouped_prefix_err, cm.grouped_matmul_dgrad, cm.grouped_matmul_wgrad)
    before = [fn.launches for fn in fns]
    outs = []
    for device in ("cpu", dev):
        leaves = [t.detach().to(device).requires_grad_(True) for t in (w, b_dec, f)]
        loss, xhat = tmat.prefix_mse(*leaves, x.to(device), p.to(device), 1024)
        loss.backward()
        outs.append([loss.detach().cpu(), xhat.cpu()] + [t.grad.float().cpu() for t in leaves])
    assert [fn.launches for fn in fns] == [n + 1 for n in before]
    assert tuple(outs[1][1].shape) == (b, d) and tuple(outs[1][4].shape) == (b, s)
    for got, want in zip(outs[1], outs[0]):
        assert rel_norm(got, want) <= 1e-2


@pytest.mark.parametrize("s,g", [(64, 1024), (384, 192)], ids=["d_sae-64", "g-192"])
def test_prefix_mse_kernel_path_pads_small_group(dev, s, g):
    """A group that is not a multiple of the kernels' 128-latent tile (d_sae
    64, so g 64; g 192): the kernel path pads each group, and K2-K4 run,
    against the f32 plain algebra on the CPU."""
    gen = torch.Generator().manual_seed(s + g)
    b, d = 128, 128
    w = torch.randn((s, d), generator=gen) / 8
    b_dec = torch.randn((d,), generator=gen) * 0.1
    f = torch.randn((b, s), generator=gen) * (torch.rand((b, s), generator=gen) < 0.2)
    x = torch.randn((b, d), generator=gen)
    p = torch.tensor([5, 40, s] if s <= g else [5, 100, g, g + 7, s], dtype=torch.int32)
    fns = (cm.grouped_prefix_err, cm.grouped_matmul_dgrad, cm.grouped_matmul_wgrad)
    before = [fn.launches for fn in fns]
    outs = []
    for device in ("cpu", dev):
        leaves = [t.detach().to(device).requires_grad_(True) for t in (w, b_dec, f)]
        loss, xhat = tmat.prefix_mse(*leaves, x.to(device), p.to(device), g)
        loss.backward()
        outs.append([loss.detach().cpu(), xhat.cpu()] + [t.grad.float().cpu() for t in leaves])
    assert [fn.launches for fn in fns] == [n + 1 for n in before]
    assert [tuple(t.shape) for t in outs[1][2:]] == [(s, d), (d,), (b, s)]
    for got, want in zip(outs[1], outs[0]):
        assert rel_norm(got, want) <= 1e-2


@pytest.mark.parametrize("d", [64, 192])
def test_prefix_mse_kernel_path_pads_d_model(dev, d):
    """A d_model that is not a multiple of the kernels' 128-column tile (64,
    192): the kernel path pads W, b_dec and x with zero columns, and K2-K4
    run, against the f32 plain algebra on the CPU."""
    gen = torch.Generator().manual_seed(d)
    b, s = 128, 2048
    w = torch.randn((s, d), generator=gen) / 32
    b_dec = torch.randn((d,), generator=gen) * 0.1
    f = torch.randn((b, s), generator=gen) * (torch.rand((b, s), generator=gen) < 0.05)
    x = torch.randn((b, d), generator=gen)
    p = torch.tensor([7, 1024, 1500, s], dtype=torch.int32)
    fns = (cm.grouped_prefix_err, cm.grouped_matmul_dgrad, cm.grouped_matmul_wgrad)
    before = [fn.launches for fn in fns]
    outs = []
    for device in ("cpu", dev):
        leaves = [t.detach().to(device).requires_grad_(True) for t in (w, b_dec, f)]
        loss, xhat = tmat.prefix_mse(*leaves, x.to(device), p.to(device), 1024)
        loss.backward()
        outs.append([loss.detach().cpu(), xhat.cpu()] + [t.grad.float().cpu() for t in leaves])
    assert [fn.launches for fn in fns] == [n + 1 for n in before]
    assert [tuple(t.shape) for t in outs[1][1:]] == [(b, d), (s, d), (d,), (b, s)]
    for got, want in zip(outs[1], outs[0]):
        assert rel_norm(got, want) <= 1e-2


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equal, with -0.0 and +0.0 taken as one value (adding +0.0
    turns -0.0 into +0.0 and leaves every other value as it is)."""
    return torch.equal((a + 0.0).view(torch.int32), (b + 0.0).view(torch.int32))


@pytest.mark.parametrize("b,s,k", [(256, 4096, 32), (64, 100, 100), (33, 16384, 32), (8, 20000, 7), (16, 1000, 512)])
def test_kth_kernel_matches_plain(dev, b, s, k):
    h = _rows(b, s, b + s + 1).to(dev)
    before = cuda_kth.kth_value_cuda.launches
    got = topk.exact_kth_value(h, k)
    want = topk._kth_plain(h, min(k, s))
    torch.cuda.synchronize()
    assert cuda_kth.kth_value_cuda.launches == before + 1
    assert _same_bits(got, want)
    assert _same_bits(got, cuda_topk.topk_stats_cuda(h, k).kth)


def _at_offset(h: torch.Tensor, dev, offset: int) -> torch.Tensor:
    """h on the card, its first element `offset` floats into an allocation
    (offset 1: not 16-byte aligned, so K6 takes one CTA a row)."""
    buf = torch.empty(h.numel() + offset, device=dev)
    out = buf[offset:].view(h.shape)
    out.copy_(h)
    return out


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("b,s,k", K1_SELECT)
def test_kth_kernel_select_branches(dev, b, s, k, offset):
    """K6 on K1's select, streamed (S % 4 == 0, h 16-byte aligned) and one
    CTA a row (otherwise): kth bitwise against the plain version, K1's kth
    and the model of its select (kth_select_model.k6_model), whose rows fall
    back; two calls agree."""
    h = _k1_select_rows(b, s, b + s + k)
    model = k6_model(h, k)
    hd = _at_offset(h, dev, offset)
    fallback = torch.zeros(1, dtype=torch.int32, device=dev)
    before = cuda_kth.kth_value_cuda.launches
    got = cuda_kth.kth_value_cuda(hd, k, fallback)
    again = cuda_kth.kth_value_cuda(hd, k)
    torch.cuda.synchronize()
    assert cuda_kth.kth_value_cuda.launches == before + 2
    assert _same_bits(got, topk._kth_plain(hd, min(k, s)))
    assert torch.equal(got.cpu().view(torch.int32), model["kth"].view(torch.int32))
    assert torch.equal(got, cuda_topk.topk_stats_cuda(hd.contiguous(), k).kth)
    assert torch.equal(got, again)
    assert int(fallback) == int(model["fallback"].sum())
    if k == 32 and s >= 2 * cand_cap():
        assert 0 < int(fallback) < b  # both branches ran (rows 0, 5 and 6 fall back)


def test_kth_kernel_gaussian_rows_take_the_filter(dev):
    """No Gaussian row of the production width falls back, streamed or not."""
    h = torch.randn((264, 16384), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    for hd in (h, _at_offset(h, dev, 1)):
        fallback = torch.zeros(1, dtype=torch.int32, device=dev)
        got = cuda_kth.kth_value_cuda(hd, 32, fallback)
        assert int(fallback) == 0 and _same_bits(got, topk._kth_plain(h, 32))


def _masks(s: int, k: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "half": rng.random(s) < 0.5,
        "fewer-than-k": np.arange(s) < k - 3,
        "all-masked": np.zeros(s, bool),
        "none-masked": np.ones(s, bool),
        "5%-dead": np.arange(s) < max(s // 20, 1),
    }


@pytest.mark.parametrize(
    "b,s,k", [(128, 1024, 512), (64, 4096, 16), (64, 4096, 512), (32, 1000, 64), (16, 16384, 512)]
)
def test_kth_masked_kernel_matches_plain(dev, b, s, k):
    h = _rows(b, s, b + s + 2)
    # Dead latents as the bench state pins them: bias -1e6, where f32 is
    # spaced 0.0625 apart and many pre-activations tie exactly.
    n_dead = max(s // 20, 1)
    h[:, :n_dead] = h[:, :n_dead] * 4.0 - 1e6
    h = h.to(dev)
    for name, mask in _masks(s, k, s).items():
        mt = torch.from_numpy(mask).to(dev)
        before = cuda_kth.kth_value_masked_cuda.launches
        got = topk.exact_kth_value_masked(h, mt, k)
        want = topk._kth_masked_plain(h, mt, min(k, s))
        torch.cuda.synchronize()
        assert cuda_kth.kth_value_masked_cuda.launches == before + 1, name
        assert _same_bits(got, want), name
        if mask.sum() < k:
            assert bool(torch.isneginf(got).all()), name


# (s, n unmasked, k): n = 1, n = k, n = k - 1, n just above one warp's 1024
# keys (2 warps a row) and above 4 and 8 warps' (8 and 16 warps a row).
K5_SIZES = [(1024, 1, 1), (1024, 512, 512), (1024, 511, 512), (2048, 1025, 512), (8192, 4097, 512),
            (16384, 8193, 512), (4096, 3276, 512)]


@pytest.mark.parametrize("s,n,k", K5_SIZES)
def test_kth_masked_kernel_group_sizes(dev, s, n, k):
    """Prefix and scattered masks of n columns, against the plain version
    and the model of K5's select, bitwise."""
    h = _rows(64, s, s + n)
    n_dead = max(s // 20, 1)
    h[:, :n_dead] = h[:, :n_dead] * 4.0 - 1e6
    rng = np.random.default_rng(n)
    for name, cols in (("prefix", np.arange(n)), ("scattered", np.sort(rng.choice(s, n, replace=False)))):
        mask = np.zeros(s, bool)
        mask[cols] = True
        want_model, n_model, _ = k5_model(h, torch.from_numpy(mask), k)
        assert n_model == n
        mt = torch.from_numpy(mask).to(dev)
        got = topk.exact_kth_value_masked(h.to(dev), mt, k)
        want = topk._kth_masked_plain(h.to(dev), mt, k)
        torch.cuda.synchronize()
        assert _same_bits(got, want), name
        assert torch.equal(got.cpu().view(torch.int32), want_model.view(torch.int32)), name
        assert bool(torch.isneginf(got).all()) == (n < k), name


@pytest.mark.parametrize("s", [16384, 32768])
def test_kth_masked_kernel_scattered_wide(dev, s):
    """A scattered 5% mask, half and all columns at the widest rows."""
    h = _rows(16, s, s).to(dev)
    rng = np.random.default_rng(s)
    for name, mask in (("5%", rng.random(s) < 0.05), ("half", rng.random(s) < 0.5), ("all", np.ones(s, bool))):
        mt = torch.from_numpy(mask).to(dev)
        got = topk.exact_kth_value_masked(h, mt, 512)
        want = topk._kth_masked_plain(h, mt, 512)
        torch.cuda.synchronize()
        assert _same_bits(got, want), name


def test_wrappers_refuse_bad_shapes(dev):
    f = torch.zeros((100, 2048), dtype=torch.bfloat16, device=dev)  # batch not a multiple of 128
    w = torch.zeros((2048, 128), dtype=torch.bfloat16, device=dev)
    x = torch.zeros((100, 128), device=dev)
    m = torch.zeros((1,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="batch"):
        cm.grouped_prefix_err(f, w, x, torch.zeros(128, device=dev), torch.ones(1, device=dev), m, m)
    with pytest.raises(ValueError, match="float32"):
        cuda_topk.topk_stats_cuda(torch.zeros((4, 8), dtype=torch.float64, device=dev), 2)
    for bad in (torch.zeros((4, 8), dtype=torch.float64, device=dev),
                torch.zeros((2, 4, 8), device=dev),
                torch.zeros((8, 4), device=dev).T):
        with pytest.raises(ValueError):
            topk.exact_kth_value(bad, 2)
        with pytest.raises(ValueError):
            topk.exact_kth_value_masked(bad, torch.ones(bad.shape[-1], dtype=torch.bool, device=dev), 2)
    with pytest.raises(ValueError, match="mask"):
        topk.exact_kth_value_masked(torch.zeros((4, 8), device=dev), torch.ones(8, device=dev), 2)
    with pytest.raises(ValueError, match="fallback"):
        cuda_kth.kth_value_cuda(torch.zeros((4, 8), device=dev), 2, torch.zeros(1, dtype=torch.int64, device=dev))


def _matryoshka_operands(dev, seed: int, b: int = 256, s: int = 2048, d: int = 128):
    gen = torch.Generator(device=dev).manual_seed(seed)
    f = (torch.randn((b, s), generator=gen, device=dev)
         * (torch.rand((b, s), generator=gen, device=dev) < 0.2)).to(torch.bfloat16)
    w = (torch.randn((s, d), generator=gen, device=dev) / 32).to(torch.bfloat16)
    x = torch.randn((b, d), generator=gen, device=dev)
    b_dec = torch.randn((d,), generator=gen, device=dev) * 0.1
    return f, w, x, b_dec


def _mr(cuts, g, dev):
    p = torch.tensor(cuts, dtype=torch.int32, device=dev)
    m = torch.div(p, g, rounding_mode="floor").to(torch.int32)
    return m, (p - m * g).to(torch.int32)


# K3's cut sets: CUTS, 64 cuts (about 16 in each group), and cuts inside
# a 128-column tile with two in one tile (r 130 and 190 of group 1).
K3_CUTS = CUTS | {
    "64-cuts": (sorted(np.random.default_rng(64).choice(np.arange(1, 2048), 63, replace=False).tolist())
                + [2048], 512),
    "in-tile": ([37, 1154, 1214, 1724, 2048], 1024),
}


@pytest.mark.parametrize("df_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("b,d", [(384, 128), (384, 1024)])  # 2 and 16 K steps: fewer and more than the stages
@pytest.mark.parametrize("cuts,g", K3_CUTS.values(), ids=K3_CUTS.keys())
def test_dgrad_kernel_matches_plain(dev, cuts, g, b, d, df_dtype):
    """dA bit for bit; df within rel-norm 1e-2 (f32 sums in another order);
    both the same bits in a second run (no atomics)."""
    s = 2048
    gen = torch.Generator(device=dev).manual_seed(len(cuts) + g + d)
    w = (torch.randn((s, d), generator=gen, device=dev) / 32).to(torch.bfloat16)
    e = torch.randn((len(cuts), b, d), generator=gen, device=dev).to(torch.bfloat16)
    m, r = _mr(cuts, g, dev)
    scale = torch.tensor([0.37], device=dev)
    before = cm.grouped_matmul_dgrad.launches
    df, da = cm.grouped_matmul_dgrad(w, e, m, r, scale, group_size=g, df_dtype=df_dtype)
    df2, da2 = cm.grouped_matmul_dgrad(w, e, m, r, scale, group_size=g, df_dtype=df_dtype)
    pdf, pda = cm.grouped_matmul_dgrad_plain(w, e, m, r, scale, group_size=g, df_dtype=df_dtype)
    torch.cuda.synchronize()
    assert cm.grouped_matmul_dgrad.launches == before + 2
    assert df.dtype == df_dtype and da.dtype == torch.bfloat16
    assert torch.equal(da.view(torch.int16), pda.view(torch.int16))
    assert torch.equal(da2.view(torch.int16), da.view(torch.int16))
    assert torch.equal(df2, df) and bool(torch.isfinite(df).all())
    assert rel_norm(df, pdf) <= 1e-2


# K4's cut sets over d_sae 2048, each read with groups of 128 and of 1024:
# the seed-0 sampled cuts, hand-set cuts (two in one group, r 0 on a
# boundary), 64 cuts, every cut but d_sae in group 0, two cuts in one
# 128-latent tile, one cut with r < 64, r = 0 on a group boundary, and only
# the full prefix.
K4_CUTS = {
    "sampled": [2, 5, 7, 8, 13, 24, 63, 87, 292, 2048],
    "hand-set": [13, 87, 128, 256, 625, 626, 1125, 1536, 1875, 2048],
    "64-cuts": K3_CUTS["64-cuts"][0],
    "all-in-group-0": [3, 9, 17, 40, 64, 65, 100, 127, 2048],
    "two-in-one-tile": [130, 190, 2048],
    "r-below-64": [37, 2048],
    "r-0-boundary": [1024, 2048],
    "full-only": [2048],
    "65-cuts": CUTS["65-cuts"][0],
    "128-cuts": CUTS["128-cuts"][0],
}


@pytest.mark.parametrize("b", [128, 1024])  # 2 and 16 K steps: fewer and more than the stages
@pytest.mark.parametrize("d", [128, 1024])
@pytest.mark.parametrize("g", [128, 1024])
@pytest.mark.parametrize("cuts", K4_CUTS.values(), ids=K4_CUTS.keys())
def test_wgrad_kernel_matches_plain(dev, cuts, g, d, b):
    """dW within rel-norm 1e-4 of the plain version (f32 sums in another
    order) and the same bits in a second run (equal work items and a
    fixed-order combine, no atomics)."""
    s = 2048
    gen = torch.Generator(device=dev).manual_seed(len(cuts) + g + d + b)
    f = (torch.randn((b, s), generator=gen, device=dev)
         * (torch.rand((b, s), generator=gen, device=dev) < 0.2)).to(torch.bfloat16)
    da = torch.randn((b, s // g, d), generator=gen, device=dev).to(torch.bfloat16)
    e = torch.randn((len(cuts), b, d), generator=gen, device=dev).to(torch.bfloat16)
    m, r = _mr(cuts, g, dev)
    scale = torch.tensor([0.37], device=dev)
    before = cm.grouped_matmul_wgrad.launches
    dw = cm.grouped_matmul_wgrad(f, da, e, m, r, scale, group_size=g)
    dw2 = cm.grouped_matmul_wgrad(f, da, e, m, r, scale, group_size=g)
    pdw = cm.grouped_matmul_wgrad_plain(f, da, e, m, r, scale, group_size=g)
    torch.cuda.synchronize()
    assert cm.grouped_matmul_wgrad.launches == before + 2
    assert dw.dtype == torch.float32 and bool(torch.isfinite(dw).all())
    assert _same_bits(dw, dw2)
    assert rel_norm(dw, pdw) <= 1e-4


@pytest.mark.parametrize("cuts,g", CUTS.values(), ids=CUTS.keys())
def test_prefix_base_kernel_matches_plain_and_k2(dev, cuts, g):
    f, w, x, b_dec = _matryoshka_operands(dev, len(cuts) + g + 1)
    m, r = _mr(cuts, g, dev)
    before = cm.grouped_prefix_base.launches
    base, xhat = cm.grouped_prefix_base(f, w, m, r, group_size=g)
    base16, _ = cm.grouped_prefix_base(f, w, m, r, group_size=g, base_dtype=torch.bfloat16)
    assert cm.grouped_prefix_base.launches == before + 2
    pbase, pxhat = cm.grouped_prefix_base_plain(f, w, m, r, group_size=g)
    assert rel_norm(base, pbase) <= 1e-4 and rel_norm(xhat, pxhat) <= 1e-4
    assert torch.equal(base16.view(torch.int16), base.to(torch.bfloat16).view(torch.int16))
    e, k2_xhat, _ = cm.grouped_prefix_err(f, w, x, b_dec, 1.0 / x.abs().max(), m, r, group_size=g)
    assert _same_bits(xhat, k2_xhat)
    rebuilt = (base + (b_dec - x)).to(torch.bfloat16)
    assert torch.equal(rebuilt.view(torch.int16), e.view(torch.int16))


@pytest.mark.parametrize("d", [128, 1024])
@pytest.mark.parametrize("cuts,g", CUTS.values(), ids=CUTS.keys())
def test_prefix_fwd_kernels_match_plain(dev, cuts, g, d):
    """K2 at its tolerances (loss rel 1e-5, xhat rel-norm 1e-4, E rel-norm
    1e-2, the same bits in two calls) and K7 against its plain version and
    against K2 bit for bit (xhat, and bf16(base + b_dec - x) = E), at one
    and eight 128-column tiles of d_model."""
    f, w, x, b_dec = _matryoshka_operands(dev, len(cuts) + g + d, d=d)
    m, r = _mr(cuts, g, dev)
    iu = 1.0 / x.abs().max()
    before = cm.grouped_prefix_err.launches, cm.grouped_prefix_base.launches
    e, xhat, loss = cm.grouped_prefix_err(f, w, x, b_dec, iu, m, r, group_size=g)
    e2, xhat2, loss2 = cm.grouped_prefix_err(f, w, x, b_dec, iu, m, r, group_size=g)
    base, base_xhat = cm.grouped_prefix_base(f, w, m, r, group_size=g)
    base16, _ = cm.grouped_prefix_base(f, w, m, r, group_size=g, base_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert (cm.grouped_prefix_err.launches, cm.grouped_prefix_base.launches) == (before[0] + 2, before[1] + 2)
    assert torch.equal(e.view(torch.int16), e2.view(torch.int16)) and torch.equal(loss, loss2)
    assert _same_bits(xhat, xhat2)
    pe, pxhat, ploss = cm.grouped_prefix_err_plain(f, w, x, b_dec, iu, m, r, group_size=g)
    assert abs(float(loss) - float(ploss)) <= 1e-5 * abs(float(ploss))
    assert rel_norm(xhat, pxhat) <= 1e-4 and rel_norm(e, pe) <= 1e-2
    pbase, _ = cm.grouped_prefix_base_plain(f, w, m, r, group_size=g)
    assert rel_norm(base, pbase) <= 1e-4
    assert _same_bits(base_xhat, xhat)
    rebuilt = (base + (b_dec - x)).to(torch.bfloat16)
    assert torch.equal(rebuilt.view(torch.int16), e.view(torch.int16))
    assert torch.equal(base16.view(torch.int16), base.to(torch.bfloat16).view(torch.int16))


@pytest.mark.parametrize("w_holds", ["column", "lane"])
def test_prefix_fwd_kernels_read_one_hot_layouts(dev, w_holds):
    """Layout probe of K2's and K7's operands: each row of f is one-hot at a
    permuted lane, and W holds its column index or its lane index (integers
    below 256, exact in bf16), with x = b_dec = 0. Every E_j, base_j and
    xhat entry is then an exact integer, so a wrong offset in either
    operand's swizzle or in the epilogue's stores shows as a mismatch."""
    b, s, d, g = 256, 256, 256, 128
    lane = torch.from_numpy(np.random.default_rng(7).permutation(s)).to(dev)
    f = torch.zeros((b, s), device=dev)
    f[torch.arange(b, device=dev), lane] = 1.0
    f = f.to(torch.bfloat16)
    grid = torch.arange(d, device=dev)[None, :] if w_holds == "column" else torch.arange(s, device=dev)[:, None]
    w = grid.expand(s, d).float().contiguous().to(torch.bfloat16)
    x = torch.zeros((b, d), device=dev)
    b_dec = torch.zeros((d,), device=dev)
    m, r = _mr([1, 15, 16, 17, 100, 128, 200, 256], g, dev)
    e, xhat, _ = cm.grouped_prefix_err(f, w, x, b_dec, torch.ones(1, device=dev), m, r, group_size=g)
    base, base_xhat = cm.grouped_prefix_base(f, w, m, r, group_size=g)
    pe, pxhat, _ = cm.grouped_prefix_err_plain(f, w, x, b_dec, torch.ones(1, device=dev), m, r, group_size=g)
    torch.cuda.synchronize()
    assert torch.equal(xhat, pxhat) and torch.equal(base_xhat, pxhat)
    assert torch.equal(e.float(), pe.float()) and torch.equal(base, pe.float())


@pytest.mark.parametrize("cuts,g", CUTS.values(), ids=CUTS.keys())
def test_gouter_kernel_matches_plain_and_k2(dev, cuts, g):
    f, w, x, b_dec = _matryoshka_operands(dev, len(cuts) + g + 2)
    m, r = _mr(cuts, g, dev)
    before = proto_gouter.grouped_prefix_err_gouter.launches
    res = proto_gouter.check(dict(f=f, w=w, x=x, b_dec=b_dec, inv_upper=1.0 / x.abs().max(), m=m, r=r),
                             group_size=g)
    assert proto_gouter.grouped_prefix_err_gouter.launches == before + 2
    assert res["repeatable"]


@pytest.mark.parametrize("cuts,g", [CUTS["sampled"], CUTS["m0-r0-full"], CUTS["65-cuts"]],
                         ids=["sampled", "m0-r0-full", "65-cuts"])
def test_gouter_kernel_odd_row_tiles(dev, cuts, g):
    """P2 at B 384: three row tiles, so the second cluster has an idle
    partner that loads and releases W's halves and stores nothing; against
    K2 and its plain version at the module's limits, bitwise repeatable,
    one call one launch of its product."""
    f, w, x, b_dec = _matryoshka_operands(dev, len(cuts) + g + 3, b=384)
    m, r = _mr(cuts, g, dev)
    before = proto_gouter.grouped_prefix_err_gouter.launches
    res = proto_gouter.check(dict(f=f, w=w, x=x, b_dec=b_dec, inv_upper=1.0 / x.abs().max(), m=m, r=r),
                             group_size=g)
    assert proto_gouter.grouped_prefix_err_gouter.launches == before + 2
    assert res["repeatable"]


# Rows wider than the narrow kernels hold (kth_wide.cu): a width just past
# them (scalar loads), one with S % 4 == 0 that no slice width divides, and
# the 64x and 128x dictionaries.
WIDE_S = [32769, 40000, 65536, 131072]


@pytest.mark.parametrize("k", [1, 32, 512])
@pytest.mark.parametrize("s", WIDE_S)
def test_wide_route_matches_plain(dev, s, k):
    """K1 on its cluster route (kth, f, live, L0 bitwise; L1 within 1e-6
    and bitwise its model's rank-order sum) and K6 on the walk (bitwise),
    each one launch; the CTAs a cluster and the rows that bisect the whole
    row are the models' (`kth_select_model.cluster_model`, `wide_model`)."""
    from saev_tpu_torch.ops import _build

    h = _k1_select_rows(8, s, s + k)
    k1 = cluster_stats_model(h, k)
    k6 = wide_model(h, k)
    h = h.to(dev)
    before = cuda_topk.topk_stats_cuda.launches, cuda_kth.kth_value_cuda.launches
    fb1 = torch.zeros(1, dtype=torch.int32, device=dev)
    fb6 = torch.zeros(1, dtype=torch.int32, device=dev)
    got = cuda_topk.topk_stats_cuda(h, k, fb1)
    kth = cuda_kth.kth_value_cuda(h, k, fb6)
    want = topk._topk_stats_plain(h, k)
    torch.cuda.synchronize()
    assert (cuda_topk.topk_stats_cuda.launches, cuda_kth.kth_value_cuda.launches) == (before[0] + 1, before[1] + 1)
    assert _build.lib().saev_wide_cluster_ctas(s) == k1["ctas"]
    for name in ("kth", "f", "live", "l0"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    torch.testing.assert_close(got.l1, want.l1, rtol=1e-6, atol=0)
    assert torch.equal(got.l1.cpu(), k1["l1"])
    assert _same_bits(kth, topk._kth_plain(h, k)) and torch.equal(kth, got.kth)
    assert int(fb1) == int(k1["fallback"].sum()) and int(fb6) == int(k6["fallback"].sum())
    assert torch.equal(got.kth.cpu(), k1["kth"]) and torch.equal(kth.cpu(), k6["kth"])


@pytest.mark.parametrize("s", WIDE_S)
def test_threshold_entry_matches_k1_on_the_wide_route(dev, s):
    """K1's threshold entry (feature-parallel) takes K1's route for S: given
    K1's kth, its f, live, L0 and L1 are K1's bits, one launch."""
    h = _k1_select_rows(8, s, s + 3).to(dev)
    k1 = cuda_topk.topk_stats_cuda(h, 32)
    before = cuda_topk.topk_stats_given_cuda.launches
    given = cuda_topk.topk_stats_given_cuda(h, k1.kth)
    torch.cuda.synchronize()
    assert cuda_topk.topk_stats_given_cuda.launches == before + 1
    assert torch.equal(given.f.view(torch.int16), k1.f.view(torch.int16)) and torch.equal(given.live, k1.live)
    assert torch.equal(given.l0, k1.l0) and torch.equal(given.l1.view(torch.int32), k1.l1.view(torch.int32))


@pytest.mark.parametrize("s", WIDE_S)
def test_wide_route_masked_matches_plain(dev, s):
    """K5 on the wide route at k 512 (and 1): masks with 5% and half of the
    columns unmasked, prefix and scattered, 40% scattered (the dense AuxK
    step at 40% dead), 24576 (64 keys a lane), n just above the group
    route's limit (the walk),
    fewer than k unmasked, one, all and none; bitwise to the plain version
    and to its model (`kth_select_model.k5_wide_model`: the group route or
    the walk by n), -inf where fewer than k."""
    from kth_select_model import wide_consts

    rng = np.random.default_rng(s)
    h = _rows(8, s, s).to(dev)
    h[:, : s // 20] = h[:, : s // 20] * 4.0 - 1e6  # pinned dead as bench.py pins them
    cols = np.arange(s)
    over = wide_consts()["group_max"] + 1
    masks = {"prefix-5%": cols < s // 20, "scattered-5%": rng.random(s) < 0.05,
             "scattered-40%": rng.random(s) < 0.4, "scattered-half": rng.random(s) < 0.5,
             "kpl-64": cols < 24576, "past-the-group-route": cols < over, "k-1": cols < 511, "one": cols == s // 2,
             "all-masked": np.zeros(s, bool), "none-masked": np.ones(s, bool)}
    routes = set()
    for name, mask in masks.items():
        mt = torch.from_numpy(mask).to(dev)
        for k in (1, 512):
            before = cuda_kth.kth_value_masked_cuda.launches
            got = cuda_kth.kth_value_masked_cuda(h, mt, k)
            want = topk._kth_masked_plain(h, mt, k)
            torch.cuda.synchronize()
            model = k5_wide_model(h.cpu(), torch.from_numpy(mask), k)
            routes.add((model["route"], model["kpl"]))
            assert cuda_kth.kth_value_masked_cuda.launches == before + 1
            assert _same_bits(got, want), (name, k)
            assert torch.equal(got.cpu().view(torch.int32), model["value"].view(torch.int32)), (name, k)
            assert bool(torch.isneginf(got).all()) == (int(mask.sum()) < k), (name, k)
    assert {("group", 32), ("group", 64), ("walk", 0)} <= routes


def _encode_operands(dev, b: int, d: int, s: int, case: str):
    """x, W (bf16) and b_enc for P1's card cases: Gaussian with a bias-only
    row whose top holds 50 ties; rows ascending or descending in column
    order (the bias dominates; rows 0-7 are bias only, so exactly so); a
    bias-only row tied at its top past the candidate buffer's cap."""
    gen = torch.Generator(device=dev).manual_seed(b + d + s)
    x = torch.randn((b, d), generator=gen, device=dev)
    w = (torch.randn((d, s), generator=gen, device=dev) / 32).to(torch.bfloat16)
    b_enc = torch.randn((s,), generator=gen, device=dev) * 0.01
    if case in ("gauss", "k-past-cap"):
        x[3] = 0.0  # a row of bias only
        b_enc[:50] = 0.25  # ties across the boundary in row 3
    elif case in ("ascending", "descending"):
        x[:8] = 0.0
        b_enc = torch.linspace(-100.0, 100.0, s, device=dev) * (1 if case == "ascending" else -1)
    elif case == "tied":
        x[5] = 0.0
        b_enc[s // 4:s // 4 + cap() + 40] = 0.5
    return x, w, b_enc


# (b, d, s, k, case): one CTA (B 128) and three (384); d_model 32 and 96,
# which the product's last stage pads with TMA's zeros; k = S = 128, k
# above the buffer's cap (every row on the exact route).
P1_CASES = [(256, 128, 2048, 32, "gauss"), (128, 64, 1152, 7, "gauss"), (128, 96, 16384, 32, "gauss"),
            (128, 32, 128, 128, "gauss"), (384, 96, 2048, 32, "ascending"), (128, 32, 2048, 32, "descending"),
            (384, 32, 1024, 32, "tied"), (128, 96, 1024, 200, "k-past-cap"), (128, 1024, 16384, 32, "ascending")]


@pytest.mark.parametrize("b,d,s,k,case", P1_CASES)
def test_encode_stats_kernel_matches_plain_and_k1(dev, b, d, s, k, case):
    """P1: h within 1e-5 of the plain version; kth, f, live and l0 bitwise
    equal to K1's and to K1's plain version on P1's own h, l1 within 1e-6;
    the rows that took the exact route and l1's bits on the others those of
    the model (tests/encode_stats_model.py); the same bits in two launches,
    and the launch counter up by one a call."""
    x, w, b_enc = _encode_operands(dev, b, d, s, case)
    before = proto_encode_stats.encode_stats.launches
    res = proto_encode_stats.check(dict(x=x, wb=w, b_enc=b_enc), k=k)
    assert proto_encode_stats.encode_stats.launches == before + 1
    assert res["h_rel"] <= 1e-5 and res["n_live"] > 0
    fallback = torch.zeros(1, dtype=torch.int32, device=dev)
    h, st = proto_encode_stats.encode_stats(x, w, b_enc, k, fallback)
    h2, st2 = proto_encode_stats.encode_stats(x, w, b_enc, k)
    torch.cuda.synchronize()
    assert proto_encode_stats.encode_stats.launches == before + 3
    assert torch.equal(h.view(torch.int32), h2.view(torch.int32))
    for name in ("kth", "l0", "l1"):
        assert torch.equal(getattr(st, name).view(torch.int32), getattr(st2, name).view(torch.int32)), name
    assert torch.equal(st.f.view(torch.int16), st2.f.view(torch.int16)) and torch.equal(st.live, st2.live)
    model = p1_model(h.cpu(), k)
    assert int(fallback) == int(model["exact"].sum())
    if case in ("tied", "k-past-cap"):
        assert int(fallback) == (b if case == "k-past-cap" else 1)
    assert _same_bits(st.kth.cpu(), model["kth"]) and torch.equal(st.f.cpu().view(torch.int16),
                                                                   model["f"].view(torch.int16))
    assert torch.equal(st.live.cpu(), model["live"]) and torch.equal(st.l0.cpu(), model["l0"])
    held = ~model["exact"]
    assert torch.equal(st.l1.cpu()[held].view(torch.int32), model["l1"][held].view(torch.int32))


# (B, S) of the pass kernels' cases: B below the card's resident CTAs and
# odd, and above them (301 > 2 x 132 at 16384 columns); S not a multiple of
# 4 (one CTA a row); S 32768 (512 threads, 128 KB of shared memory a row).
PASS_SHAPES = [(64, 2048), (33, 1000), (33, 1001), (8, 16384), (301, 16384), (4, 20000), (5, 32768)]


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("b,s", PASS_SHAPES)
@pytest.mark.parametrize("n_passes", [0, 8, 16, 32])
def test_count_loop_kernel_matches_plain(dev, b, s, n_passes, offset):
    """P3 streamed (S % 4 == 0, keys 16-byte aligned) and one CTA a row
    (otherwise): equal to its plain version and to the model of its
    partition, the same in two launches, its launch counter up by 2."""
    rng = np.random.default_rng(b + s)
    key = rng.integers(-8, 40, size=(b, s), dtype=np.int32)
    key[0] = np.iinfo(np.int32).min
    key[1] = np.iinfo(np.int32).max
    buf = torch.empty(b * s + offset, dtype=torch.int32, device=dev)
    kd = buf[offset:].view(b, s)
    kd.copy_(torch.from_numpy(key))
    before = microbench_kth.count_loop.launches
    got = microbench_kth.count_loop(kd, n_passes)
    again = microbench_kth.count_loop(kd, n_passes)
    torch.cuda.synchronize()
    assert microbench_kth.count_loop.launches == before + 2
    assert torch.equal(got, microbench_kth.count_loop_plain(kd, n_passes))
    assert torch.equal(got, again)
    assert torch.equal(got.cpu(), count_loop_model(torch.from_numpy(key), n_passes)["out"])


def test_bench_wrappers_refuse_bad_shapes(dev):
    with pytest.raises(ValueError):
        proto_encode_stats.encode_stats(torch.zeros((100, 64), device=dev),
                                        torch.zeros((64, 256), dtype=torch.bfloat16, device=dev),
                                        torch.zeros(256, device=dev), 8)
    with pytest.raises(ValueError):
        proto_encode_stats.encode_stats(torch.zeros((128, 64), device=dev),
                                        torch.zeros((64, 256), device=dev), torch.zeros(256, device=dev), 8)
    with pytest.raises(ValueError):
        microbench_kth.count_loop(torch.zeros((4, 8), device=dev), 8)
    f = torch.zeros((100, 2048), dtype=torch.bfloat16, device=dev)
    w = torch.zeros((2048, 128), dtype=torch.bfloat16, device=dev)
    m = torch.zeros((1,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="batch"):
        cm.grouped_prefix_base(f, w, m, m)
    with pytest.raises(ValueError, match="batch"):
        proto_gouter.grouped_prefix_err_gouter(f, w, torch.zeros((100, 128), device=dev),
                                               torch.zeros(128, device=dev), torch.ones(1, device=dev), m, m)


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("b,s,k", [(256, 4096, 32), (64, 100, 100), (33, 16384, 32), (8, 20000, 7), (16, 1000, 512),
                                   (8, 700, 1), (33, 1001, 32), (301, 16384, 32), (5, 32768, 32), (5, 32768, 32768)])
@pytest.mark.parametrize("mode", proto_kth_ops.MODES)
def test_kth_ops_kernel_matches_plain_and_k6(dev, mode, b, s, k, offset):
    """P4 streamed (S % 4 == 0, h 16-byte aligned) and one CTA a row
    (otherwise), B below the card's resident CTAs (odd, too) and above
    them: bitwise equal to its plain version and to the model of its
    partition, the exact modes also to K6 and to the k-th value (-0.0 and
    +0.0 as one); the same bits in two launches, its launch counter up by
    2."""
    h = _rows(b, s, b + s + 3)
    hd = _at_offset(h, dev, offset)
    before = proto_kth_ops.kth_ops.launches
    got = proto_kth_ops.kth_ops(hd, k, mode)
    again = proto_kth_ops.kth_ops(hd, k, mode)
    torch.cuda.synchronize()
    assert proto_kth_ops.kth_ops.launches == before + 2
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    assert torch.equal(got.view(torch.int32), proto_kth_ops.kth_ops_plain(hd, k, mode).view(torch.int32))
    assert torch.equal(got.cpu().view(torch.int32), kth_ops_model(h, k, mode)["kth"].view(torch.int32))
    if mode in proto_kth_ops.EXACT:
        assert torch.equal(got.view(torch.int32), cuda_kth.kth_value_cuda(hd, k).view(torch.int32))
        assert _same_bits(got, topk._kth_plain(hd, k))


def test_kth_ops_refuses_bad_inputs(dev):
    for bad in (torch.zeros((4, 8), dtype=torch.float64, device=dev),
                torch.zeros((4, 8), dtype=torch.bfloat16, device=dev),
                torch.zeros((8, 4), device=dev).T,
                torch.zeros((2, proto_kth_ops.MAX_S + 1), device=dev)):
        with pytest.raises(ValueError):
            proto_kth_ops.kth_ops(bad, 2, "prod")
    with pytest.raises(ValueError, match="mode"):
        proto_kth_ops.kth_ops(torch.zeros((4, 8), device=dev), 2, "popc")
    with pytest.raises(ValueError, match="k="):
        proto_kth_ops.kth_ops(torch.zeros((4, 8), device=dev), 9, "mxu")


# --- The train step's products at matmul_precision="default" ---


# The card's bf16 products with f32 accumulation against the same algebra on
# the CPU (f32 sums of the exact bf16 products): the sums run in another
# order, and the tensor cores do not round every f32 add to nearest, so the
# card's sums drift from the exact one with K (chip_smoke.py's
# `product_drift`: on an H100 about 1e-6 at K 1024). These products' K is at
# most 2048; 1e-5 is a hundredth of what rounding the operands moves.
BF16_PRODUCT_REL = 1e-5


def _bf16_algebra(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16(a) @ bf16(b) with f32 accumulation, on the CPU."""
    return a.cpu().to(torch.bfloat16).float() @ b.cpu().to(torch.bfloat16).float()


def test_linear_bias_default_is_bf16_algebra(dev):
    """The encoder at "default" on the card: h, dW, db and dx against the
    bf16 algebra of the same operands on the CPU (rel-norm BF16_PRODUCT_REL),
    and h not the f32 product."""
    gen = torch.Generator().manual_seed(5)
    x, w, b, dh = (torch.randn(s, generator=gen) for s in ((256, 128), (128, 2048), (2048,), (256, 2048)))
    leaves = [t.to(dev).requires_grad_(True) for t in (x, w, b)]
    h = modeling._linear_bias(*leaves, "default")
    h.backward(dh.to(dev))
    xa = torch.cat([x, torch.ones((256, 1))], dim=1)
    dwb = _bf16_algebra(xa.T, dh)
    for what, got, want in (("h", h, _bf16_algebra(x, w) + b), ("dW", leaves[1].grad, dwb[:-1]),
                            ("db", leaves[2].grad, dwb[-1]), ("dx", leaves[0].grad, _bf16_algebra(dh, w.T))):
        err = rel_norm(got.detach().cpu(), want)
        assert got.dtype == torch.float32 and err <= BF16_PRODUCT_REL, (what, err)
    assert rel_norm(h.detach().cpu(), x @ w + b) > 1e-4


def test_matmul_default_is_bf16_algebra(dev):
    """The AuxK products (modeling.matmul) at "default", forward and
    backward, against the bf16 algebra; at "highest" the f32 product."""
    gen = torch.Generator().manual_seed(6)
    a, b, g = (torch.randn(s, generator=gen) for s in ((256, 1024), (1024, 128), (256, 128)))
    leaves = [t.to(dev).requires_grad_(True) for t in (a, b)]
    out = modeling.matmul(*leaves, "default")
    out.backward(g.to(dev))
    for what, got, want in (("out", out, _bf16_algebra(a, b)), ("da", leaves[0].grad, _bf16_algebra(g, b.T)),
                            ("db", leaves[1].grad, _bf16_algebra(a.T, g))):
        err = rel_norm(got.detach().cpu(), want)
        assert got.dtype == torch.float32 and err <= BF16_PRODUCT_REL, (what, err)
    assert rel_norm(modeling.matmul(a.to(dev), b.to(dev), "highest").cpu(), a @ b) <= 1e-6


def test_highest_is_f32_under_global_tf32(dev):
    """With the process's TF32 switch on, "highest" products (modeling.matmul
    forward and backward, _linear_bias, the multi-prefix decode's batched
    and mask products) stay f32: within 1e-6 rel-norm of the f64 product,
    where TF32's rounding puts a plain product near 1e-4. The switch is on
    again after each call."""
    gen = torch.Generator().manual_seed(7)
    a, b, g = (torch.randn(s, generator=gen) for s in ((512, 1024), (1024, 256), (512, 256)))
    bias = torch.randn(256, generator=gen)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        assert rel_norm((a.to(dev) @ b.to(dev)).cpu(), a.double() @ b.double()) > 1e-5  # TF32 is on
        leaves = [t.to(dev).requires_grad_(True) for t in (a, b)]
        out = modeling.matmul(*leaves, "highest")
        out.backward(g.to(dev))
        lin = modeling._linear_bias(a.to(dev), b.to(dev), bias.to(dev), "highest")
        cfg = modeling.SparseAutoencoderConfig(d_model=256, d_sae=1024)
        params = {"W_dec": b.to(dev), "b_dec": bias.to(dev)}
        cuts = torch.tensor([100, 512, 1024], device=dev)
        dec = modeling.decode(cfg, params, a.to(dev), cuts, group_size=256, precision="highest")
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    a64, b64, g64 = a.double(), b.double(), g.double()
    for what, got, want in (("out", out, a64 @ b64), ("da", leaves[0].grad, g64 @ b64.T),
                            ("db", leaves[1].grad, a64.T @ g64), ("linear", lin, a64 @ b64 + bias.double())):
        assert rel_norm(got.detach().cpu(), want) <= 1e-6, what
    for j, p in enumerate(cuts.tolist()):
        want = a64[:, :p] @ b64[:p] + bias.double()
        assert rel_norm(dec[:, j].cpu(), want) <= 1e-6, p


def test_decode_default_is_bf16_algebra(dev, monkeypatch):
    """The multi-prefix decode at "default" on the card: its batched group
    product, mask contraction and remainder products take bf16 operands with
    f32 results (torch.bmm and torch.mm with out_dtype), against the same
    decode's bf16 algebra on the CPU (the card's route forced there, each
    product's plain version), within rel-norm 1e-3: the mask contraction
    rounds the partial sums to bf16, where one ulp is 4e-3 of a value."""
    gen = torch.Generator().manual_seed(8)
    f, w = torch.randn((256, 1024), generator=gen), torch.randn((1024, 128), generator=gen)
    cfg = modeling.SparseAutoencoderConfig(d_model=128, d_sae=1024)
    cuts = torch.tensor([7, 256, 700, 1024])
    b_dec = torch.zeros(128)
    got = modeling.decode(cfg, {"W_dec": w.to(dev), "b_dec": b_dec.to(dev)}, f.to(dev), cuts.to(dev),
                          group_size=256, precision="default")
    monkeypatch.setattr(modeling, "_bf16_operands", lambda t: True)
    want = modeling.decode(cfg, {"W_dec": w, "b_dec": b_dec}, f, cuts, group_size=256, precision="default")
    for j, p in enumerate(cuts.tolist()):
        err = rel_norm(got[:, j].cpu(), want[:, j])
        assert got.dtype == torch.float32 and err <= 1e-3, (p, err)
        assert rel_norm(got[:, j].cpu(), f[:, :p] @ w[:p]) > 1e-4  # not the f32 product


def test_bf16_route_refuses_without_the_product(dev, monkeypatch):
    """A torch with no bf16 product of f32 result raises; it does not fall
    back to f32 unsaid."""
    monkeypatch.setattr(modeling, "has_bf16_mm_f32", lambda: False)
    with pytest.raises(RuntimeError, match="out_dtype"):
        modeling.matmul(torch.ones((8, 8), device=dev), torch.ones((8, 8), device=dev), "default")


STEP_VARIANTS = {"warm": dict(aux_enabled=False), "dense": {}, "subspace": dict(aux_subspace_cap=128)}


@pytest.mark.parametrize("variant", STEP_VARIANTS)
def test_train_step_default_precision_on_the_card(dev, monkeypatch, variant):
    """The train step at "default" on the card: its encoder output is the
    bf16 algebra of its operands (rel-norm BF16_PRODUCT_REL) and not their
    f32 product,
    and its loss and grad_norm are within 1e-2 of the CPU's f32 step."""
    cfg = modeling.SparseAutoencoderConfig(
        d_model=128, d_sae=2048, activation=modeling.TopK(top_k=8, aux=modeling.AuxK(k_aux=64))
    )
    obj = objectives.Matryoshka(n_prefixes=4)
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(256, 128)).astype(np.float32))
    pf = torch.from_numpy(np.stack([objectives.sample_prefixes(2048, 4, rng=rng) for _ in range(2)]))
    ts = train.init_sweep_state(cfg, 2, torch.Generator().manual_seed(0), device="cpu")
    ts.obj_state["toks_since_active"][:, :100] = 1 << 30

    def hp(device):
        return {"lr": torch.full((2,), 1e-3, device=device), "n_lr_warmup": torch.ones(2, device=device),
                "grad_clip": torch.ones(2, device=device), "sparsity_coeff": torch.zeros(2, device=device),
                "aux_alpha": torch.full((2,), 1 / 32, device=device)}

    step = train.make_train_step(cfg, obj, n_steps=10, **STEP_VARIANTS[variant])
    _, want = step(ts, x, pf, hp("cpu"))
    seen = []
    real = modeling._linear_bias

    def spy(*args):
        out = real(*args)
        seen.append(([a.detach() if torch.is_tensor(a) else a for a in args], out.detach()))
        return out

    monkeypatch.setattr(modeling, "_linear_bias", spy)
    ts_d = train.SweepState(*(train._tree_map(lambda t: t.to(dev), v) for v in ts))
    _, got = step(ts_d, x.to(dev), pf.to(dev), hp(dev))
    torch.cuda.synchronize()
    assert len(seen) == 2
    for (xs, w, b, precision), h in seen:
        assert precision == "default" and h.is_cuda
        assert rel_norm(h.cpu(), _bf16_algebra(xs, w) + b.cpu()) <= BF16_PRODUCT_REL
        assert rel_norm(h.cpu(), xs.cpu() @ w.cpu() + b.cpu()) > 1e-4
    for key in ("loss", "grad_norm"):
        rel = float(((got[key].cpu() - want[key]).abs() / want[key].abs()).max())
        assert rel <= 1e-2, (key, rel)


COMPACT_SHAPES = [(6, 10), (256, 16384), (1000, 4096), (0, 64)]


@pytest.mark.parametrize("b,s", COMPACT_SHAPES)
def test_inference_compaction_on_the_card_matches_scipy(dev, b, s):
    """Inference's CSR compaction (framework/inference.py `compact_rows`) on
    the card, assembled on the host (`csr_block`), equals
    `scipy.sparse.csr_array` of the dense batch copied whole: indptr and
    indices with their dtypes, and the values bit for bit; with negative
    kept values, exact zeros (-0.0 too), empty rows and a masked row."""
    import scipy.sparse

    from saev_tpu_torch.framework import inference

    rng = np.random.default_rng(b + s)
    f = np.where(rng.random((b, s)) < 0.01 + 32 / s, rng.normal(size=(b, s)), 0.0).astype(np.float32)
    if b > 4:
        f[1] = 0.0
        f[2, ::3] = -0.0
        f[3] = -np.abs(f[3])
    ft = torch.from_numpy(f).to(dev)
    if b > 4:
        ft[4] = torch.where(torch.zeros((), dtype=torch.bool, device=dev), ft[4], 0.0)  # a masked row
    counts, cols, vals = inference.compact_rows(ft)
    assert counts.is_cuda and cols.is_cuda and vals.is_cuda and cols.dtype == torch.int32
    got = inference.csr_block(counts.cpu().numpy(), cols.cpu().numpy(), vals.cpu().numpy(), s)
    want = scipy.sparse.csr_array(ft.cpu().numpy())
    for name in ("indptr", "indices"):
        a, w = getattr(got, name), getattr(want, name)
        assert a.dtype == w.dtype, name
        np.testing.assert_array_equal(a, w, err_msg=name)
    np.testing.assert_array_equal(got.data.view(np.int32), want.data.view(np.int32))
