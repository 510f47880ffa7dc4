"""The selects of kernels K1 and K6 (csrc/topk_row.cuh) and K5
(csrc/kth_masked.cu), modelled in plain torch (kth_select_model.py), against
the JAX package and the port's plain versions, bit for bit. No kernel runs
here.

kth (and K5's value) must equal `saev_tpu.ops.pallas_topk`'s kernels in
interpret mode bit for bit, and `_kth_plain` / `_kth_masked_plain` with -0.0
and +0.0 taken as one value; K1's f, live and L0 too, L1 within 1e-6. The
rows are Gaussian with edge rows: all zeros, all negative, fewer than k
positive, ties across the boundary and at the top, signed zeros, -inf; at k
1, T', T' + 1 and S and a ragged S. Both branches of K1's and K6's select
are reached.
K5's masks: prefixes, scattered, n = k and k - 1, one column, all and none.
Hypothesis draws random rows and masks.

The wide route of K1, K5 and K6 (csrc/kth_wide.cu, rows over 32768
columns) is modelled at small widths: K1's cluster route at slices of 128
or 256 columns (CLUSTER; 2 to 9 CTAs a row, the last slice ragged), K5's
route chosen from n (GROUP: one warp a CTA, so the group route's limits
fall at 1024 and 2048 columns) and the walk at a chunk width of 256
(WIDE), and held to the same kernels and plain versions, bit for bit, on
the same edge rows and masks; with small capacities and few threads their
rows reach the rank, the bisection over the candidates and the
cluster-wide or whole-row fallback.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from kth_select_model import (cand_cap, cluster_model, cluster_slices, cluster_stats_model, k1_dispatch, k1_layout,
                              k1_model, k5_model, k5_wide_model, k6_dispatch, k6_model, walk_stats_model, wide_chunks,
                              wide_consts, wide_model)

from saev_tpu.ops import pallas_topk
from saev_tpu_torch.ops import topk


def same_value_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equal f32, -0.0 and +0.0 taken as one value: the plain
    versions rank them as one (torch.topk), the kernels' order key puts -0.0
    just below +0.0 (adding +0.0 turns -0.0 into +0.0 and leaves every other
    value as it is)."""
    return torch.equal((a + 0.0).view(torch.int32), (b + 0.0).view(torch.int32))


def _rows(b: int, s: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(b, s)).astype(np.float32)
    h[0] = 0.0  # all tied at zero: every key reaches t0
    h[1] = -np.abs(h[1])  # all negative
    h[2] = -np.abs(h[2])
    h[2, :3] = [1.0, 2.0, 3.0]  # fewer than k positive values
    h[3, : min(40, s)] = 7.0  # ties across the boundary
    h[4, ::2] = -0.0  # signed zeros beside a few positives
    h[4, 1::2] = -np.abs(h[4, 1::2])
    h[4, 1:12:2] = 0.5
    h[5, ::3] = -np.inf  # -inf beside finite values
    h[6] = -np.inf  # all -inf
    h[7, : min(2 * cand_cap(), s)] = 3.5  # tied at the top, beyond the buffer
    h[:, 8:12] = 0.0  # exact zeros (L0 counts h != 0)
    return h


def _t_live(s: int, dispatch=k1_dispatch) -> int:
    """T', the threads that hold a column."""
    return min(k1_layout(s, dispatch)[1], -(-s // 4))


def _k1_cases():
    cases = []
    for s in (512, 1000, 2048, 20000):
        t = _t_live(s)
        cases += [(s, k) for k in sorted({1, 32, t, t + 1, s}) if k <= s]
    return cases


@pytest.mark.parametrize("s,k", _k1_cases())
def test_k1_model_matches_pallas_and_plain(s, k):
    h = _rows(32, s, s + k)
    got = k1_model(torch.from_numpy(h), k)
    kth, f, live_p, l0, l1 = pallas_topk.topk_stats_pallas(jnp.asarray(h), k, 32, True)
    np.testing.assert_array_equal(got["kth"].numpy().view(np.int32), np.asarray(kth).view(np.int32))
    np.testing.assert_array_equal(got["f"].float().numpy(), np.asarray(f, np.float32))
    np.testing.assert_array_equal(got["live"].numpy(), np.asarray(live_p).sum(0) > 0)
    np.testing.assert_array_equal(got["l0"].numpy(), np.asarray(l0))
    np.testing.assert_allclose(got["l1"].numpy(), np.asarray(l1), rtol=1e-6)
    plain = topk._topk_stats_plain(torch.from_numpy(h), k)
    assert same_value_bits(got["kth"], plain.kth)
    for name in ("f", "live", "l0"):
        assert torch.equal(got[name], getattr(plain, name)), name
    torch.testing.assert_close(got["l1"], plain.l1, rtol=1e-6, atol=0)
    if k > _t_live(s):
        assert bool(got["fallback"].all()) and not bool(got["filter"].any())


def test_k1_model_reaches_both_branches():
    """At k 32 the Gaussian rows fit the buffer; the rows of zeros, of -0.0
    beside a few positives, of -inf and tied at the top beyond the buffer
    take the whole-row bisection."""
    for s in (2048, 16384):
        got = k1_model(torch.from_numpy(_rows(64, s, 5)), 32)
        fell = set(np.flatnonzero(got["fallback"].numpy()).tolist())
        assert fell == {0, 4, 6, 7}, (s, fell)
        ok = ~got["fallback"]
        assert bool(got["filter"].all())
        assert int(got["n_cand"][ok].min()) >= 32 and int(got["n_cand"][ok].max()) <= cand_cap()
        assert int(got["n_cand"][8:].max()) < 400  # Gaussian rows: a few dozen to a few hundred


def test_k1_model_production_row_width():
    """Gaussian rows at d_sae 16384, k 32: no row falls back, and the
    candidates are the keys at or above the 32nd largest maximum of 256."""
    h = torch.from_numpy(np.random.default_rng(9).normal(size=(32, 16384)).astype(np.float32))
    got = k1_model(h, 32)
    assert k1_layout(16384)[1] == 256 and not bool(got["fallback"].any())
    assert same_value_bits(got["kth"], topk._kth_plain(h, 32))


@settings(max_examples=60, deadline=None)
@given(s=st.integers(1, 3000), k_frac=st.floats(0.0, 1.0), seed=st.integers(0, 2**16),
       levels=st.sampled_from([0, 3, 50]))
def test_k1_model_matches_plain_on_random_rows(s, k_frac, seed, levels):
    """Random rows, a few levels (ties) or continuous, k anywhere in 1..S."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(4, s)).astype(np.float32)
    if levels:
        h = np.round(h * levels / 3).astype(np.float32) * np.float32(0.25)
    h[rng.random(h.shape) < 0.05] = -0.0
    k = max(1, min(s, round(k_frac * s)))
    ht = torch.from_numpy(h)
    got = k1_model(ht, k)
    assert same_value_bits(got["kth"], topk._kth_plain(ht, k))
    want = np.sort(h, axis=1)[:, ::-1][:, k - 1 : k]
    np.testing.assert_array_equal(got["kth"].numpy(), want)


# --- K6 ---


def _k6_cases():
    cases = []
    for s in (512, 1000, 1001, 2048, 16384):
        t = _t_live(s, k6_dispatch)
        cases += [(s, k) for k in sorted({1, 32, t, t + 1, s}) if k <= s]
    return cases


@pytest.mark.parametrize("s,k", _k6_cases())
def test_k6_model_matches_pallas_and_plain(s, k):
    """K6's kth, bit for bit, against the TPU kernel (32-step bisection, in
    interpret mode) and the plain version; with k above T' every row takes
    the whole-row bisection."""
    h = _rows(32, s, s + k + 1)
    got = k6_model(torch.from_numpy(h), k)
    want = pallas_topk.exact_kth_value_pallas(jnp.asarray(h), k, True)
    np.testing.assert_array_equal(got["kth"].numpy().view(np.int32), np.asarray(want).view(np.int32))
    assert same_value_bits(got["kth"], topk._kth_plain(torch.from_numpy(h), k))
    if k > _t_live(s, k6_dispatch):
        assert bool(got["fallback"].all()) and not bool(got["filter"].any())


@pytest.mark.parametrize("s,fell_want", [(1000, set()), (1001, set()), (2048, {0, 4, 6, 7}),
                                         (16384, {0, 4, 6, 7})])
def test_k6_model_reaches_both_branches(s, fell_want):
    """At k 32 the Gaussian rows take the candidate filter; at 2048 columns
    and more the rows of zeros, of -0.0 beside a few positives, of -inf and
    tied at the top beyond the buffer take the whole-row bisection, and at
    1000 and 1001 every row fits the buffer."""
    h = torch.from_numpy(_rows(64, s, 6))
    got = k6_model(h, 32)
    assert set(np.flatnonzero(got["fallback"].numpy()).tolist()) == fell_want
    assert bool(got["filter"].all())
    assert same_value_bits(got["kth"], topk._kth_plain(h, 32))


# --- K5 ---


def _masked_rows(b: int, s: int, seed: int) -> np.ndarray:
    """`_rows` with a twentieth of the columns pinned as bench.py pins dead
    latents: bias -1e6, where f32 values lie 0.0625 apart and tie exactly."""
    h = _rows(b, s, seed)
    n = max(s // 20, 1)
    h[:, :n] = h[:, :n] * 4.0 - 1e6
    return h


def _k5_masks(s: int, k: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    cols = np.arange(s)
    return {
        "prefix-5%": cols < max(s // 20, 1),
        "prefix-20%": cols < s // 5,
        "scattered-5%": rng.random(s) < 0.05,
        "scattered-half": rng.random(s) < 0.5,
        "n-is-k": cols < k,
        "n-is-k-1": cols < k - 1,
        "one": cols == s // 2,
        "all-masked": np.zeros(s, bool),
        "none-masked": np.ones(s, bool),
    }


@pytest.mark.parametrize("s,k", [(1024, 512), (4096, 512), (1000, 64), (16384, 512), (2048, 1), (20000, 7)])
def test_k5_model_matches_pallas_and_plain(s, k):
    h = _masked_rows(32, s, s + k)
    ht = torch.from_numpy(h)
    for name, mask in _k5_masks(s, k, s).items():
        got, n, _ = k5_model(ht, torch.from_numpy(mask), k)
        want = pallas_topk.exact_kth_value_masked_pallas(jnp.asarray(h), jnp.asarray(mask[None, :], jnp.int32),
                                                         k, True)
        np.testing.assert_array_equal(got.numpy().view(np.int32), np.asarray(want).view(np.int32), err_msg=name)
        plain = topk._kth_masked_plain(ht, torch.from_numpy(mask), min(k, s))
        assert same_value_bits(got, plain), name
        assert bool(torch.isneginf(got).all()) == (n < k), name


def test_k5_model_group_sizes():
    """A warp a row at the tight rung and the dense step's 5% (819 of 1024
    and of 16384), 4 warps at the wide rung (3276 of 4096), 16 for a row of
    16384 with nothing masked."""
    rng = np.random.default_rng(3)
    for s, n, want in ((1024, 819, 1), (16384, 819, 1), (4096, 3276, 4), (16384, 16384, 16), (1024, 1025 - 1, 1)):
        h = torch.from_numpy(rng.normal(size=(2, s)).astype(np.float32))
        mask = torch.arange(s) < n
        got, n_got, g = k5_model(h, mask, 512)
        assert (n_got, g) == (n, want), (s, n, g)
        assert same_value_bits(got, topk._kth_masked_plain(h, mask, 512))


@settings(max_examples=60, deadline=None)
@given(s=st.integers(1, 5000), k_frac=st.floats(0.0, 1.0), p=st.floats(0.0, 1.0), seed=st.integers(0, 2**16))
def test_k5_model_matches_plain_on_random_masks(s, k_frac, p, seed):
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(np.round(rng.normal(size=(3, s)) * 8).astype(np.float32))
    mask = torch.from_numpy(rng.random(s) < p)
    k = max(1, min(s, math.ceil(k_frac * s)))
    got, n, _ = k5_model(h, mask, k)
    assert same_value_bits(got, topk._kth_masked_plain(h, mask, k))
    assert n == int(mask.sum())


def test_select_probe_finds_its_markers():
    """scripts/select_probe.py rewrites the committed K1, K6 and K5 sources:
    a clock64 stamp into the CTA's slots at each of K1's seven phase
    boundaries (K6: its row's start and the select's end, the select's own
    three from the header), copied to the row's slots once, K5's five, and
    K5's launch bounds; each marker is there once."""
    from saev_tpu_torch.scripts import select_probe

    copy = "g_stamps[row * 8 + i] = g_cta[blockIdx.x * 8 + i];"
    src = select_probe.stamped_row_source()
    assert [src.count(f"g_cta[blockIdx.x * 8 + {i}] = clock64();") for i in range(8)] == [1] * 7 + [0]
    assert src.count(copy) == 1
    assert src.count("__device__ long long* g_stamps;") == 1
    src = select_probe.stamped_k6_source()
    assert [src.count(f"g_cta[blockIdx.x * 8 + {i}] = clock64();") for i in range(8)] == [1, 0, 0, 0, 1, 0, 0, 0]
    assert src.count(copy) == 1
    src = select_probe.stamped_k5_source()
    assert [src.count(f"g_cta[blockIdx.x * 2 + {i}]") for i in range(3)] == [1, 1, 0]
    assert [src.count(f"g_row[row * 3 + {i}]") for i in range(4)] == [1, 1, 1, 0]
    assert src.count("__device__ long long* g_row;") == 1
    for min_blocks in (1, 2, 3):
        assert f"__launch_bounds__(kMaxWarps * 32, {min_blocks})\n" in select_probe.k5_capped_source(min_blocks)
        assert f"__launch_bounds__(MAXT, {min_blocks})\n    kth_stream_kernel(" in select_probe.k6_capped_source(min_blocks)


def test_select_probe_finds_the_wide_markers():
    """scripts/select_probe.py stamps a copy of K1's cluster kernel (csrc/
    kth_wide.cu) at its ten phase boundaries, each once, in program order,
    and declares its pointer once; nothing outside the cluster kernel
    changes. Its variants of the route (the full cluster barrier a row, 256
    threads a CTA) each find their one marker."""
    from saev_tpu_torch.ops import _build
    from saev_tpu_torch.scripts import select_probe

    src = select_probe.stamped_wide_source()
    at = [src.index(f"* 10 + {i}] = clock64();") for i in range(10)]
    assert at == sorted(at) and all(src.count(f"* 10 + {i}] = clock64();") == 1 for i in range(10))
    assert src.count("__device__ long long* g_wide;") == 1
    plain = (_build.CSRC / "kth_wide.cu").read_text()
    kept = "\n".join(line for line in src.splitlines() if "g_wide" not in line)
    assert kept.strip() == plain.strip()
    for name, edits in select_probe.WIDE_VARIANTS.items():
        variant = select_probe.wide_variant_source(name)
        assert (variant == plain) == (not edits) and all(new in variant for _, new in edits), name


# --- the wide route (kth_wide.cu) ---

# The walk (K6; K5 and K1 past their routes) at a chunk width that cuts these
# rows into 3-5 chunks, a buffer the tied rows overflow, and a CTA of 64
# threads, so Gaussian rows rank at k 1 and bisect their candidates at k 32.
WIDE = {"chunk": 256, "cap": 200, "threads": 64}
# K1's cluster route at slices of 256 columns (8 keys a thread, 32 threads):
# 3 CTAs a row at 700 columns, 5 at 1031, the last slice ragged; buffers the
# tied rows overflow.
CLUSTER = {"vpt": 8, "threads": 32, "slice_cap": 96, "union_cap": 256}
# K5's group route at one warp a CTA: KPL 32 up to 1024 unmasked columns,
# KPL 64 up to 2048, the walk past it.
GROUP = {"warps": 1, "walk": WIDE}


def _same_stats(got: dict, h: np.ndarray, k: int) -> None:
    """K1's statistics against the Pallas kernel (interpret mode) and the
    plain version: kth, f, live and L0 bit for bit, L1 within 1e-6."""
    ht = torch.from_numpy(h)
    kth, f, live_p, l0, l1 = pallas_topk.topk_stats_pallas(jnp.asarray(h), k, 32, True)
    np.testing.assert_array_equal(got["kth"].numpy().view(np.int32), np.asarray(kth).view(np.int32))
    np.testing.assert_array_equal(got["f"].float().numpy(), np.asarray(f, np.float32))
    np.testing.assert_array_equal(got["live"].numpy(), np.asarray(live_p).sum(0) > 0)
    np.testing.assert_array_equal(got["l0"].numpy(), np.asarray(l0))
    np.testing.assert_allclose(got["l1"].numpy(), np.asarray(l1), rtol=1e-6)
    plain = topk._topk_stats_plain(ht, k)
    assert same_value_bits(got["kth"], plain.kth)
    for name in ("f", "live", "l0"):
        assert torch.equal(got[name], getattr(plain, name)), name
    torch.testing.assert_close(got["l1"], plain.l1, rtol=1e-6, atol=0)


@pytest.mark.parametrize("s", [700, 1031])
@pytest.mark.parametrize("k", [1, 32, "s"])
def test_wide_model_matches_pallas_and_plain(s, k):
    """K1's cluster route and the walk (K6's; K1's past the cluster route)
    against the TPU kernels (interpret mode) and the plain versions: kth bit
    for bit, f, live and L0 equal, L1 within 1e-6."""
    k = s if k == "s" else k
    h = _rows(32, s, s + k + 2)
    ht = torch.from_numpy(h)
    assert len(wide_chunks(s, WIDE["chunk"])) >= 3 and len(cluster_slices(s, 8 * 32)) >= 3
    _same_stats(cluster_stats_model(ht, k, **CLUSTER), h, k)
    _same_stats(walk_stats_model(ht, k, **WIDE), h, k)
    want = pallas_topk.exact_kth_value_pallas(jnp.asarray(h), k, True)
    np.testing.assert_array_equal(wide_model(ht, k, **WIDE)["kth"].numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))


@pytest.mark.parametrize("s,k", [(700, 32), (1031, 64), (1031, 1), (900, 900)])
def test_wide_masked_model_matches_pallas_and_plain(s, k):
    """K5's wide route: the group route or the walk by n, -inf where fewer
    than k columns are unmasked, against the TPU kernel and the plain
    version."""
    h = _masked_rows(32, s, s + k)
    ht = torch.from_numpy(h)
    for name, mask in _k5_masks(s, k, s).items():
        mt = torch.from_numpy(mask)
        got = k5_wide_model(ht, mt, k, **GROUP)
        want = pallas_topk.exact_kth_value_masked_pallas(jnp.asarray(h), jnp.asarray(mask[None, :], jnp.int32),
                                                         k, True)
        np.testing.assert_array_equal(got["value"].numpy().view(np.int32), np.asarray(want).view(np.int32),
                                      err_msg=name)
        assert same_value_bits(got["value"], topk._kth_masked_plain(ht, mt, k)), name
        assert bool(torch.isneginf(got["value"]).all()) == (int(mask.sum()) < k), name
        walk = wide_model(ht, k, mt, **WIDE)["kth"]
        assert torch.equal(walk.view(torch.int32), got["value"].view(torch.int32)), name


def test_wide_model_reaches_every_branch():
    """The walk: Gaussian rows rank their candidates at k 1 and bisect them
    at k 32; the rows of zeros, of -0.0 beside a few positives, of -inf and
    tied at the top overflow the buffer and bisect the whole row; a row
    tied across the boundary keeps its ties at 7.0 (36 of them) in the
    buffer and ranks them."""
    h = torch.from_numpy(_rows(64, 1031, 7))
    one = wide_model(h, 1, **WIDE)
    assert bool(one["ranked"][8:].all())
    got = wide_model(h, 32, **WIDE)
    assert set(np.flatnonzero(got["fallback"].numpy()).tolist()) == {0, 4, 6, 7}
    assert bool(got["bisected"][8:].all()) and bool(got["ranked"][3]) and int(got["n_cand"][3]) == 36
    for g in (one, got):
        assert same_value_bits(g["kth"], topk._kth_plain(h, int(g is got) * 31 + 1))


def test_cluster_model_reaches_every_branch():
    """K1's cluster route at 5 slices of 256 (4 keys a thread, 64 threads):
    Gaussian rows rank their kept candidates at k 1 and bisect them at k 32
    (each CTA's bound its own k-th largest maximum, the largest of them
    dropping some); the rows of zeros, of -0.0 beside a few positives, of
    -inf and tied at the top overflow a buffer and bisect the cluster's
    registers; at k 100 (2k above 64 threads) the bound is the least of the
    CTAs' 20th largest maxima; at k 400 (q = 80) no bound exists and every
    row bisects."""
    h = torch.from_numpy(_rows(64, 1280, 7))
    kw = {"vpt": 4, "threads": 64, "slice_cap": 100, "union_cap": 400}
    one = cluster_model(h, 1, **kw)
    assert one["ctas"] == 5 and one["own"] and bool(one["ranked"][8:].all())
    got = cluster_model(h, 32, **kw)
    assert got["own"] and set(np.flatnonzero(got["fallback"].numpy()).tolist()) == {0, 4, 6, 7}
    assert bool(got["bisected"][8:].all()) and bool((got["n_kept"][8:] < got["n_cand"][8:]).all())
    shared = cluster_model(h, 100, **kw)
    assert not shared["own"] and not bool(shared["fallback"][8:].any())
    past = cluster_model(h, 400, **kw)
    assert not past["own"] and bool(past["fallback"].all())
    for g, k in ((one, 1), (got, 32), (shared, 100), (past, 400)):
        assert same_value_bits(g["kth"], topk._kth_plain(h, k))


@pytest.mark.parametrize("ctas", [2, 4, 8])
@pytest.mark.parametrize("ragged", [False, True])
def test_cluster_model_cluster_sizes(ctas, ragged):
    """C = 2, 4 and 8 CTAs a row, with the last slice full or ragged (S not
    a multiple of the slice): the slices cover the row once, their widths
    multiples of 4 but the last; the route's bits are the plain version's
    at k 1, 32 and past the bound (q above the last slice's threads), and
    L1 in rank order within 1e-6."""
    kw = {"vpt": 4, "threads": 32, "slice_cap": 128, "union_cap": 512}
    s = ctas * 128 - (53 if ragged else 0)
    slices = cluster_slices(s, 128)
    assert len(slices) == ctas and slices[0][0] == 0 and sum(n for _, n in slices) == s
    assert all(a + n == b for (a, n), (b, _) in zip(slices, slices[1:])) and all(n % 4 == 0 for _, n in slices[:-1])
    assert (slices[-1][1] < slices[0][1]) == ragged
    h = _rows(16, s, s + ctas)
    ht = torch.from_numpy(h)
    for k in (1, 32, 33 * ctas):
        got = cluster_stats_model(ht, k, **kw)
        plain = topk._topk_stats_plain(ht, k)
        assert same_value_bits(got["kth"], plain.kth), k
        for name in ("f", "live", "l0"):
            assert torch.equal(got[name], getattr(plain, name)), (k, name)
        torch.testing.assert_close(got["l1"], plain.l1, rtol=1e-6, atol=0)
        if k == 33 * ctas:
            assert bool(got["fallback"].all())


def test_cluster_model_tie_across_a_slice_boundary():
    """Ties at the top straddling the boundary of slices 0 and 1, more than
    a CTA's buffer holds on either side: both CTAs' bounds are the tied
    value, the buffers overflow, and the row bisects the cluster's
    registers, to the plain version's bits; fewer ties fit and rank."""
    kw = {"vpt": 4, "threads": 64, "slice_cap": 64, "union_cap": 256}
    h = np.random.default_rng(3).normal(size=(4, 512)).astype(np.float32)
    h[0, 256 - 80:256 + 80] = 5.0  # 80 ties in slice 0 and 80 in slice 1
    h[1, 256 - 20:256 + 20] = 5.0  # 20 and 20
    ht = torch.from_numpy(h)
    got = cluster_stats_model(ht, 32, **kw)
    assert got["ctas"] == 2 and bool(got["fallback"][0]) and not bool(got["fallback"][1:].any())
    assert int(got["n_cand"][1]) >= 40
    plain = topk._topk_stats_plain(ht, 32)
    assert same_value_bits(got["kth"], plain.kth) and float(got["kth"][0]) == 5.0 == float(got["kth"][1])
    assert torch.equal(got["f"], plain.f) and torch.equal(got["l0"], plain.l0)


@pytest.mark.parametrize("n_off", [-1, 0, 1])
@pytest.mark.parametrize("limit", ["kpl32", "group"])
def test_k5_wide_model_route_at_its_limits(limit, n_off):
    """K5's route by n at the group route's register limits (one warp a
    CTA: KPL 32 holds 1024 columns, KPL 64 2048): n just below, at and just
    above each, as a prefix and scattered, to the TPU kernel's and the plain
    version's bits; the walk takes n past 2048."""
    s = 2112
    n = (1024 if limit == "kpl32" else 2048) + n_off
    h = _masked_rows(32, s, n)
    ht = torch.from_numpy(h)
    rng = np.random.default_rng(n)
    for mask in (np.arange(s) < n, np.isin(np.arange(s), rng.permutation(s)[:n])):
        mt = torch.from_numpy(mask)
        got = k5_wide_model(ht, mt, 512, **GROUP)
        assert got["n"] == n
        if limit == "kpl32":
            assert got["route"] == "group" and got["kpl"] == (32 if n <= 1024 else 64)
        else:
            assert got["route"] == ("group" if n <= 2048 else "walk")
        want = pallas_topk.exact_kth_value_masked_pallas(jnp.asarray(h), jnp.asarray(mask[None, :], jnp.int32),
                                                         512, True)
        np.testing.assert_array_equal(got["value"].numpy().view(np.int32), np.asarray(want).view(np.int32))
        assert same_value_bits(got["value"], topk._kth_masked_plain(ht, mt, 512))


@pytest.mark.parametrize("s", [32769, 40000, 65536, 131072])
def test_wide_chunks_at_the_card_widths(s):
    """The routes at the widths the card takes: the walk's chunks (K6) at
    most kWideVpt * kWideThreads columns each, one width (a multiple of 4,
    so a row with S % 4 == 0 keeps its 16-byte loads) but the last,
    covering the row once; K1's cluster (2 CTAs up to 65536, 4 at 131072)
    with slices of at most kSliceVpt * kSliceThreads; K5's group route up to
    kGroupMaxN unmasked columns. The Gaussian rows of 16384 x 65536 at k 32
    and 512 fit the walk's buffer and K1's union."""
    c = wide_consts()
    chunks = wide_chunks(s, c["vpt"] * c["threads"])
    assert chunks[0][0] == 0 and sum(n for _, n in chunks) == s
    assert all(a + n == b for (a, n), (b, _) in zip(chunks, chunks[1:]))
    assert all(n % 4 == 0 for _, n in chunks[:-1]) and 0 < chunks[-1][1] <= chunks[0][1] <= c["vpt"] * c["threads"]
    assert len(chunks) * 512 <= c["cap"]
    slice_cols = c["slice_vpt"] * c["slice_threads"]
    slices = cluster_slices(s, slice_cols)
    assert len(slices) == (2 if s <= 65536 else 4) <= c["max_cluster"]
    assert all(n <= slice_cols for _, n in slices) and sum(n for _, n in slices) == s
    assert c["group_max"] == c["group_warps"] * 32 * 64 == 32768
    if s == 65536:
        h = torch.from_numpy(np.random.default_rng(2).normal(size=(4, s)).astype(np.float32))
        for k in (32, 512):
            got = wide_model(h, k)
            assert not bool(got["fallback"].any()) and same_value_bits(got["kth"], topk._kth_plain(h, k))
            got = cluster_model(h, k)
            assert not bool(got["fallback"].any()) and same_value_bits(got["kth"], topk._kth_plain(h, k))
            assert got["own"] == (2 * k <= c["slice_threads"])


@settings(max_examples=40, deadline=None)
@given(s=st.integers(1, 1500), k_frac=st.floats(0.0, 1.0), p=st.floats(0.0, 1.0), seed=st.integers(0, 2**16),
       levels=st.sampled_from([0, 3, 50]))
def test_wide_model_matches_plain_on_random_rows(s, k_frac, p, seed, levels):
    """Random rows (continuous or a few levels, so ties), k anywhere, with
    and without a mask, at a chunk width of 128 and slices of 128: the same
    bits as the plain versions whichever branch or route a row takes."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(4, s)).astype(np.float32)
    if levels:
        h = np.round(h * levels / 3).astype(np.float32) * np.float32(0.25)
    h[rng.random(h.shape) < 0.05] = -0.0
    ht = torch.from_numpy(h)
    k = max(1, min(s, round(k_frac * s)))
    small = {"chunk": 128, "cap": 96, "threads": 32}
    assert same_value_bits(wide_model(ht, k, **small)["kth"], topk._kth_plain(ht, k))
    kw = {"vpt": 4, "threads": 32, "slice_cap": 48, "union_cap": 160}
    assert same_value_bits(cluster_model(ht, k, **kw)["kth"], topk._kth_plain(ht, k))
    mask = torch.from_numpy(rng.random(s) < p)
    want = topk._kth_masked_plain(ht, mask, k)
    assert same_value_bits(wide_model(ht, k, mask, **small)["kth"], want)
    assert same_value_bits(k5_wide_model(ht, mask, k, warps=1, walk=small)["value"], want)
