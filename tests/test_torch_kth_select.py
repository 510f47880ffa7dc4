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
columns) is modelled at small widths: the cluster route of K1 and K6 at
slices of 128 or 256 columns (CLUSTER; 2 to 9 CTAs a row, the last slice
ragged) and of K6 and K5 (under its mask, its bound the cluster's) at
slices of 512 (CLUSTER_K5), K5's route chosen from n and S (GROUP: one warp
a CTA, so the group route's limits fall at 1024 and 2048 columns; the
cluster route past them up to 8 slices) and the walk at a chunk width of
256 (WIDE), and held to the same kernels and plain versions, bit for bit,
on the same edge rows and masks (prefixes that empty whole slices, n < k
and n = k, ties across a slice boundary, an unmasked -inf); with small
capacities and few threads their rows reach the rank, the bisection over
the candidates and the cluster-wide or whole-row fallback. The routes'
limits at the card's widths (8 slices of 32768: S = 262144) are held to
the plain versions at full size.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from kth_select_model import (bisect, bisect_from, cand_cap, cluster_model, cluster_slices, cluster_stats_model,
                              k1_dispatch, k1_layout, k1_model, k5_model, k5_wide_model, k6_dispatch, k6_model,
                              k6_wide_model, order_key, takes_cluster, walk_stats_model, wide_bound_bit, wide_chunks,
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
    threads a CTA, the block's select for K6 and K5, the bound by `bisect`
    alone, eight bulk copies a slice) each find their one marker."""
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
# KPL 64 up to 2048; past it the cluster route up to 8 slices of 256 (2048
# columns, so never at these widths) and the walk.
GROUP = {"warps": 1, "cluster": CLUSTER, "walk": WIDE}
# The cluster route of K6 and K5 at slices of 512 columns (8 keys a thread,
# 64 threads): 6 CTAs a row at 2600 columns, 8 at 4000, the last slice
# ragged; buffers the tied rows overflow. K5's routes at one warp a CTA with
# it: the group route up to 2048 unmasked columns, the cluster past it up
# to 4096 columns, the walk past them.
CLUSTER_K5 = {"vpt": 8, "threads": 64, "slice_cap": 160, "union_cap": 480}
GROUP_CLUSTER = {"warps": 1, "cluster": CLUSTER_K5, "walk": WIDE}


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


# --- the cluster route of K6 and K5 (select alone; K5 under its mask) ---


def _cluster_rows(b: int, s: int, seed: int) -> np.ndarray:
    """`_masked_rows` with ties at the top straddling the boundary of slices
    0 and 1 of CLUSTER_K5 (columns 472-551, row 9) and a row of -inf with a
    finite value at every 7th column (row 10), whose k-th largest unmasked
    value is -inf where a mask leaves fewer than k of them."""
    h = _masked_rows(b, s, seed)
    h[9, 512 - 40:512 + 40] = 6.0
    h[10] = -np.inf
    h[10, ::7] = np.abs(h[11, ::7])
    return h


def _cluster_masks(s: int, k: int, seed: int) -> dict:
    """K5's masks on the cluster route: 40% and 60% unmasked as a prefix
    (the last slices hold no unmasked column) and scattered, the last 40%
    (the first slices hold none), n = k and k - 1, one, all and none."""
    rng = np.random.default_rng(seed)
    cols = np.arange(s)
    return {
        "prefix-40%": cols < int(s * 0.4),
        "prefix-60%": cols < int(s * 0.6),
        "last-40%": cols >= s - int(s * 0.4),
        "scattered-40%": rng.random(s) < 0.4,
        "scattered-60%": rng.random(s) < 0.6,
        "n-is-k": cols >= s - k,
        "n-is-k-1": cols < k - 1,
        "one": cols == s // 2,
        "all-masked": np.zeros(s, bool),
        "none-masked": np.ones(s, bool),
    }


@pytest.mark.parametrize("s", [2600, 4000])
@pytest.mark.parametrize("k", [1, 32, 200])
def test_cluster_masked_model_matches_pallas_and_plain(s, k):
    """K5 on the cluster route (`cluster_model` under a mask, CLUSTER_K5)
    against the TPU kernel in interpret mode, bit for bit, and the plain
    version, -0.0 and +0.0 as one value: prefixes that empty whole slices,
    scattered masks, n < k and n = k, one, all and none, on the edge rows
    (zeros, -0.0, ties across a slice boundary, -inf unmasked); -inf where
    fewer than k columns are unmasked."""
    h = _cluster_rows(32, s, s + k)
    ht = torch.from_numpy(h)
    assert len(cluster_slices(s, 8 * 64)) >= 6
    for name, mask in _cluster_masks(s, k, s + k).items():
        mt = torch.from_numpy(mask)
        got = cluster_model(ht, k, mt, **CLUSTER_K5)
        want = pallas_topk.exact_kth_value_masked_pallas(jnp.asarray(h), jnp.asarray(mask[None, :], jnp.int32),
                                                         k, True)
        np.testing.assert_array_equal(got["kth"].numpy().view(np.int32), np.asarray(want).view(np.int32),
                                      err_msg=name)
        assert same_value_bits(got["kth"], topk._kth_masked_plain(ht, mt, k)), name
        assert bool(torch.isneginf(got["kth"]).all()) == (int(mask.sum()) < k), name


@pytest.mark.parametrize("s", [2600, 4000])
@pytest.mark.parametrize("k", [1, 32, 200, "s"])
def test_cluster_select_model_matches_pallas_and_plain(s, k):
    """K6 on the cluster route (`cluster_model`, its select alone, and
    `k6_wide_model`, which takes it at these slices) against the TPU kernel
    in interpret mode and the plain version, on the edge rows."""
    k = s if k == "s" else k
    h = _cluster_rows(32, s, s + k + 1)
    ht = torch.from_numpy(h)
    got = k6_wide_model(ht, k, cluster=CLUSTER_K5, walk=WIDE)
    assert got["route"] == "cluster" and torch.equal(got["kth"], cluster_model(ht, k, **CLUSTER_K5)["kth"])
    want = pallas_topk.exact_kth_value_pallas(jnp.asarray(h), k, True)
    np.testing.assert_array_equal(got["kth"].numpy().view(np.int32), np.asarray(want).view(np.int32))
    assert same_value_bits(got["kth"], topk._kth_plain(ht, k))


def test_cluster_masked_model_reaches_every_branch():
    """K5's cluster route at CLUSTER_K5, 8 slices of 512: each CTA's share of
    k follows its unmasked columns, so a mask that empties slices still
    bounds the Gaussian rows (no fallback under the last 40% or the first
    40% unmasked, at k 1, 32 and 100); most rank their kept candidates at k
    1 and all bisect them at k 100, where more than 64 are kept; the rows of
    zeros, of -0.0 beside a few positives, of -inf and tied at the top
    overflow and bisect the cluster's registers; where fewer than k threads
    hold an unmasked column the bound is 0 and every row bisects."""
    s = 4000
    h = torch.from_numpy(_cluster_rows(64, s, 11))
    cols = torch.arange(s)
    # The last 40% leaves out row 7's ties (its first 2048 columns).
    for mask, fell in ((cols < int(s * 0.4), {0, 4, 6, 7}), (cols >= s - int(s * 0.4), {0, 4, 6})):
        one = cluster_model(h, 1, mask, **CLUSTER_K5)
        assert one["ctas"] == 8 and not one["own"] and not bool(one["fallback"][12:].any())
        assert int(one["ranked"][12:].sum()) > int(one["bisected"][12:].sum())
        got = cluster_model(h, 32, mask, **CLUSTER_K5)
        assert set(np.flatnonzero(got["fallback"].numpy()).tolist()) == fell
        assert bool((got["lower"][12:] > 0).all())
        wide = cluster_model(h, 100, mask, **CLUSTER_K5)
        assert bool(wide["bisected"][12:].all())
        for g, k in ((one, 1), (got, 32), (wide, 100)):
            assert same_value_bits(g["kth"], topk._kth_masked_plain(h, mask, k))
    sparse = cols % 64 == 0  # 63 columns: fewer than k threads hold one
    got = cluster_model(h, 100, sparse, **CLUSTER_K5)
    assert bool(got["fallback"].all()) and bool((got["lower"] == 0).all())
    assert bool(torch.isneginf(got["kth"]).all())


@pytest.mark.parametrize("n_off", [-1, 0, 1])
def test_k5_wide_model_cluster_route_at_its_limits(n_off):
    """K5's route by n and S at one warp a CTA with CLUSTER_K5: n just below,
    at and just above the group route's 2048, as a prefix and scattered, at
    3000 columns (the cluster route past 2048) and 4100 (past 8 slices of
    512: the walk), to the TPU kernel's and the plain version's bits."""
    n = 2048 + n_off
    for s, past in ((3000, "cluster"), (4100, "walk")):
        h = _masked_rows(32, s, n + s)
        ht = torch.from_numpy(h)
        rng = np.random.default_rng(n)
        for mask in (np.arange(s) < n, np.isin(np.arange(s), rng.permutation(s)[:n])):
            mt = torch.from_numpy(mask)
            got = k5_wide_model(ht, mt, 512, **GROUP_CLUSTER)
            assert got["route"] == ("group" if n <= 2048 else past)
            want = pallas_topk.exact_kth_value_masked_pallas(jnp.asarray(h), jnp.asarray(mask[None, :], jnp.int32),
                                                             512, True)
            np.testing.assert_array_equal(got["value"].numpy().view(np.int32), np.asarray(want).view(np.int32))
            assert same_value_bits(got["value"], topk._kth_masked_plain(ht, mt, 512))


@pytest.mark.parametrize("off", [-4, 0, 4])
def test_wide_routes_at_the_cluster_limit(off):
    """At the card's constants K6 and K5 (past 32768 unmasked columns) take
    the cluster route up to 8 slices of 32768 columns, S = 262144, and the
    walk past it (S = 262144 + 4), as K1 does; Gaussian rows at k 32 and
    k_aux 512 (K5 under 40% scattered) to the plain versions' bits, with no
    row falling back."""
    s = 262144 + off
    route = "cluster" if off <= 0 else "walk"
    assert takes_cluster(s) == (off <= 0)
    rng = np.random.default_rng(s)
    h = torch.from_numpy(rng.normal(size=(2, s)).astype(np.float32))
    got = k6_wide_model(h, 32)
    assert got["route"] == route and not bool(got["fallback"].any())
    assert same_value_bits(got["kth"], topk._kth_plain(h, 32))
    mask = torch.from_numpy(rng.random(s) < 0.4)
    got = k5_wide_model(h, mask, 512)
    assert got["route"] == route and not bool(got["fallback"].any())
    assert same_value_bits(got["value"], topk._kth_masked_plain(h, mask, 512))


@settings(max_examples=40, deadline=None)
@given(s=st.integers(1, 2500), k_frac=st.floats(0.0, 1.0), p=st.floats(0.0, 1.0), seed=st.integers(0, 2**16),
       layout=st.sampled_from(["scattered", "prefix", "last"]), levels=st.sampled_from([0, 3, 50]))
def test_cluster_masked_model_matches_plain_on_random_masks(s, k_frac, p, seed, layout, levels):
    """Random rows (continuous or a few levels, so ties) and masks
    (scattered, a prefix or the last columns) at slices of 128 and small
    buffers, k anywhere: K5's cluster route gives the plain version's bits
    whichever branch a row takes."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(4, s)).astype(np.float32)
    if levels:
        h = np.round(h * levels / 3).astype(np.float32) * np.float32(0.25)
    h[rng.random(h.shape) < 0.05] = -np.inf
    ht = torch.from_numpy(h)
    k = max(1, min(s, round(k_frac * s)))
    n = round(p * s)
    mask = {"scattered": rng.random(s) < p, "prefix": np.arange(s) < n, "last": np.arange(s) >= s - n}[layout]
    mt = torch.from_numpy(mask)
    kw = {"vpt": 4, "threads": 32, "slice_cap": 48, "union_cap": 160}
    assert same_value_bits(cluster_model(ht, k, mt, **kw)["kth"], topk._kth_masked_plain(ht, mt, k))


@pytest.mark.parametrize("s", [2600, 4000])
def test_cluster_masked_model_pinned_prefix(s):
    """K5's cluster route on dead latents pinned as bench.py pins them (bias
    -1e6, where f32 values lie 0.0625 apart and 2^17 keys span 512.0) under
    a prefix mask of them: the bound resolves the maxima's narrow range
    (`wide_bound_bit`), so no row falls back, to the TPU kernel's and the
    plain version's bits."""
    rng = np.random.default_rng(s)
    h = rng.normal(size=(32, s)).astype(np.float32)
    n = int(s * 0.6)
    h[:, :n] = (h[:, :n].astype(np.float64) - 1e6).astype(np.float32)
    mask = np.arange(s) < n
    ht, mt = torch.from_numpy(h), torch.from_numpy(mask)
    for k in (32, 100):
        got = cluster_model(ht, k, mt, **CLUSTER_K5)
        assert not bool(got["fallback"].any()), k
        want = pallas_topk.exact_kth_value_masked_pallas(jnp.asarray(h), jnp.asarray(mask[None, :], jnp.int32), k,
                                                         True)
        np.testing.assert_array_equal(got["kth"].numpy().view(np.int32), np.asarray(want).view(np.int32))
        assert same_value_bits(got["kth"], topk._kth_masked_plain(ht, mt, k))


# --- kth_wide.cu `bisect_from`: the cluster route's bound, searched from the row before's ---


def _thread_maxima(h: np.ndarray) -> np.ndarray:
    """The 512 thread maxima of a 32768-column slice in K1's layout (64 keys a
    thread), as order keys."""
    key = order_key(torch.from_numpy(h)).numpy()
    return key.reshape(16, 512, 4).transpose(1, 0, 2).reshape(512, 64).max(1)


def _bisect_from_cases() -> dict:
    """(maxima as order keys, the bound's lowest bit or None for the kernel's
    `bound_bit`, guesses) by name: random keys in narrow windows (near key 1,
    across the sign, at the top) and over every key; the bound of a Gaussian
    slice; and slices after a Gaussian one, the guess its bound (about
    +2.9): most values N(-10, 1) with 16 of them non-negative, so the maxima
    span the sign and fewer than k lie above -1.5, and maxima that span
    -2.0, where the counts run down past half the keys."""
    rng = np.random.default_rng(28)

    def keys(lo: int, hi: int) -> np.ndarray:
        return rng.integers(lo, hi, 512, dtype=np.int64, endpoint=True)

    gauss = _thread_maxima(rng.normal(size=32768).astype(np.float32))
    lo, hi = torch.tensor([int(gauss.min())]), torch.tensor([int(gauss.max())])
    prev = int(bisect(lo, hi, 32, lambda t: (torch.from_numpy(gauss)[None] >= t[:, None]).sum(-1),
                      lowest=wide_bound_bit(lo, hi))[0])
    sign = rng.normal(-10.0, 1.0, 32768).astype(np.float32)
    sign[rng.permutation(32768)[:16]] = np.abs(rng.normal(size=16))
    two = rng.normal(-2.0, 0.3, 32768).astype(np.float32)
    return {
        "near-key-1": (keys(1, 0xFFF), 0, []),
        "across-the-sign": (keys(0x7FFFFE00, 0x800001FF), 3, []),
        "near-the-top": (keys(0xFFFFF000, 0xFFFFFFFF), 2, []),
        "every-key": (keys(1, 0xFFFFFFFF), 17, []),
        "gaussian": (gauss, None, [prev]),
        "after-gaussian-across-the-sign": (_thread_maxima(sign), None, [prev]),
        "after-gaussian-across-minus-2": (_thread_maxima(two), None, [prev]),
    }


_BISECT_FROM = _bisect_from_cases()


@pytest.mark.parametrize("case", list(_BISECT_FROM))
def test_bisect_from_ends_and_matches_bisect(case):
    """The model of kth_wide.cu `bisect_from` (its uint64 arithmetic) ends
    within the kernel's 66 counts and gives `bisect`'s answer from every
    guess: below, at and above the answer, the range's ends, past them, 0
    and the largest key, and the row before's bound, at k 1, 2, 32, half
    and all of the maxima. Among the rows: maxima that span the sign after
    a Gaussian row, where a downward step once ran past key 0 and the
    kernel's search never ended, and maxima that span -2.0."""
    mx, lowest, guesses = _BISECT_FROM[case]
    mxt = torch.from_numpy(mx)
    lo, hi = int(mx.min()), int(mx.max())
    if lowest is None:
        lowest = int(wide_bound_bit(torch.tensor([lo]), torch.tensor([hi]))[0])
    step = 1 << lowest

    def count(t: int) -> int:
        return int((mxt >= t).sum())

    for want in sorted({1, 2, 32, len(mx) // 2, len(mx)}):
        ref = int(bisect(torch.tensor([lo]), torch.tensor([hi]), want,
                         lambda t: (mxt[None] >= t[:, None]).sum(-1), lowest=lowest)[0])
        assert count(ref) >= want
        for g in guesses + [ref - step, ref, ref + step, ref + 7 * step, ref - 1000 * step, lo - step, lo, hi,
                            hi + step, 0, 0xFFFFFFFF]:
            got, calls = bisect_from(lo, hi, want, lowest, g % 2**32, count)
            assert got == ref, (want, hex(g))
            assert calls <= 66
