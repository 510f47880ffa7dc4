"""The model of P1's select (tests/encode_stats_model.py, the partition of
csrc/encode_stats.cu) against P1's plain version and the JAX package.

- On rows built to reach each of its branches (Gaussian, a bias-only row
  with 50 ties at the top, a zero row, a row tied at its top past the
  buffer's cap, rows ascending and descending in column order, -0.0 beside
  +0.0 at kth) and k 1, 32, above the cap and S: kth, f, live and l0 bit
  for bit equal to `encode_stats_plain`'s statistics, l1 within 1e-6.
- Which rows take the exact route, and how many prunes a row takes on
  ascending and Gaussian rows.
- On the JAX script's operands: the port's h within 1e-5 of the Pallas
  kernel's in interpret mode, and the model's statistics of that h equal to
  the JAX package's `_topk_stats_xla`, live to the kernel's per-tile counts.
"""

import importlib.util
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from encode_stats_model import WARP_ROWS, append_order, cap, p1_model, tile

from saev_tpu.ops import topk as jtopk
from saev_tpu_torch.ops import topk
from saev_tpu_torch.scripts import proto_encode_stats

ROOT = pathlib.Path(__file__).resolve().parent.parent
B, S = 64, 2048
GAUSS_PRUNES = 6  # at most, a Gaussian row of S over its S / 128 tiles
L1_REL = 1e-6


def _rows(b: int, s: int, seed: int) -> np.ndarray:
    """Gaussian rows, with the edge rows of the kernel's branches."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(b, s)).astype(np.float32)
    h[1] = rng.normal(size=s) * 0.01  # a bias-only row: 50 ties at the top
    h[1, :50] = 0.25
    h[2] = 0.0  # a zero row
    h[3, 100:100 + cap() + 40] = 7.0  # tied at its top past the cap
    h[4] = np.arange(s, dtype=np.float32) / s  # ascending
    h[5] = -np.arange(s, dtype=np.float32) / s  # descending
    if s >= 1024:  # -0.0 beside +0.0: 10 values above, then 30 of each
        h[6] = -np.abs(h[6]) - 1.0
        h[6, 500:510] = 1.0 + np.arange(10)
        h[6, 600:660:2] = 0.0
        h[6, 601:661:2] = -0.0
    return h


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equal; f32 zeros taken as one value (the plain version's kth
    is torch's, which does not order -0.0 below +0.0)."""
    if a.dtype == torch.float32:
        a, b = (a + 0.0).view(torch.int32), (b + 0.0).view(torch.int32)
    else:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a, b)


def _assert_matches_plain(h: torch.Tensor, k: int) -> dict:
    got = p1_model(h, k)
    want = topk._topk_stats_plain(h, k)
    assert got["f"].dtype == torch.bfloat16 and got["kth"].dtype == torch.float32
    for name in ("kth", "f", "l0"):
        assert _same_bits(got[name], getattr(want, name)), name
    assert torch.equal(got["live"], want.live)
    rel = ((got["l1"] - want.l1).abs() / want.l1.abs().clamp_min(1e-30)).max()
    assert float(rel) <= L1_REL
    return got


def test_constants_read_from_the_source():
    assert tile() == 128 and cap() % 4 == 0 and cap() >= 64
    order = append_order(tile())
    assert sorted(order.tolist()) == list(range(tile()))
    assert order[:4].tolist() == [0, 1, 8, 9] and order[32:36].tolist() == [2, 3, 10, 11]


@pytest.mark.parametrize("k", [1, 32, 7])
def test_model_matches_plain(k):
    h = torch.from_numpy(_rows(B, S, k))
    got = _assert_matches_plain(h, k)
    # The zero row and the row tied past the cap take the exact route; the
    # bias-only row's 50 ties and the signed zeros fit the buffer.
    assert got["exact"].nonzero().flatten().tolist() == [2, 3]
    assert int(got["n"][1]) == 50


@pytest.mark.parametrize("k", [lambda c: c, lambda c: c + 1, lambda c: 1000], ids=["cap", "cap+1", "1000"])
def test_model_k_at_and_above_the_cap(k):
    c = cap()
    kk = k(c)
    h = torch.from_numpy(_rows(B, 1024, kk))
    got = _assert_matches_plain(h, kk)
    if kk > c:  # the buffer cannot hold k keys: every row takes the exact route
        assert bool(got["exact"].all())
    else:
        assert not bool(got["exact"][4:].any())


@pytest.mark.parametrize("s", [128, 1024])
def test_model_k_is_s(s):
    h = torch.from_numpy(_rows(WARP_ROWS, s, s))
    got = _assert_matches_plain(h, s)
    assert bool(got["exact"].all()) == (s > cap())


def test_one_tile_rows():
    """One tile of Gaussian rows: a prune only where the tile's keys pass
    the cap, after which the buffer holds the keys >= a bound of the k-th
    largest, at least k and at most the cap."""
    h = torch.from_numpy(np.random.default_rng(2).normal(size=(WARP_ROWS, tile())).astype(np.float32))
    got = _assert_matches_plain(h, 32)
    pruned = tile() > cap()
    assert got["prunes"].tolist() == [int(pruned)] * WARP_ROWS
    if pruned:
        assert all(32 <= n <= cap() for n in got["n"].tolist())
    else:
        assert got["n"].tolist() == [tile()] * WARP_ROWS


def test_signed_zeros_at_kth():
    """kth = +0.0 on the filter route: the -0.0 entries are kept, as bf16 -0.0."""
    h = torch.from_numpy(_rows(WARP_ROWS, S, 0))
    got = _assert_matches_plain(h, 32)
    assert float(got["kth"][6]) == 0.0 and not bool(got["exact"][6])
    f6 = got["f"][6].view(torch.int16)
    assert int((f6 == -32768).sum()) == 30 and int((got["f"][6] > 0).sum()) == 10


def _ascending_prunes(n_tiles: int, k: int) -> int:
    """Each tile's keys beat every earlier key: a prune whenever a whole tile
    would pass the cap, after which the buffer holds k (k <= tile)."""
    n, prunes = 0, 0
    for _ in range(n_tiles):
        if n + tile() > cap():
            prunes, n = prunes + 1, k
        else:
            n += tile()
    return prunes


@pytest.mark.parametrize("k", [1, 32])
def test_prunes_on_ascending_and_gaussian_rows(k):
    rng = np.random.default_rng(k)
    h = rng.normal(size=(2 * WARP_ROWS, S)).astype(np.float32)
    h[:WARP_ROWS] = np.sort(h[:WARP_ROWS], axis=1)  # one warp of ascending rows, one of Gaussian rows
    got = _assert_matches_plain(torch.from_numpy(h), k)
    assert not bool(got["exact"].any())
    want = _ascending_prunes(S // tile(), k)
    assert got["prunes"][:WARP_ROWS].tolist() == [want] * WARP_ROWS
    gauss = got["prunes"][WARP_ROWS:]
    assert 1 <= int(gauss.min()) and int(gauss.max()) <= GAUSS_PRUNES < want


def test_descending_rows_prune_once():
    h = -np.sort(np.random.default_rng(3).normal(size=(WARP_ROWS, S)).astype(np.float32), axis=1)
    got = _assert_matches_plain(torch.from_numpy(h), 32)
    # The first tiles pass the cap once; after that no key reaches L.
    assert got["prunes"].tolist() == [1] * WARP_ROWS and all(32 <= n <= cap() for n in got["n"].tolist())


def test_a_warp_prunes_all_its_rows():
    """Every row prunes early; later only row 0 passes the cap, and its
    warp's 15 other rows prune with it while the next warp's rows do not."""
    rng = np.random.default_rng(5)
    h = np.full((2 * WARP_ROWS, 4 * tile()), -1.0, np.float32)
    h[:, :8] = rng.normal(size=(2 * WARP_ROWS, 8)).astype(np.float32) + 2.0
    h[0, 2 * tile():] = rng.normal(size=2 * tile()).astype(np.float32) + 10.0
    got = _assert_matches_plain(torch.from_numpy(h), 4)
    prunes = got["prunes"].tolist()
    assert prunes[:WARP_ROWS] == [prunes[0]] * WARP_ROWS and prunes[WARP_ROWS:] == [prunes[-1]] * WARP_ROWS
    assert prunes[0] > prunes[-1] >= 1
    assert not bool(got["exact"].any())


def _load_script(name: str):
    path = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(f"_jax_scripts_{name}", ROOT / "scripts" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
    return mod


@pytest.mark.parametrize("k", [1, 32])
def test_model_matches_pallas(k):
    """x, W, b_enc through the JAX script's kernel in interpret mode and
    through the port's plain product; the model on the port's h gives the
    JAX package's statistics of that h."""
    mod = _load_script("proto_encode_stats")
    rng = np.random.default_rng(11)
    d = 64
    x = rng.normal(size=(2 * tile(), d)).astype(np.float32)
    w = (rng.normal(size=(d, S)) / 32).astype(np.float32)
    b = (rng.normal(size=(S,)) * 0.01).astype(np.float32)
    x[3:20] = 0.0  # h = b_enc: rows tied at their top past the cap
    b[1000:1000 + cap() + 40] = 0.5
    wb = jnp.asarray(w, jnp.bfloat16)
    hs, kth, f, live_p, l0, l1 = mod.encode_stats_pallas(jnp.asarray(x), wb, jnp.asarray(b), k, 128, True)
    h, _ = proto_encode_stats.encode_stats_plain(torch.from_numpy(x), torch.from_numpy(np.asarray(wb, np.float32))
                                                 .to(torch.bfloat16), torch.from_numpy(b), k)
    hn = np.asarray(hs, np.float64)
    assert np.linalg.norm(h.numpy() - hn) / np.linalg.norm(hn) <= 1e-5
    got = p1_model(h, k)
    want = jtopk._topk_stats_xla(jnp.asarray(h.numpy()), k)
    np.testing.assert_array_equal(got["kth"].numpy(), np.asarray(want.kth))
    np.testing.assert_array_equal(got["f"].float().numpy(), np.asarray(want.f, np.float32))
    np.testing.assert_array_equal(got["l0"].numpy(), np.asarray(want.l0))
    np.testing.assert_allclose(got["l1"].numpy(), np.asarray(want.l1), rtol=L1_REL)
    np.testing.assert_array_equal(got["live"].numpy(), np.asarray(live_p).sum(axis=0) > 0)
    assert got["exact"].nonzero().flatten().tolist() == list(range(3, 20))
