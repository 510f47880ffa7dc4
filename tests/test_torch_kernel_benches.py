"""The plain versions of K7, P1, P2 and P3 and the bench modules of
saev_tpu_torch/scripts against the JAX package and its scripts.

Shapes of tests/test_ops_matryoshka.py (B 128, S 2048, D 128, groups of 512,
cuts with m = 0, r = 0, two in one group and the full prefix). The JAX side
runs each Pallas kernel in interpret mode; the prototype kernels are loaded
from scripts/ by file path (nothing there is imported as a package).

- K7 `grouped_prefix_base`: rel-norm 1e-5 in f32; 1e-3 with a bf16 base (one
  bf16 ulp of summation-order difference).
- P2 `grouped_prefix_err_gouter`: the JAX script's limits, E rel-norm 2e-3,
  err_full rel-norm 1e-5, loss rel 1e-4.
- P1 `encode_stats_pallas`: h rel-norm 1e-5; kth, f and l0 equal to
  `_topk_stats_xla` applied to the port's own h; live equal to the kernel's
  per-tile live counts summed.
- P3 `loop_kernel`: counts equal.
"""

import functools
import importlib.util
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from saev_tpu.ops import pallas_matryoshka as pk
from saev_tpu.ops import topk as jtopk
from saev_tpu_torch.ops import cuda_matryoshka as cm
from saev_tpu_torch.ops import topk
from saev_tpu_torch.scripts import kprof, microbench_kth, proto_encode_stats, proto_gouter

ROOT = pathlib.Path(__file__).resolve().parent.parent
B, S, D, G = 128, 2048, 128, 512  # 4 groups
CUTS = {
    "mid-boundary-mid-full": [300, 512, 1100, S],
    "two-in-group0": [100, 300, 1536, S],
}


def _load_script(name: str):
    """scripts/<name>.py as a module, leaving sys.path as it was (the
    scripts insert their own directories)."""
    path = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(f"_jax_scripts_{name}", ROOT / "scripts" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
    return mod


def rel_norm(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _tb(x) -> torch.Tensor:
    return _t(np.asarray(x, np.float32)).to(torch.bfloat16)


def _cuts(p):
    p = np.asarray(p, np.int32)
    return p // G, p % G


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    f = rng.normal(size=(B, S)).astype(np.float32)
    w = (rng.normal(size=(S, D)) / 32).astype(np.float32)
    x = rng.normal(size=(B, D)).astype(np.float32)
    b_dec = (rng.normal(size=(D,)) * 0.1).astype(np.float32)
    return f, w, x, b_dec


# --- K7 -------------------------------------------------------------------------


@pytest.mark.parametrize("base_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("cuts", CUTS.values(), ids=CUTS.keys())
def test_prefix_base_plain_matches_pallas(data, cuts, base_dtype):
    f, w, _, _ = data
    m, r = _cuts(cuts)
    jdt = jnp.float32 if base_dtype == torch.float32 else jnp.bfloat16
    base, xhat = pk.grouped_prefix_base(
        jnp.asarray(f, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), jnp.asarray(m), jnp.asarray(r),
        group_size=G, block_rows=64, base_dtype=jdt, interpret=True,
    )
    pbase, pxhat = cm.grouped_prefix_base_plain(_tb(f), _tb(w), _t(m), _t(r), group_size=G, base_dtype=base_dtype)
    assert pbase.dtype == base_dtype and pxhat.dtype == torch.float32
    assert pbase.shape == (len(cuts), B, D)
    tol = 1e-5 if base_dtype == torch.float32 else 1e-3
    assert rel_norm(pbase.float().numpy(), np.asarray(base, np.float32)) <= tol
    assert rel_norm(pxhat.numpy(), np.asarray(xhat)) <= 1e-5


@pytest.mark.parametrize("cuts", CUTS.values(), ids=CUTS.keys())
def test_prefix_base_plain_rebuilds_k2_error(data, cuts):
    """bf16(base_j + (b_dec - x)) is K2's E_j and the two xhat are one: the
    identities chip_smoke.py holds the kernels to, bit for bit."""
    f, w, x, b_dec = data
    m, r = (_t(v) for v in _cuts(cuts))
    base, xhat = cm.grouped_prefix_base_plain(_tb(f), _tb(w), m, r, group_size=G)
    e, k2_xhat, _ = cm.grouped_prefix_err_plain(_tb(f), _tb(w), _t(x), _t(b_dec), torch.tensor(0.5), m, r,
                                                group_size=G)
    assert torch.equal(xhat, k2_xhat)
    rebuilt = (base + (_t(b_dec) - _t(x))).to(torch.bfloat16)
    assert torch.equal(rebuilt.view(torch.int16), e.view(torch.int16))


# --- P2 -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gouter_jax():
    return _load_script("proto_gouter").grouped_prefix_err_gouter


@pytest.mark.parametrize("cuts", CUTS.values(), ids=CUTS.keys())
def test_gouter_plain_matches_pallas(data, gouter_jax, cuts):
    f, w, x, b_dec = data
    m, r = _cuts(cuts)
    iu = 1.0 / max(float(np.abs(x).max()), 1e-12)
    e, err, loss_p = gouter_jax(
        jnp.asarray(f, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), jnp.asarray(x), jnp.asarray(b_dec),
        jnp.asarray(iu, jnp.float32), jnp.asarray(m), jnp.asarray(r), group_size=G, block_rows=64,
        interpret=True,
    )
    pe, perr, ploss = proto_gouter.grouped_prefix_err_gouter_plain(
        _tb(f), _tb(w), _t(x), _t(b_dec), torch.tensor(iu), _t(m), _t(r), group_size=G
    )
    assert pe.dtype == torch.bfloat16 and perr.dtype == torch.float32
    assert rel_norm(pe.float().numpy(), np.asarray(e, np.float32)) <= 2e-3
    assert rel_norm(perr.numpy(), np.asarray(err)) <= 1e-5
    jloss = float(np.asarray(loss_p)[::8, 0].sum())
    assert abs(float(ploss) - jloss) <= 1e-4 * abs(jloss)


def _gouter_by_k16(f, w, x, b_dec, inv_upper, m, r, g, tile=128, cluster=2, step=16):
    """P2's walk (csrc/prefix_gouter.cu) written out in torch: the row tiles
    in clusters of `cluster` (the last one with an idle partner where their
    count is odd), each live tile's accumulator starting at b_dec - x and
    walking K = d_sae in 16-lane steps in f32; each cut, met in ascending p
    (stable in j) in the step that holds it, snapshots bf16(acc + the lanes
    below it); err_full is the final acc. Returns E, err_full, the loss (one
    partial a live tile, in tile order) and the clusters' tiles."""
    b, d = f.shape[0], w.shape[1]
    n_tiles = -(-b // tile)
    clusters = [list(range(c, c + cluster)) for c in range(0, n_tiles, cluster)]
    ff, wf = f.float(), w.float()
    p = (m * g + r).tolist()
    order = sorted(range(len(p)), key=lambda j: p[j])
    e = torch.empty((len(p), b, d), dtype=torch.bfloat16)
    err = torch.empty((b, d))
    partials = []
    for tiles in clusters:
        for t in tiles:
            if t * tile >= b:  # the idle partner: W loads and releases only
                continue
            rows = slice(t * tile, (t + 1) * tile)
            acc = (b_dec - x[rows]).float()
            snaps, ci = [None] * len(p), 0
            for k0 in range(0, f.shape[1], step):
                while ci < len(order) and p[order[ci]] < k0 + step:
                    pj = p[order[ci]]
                    snaps[order[ci]] = acc + ff[rows, k0:pj] @ wf[k0:pj] if pj > k0 else acc
                    ci += 1
                acc = acc + ff[rows, k0 : k0 + step] @ wf[k0 : k0 + step]
            for j in order[ci:]:
                snaps[j] = acc
            e[:, rows] = torch.stack(snaps).to(torch.bfloat16)
            err[rows] = acc
            partials.append(((e[:, rows].float() * inv_upper) ** 2).sum())
    return e, err, torch.stack(partials).sum(), clusters


GOUTER_CUTS = CUTS | {"65-cuts": list(range(1, 21)) + list(range(60, S, 46))[:44] + [S]}


@pytest.mark.parametrize("cuts", GOUTER_CUTS.values(), ids=GOUTER_CUTS.keys())
def test_gouter_walk_matches_pallas_and_plain(gouter_jax, cuts):
    """P2's schedule at B 384 (three row tiles: two clusters, the second
    with an idle partner) against the Pallas kernel in interpret mode (the
    JAX script's limits: E rel-norm 2e-3, err_full 1e-5, loss 1e-4) and the
    plain version (1e-2, 1e-4, 1e-5)."""
    rng = np.random.default_rng(len(cuts))
    b = 384
    f = (rng.normal(size=(b, S)) * (rng.random((b, S)) < 0.2)).astype(np.float32)
    w = (rng.normal(size=(S, D)) / 32).astype(np.float32)
    x = rng.normal(size=(b, D)).astype(np.float32)
    b_dec = (rng.normal(size=(D,)) * 0.1).astype(np.float32)
    m, r = _cuts(cuts)
    iu = 1.0 / max(float(np.abs(x).max()), 1e-12)
    args = (_tb(f), _tb(w), _t(x), _t(b_dec), torch.tensor(iu), _t(m), _t(r))
    e, err, loss, clusters = _gouter_by_k16(*args, G)
    assert clusters == [[0, 1], [2, 3]]
    je, jerr, jloss_p = gouter_jax(
        jnp.asarray(f, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), jnp.asarray(x), jnp.asarray(b_dec),
        jnp.asarray(iu, jnp.float32), jnp.asarray(m), jnp.asarray(r), group_size=G, block_rows=64,
        interpret=True,
    )
    pe, perr, ploss = proto_gouter.grouped_prefix_err_gouter_plain(*args, group_size=G)
    jloss = float(np.asarray(jloss_p)[::8, 0].sum())
    for (want_e, want_err, want_loss), (e_tol, err_tol, loss_tol) in (
        ((np.asarray(je, np.float32), np.asarray(jerr), jloss), (2e-3, 1e-5, 1e-4)),
        ((pe.float().numpy(), perr.numpy(), float(ploss)), (1e-2, 1e-4, 1e-5)),
    ):
        assert rel_norm(e.float().numpy(), want_e) <= e_tol
        assert rel_norm(err.numpy(), want_err) <= err_tol
        assert abs(float(loss) - want_loss) <= loss_tol * abs(want_loss)


def test_gouter_plain_is_k2_plain_with_full_error(data):
    """Folding b_dec - x in first changes no bit of the plain E or loss; the
    second output is K2's xhat + b_dec - x."""
    f, w, x, b_dec = data
    m, r = (_t(v) for v in _cuts(CUTS["two-in-group0"]))
    args = (_tb(f), _tb(w), _t(x), _t(b_dec), torch.tensor(0.3), m, r)
    e, err, loss = proto_gouter.grouped_prefix_err_gouter_plain(*args, group_size=G)
    e0, xhat0, loss0 = cm.grouped_prefix_err_plain(*args, group_size=G)
    assert torch.equal(e.view(torch.int16), e0.view(torch.int16))
    assert torch.equal(loss, loss0)
    torch.testing.assert_close(err, xhat0 + (_t(b_dec) - _t(x)), rtol=0, atol=0)


def test_gouter_check_passes_on_cpu(data):
    """The module's check (P2 against K2 and its plain version) on the CPU,
    where both take their plain versions."""
    f, w, x, b_dec = data
    m, r = (_t(v) for v in _cuts(CUTS["mid-boundary-mid-full"]))
    res = proto_gouter.check(dict(f=_tb(f), w=_tb(w), x=_t(x), b_dec=_t(b_dec), inv_upper=torch.tensor(0.4),
                                  m=m, r=r), group_size=G)
    assert res["repeatable"] and res["e_rel_k2"] == 0.0 and res["loss_rel_k2"] == 0.0
    assert res["err_rel_k2"] <= 1e-7 and res["e_rel"] == 0.0


# --- P1 -------------------------------------------------------------------------


def _encode_operands():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(256, D)).astype(np.float32)
    w = (rng.normal(size=(D, S)) / 32).astype(np.float32)
    b = (rng.normal(size=(S,)) * 0.01).astype(np.float32)
    x[3] = 0.0  # h = b_enc: a row of bias only
    return x, w, b


def test_encode_stats_plain_matches_pallas():
    mod = _load_script("proto_encode_stats")
    x, w, b = _encode_operands()
    wb = jnp.asarray(w, jnp.bfloat16)
    hs, kth, f, live_p, l0, l1 = mod.encode_stats_pallas(jnp.asarray(x), wb, jnp.asarray(b), 32, 128, True)
    h, st = proto_encode_stats.encode_stats_plain(_t(x), _t(np.asarray(wb, np.float32)).to(torch.bfloat16),
                                                  _t(b), 32)
    assert h.dtype == torch.float32 and st.f.dtype == torch.bfloat16
    assert rel_norm(h.numpy(), np.asarray(hs)) <= 1e-5
    # The statistics are exact with respect to the port's own h.
    want = jtopk._topk_stats_xla(jnp.asarray(h.numpy()), 32)
    np.testing.assert_array_equal(st.kth.numpy(), np.asarray(want.kth))
    np.testing.assert_array_equal(st.f.float().numpy(), np.asarray(want.f, np.float32))
    np.testing.assert_array_equal(st.l0.numpy(), np.asarray(want.l0))
    np.testing.assert_allclose(st.l1.numpy(), np.asarray(want.l1), rtol=1e-6)
    live_jax = np.asarray(live_p).sum(axis=0) > 0
    np.testing.assert_array_equal(st.live.numpy(), live_jax)
    assert live_jax.any()


def test_encode_stats_check_passes_on_cpu():
    x, w, b = _encode_operands()
    wb = _t(w).to(torch.bfloat16)
    res = proto_encode_stats.check(dict(x=_t(x), w=_t(w), wb=wb, b_enc=_t(b)), k=16)
    assert res["h_rel"] == 0.0 and res["n_live"] > 0


# --- P3 -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def loop_kernel():
    return _load_script("microbench_kth").loop_kernel


def _keys(b: int, s: int) -> np.ndarray:
    rng = np.random.default_rng(b + s)
    key = rng.integers(-8, 40, size=(b, s), dtype=np.int32)
    key[0] = np.iinfo(np.int32).min
    key[1] = np.iinfo(np.int32).max
    key[2, ::3] = 0
    return key


@pytest.mark.parametrize("n_passes", [8, 16, 32])
def test_count_loop_plain_matches_pallas(loop_kernel, n_passes):
    b, s, tile = 64, S, 32
    key = _keys(b, s)
    call = pl.pallas_call(
        functools.partial(loop_kernel, n_passes),
        out_shape=jax.ShapeDtypeStruct((b, 1), jnp.int32),
        grid=(b // tile,),
        in_specs=[pl.BlockSpec((tile, s), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((tile, 1), lambda i: (i, 0)),
        interpret=True,
    )
    want = np.asarray(call(jnp.asarray(key)))
    got = microbench_kth.count_loop_plain(_t(key), n_passes)
    assert got.dtype == torch.int32 and got.shape == (b, 1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 0] == 0 and got[1, 0] == n_passes * s


def test_count_loop_check_passes_on_cpu():
    microbench_kth.check({"key": _t(np.abs(_keys(8, 300)) + 1)})


# --- the wrappers and the profiler on the CPU -----------------------------------


def test_cpu_wrappers_take_plain_versions(data):
    f, w, x, b_dec = data
    m, r = (_t(v) for v in _cuts(CUTS["two-in-group0"]))
    fns = (cm.grouped_prefix_base, proto_gouter.grouped_prefix_err_gouter, proto_encode_stats.encode_stats,
           microbench_kth.count_loop)
    before = [fn.launches for fn in fns]
    pairs = (
        (cm.grouped_prefix_base(_tb(f), _tb(w), m, r, group_size=G),
         cm.grouped_prefix_base_plain(_tb(f), _tb(w), m, r, group_size=G)),
        (proto_gouter.grouped_prefix_err_gouter(_tb(f), _tb(w), _t(x), _t(b_dec), torch.tensor(0.5), m, r,
                                                group_size=G),
         proto_gouter.grouped_prefix_err_gouter_plain(_tb(f), _tb(w), _t(x), _t(b_dec), torch.tensor(0.5), m, r,
                                                      group_size=G)),
        (proto_encode_stats.encode_stats(_t(x), _tb(w[:D].copy()), _t(b_dec), 8)[1],
         proto_encode_stats.encode_stats_plain(_t(x), _tb(w[:D].copy()), _t(b_dec), 8)[1]),
        ((microbench_kth.count_loop(_t(_keys(4, 100)), 16),), (microbench_kth.count_loop_plain(_t(_keys(4, 100)), 16),)),
    )
    for got, want in pairs:
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert before == [fn.launches for fn in fns]


def test_device_profile_refuses_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    with pytest.raises(RuntimeError, match="CUDA"):
        kprof.device_profile(lambda: calls.append(1), n=2, warmup=1)
    assert calls == []  # nothing ran: no CPU profile
    assert kprof.total_device_ms([("a", 1.5, 1), ("b", 0.25, 2)]) == 1.75
    assert kprof.total_device_ms([("a", 1.5, 1), ("b", 0.25, 2)], lambda name: name == "b") == 0.25


class _Event:
    device_type = torch.autograd.DeviceType.CUDA

    def __init__(self, key, us, count):
        self.key, self.self_device_time_total, self.count = key, us, count


@pytest.mark.parametrize("expect, recorded, want_profiles", [
    ((), [[], [], [("k_main", 3000.0, 2)]], 3),  # two empty profiles, then one with device time
    (("k_main", "k_tail"), [[("k_main", 3000.0, 2)], [("k_main", 3000.0, 2), ("k_tail", 500.0, 2)]], 2),
    ((), [[]] * 10, 8),  # never recorded: gives up after `tries` and returns no rows
])
def test_device_profile_takes_a_missed_profile_again(monkeypatch, expect, recorded, want_profiles):
    """A profile that recorded no kernel, or missed an expected one, is taken
    again after a pause; warm-up runs once, each profile runs fn n times."""
    made, pauses = [], []
    monkeypatch.setattr(kprof.time, "sleep", pauses.append)

    class FakeProfile:
        def __init__(self, activities):
            made.append(self)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return [_Event(*e) for e in recorded[len(made) - 1]]

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(kprof.device_profile, "retakes", 0)
    calls = []
    rows = kprof.device_profile(lambda: calls.append(1), n=2, warmup=1, expect=expect)
    assert len(made) == want_profiles
    assert kprof.device_profile.retakes == want_profiles - 1 == len(pauses)
    assert len(calls) == 1 + 2 * want_profiles
    want = sorted(((k, us / 1e3 / c * round(c / 2), round(c / 2)) for k, us, c in recorded[want_profiles - 1]),
                  key=lambda row: -row[1])
    assert rows == want


def test_plain_stats_are_k1_plain():
    """P1's plain statistics are K1's plain version applied to its h."""
    x, w, b = _encode_operands()
    h, st = proto_encode_stats.encode_stats_plain(_t(x), _t(w).to(torch.bfloat16), _t(b), 32)
    for got, want in zip(st, topk._topk_stats_plain(h, 32)):
        assert torch.equal(got, want)
