"""Plain-torch models of P4's and P3's kernels (csrc/kth_ops.cu, modelled in
tests/kth_select_model.py) against the plain versions of
saev_tpu_torch/scripts/proto_kth_ops.py and microbench_kth.py and against the
JAX scripts' Pallas bodies in interpret mode, bit for bit.

The models follow the kernels' partition step by step: VPT keys a thread
in runs of 4 columns over T threads (the dispatch tables read from the
source), each mode's key domain and pad past the row's end, the count of a
pass split over kAcc accumulators a thread (P3: its passes over kLoopAcc;
kMxuAcc D fragments in mxu,
with the bf16 A fragment's lane layout), the warp's and the block's sums,
and the rows of each persistent CTA over a grid smaller and larger than B.

- P4: rows of 64 x 2048, Gaussian with `proto_kth_ops.edge_rows`, k 1, 32
  and S, and a ragged width of 1000; every mode equal to its plain version
  and to its JAX body (`scripts/proto_kth_ops.py`), the exact modes to the
  k-th value with -0.0 and +0.0 taken as one.
- P3: the one-sweep sum with one block sum a row at 0, 1, 8 and 32 passes
  and S 1, 1000 and 2048, equal to `count_loop_plain` and to `loop_kernel`
  (`scripts/microbench_kth.py`).
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
from kth_select_model import (PASS_MODES, _mxu_lane_counts, count_loop_model, cta_rows, kth_ops_model, pass_consts,
                              pass_dispatch, streams)

from saev_tpu_torch.ops.topk import _kth_plain
from saev_tpu_torch.scripts import microbench_kth, proto_kth_ops

ROOT = pathlib.Path(__file__).resolve().parent.parent
B, S, TILE = 64, 2048, 32
BODIES = {"prod": "_prod_kernel", "i32key": "_i32key_kernel", "subsar": "_subsar_kernel",
          "f32red": "_f32red_kernel", "mxu": "_mxu_kernel"}
# Resident CTAs of a card (the grid's cap) below and above B.
FEW, MANY = 7, 264


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


@pytest.fixture(scope="module")
def kth_script():
    return _load_script("proto_kth_ops")


@pytest.fixture(scope="module")
def loop_kernel():
    return _load_script("microbench_kth").loop_kernel


def _pallas(body, x: np.ndarray, out_dtype, tile: int) -> np.ndarray:
    b, s = x.shape
    call = pl.pallas_call(
        body,
        out_shape=jax.ShapeDtypeStruct((b, 1), out_dtype),
        grid=(b // tile,),
        in_specs=[pl.BlockSpec((tile, s), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((tile, 1), lambda i: (i, 0)),
        interpret=True,
    )
    return np.asarray(call(jnp.asarray(x)))


def _rows(s: int = S, seed: int = 0) -> torch.Tensor:
    h = np.random.default_rng(seed).normal(size=(B, s)).astype(np.float32)
    return proto_kth_ops.edge_rows(torch.from_numpy(h))


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


# --- what the models read from the source ---


@pytest.mark.parametrize("s", [1, 4, 1000, 1024, 1025, 2048, 16384, 16385, 32768])
def test_pass_dispatch_holds_every_column(s):
    """P4's and P3's tables agree (`pass_dispatch` asserts it); T threads of
    VPT keys hold the row, T a multiple of 32 within the CTA's MAXT, VPT
    whole runs of 4."""
    vpt, maxt = pass_dispatch(s)
    nt = -(-(-(-s // vpt)) // 32) * 32
    assert vpt % 4 == 0 and nt <= maxt and nt * vpt >= s and (nt - 32) * vpt < s


def test_pass_consts_are_powers_of_two():
    """The accumulators are summed pairwise (`warp_count`, `count_row`),
    which needs a power of two; and the production row's VPT 64 splits
    evenly over them."""
    c = pass_consts()
    for n in c.values():
        assert n >= 1 and n & (n - 1) == 0
    assert pass_dispatch(16384)[0] % c["acc"] == 0 and pass_dispatch(16384)[0] % c["loop_acc"] == 0


@pytest.mark.parametrize("b,ctas", [(1, 3), (5, MANY), (MANY, MANY), (1000, MANY), (B, FEW)])
def test_cta_rows_take_every_row_once(b, ctas):
    rows = cta_rows(b, ctas)
    assert len(rows) == min(b, ctas)
    assert sorted(r for rs in rows for r in rs) == list(range(b))
    assert all(rs == list(range(g, b, len(rows))) for g, rs in enumerate(rows))


@pytest.mark.parametrize("s,offset,want", [(2048, 0, True), (1000, 0, True), (1001, 0, False), (2048, 1, False),
                                           (2048, 4, True), (2, 0, False)])
def test_streams_picks_the_route(s, offset, want):
    assert streams(s, offset) == want


# --- P4 ---


@pytest.mark.parametrize("k", [1, 32, S], ids=["k1", "k32", "kS"])
@pytest.mark.parametrize("mode", PASS_MODES)
def test_kth_ops_model_matches_plain_and_pallas(kth_script, mode, k):
    h = _rows()
    want = proto_kth_ops.kth_ops_plain(h, k, mode)
    for ctas in (FEW, MANY):
        got = kth_ops_model(h, k, mode, ctas)
        assert got["vpt"] * got["threads"] >= S
        np.testing.assert_array_equal(_bits(got["kth"]), _bits(want))
    jax_body = _pallas(functools.partial(getattr(kth_script, BODIES[mode]), k), h.numpy(), jnp.float32, TILE)
    np.testing.assert_array_equal(_bits(want), _bits(jax_body))
    if mode != "subsar":
        np.testing.assert_array_equal(_bits(want + 0.0), _bits(_kth_plain(h, k) + 0.0))


@pytest.mark.parametrize("mode", PASS_MODES)
def test_kth_ops_model_ragged(kth_script, mode):
    """1000 columns: 24 pad keys at the row's end (T 256, VPT 4)."""
    h = _rows(seed=1)[:, :proto_kth_ops.RAGGED].contiguous()
    got = kth_ops_model(h, 32, mode, FEW)
    assert got["vpt"] * got["threads"] > proto_kth_ops.RAGGED
    want = _pallas(functools.partial(getattr(kth_script, BODIES[mode]), 32), h.numpy(), jnp.float32, B)
    np.testing.assert_array_equal(_bits(got["kth"]), _bits(want))
    np.testing.assert_array_equal(_bits(got["kth"]), _bits(proto_kth_ops.kth_ops_plain(h, 32, mode)))


@pytest.mark.parametrize("mode", PASS_MODES)
def test_kth_ops_pads_add_to_no_count(mode):
    """Every candidate a run reaches, the first step's included, leaves the
    mode's pad out of its count: u32 0 below every candidate, INT32_MIN
    below every signed one, and subsar's INT32_MAX, whose (pad - cand) >> 31
    is 0 (the count adds the row's true S instead)."""
    h = _rows(s=1000, seed=2)
    got = kth_ops_model(h, 32, mode, FEW)
    cands, pad = got["cands"], got["pad"]
    if mode == "subsar":
        assert bool(((pad - cands) >= 0).all())
    else:
        assert bool((pad < cands).all())
    if mode == "i32key":
        assert bool((cands[:, 0] == 0).all())  # INT32_MIN + INT32_MIN wraps to 0


@pytest.mark.parametrize("frags", [1, 2, 4])
@pytest.mark.parametrize("vpt", [4, 8, 64])
def test_mxu_fragments_count_each_key_once(vpt, frags):
    """Each of a thread's keys lands in one bf16 A slot of one product, and
    the lanes that read column 0 of the D fragments see every row once:
    one key set alone counts 1, all keys count T * VPT."""
    nt = 64
    ones = torch.ones((1, nt, vpt))
    assert float(_mxu_lane_counts(ones, frags).sum()) == nt * vpt
    rng = np.random.default_rng(vpt * 10 + frags)
    for t, j in zip(rng.integers(0, nt, 8), rng.integers(0, vpt, 8)):
        one = torch.zeros((1, nt, vpt))
        one[0, t, j] = 1.0
        lanes = _mxu_lane_counts(one, frags)
        warp = int(t) // 32
        assert float(lanes.sum()) == 1.0 and float(lanes[0, 32 * warp:32 * warp + 32].sum()) == 1.0


# --- P3 ---


def _keys(b: int, s: int, seed: int) -> np.ndarray:
    """Keys folded into [-8, 40) so that the counts vary, a row of
    INT32_MIN (no pass counts it), one of INT32_MAX, and a row drawn as the
    bench draws its keys, from [1, 2^31)."""
    rng = np.random.default_rng(seed)
    key = rng.integers(-8, 40, size=(b, s), dtype=np.int32)
    key[0] = np.iinfo(np.int32).min
    key[1] = np.iinfo(np.int32).max
    key[2] = rng.integers(1, 2**31, size=s, dtype=np.int32)
    return key


@pytest.mark.parametrize("s", [1, 1000, 2048])
@pytest.mark.parametrize("n_passes", [0, 1, 8, 32])
def test_count_loop_model_matches_plain_and_pallas(loop_kernel, n_passes, s):
    key = _keys(B, s, n_passes + s)
    want = microbench_kth.count_loop_plain(torch.from_numpy(key), n_passes)
    for ctas in (FEW, MANY):
        got = count_loop_model(torch.from_numpy(key), n_passes, ctas)
        assert got["vpt"] * got["threads"] >= s
        assert got["out"].dtype == torch.int32 and torch.equal(got["out"], want)
    jax_out = _pallas(functools.partial(loop_kernel, n_passes), key, jnp.int32, TILE)
    np.testing.assert_array_equal(want.numpy(), jax_out)
    assert int(want[0, 0]) == 0 and int(want[1, 0]) == n_passes * s
