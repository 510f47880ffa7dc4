"""P4's plain versions (saev_tpu_torch/scripts/proto_kth_ops.py) against the
five Pallas bodies of scripts/proto_kth_ops.py, run in interpret mode.

The JAX script is loaded by file path (nothing in scripts/ is a package).
Rows of 64 x 2048, Gaussian with the edge rows of `edge_rows` (all zeros,
all negative, fewer than k positive, ties across the boundary, -0.0 beside
positives), in blocks of 32 rows as the script's `tile_rows` 32; k 1, 32 and
S; a ragged width of 1000 in one full-width block.

- every mode's plain version equals its JAX body bit for bit;
- the exact modes (all but subsar) equal `jax.lax.top_k(h, k)[0][:, -1:]`
  bit for bit, -0.0 and +0.0 taken as one value.
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

from saev_tpu_torch.scripts import proto_kth_ops

ROOT = pathlib.Path(__file__).resolve().parent.parent
B, S, TILE = 64, 2048, 32
BODIES = {"prod": "_prod_kernel", "i32key": "_i32key_kernel", "subsar": "_subsar_kernel",
          "f32red": "_f32red_kernel", "mxu": "_mxu_kernel"}


@pytest.fixture(scope="module")
def script():
    """scripts/proto_kth_ops.py as a module, leaving sys.path as it was (the
    script inserts its own directory)."""
    path = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location("_jax_scripts_proto_kth_ops",
                                                      ROOT / "scripts" / "proto_kth_ops.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
    return mod


def _rows(s: int = S, seed: int = 0) -> np.ndarray:
    h = np.random.default_rng(seed).normal(size=(B, s)).astype(np.float32)
    return proto_kth_ops.edge_rows(torch.from_numpy(h)).numpy()


def _pallas(body, h: np.ndarray, k: int, tile: int) -> np.ndarray:
    b, s = h.shape
    call = pl.pallas_call(
        functools.partial(body, k),
        out_shape=jax.ShapeDtypeStruct((b, 1), jnp.float32),
        grid=(b // tile,),
        in_specs=[pl.BlockSpec((tile, s), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((tile, 1), lambda i: (i, 0)),
        interpret=True,
    )
    return np.asarray(call(jnp.asarray(h)))


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _bits_zero_as_one(a) -> np.ndarray:
    return (np.asarray(a, np.float32) + np.float32(0.0)).view(np.int32)


def _plain(h: np.ndarray, k: int, mode: str) -> np.ndarray:
    got = proto_kth_ops.kth_ops_plain(torch.from_numpy(h), k, mode)
    assert got.dtype == torch.float32 and got.shape == (h.shape[0], 1)
    return got.numpy()


@pytest.mark.parametrize("k", [1, 32, S], ids=["k1", "k32", "kS"])
@pytest.mark.parametrize("mode", proto_kth_ops.MODES)
def test_plain_matches_pallas_body(script, mode, k):
    h = _rows()
    got = _plain(h, k, mode)
    want = _pallas(getattr(script, BODIES[mode]), h, k, TILE)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if mode in proto_kth_ops.EXACT:
        top = jax.lax.top_k(jnp.asarray(h), k)[0][:, -1:]
        np.testing.assert_array_equal(_bits_zero_as_one(got), _bits_zero_as_one(top))


@pytest.mark.parametrize("mode", proto_kth_ops.MODES)
def test_plain_matches_pallas_body_ragged(script, mode):
    h = np.ascontiguousarray(_rows(seed=1)[:, :proto_kth_ops.RAGGED])
    got = _plain(h, 32, mode)
    np.testing.assert_array_equal(_bits(got), _bits(_pallas(getattr(script, BODIES[mode]), h, 32, B)))


def test_subsar_is_not_exact():
    """subsar finds the k-th largest 31-bit key and drops the lowest bit of
    the order key: it differs from the exact value on some rows, never by
    more than that bit."""
    h = _rows(seed=2)
    got = _plain(h, 32, "subsar")
    exact = _plain(h, 32, "prod")
    key = lambda a: proto_kth_ops._order_key(torch.from_numpy(a)).numpy()  # noqa: E731
    diff = key(exact) - key(got)
    assert set(np.unique(diff)) <= {0, 1} and diff.any()


def test_cpu_wrapper_takes_the_plain_version():
    h = torch.from_numpy(_rows(s=300, seed=3))
    before = proto_kth_ops.kth_ops.launches
    for mode in proto_kth_ops.MODES:
        assert torch.equal(proto_kth_ops.kth_ops(h, 7, mode), proto_kth_ops.kth_ops_plain(h, 7, mode))
    assert proto_kth_ops.kth_ops.launches == before
    with pytest.raises(ValueError, match="mode"):
        proto_kth_ops.kth_ops(h, 7, "popc")
    with pytest.raises(ValueError, match="k="):
        proto_kth_ops.kth_ops(h, 301, "prod")


def test_check_passes_on_cpu():
    """The module's check on the CPU, where K6 and P4 take their plain
    versions: the rows, the edge rows with k 32, 1 and S, and the ragged
    width."""
    h = torch.from_numpy(np.random.default_rng(4).normal(size=(8, 1200)).astype(np.float32))
    assert proto_kth_ops.check({"h": h}) == 8 * 5


SASS = """
	code for sm_90a
		Function : _ZN43_GLOBAL__N__b24f0e1f_10_kth_ops_cu_07bce94f21kth_ops_stream_kernelILi4ELi4ELi256EEEvPKfiiiPf
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                           /* 0x00000a00ff017b82 */
                                                                                    /* 0x000e220000000800 */
        /*0010*/                   SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [UR4], R3 ;   /* 0x0000000000007b1d */
        /*0020*/              @!P0 BRA 0x10 ;                                     /* 0x0000000000f01947 */
        /*0030*/                   ISETP.GE.U32.AND P1, PT, R4, R5, PT ;           /* 0x000000050400720c */
        /*0040*/                   HMMA.16816.F32.BF16 R8, R12, R16, R8 ;          /* 0x000000100c08723c */
        /*0050*/              @!P1 HMMA.16816.F32.BF16 R8, R12, R16, R8 ;          /* 0x000000100c08723c */
        /*0060*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;                  /* 0x0000000000007b1d */
        /*0070*/               @P2 BRA 0x30 ;                                     /* 0x0000000000f01947 */
        /*0080*/                   STG.E desc[UR6][R2.64], R8 ;                   /* 0x0000000802007986 */
        /*0090*/               @P3 BRA 0x10 ;                                     /* 0x0000000000f01947 */
        /*00a0*/                   EXIT ;                                         /* 0x000000000000794d */
        /*00b0*/                   BRA 0xb0;                                      /* 0xfffffffc00fc7947 */
		Function : _ZN43_GLOBAL__N__b24f0e1f_10_kth_ops_cu_07bce94f14kth_ops_kernelILi0ELi4ELi256EEEvPKfiiPf
        /*0000*/                   ISETP.GE.U32.AND P0, PT, R4, R5, PT ;           /* 0x000000050400720c */
        /*0010*/                   REDUX.SUM UR4, R2 ;                              /* 0x00000000020473c4 */
		Function : _ZN43_GLOBAL__N__b24f0e1f_10_kth_ops_cu_07bce94f24count_loop_stream_kernelILi4ELi256EEEvPKiiiiPi
        /*0000*/                   ISETP.GE.AND P0, PT, R4, R6, PT ;               /* 0x000000060400720c */
        /*0010*/               @P0 IADD3 R7, R7, 0x1, RZ ;                        /* 0x0000000107070810 */
        /*0020*/                   ISETP.GE.AND P1, PT, R5, R6, PT ;               /* 0x000000060500720c */
        /*0030*/               @P1 IADD3 R7, R7, 0x1, RZ ;                        /* 0x0000000107071810 */
        /*0040*/                   IADD3 R6, R6, 0x1, RZ ;                        /* 0x0000000106067810 */
        /*0050*/               @P2 BRA 0x0 ;                                      /* 0x0000000000f01947 */
		Function : _ZN43_GLOBAL__N__b24f0e1f_7_kth_cu_5a1b2c3d10kth_kernelILb0ELi4ELi256EEEvPKfPKhiiPf
        /*0000*/                   HMMA.16816.F32.BF16 R8, R12, R16, R8 ;          /* 0x000000100c08723c */
"""


def test_parse_sass_counts_opcodes_per_instantiation():
    """Opcodes of each kth_ops_kernel and count_loop_kernel instantiation,
    stream form or not (predicates dropped, other kernels ignored), and of
    its pass loop: the shortest loop of at least VPT instructions without
    an mbarrier wait, not the row loop around it nor the wait for a row's
    copy; the pass loop's longest register chain (a guarded instruction
    reads its guard and its old result)."""
    found = proto_kth_ops.parse_sass(SASS)
    assert found == {
        ("mxu", "stream", 4, 256): {
            "all": {"LDC": 1, "SYNCS": 1, "BRA": 4, "ISETP": 1, "HMMA": 2, "BAR": 1, "STG": 1, "EXIT": 1},
            "pass": {"ISETP": 1, "HMMA": 2, "BAR": 1, "BRA": 1}, "chain": 2},
        ("prod", "rows", 4, 256): {"all": {"ISETP": 1, "REDUX": 1}, "pass": {}, "chain": 0},
        ("count_loop", "stream", 4, 256): {"all": {"ISETP": 2, "IADD3": 3, "BRA": 1},
                                           "pass": {"ISETP": 2, "IADD3": 3, "BRA": 1}, "chain": 3},
    }
    assert proto_kth_ops.hmma_by_mode(found) == {"prod": [0], "i32key": [], "subsar": [], "f32red": [], "mxu": [2]}


def _dump(kernels: dict[str, str]) -> str:
    """A SASS dump of one-CTA-a-row kernels at VPT 64, 256 threads, each a
    pass loop of a compare and a guarded add a key into one register."""
    lines = ["\tcode for sm_90a"]
    for name, mangled in kernels.items():
        lines.append(f"\t\tFunction : _ZN43_GLOBAL__N__b24f0e1f_10_kth_ops_cu_07bce94f{mangled}EEEvPKfiiPf")
        for j in range(64):
            lines.append(f"        /*{32 * j:04x}*/                   ISETP.GE.U32.AND P0, PT, R{8 + j}, R5, PT ;")
            lines.append(f"        /*{32 * j + 16:04x}*/               @P0 IADD3 R7, R7, 0x1, RZ ;")
        lines.append("        /*0800*/               @P1 BRA 0x0 ;")
        lines.append("        /*0810*/                   EXIT ;")
    return "\n".join(lines) + "\n"


def test_sass_report_reads_a_saved_dump(tmp_path, capsys):
    """`main(["--sass", file])` reports an older tree's kernels, one CTA a
    row only: each pass loop's instructions and register chain, in all and
    a key."""
    kernels = {mode: f"14kth_ops_kernelILi{i}ELi64ELi256" for i, mode in enumerate(proto_kth_ops.MODES)}
    kernels["count_loop"] = "17count_loop_kernelILi64ELi256"
    path = tmp_path / "dump.sass"
    path.write_text(_dump(kernels))
    proto_kth_ops.main(["--sass", str(path)])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("SASS HMMA per instantiation: prod [0]")
    assert out[1:] == [f"SASS {k} rows <64, 256> pass loop: 129 instructions (2.02 a key), chain 65 (1.02 a key): "
                       "ISETP 64, IADD3 64, BRA 1" for k in kernels]
