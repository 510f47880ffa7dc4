"""Where K1's, K6's and K5's time goes on the card, measured on instrumented
or re-bounded copies of the committed sources (csrc/topk_row.cuh,
csrc/topk_stats.cu and csrc/kth.cu; csrc/kth_masked.cu); the library itself
is untouched.

    python -m saev_tpu_torch.scripts.select_probe

- `k1_phases`: a copy of K1 with a clock64 stamp, from thread 0, at each
  phase boundary of every row: the row into registers, the lower bound, the
  filter, the select, the epilogue's loop, the reductions and stores. Prints
  the mean cycles a row spends in each phase, and the CUDA-event times of
  the copy with and without stamps and of the library's K1, at the
  production shape (16384 x 16384 Gaussian rows, k 32).
- `k6_phases`: the same stamps in a copy of K6, which runs K1's select
  alone: the row into registers, the lower bound, the filter, the select.
- `k6_caps`: K6's streamed kernel built with launch bounds that ask for 2
  and 3 CTAs an SM (three 64 KB row buffers fit in shared memory; the
  registers are the question), timed by CUDA events at the production
  shape and held bitwise to the plain version.
- `k5_phases`: a copy of K5 with clock64 stamps: each CTA's start and the
  end of its mask compaction (thread 0), and each row's gather start, keys
  gathered and bisection done (the first lane of the row's first warp).
  Prints the mean cycles of each phase at the train step's three shapes
  (dead columns pinned near -1e6 as bench.py pins them) and at the tight
  shape on Gaussian rows, and the kernel's device time by the profiler.
- `k1_wide_phases`: a copy of K1's cluster route (csrc/kth_wide.cu,
  `wide_cluster_kernel`) with a clock64 stamp, from thread 0 of the first
  two CTAs (one cluster), at each phase boundary of their first 64 rows:
  the wait for the slice, the keys and maxima, the bound, the filter, the
  cluster barrier, the counts and bounds read, the union and select, the
  epilogue's loop, the reductions. Prints the mean cycles of each over rows
  4-59 and the row's period, at 16384 x 65536 and x 131072 (k 32), and the
  copy's time beside the library's.
- `k1_wide_variants`: K1's cluster route built three ways from the
  committed kth_wide.cu: as it is; with its per-row barrier the full
  cluster barrier (`hopper::cluster_sync`, whose release also waits for
  the CTA's global stores and bulk copies in flight) in place of
  `cluster_sync_shared`; and with 256 threads a CTA (slices of 16384
  columns: 4 CTAs a row at 65536, 8 at 131072, two CTAs an SM). Each one's
  registers, its CUDA-event time at 16384 x 65536 and x 131072 (k 32), its
  kth held bitwise to the plain version.
- `k5_caps`: K5 built with launch bounds that ask for 1, 2 and 3 CTAs an SM
  (the KPL 32 kernel's registers held to 128, 64 and 40), timed by CUDA
  events at the train step's three shapes (16384 x 1024 with 819 unmasked
  columns, x 4096 with 3276, x 16384 with 819), each held bitwise to the
  plain version.

- `p1_phases`: a copy of P1's product (csrc/encode_stats.cu) in which every
  thread adds the clock64 cycles between its phase boundaries to its own
  sums, and thread 0 stores its CTA's: the K walk (with f's zeros), the
  epilogue's stores of h and keys, the scans and appends, the prunes, the
  final select and scatter, the exact route; and its warp's prune events.
  Prints the mean over CTAs of each, the CUDA-event times of the copy with
  and without stamps, and, by the profiler, the device time of the
  library's two launches (x rounded, the product), at the production shape
  (16384 x 1024 -> 16384, k 32) on the bench's operands and on rows that
  ascend in column order (b_enc a ramp from -100 to 100, rows 0-7 bias
  only), with the rows that took the exact route. Its copy is held bit for
  bit to the library's P1.

Thread 0 stamps a CTA's slots (g_cta[blockIdx.x * 8 + i]) as its row goes
through the phases, and copies them to the row's (g_stamps[row * 8 + i])
when the row is done: the select's routine does not know the row.
"""

import ctypes
import pathlib
import shutil
import subprocess
import tempfile

import torch

from ..ops import _build, cuda_kth, cuda_topk, topk
from . import kprof

B, S, K = 16384, 16384, 32
K_AUX = 512
K5_SHAPES = ((1024, 819), (4096, 3276), (16384, 819))
PHASES = ("row into registers", "lower bound", "filter", "select", "epilogue loop", "reductions and stores")
K6_PHASES = PHASES[:4]
SEED = 0

# Where each stamp goes in topk_row.cuh: (text, stamp index, before or after).
_STAMPS = (
    ("  uint32_t key[VPT];\n", 0, "before"),
    ("  __syncthreads();\n  released();\n", 1, "after"),
    ("  // 2. The keys >= t0", 2, "before"),
    ("  const int n_cand = sm.n_cand;\n", 3, "after"),
    ("  const float kth = key_float(kth_key);\n", 4, "before"),
    ("  l0 = __reduce_add_sync(0xffffffffu, l0);\n", 5, "before"),
    ("    l1_out[row] = l1_total;\n", 6, "after"),
)
# The same in kth.cu's row: its start, the select's end, and the row done.
_K6_STAMPS = (
    ("  uint32_t key[VPT];\n", 0, "before"),
    ("  const uint32_t kth = select_kth_key<VPT, MAXT>(key, mx, S, k, sm, fallback, released);\n", 4, "after"),
)
_K6_DONE = "  if (threadIdx.x == 0) out[row] = key_float(kth);\n"
_K6_BOUNDS = "__global__ void __launch_bounds__(MAXT)\n    kth_stream_kernel("
_POINTERS = "__device__ long long* g_stamps;\n__device__ long long* g_cta;\n"


def _stamp(i: int) -> str:
    return f"  if (threadIdx.x == 0 && g_stamps) g_cta[blockIdx.x * 8 + {i}] = clock64();\n"


def _copy(indent: str, n: int) -> str:
    return (f"{indent}if (threadIdx.x == 0 && g_stamps)\n{indent}  for (int i = 0; i < {n}; ++i) "
            f"g_stamps[row * 8 + i] = g_cta[blockIdx.x * 8 + i];\n")


def _insert(src: str, name: str, stamps) -> str:
    for text, i, where in stamps:
        if src.count(text) != 1:
            raise ValueError(f"{name}: the probe's marker {text!r} is not there once")
        src = src.replace(text, _stamp(i) + text if where == "before" else text + _stamp(i))
    return src


_K5_BOUNDS = "__launch_bounds__(kMaxWarps * 32, KPL == 32 ? 2 : 1)"
# Where each stamp goes in kth_masked.cu: (text, array and index, before or after).
_K5_STAMPS = (
    ("  const int lane = tid & 31, warp = tid >> 5, W = nt >> 5;\n", "cta", 0, "after"),
    ("  // 2. Fewer than k unmasked columns", "cta", 1, "before"),
    ("    const float* hr = h + row * S;\n", "row", 0, "after"),
    ("    // The k-th largest key, in [lo, hi].\n", "row", 1, "before"),
    ("    if (g == 0 && lane == 0) out[row] = key_float(kth);\n", "row", 2, "before"),
)
K5_PHASES = ("mask compaction (a CTA)", "keys gathered (a row)", "bisection (a row)")


def stamped_row_source() -> str:
    """topk_row.cuh with a clock64 stamp of thread 0 at each phase boundary
    into its CTA's slots, copied to g_stamps[row * 8 + i] when K1's row is
    done (device pointers, g_stamps null for no stamps)."""
    src = _insert((_build.CSRC / "topk_row.cuh").read_text(), "topk_row.cuh", _STAMPS)
    done = "    l1_out[row] = l1_total;\n" + _stamp(6)
    src = src.replace(done, done + _copy("    ", 7))
    return src.replace("namespace {\n", _POINTERS + "\nnamespace {\n", 1)


def stamped_k6_source() -> str:
    """kth.cu with stamps at its row's start and the select's end, copied to
    g_stamps[row * 8 + i] when the row is done; the select's own stamps come
    from `stamped_row_source`'s header (the pointers are declared there)."""
    src = _insert((_build.CSRC / "kth.cu").read_text(), "kth.cu", _K6_STAMPS)
    if src.count(_K6_DONE) != 1:
        raise ValueError(f"kth.cu: the probe's marker {_K6_DONE!r} is not there once")
    return src.replace(_K6_DONE, _K6_DONE + _copy("  ", 5))


def k5_capped_source(min_blocks: int) -> str:
    """kth_masked.cu with launch bounds that ask for min_blocks CTAs an SM."""
    src = (_build.CSRC / "kth_masked.cu").read_text()
    if src.count(_K5_BOUNDS) != 1:
        raise ValueError("kth_masked.cu: the probe's launch bounds are not there once")
    return src.replace(_K5_BOUNDS, f"__launch_bounds__(kMaxWarps * 32, {min_blocks})")


def stamped_k5_source() -> str:
    """kth_masked.cu with clock64 stamps: g_cta[blockIdx.x * 2 + i] from
    thread 0, g_row[row * 3 + i] from the first lane of each row's first warp
    (device pointers, null for no stamps)."""
    src = (_build.CSRC / "kth_masked.cu").read_text()
    for text, where, i, place in _K5_STAMPS:
        if src.count(text) != 1:
            raise ValueError(f"kth_masked.cu: the probe's marker {text!r} is not there once")
        if where == "cta":
            stamp = f"  if (tid == 0 && g_cta) g_cta[blockIdx.x * 2 + {i}] = clock64();\n"
        else:
            stamp = f"    if (g == 0 && lane == 0 && g_row) g_row[row * 3 + {i}] = clock64();\n"
        src = src.replace(text, stamp + text if place == "before" else text + stamp)
    pointers = "__device__ long long* g_cta;\n__device__ long long* g_row;\n"
    return src.replace("namespace {\n", pointers + "\nnamespace {\n", 1)


def k6_capped_source(min_blocks: int) -> str:
    """kth.cu with launch bounds on the streamed kernel that ask for
    min_blocks CTAs an SM."""
    src = (_build.CSRC / "kth.cu").read_text()
    if src.count(_K6_BOUNDS) != 1:
        raise ValueError("kth.cu: the probe's launch bounds are not there once")
    return src.replace(_K6_BOUNDS, _K6_BOUNDS.replace("(MAXT)", f"(MAXT, {min_blocks})"))


WIDE_S = (65536, 131072)
WIDE_PHASES = ("wait for the slice", "keys and maxima", "bound", "filter", "cluster barrier",
               "counts and bounds read", "union and select", "epilogue loop", "reductions")
_WIDE_ROWS = 64  # rows stamped of each of the first two CTAs
# Where each stamp goes in wide_cluster_kernel: (text, stamp index, before or after).
_WIDE_STAMPS = (
    ("    uint32_t key[kSliceVpt];\n    uint32_t mx;\n", 0, "after"),
    ("      parity ^= 1;\n", 1, "after"),
    ("    sm.maxima[tid] = mx;\n    __syncthreads();\n", 2, "after"),
    ("      if (bounded && !own) {\n", 3, "before"),
    ("      hopper::cluster_sync_shared();  // B:", 4, "before"),
    ("      // 3. The union: each CTA's count and offset", 5, "before"),
    ("      if (fits) {\n", 6, "before"),
    ("    // 5. This slice's f, live, L0 and L1", 7, "before"),
    ("    l0 = __reduce_add_sync(0xffffffffu, l0);\n", 8, "before"),
    ("  }\n  hopper::cluster_sync();  // the last row's parts", 9, "before"),
)


def stamped_wide_source() -> str:
    """kth_wide.cu with a clock64 stamp of thread 0 of CTAs 0 and 1 at each
    phase boundary of K1's cluster kernel, into g_wide[(blockIdx.x * 64 +
    it) * 10 + i] for its first 64 rows (a device pointer, null for no
    stamps)."""
    src = (_build.CSRC / "kth_wide.cu").read_text()
    a = src.index("    wide_cluster_kernel(")
    b = src.index("cudaError_t cluster_config(")
    body = src[a:b]
    for text, i, where in _WIDE_STAMPS:
        if body.count(text) != 1:
            raise ValueError(f"kth_wide.cu: the probe's marker {text!r} is not there once")
        stamp = (f"    if (threadIdx.x == 0 && g_wide && blockIdx.x < 2 && it < {_WIDE_ROWS}) "
                 f"g_wide[(blockIdx.x * {_WIDE_ROWS} + it) * 10 + {i}] = clock64();\n")
        body = body.replace(text, stamp + text if where == "before" else text + stamp)
    src = src[:a] + body + src[b:]
    return src.replace("namespace {\n", "__device__ long long* g_wide;\nnamespace {\n", 1)


# K1's cluster route built other ways: (text, its replacement) in kth_wide.cu.
WIDE_VARIANTS = {
    "as committed": (),
    "full cluster barrier a row": (("      hopper::cluster_sync_shared();  // B:",
                                    "      hopper::cluster_sync();  // B:"),),
    "256 threads a CTA": (("constexpr int kSliceThreads = 512;", "constexpr int kSliceThreads = 256;"),),
}


def wide_variant_source(name: str) -> str:
    """kth_wide.cu with WIDE_VARIANTS[name]'s replacements."""
    src = (_build.CSRC / "kth_wide.cu").read_text()
    for old, new in WIDE_VARIANTS[name]:
        if src.count(old) != 1:
            raise ValueError(f"kth_wide.cu: the probe's marker {old!r} is not there once")
        src = src.replace(old, new)
    return src


def _compile(tmp: pathlib.Path, source: pathlib.Path, name: str) -> tuple[ctypes.CDLL, str]:
    out = tmp / f"{name}.so"
    res = subprocess.run([_build.cuda_tool("nvcc"), *_build.NVCC_FLAGS, "-shared", "-o", str(out), str(source)],
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stderr}")
    return ctypes.CDLL(str(out)), res.stderr


def _events_ms(fn, n: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def _probe_dir(tmp: pathlib.Path, name: str) -> pathlib.Path:
    d = tmp / name
    d.mkdir()
    for f in ("topk_stats.cu", "kth.cu", "hopper.cuh", "order_key.cuh", "row_stream.cuh"):
        shutil.copy(_build.CSRC / f, d / f)
    (d / "topk_row.cuh").write_text(stamped_row_source())
    return d


def _stamp_setter(src: pathlib.Path) -> None:
    with open(src, "a") as fh:
        fh.write('\nextern "C" int saev_probe_stamps(long long* p, long long* cta) {\n'
                 "  cudaError_t e = cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));\n"
                 "  return e != cudaSuccess ? e : cudaMemcpyToSymbol(g_cta, &cta, sizeof(cta));\n}\n")


def _run_stamped(lib: ctypes.CDLL, call, library_call, n_phases: int) -> tuple[float, float, float, list, float]:
    """The copy's CUDA-event time without and with stamps, the library's, and
    the mean cycles a row spends in each of n_phases phases and in all."""
    lib.saev_probe_stamps.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    stamps = torch.zeros((B, 8), dtype=torch.int64, device="cuda")
    cta = torch.zeros((B, 8), dtype=torch.int64, device="cuda")
    lib.saev_probe_stamps(None, None)
    plain_ms = _events_ms(call)
    lib.saev_probe_stamps(ctypes.c_void_p(stamps.data_ptr()), ctypes.c_void_p(cta.data_ptr()))
    stamped_ms = _events_ms(call)
    lib.saev_probe_stamps(None, None)
    library_ms = _events_ms(library_call)
    st = stamps.double()
    cycles = (st[:, 1:n_phases + 1] - st[:, 0:n_phases]).mean(0).tolist()
    return plain_ms, stamped_ms, library_ms, cycles, float((st[:, n_phases] - st[:, 0]).mean())


def k1_phases(tmp: pathlib.Path) -> list[str]:
    d = _probe_dir(tmp, "k1")
    _stamp_setter(d / "topk_stats.cu")
    lib, _ = _compile(d, d / "topk_stats.cu", "k1_probe")
    lib.saev_topk_stats.argtypes = _build.SIGNATURES["saev_topk_stats"]
    h = torch.randn((B, S), generator=torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    kth = torch.empty((B, 1), device="cuda")
    f = torch.empty((B, S), dtype=torch.bfloat16, device="cuda")
    live = torch.zeros(S, dtype=torch.int32, device="cuda")
    l0, l1 = torch.empty((B, 1), device="cuda"), torch.empty((B, 1), device="cuda")

    def call():
        code = lib.saev_topk_stats(h.data_ptr(), B, S, K, kth.data_ptr(), f.data_ptr(), live.data_ptr(),
                                   l0.data_ptr(), l1.data_ptr(), None, torch.cuda.current_stream().cuda_stream)
        _build.check(code, "select_probe K1")

    plain_ms, stamped_ms, library_ms, cycles, total = _run_stamped(
        lib, call, lambda: cuda_topk.topk_stats_cuda(h, K), len(PHASES))
    want = topk._topk_stats_plain(h, K)
    if not torch.equal(kth, want.kth):
        raise AssertionError("select_probe: the stamped K1's kth differs from the plain version")
    return [f"K1 {B}x{S} k {K}: library {library_ms:.3f} ms, the probe's copy {plain_ms:.3f} ms, with stamps "
            f"{stamped_ms:.3f} ms; mean cycles a row: "
            + ", ".join(f"{name} {c:.0f}" for name, c in zip(PHASES, cycles)) + f"; in all {total:.0f}"]


def k6_phases(tmp: pathlib.Path) -> list[str]:
    d = _probe_dir(tmp, "k6")
    (d / "kth.cu").write_text(stamped_k6_source())
    _stamp_setter(d / "kth.cu")
    lib, _ = _compile(d, d / "kth.cu", "k6_probe")
    lib.saev_kth.argtypes = _build.SIGNATURES["saev_kth"]
    h = torch.randn((B, S), generator=torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    out = torch.empty((B, 1), device="cuda")

    def call():
        code = lib.saev_kth(h.data_ptr(), B, S, K, out.data_ptr(), None, torch.cuda.current_stream().cuda_stream)
        _build.check(code, "select_probe K6")

    plain_ms, stamped_ms, library_ms, cycles, total = _run_stamped(
        lib, call, lambda: cuda_kth.kth_value_cuda(h, K), len(K6_PHASES))
    if not torch.equal(out, topk._kth_plain(h, K)):
        raise AssertionError("select_probe: the stamped K6 differs from the plain version")
    return [f"K6 {B}x{S} k {K}: library {library_ms:.3f} ms, the probe's copy {plain_ms:.3f} ms, with stamps "
            f"{stamped_ms:.3f} ms; mean cycles a row: "
            + ", ".join(f"{name} {c:.0f}" for name, c in zip(K6_PHASES, cycles)) + f"; in all {total:.0f}"]


# P1's phase boundaries in encode_stats.cu: (text, the phase it ends, before
# or after); the sums are declared before the first and stored before the
# last.
_P1_STAMPS = (
    ("    // The tile's K walk.\n", 2, "before"),
    ("    // The tile's epilogue: h written, the keys formed.\n", 0, "before"),
    ("    // Append the keys >= L to each row's buffer, pruning first where that\n", 1, "before"),
    ("  // Each held row's kth: the k-th largest key of its buffer.\n", 2, "before"),
    ("  // The rows that took the exact route: K1's row routine on their h, read\n", 3, "before"),
    ("  if (threadIdx.x == 0 && exact != nullptr && n_exact > 0) atomicAdd(exact, n_exact);\n", 4, "before"),
)
_P1_START = "  // Each row's state, the same in the four lanes of its quad: the bound L,\n"
_P1_PRUNE = "    if (__any_sync(FULL, over)) {\n"
_P1_PRUNED = "        held[hh] = held[hh] && n_buf[hh] + total[hh] <= kCap;\n      }\n"
P1_ROWS = 64  # rows a CTA of P1 owns (encode_stats.cu kRows)
P1_PHASES = ("K walk and f's zeros", "epilogue: h stored, keys", "scans and appends", "final select and scatter",
             "exact route", "prunes")


def stamped_p1_source() -> str:
    """encode_stats.cu with each thread's cycles between phase boundaries
    summed (`P1_PHASES`, the prunes apart from the appends) and its warp's
    prune events counted; thread 0 stores its CTA's into g_cta[blockIdx.x *
    8 + i], the prune events at i = 6 (a device pointer, null for no
    stamps)."""
    src = (_build.CSRC / "encode_stats.cu").read_text()
    for text in (_P1_START, _P1_PRUNE, _P1_PRUNED) + tuple(t for t, _, _ in _P1_STAMPS):
        if src.count(text) != 1:
            raise ValueError(f"encode_stats.cu: the probe's marker {text!r} is not there once")

    def stamp(i: int) -> str:
        return f"  {{ const long long now = clock64(); probe_sum[{i}] += now - probe_t; probe_t = now; }}\n"

    src = src.replace(_P1_START, "  long long probe_t = clock64(), probe_sum[7] = {0, 0, 0, 0, 0, 0, 0};\n" + _P1_START)
    src = src.replace(_P1_PRUNE, _P1_PRUNE + "      ++probe_sum[6];\n" + stamp(2))
    src = src.replace(_P1_PRUNED, _P1_PRUNED + stamp(5))
    for text, i, _ in _P1_STAMPS:
        src = src.replace(text, stamp(i) + text)
    last = _P1_STAMPS[-1][0]
    return src.replace(last, "  if (threadIdx.x == 0 && g_cta)\n    for (int i = 0; i < 7; ++i) "
                       "g_cta[blockIdx.x * 8 + i] = probe_sum[i];\n" + last).replace(
        "namespace {\n", "__device__ long long* g_cta;\n\nnamespace {\n", 1)


def _p1_case(lib: ctypes.CDLL, inp: dict, what: str) -> str:
    from . import proto_encode_stats as pe

    x, wb, b_enc = inp["x"], inp["wb"], inp["b_enc"]
    b, d = x.shape
    s = wb.shape[1]
    xb = torch.empty((b, d), dtype=torch.bfloat16, device="cuda")
    h = torch.empty((b, s), device="cuda")
    kth, l0, l1 = (torch.empty((b, 1), device="cuda") for _ in range(3))
    f = torch.empty((b, s), dtype=torch.bfloat16, device="cuda")
    live = torch.zeros(s, dtype=torch.int32, device="cuda")
    exact = torch.zeros(1, dtype=torch.int32, device="cuda")
    cta = torch.zeros((b // P1_ROWS, 8), dtype=torch.int64, device="cuda")

    def call():
        live.zero_()
        code = lib.saev_encode_stats(x.data_ptr(), wb.data_ptr(), b_enc.data_ptr(), b, d, s, pe.K, xb.data_ptr(),
                                     h.data_ptr(), kth.data_ptr(), f.data_ptr(), live.data_ptr(), l0.data_ptr(),
                                     l1.data_ptr(), exact.data_ptr(), torch.cuda.current_stream().cuda_stream)
        _build.check(code, "select_probe P1")

    lib.saev_probe_cta(None)
    plain_ms = _events_ms(call)
    lib.saev_probe_cta(ctypes.c_void_p(cta.data_ptr()))
    exact.zero_()
    stamped_ms = _events_ms(call)
    n_exact = int(exact) // 11  # 1 + 10 launches
    lib.saev_probe_cta(None)
    fallback = torch.zeros(1, dtype=torch.int32, device="cuda")
    want_h, want = pe.encode_stats(x, wb, b_enc, pe.K, fallback)
    if not (torch.equal(h, want_h) and torch.equal(kth, want.kth) and torch.equal(f, want.f)
            and torch.equal(live != 0, want.live) and torch.equal(l1, want.l1)):
        raise AssertionError(f"select_probe: the stamped P1 differs from the library's on {what}")
    rows = kprof.device_profile(lambda: pe.encode_stats(x, wb, b_enc, pe.K), n=10, warmup=2,
                                expect=("encode_round_kernel", "encode_stats_wgmma_kernel"))
    dev = {name: sum(t for kname, t, _ in rows if name in kname) for name in ("encode_round_kernel",
                                                                               "encode_stats_wgmma_kernel")}
    c = cta.double().mean(0)
    total = float(c[:6].sum())
    return (f"P1 {b}x{d} -> {s} k {pe.K}, {what}: rows on the exact route {int(fallback)} (stamped run "
            f"{n_exact}); the probe's copy {plain_ms:.4f} ms, with stamps {stamped_ms:.4f} ms; library by the "
            f"profiler: " + ", ".join(f"{name} {ms:.4f} ms" for name, ms in dev.items())
            + "; mean cycles a CTA (thread 0): " + ", ".join(f"{name} {float(v):.0f} ({100 * float(v) / total:.1f}%)"
                                                            for name, v in zip(P1_PHASES, c[:6]))
            + f"; in all {total:.0f}; prune events of thread 0's warp {float(c[6]):.2f}")


def p1_phases(tmp: pathlib.Path) -> list[str]:
    from . import proto_encode_stats as pe

    d = tmp / "p1"
    d.mkdir()
    for f in ("hopper.cuh", "order_key.cuh", "prefix_walk.cuh", "topk_row.cuh"):
        shutil.copy(_build.CSRC / f, d / f)
    (d / "encode_stats.cu").write_text(stamped_p1_source() + (
        '\nextern "C" int saev_probe_cta(long long* cta) {\n'
        "  return cudaMemcpyToSymbol(g_cta, &cta, sizeof(cta));\n}\n"))
    lib, _ = _compile(d, d / "encode_stats.cu", "p1_probe")
    lib.saev_encode_stats.argtypes = _build.SIGNATURES["saev_encode_stats"]
    lib.saev_probe_cta.argtypes = [ctypes.c_void_p]
    inp = pe.inputs()
    lines = [_p1_case(lib, inp, "the bench's operands")]
    inp["b_enc"] = torch.linspace(-100.0, 100.0, pe.S, device="cuda")
    inp["x"][:8] = 0.0
    lines.append(_p1_case(lib, inp, "rows ascending in column order"))
    return lines


def k6_caps(tmp: pathlib.Path) -> list[str]:
    h = torch.randn((B, S), generator=torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    want = topk._kth_plain(h, K)
    lines = []
    for min_blocks in (2, 3):
        d = tmp / f"k6_{min_blocks}"
        d.mkdir()
        for f in ("topk_row.cuh", "hopper.cuh", "order_key.cuh", "row_stream.cuh"):
            shutil.copy(_build.CSRC / f, d / f)
        (d / "kth.cu").write_text(k6_capped_source(min_blocks))
        lib, log = _compile(d, d / "kth.cu", f"k6_{min_blocks}")
        lib.saev_kth.argtypes = _build.SIGNATURES["saev_kth"]
        out = torch.empty((B, 1), device="cuda")

        def call(lib=lib, out=out):
            code = lib.saev_kth(h.data_ptr(), B, S, K, out.data_ptr(), None, torch.cuda.current_stream().cuda_stream)
            _build.check(code, "select_probe K6")

        ms = _events_ms(call, 20)
        if not torch.equal(out, want):
            raise AssertionError(f"select_probe: K6 with {min_blocks} CTAs an SM differs from the plain version")
        res = _build.ptxas_resources(log, "kth_stream_kernelILi64ELi256E")
        lines.append(f"K6 {B}x{S} k {K}, streamed kernel asking for {min_blocks} CTAs an SM "
                     f"{list(res.values())}: {ms:.4f} ms (bitwise equal)")
    return lines


def k5_phases(tmp: pathlib.Path) -> list[str]:
    d = tmp / "k5"
    d.mkdir()
    shutil.copy(_build.CSRC / "order_key.cuh", d / "order_key.cuh")
    src = stamped_k5_source() + ('\nextern "C" int saev_probe_stamps(long long* cta, long long* row) {\n'
                                 "  cudaError_t e = cudaMemcpyToSymbol(g_cta, &cta, sizeof(cta));\n"
                                 "  return e != cudaSuccess ? e : cudaMemcpyToSymbol(g_row, &row, sizeof(row));\n}\n")
    (d / "kth_masked.cu").write_text(src)
    lib, _ = _compile(d, d / "kth_masked.cu", "k5_probe")
    lib.saev_kth_masked.argtypes = _build.SIGNATURES["saev_kth_masked"]
    lib.saev_probe_stamps.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lines = []
    for s, n, pinned in [(s, n, True) for s, n in K5_SHAPES] + [(K5_SHAPES[0][0], K5_SHAPES[0][1], False)]:
        h = torch.randn((B, s), generator=torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
        if pinned:
            h[:, :n] = h[:, :n] * 4.0 - 1e6
        mask = torch.arange(s, device="cuda") < n
        out = torch.empty((B, 1), device="cuda")
        cta = torch.zeros((B, 2), dtype=torch.int64, device="cuda")
        row = torch.zeros((B, 3), dtype=torch.int64, device="cuda")

        def call():
            code = lib.saev_kth_masked(h.data_ptr(), mask.data_ptr(), B, s, K_AUX, out.data_ptr(),
                                       torch.cuda.current_stream().cuda_stream)
            _build.check(code, "select_probe K5")

        lib.saev_probe_stamps(None, None)
        plain_ms = _events_ms(call, 20)
        lib.saev_probe_stamps(ctypes.c_void_p(cta.data_ptr()), ctypes.c_void_p(row.data_ptr()))
        stamped_ms = _events_ms(call, 20)
        lib.saev_probe_stamps(None, None)
        want = topk._kth_masked_plain(h, mask, K_AUX)
        if not torch.equal((out + 0.0).view(torch.int32), (want + 0.0).view(torch.int32)):
            raise AssertionError(f"select_probe: the stamped K5 differs at {B}x{s}")
        rows = kprof.device_profile(lambda: cuda_kth.kth_value_masked_cuda(h, mask, K_AUX), n=10, warmup=2,
                                    expect=("kth_masked_kernel",))
        dev_ms = sum(t for name, t, _ in rows if "kth_masked_kernel" in name)
        c, r = cta[cta[:, 1] > 0].double(), row.double()  # the CTAs that ran
        cycles = [float((c[:, 1] - c[:, 0]).mean()), float((r[:, 1] - r[:, 0]).mean()),
                  float((r[:, 2] - r[:, 1]).mean())]
        kind = "pinned near -1e6" if pinned else "Gaussian"
        lines.append(f"K5 {B}x{s}, {n} unmasked ({kind}), k {K_AUX}: probe's copy {plain_ms:.4f} ms, with stamps "
                     f"{stamped_ms:.4f} ms, library by the profiler {dev_ms:.4f} ms; mean cycles: "
                     + ", ".join(f"{name} {v:.0f}" for name, v in zip(K5_PHASES, cycles))
                     + f"; {len(c)} CTAs")
    return lines


def k1_wide_phases(tmp: pathlib.Path) -> list[str]:
    d = tmp / "wide"
    d.mkdir()
    for f in ("hopper.cuh", "order_key.cuh", "row_stream.cuh", "topk_row.cuh"):
        shutil.copy(_build.CSRC / f, d / f)
    (d / "kth_wide.cu").write_text(stamped_wide_source() + (
        '\nextern "C" int saev_probe_stamps(long long* p) {\n'
        "  return cudaMemcpyToSymbol(g_wide, &p, sizeof(p));\n}\n"))
    lib, _ = _compile(d, d / "kth_wide.cu", "wide_probe")
    lib.saev_topk_stats_wide.argtypes = _build.SIGNATURES["saev_topk_stats_wide"]
    lib.saev_probe_stamps.argtypes = [ctypes.c_void_p]
    lines = []
    for s in WIDE_S:
        h = torch.randn((B, s), generator=torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
        kth = torch.empty((B, 1), device="cuda")
        f = torch.empty((B, s), dtype=torch.bfloat16, device="cuda")
        live = torch.zeros(s, dtype=torch.int32, device="cuda")
        l0, l1 = torch.empty((B, 1), device="cuda"), torch.empty((B, 1), device="cuda")
        stamps = torch.zeros((2, _WIDE_ROWS, 10), dtype=torch.int64, device="cuda")

        def call():
            code = lib.saev_topk_stats_wide(h.data_ptr(), B, s, K, kth.data_ptr(), f.data_ptr(), live.data_ptr(),
                                            l0.data_ptr(), l1.data_ptr(), None,
                                            torch.cuda.current_stream().cuda_stream)
            _build.check(code, "select_probe K1 wide")

        lib.saev_probe_stamps(None)
        plain_ms = _events_ms(call)
        library_ms = _events_ms(lambda: cuda_topk.topk_stats_cuda(h, K))
        lib.saev_probe_stamps(ctypes.c_void_p(stamps.data_ptr()))
        call()
        torch.cuda.synchronize()
        lib.saev_probe_stamps(None)
        if not torch.equal(kth, topk._kth_plain(h, K)):
            raise AssertionError(f"select_probe: the stamped K1 differs from the plain version at {B}x{s}")
        st = stamps.double()[:, 4:60]
        cycles = (st[..., 1:] - st[..., :-1]).mean((0, 1)).tolist()
        period = float((st[:, 1:, 0] - st[:, :-1, 0]).mean())
        lines.append(f"K1 cluster route {B}x{s} k {K}: library {library_ms:.3f} ms, the probe's copy "
                     f"{plain_ms:.3f} ms; mean cycles a row (CTAs 0 and 1, rows 4-59): "
                     + ", ".join(f"{name} {c:.0f}" for name, c in zip(WIDE_PHASES, cycles))
                     + f"; the row's period {period:.0f}")
    return lines


def k1_wide_variants(tmp: pathlib.Path) -> list[str]:
    libs, lines = {}, []
    for i, name in enumerate(WIDE_VARIANTS):
        d = tmp / f"wide_variant_{i}"
        d.mkdir()
        for f in ("hopper.cuh", "order_key.cuh", "row_stream.cuh", "topk_row.cuh"):
            shutil.copy(_build.CSRC / f, d / f)
        (d / "kth_wide.cu").write_text(wide_variant_source(name))
        lib, log = _compile(d, d / "kth_wide.cu", f"wide_variant_{i}")
        lib.saev_topk_stats_wide.argtypes = _build.SIGNATURES["saev_topk_stats_wide"]
        libs[name] = lib
        res = _build.ptxas_resources(log, "wide_cluster_kernelILb1ELb0E")
        lines.append(f"K1 cluster route, {name}: {list(res.values())}")
    for s in WIDE_S:
        h = torch.randn((B, s), generator=torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
        want = topk._kth_plain(h, K)
        kth = torch.empty((B, 1), device="cuda")
        f = torch.empty((B, s), dtype=torch.bfloat16, device="cuda")
        live = torch.zeros(s, dtype=torch.int32, device="cuda")
        l0, l1 = torch.empty((B, 1), device="cuda"), torch.empty((B, 1), device="cuda")
        times = []
        for name, lib in libs.items():

            def call(lib=lib):
                code = lib.saev_topk_stats_wide(h.data_ptr(), B, s, K, kth.data_ptr(), f.data_ptr(),
                                                live.data_ptr(), l0.data_ptr(), l1.data_ptr(), None,
                                                torch.cuda.current_stream().cuda_stream)
                _build.check(code, "select_probe K1 wide variant")

            ms = _events_ms(call)
            if not torch.equal(kth, want):
                raise AssertionError(f"select_probe: K1's cluster route, {name}, differs at {B}x{s}")
            times.append(f"{name} {ms:.4f} ms")
        lines.append(f"K1 cluster route {B}x{s} k {K}: " + "; ".join(times) + " (kth bitwise equal)")
    return lines


def k5_caps(tmp: pathlib.Path) -> list[str]:
    lines, libs = [], {}
    for min_blocks in (1, 2, 3):
        src = tmp / f"k5_{min_blocks}.cu"
        src.write_text(k5_capped_source(min_blocks))
        shutil.copy(_build.CSRC / "order_key.cuh", tmp / "order_key.cuh")
        lib, log = _compile(tmp, src, f"k5_{min_blocks}")
        lib.saev_kth_masked.argtypes = _build.SIGNATURES["saev_kth_masked"]
        libs[min_blocks] = lib
        res = _build.ptxas_resources(log, "kth_masked_kernelILi32E")
        lines.append(f"K5 at least {min_blocks} CTAs an SM: KPL 32 kernel {list(res.values())}")
    for s, n in K5_SHAPES:
        h = torch.randn((B, s), generator=torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
        h[:, :n] = h[:, :n] * 4.0 - 1e6
        mask = torch.arange(s, device="cuda") < n
        want = topk._kth_masked_plain(h, mask, K_AUX)
        times = []
        for min_blocks, lib in libs.items():
            out = torch.empty((B, 1), device="cuda")

            def call(lib=lib, out=out):
                code = lib.saev_kth_masked(h.data_ptr(), mask.data_ptr(), B, s, K_AUX, out.data_ptr(),
                                           torch.cuda.current_stream().cuda_stream)
                _build.check(code, "select_probe K5")

            ms = _events_ms(call, 20)
            if not torch.equal((out + 0.0).view(torch.int32), (want + 0.0).view(torch.int32)):
                raise AssertionError(f"select_probe: K5 with {min_blocks} CTAs an SM differs at {B}x{s}")
            times.append(f"{min_blocks} CTAs {ms:.4f} ms")
        lines.append(f"K5 {B}x{s}, {n} unmasked, k {K_AUX}: " + "; ".join(times) + " (bitwise equal)")
    return lines


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("select_probe needs a CUDA device")
    print(kprof.card())
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        for probe in (k1_phases, k6_phases, k6_caps, k5_phases, k5_caps, k1_wide_phases, k1_wide_variants,
                      p1_phases):
            for line in probe(pathlib.Path(tmp)):
                print(line, flush=True)


if __name__ == "__main__":
    main()
