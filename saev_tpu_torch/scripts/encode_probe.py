"""P1 (csrc/encode_stats.cu) and the two calls it fuses, in one tree of this
repository, to set two trees side by side on one card.

    python saev_tpu_torch/scripts/encode_probe.py [ROOT] [--phases] [--variants]

Imports `saev_tpu_torch` from ROOT (default: the checkout that holds this
file), builds its kernels and prints:
- the card's name and power limit;
- registers, stack frame and spills of P1's kernels from ptxas's report of
  the build, and the HGMMA, UTMALDG and HMMA counts of their SASS;
- at 16384 x 1024 -> 16384, k 32 (`proto_encode_stats.inputs`, W in bf16):
  CUDA-event ms a call over 10 calls, and device ms by
  `kprof.device_profile` with each kernel by name, of P1, of the bf16
  encoder (`modeling._linear_bias(x, W, b_enc, "default")`), of K1 on the
  encoder's h, and the two calls' sum: the yardstick P1 is held to.
With --phases (this checkout's sources) it also prints
`select_probe.p1_phases`: P1's time split from clock64 stamps and its rows
on the exact route. With --variants (this checkout's sources) it builds
copies of encode_stats.cu alone, each with one part taken out or changed
(`VARIANTS`; outputs no longer P1's where a part is taken out), and times
each by CUDA events beside the copy as committed: what each part of P1
costs at the bench shape.
Run it once with each tree's root in one call, in the order parent, change,
change, parent.
"""

import ctypes
import pathlib
import subprocess
import sys
import tempfile

N_EVENTS = 10
ENCODER, K1 = "bf16 encoder", "K1 on the encoder's h"
_H_STORE = "          __stcs(reinterpret_cast<float2*>(h + (long)(b0 + row_l + 8 * hh) * S + col), make_float2(o0, o1));\n"
_F_STORE = ("        __stcs(reinterpret_cast<uint4*>(f + (long)(b0 + (u >> 4)) * S + n0 + (u & 15) * 8), "
            "make_uint4(0u, 0u, 0u, 0u));\n")
_WALK_END = "    if (lane == 0) mbar_arrive(smem_u32(&empty[(j * n_k + n_k - 1) % STAGES]));\n"
# Name -> (text, replacement) pairs applied to encode_stats.cu, each text
# found once.
VARIANTS = {
    "as committed": (),
    "K walk only (no epilogue, select or stores)": ((_WALK_END, _WALK_END + "    if (k > 0) continue;\n"),),
    "no stores of h or f": ((_H_STORE, ""), (_F_STORE, "")),
    "no prunes or appends": (("    if (__any_sync(FULL, over)) {\n", "    if (__any_sync(FULL, over && k < 0)) {\n"),
                             ("    if (!__any_sync(FULL, total[0] + total[1] > 0)) continue;\n",
                              "    if (!__any_sync(FULL, total[0] + total[1] > 0x7fffffff)) continue;\n")),
    "x rows 0-63 in every CTA": (("  tma_load_2d(a_dst, map_x, bar, k0, b0);", "  tma_load_2d(a_dst, map_x, bar, k0, 0);"),),
    "plain stores (not streaming)": (
        (_H_STORE, _H_STORE.replace("__stcs(", "*").replace(", make_float2(o0, o1));", " = make_float2(o0, o1);")),
        (_F_STORE, _F_STORE.replace("__stcs(", "*").replace(", make_uint4(0u, 0u, 0u, 0u));",
                                                            " = make_uint4(0u, 0u, 0u, 0u);"))),
    "wgmma wait_all a step": (("      wgmma_wait_one();\n", "      wgmma_wait_all();\n"),),
    # Two CTAs a row block, each walking half of the bench shape's 128
    # column tiles (each selects on its half alone: the statistics are not
    # P1's): what x's rows cost when half as many are resident at a time.
    "two CTAs a row block, half the columns each": (
        ("  const int b0 = blockIdx.x * kRows;", "  const int b0 = (blockIdx.x >> 1) * kRows;"),
        ("n_tiles = S / TILE, n_steps", "n_tiles = S / TILE / 2, n_steps"),
        ("    const int n0 = j * TILE;", "    const int n0 = (j + (blockIdx.x & 1) * n_tiles) * TILE;"),
        ("n0 = (g / n_k) * TILE;", "n0 = ((g / n_k) + (blockIdx.x & 1) * 64) * TILE;"),
        ("<<<B / kRows", "<<<2 * B / kRows")),
}


def _events_ms(fn, n: int = N_EVENTS) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def resources() -> list[str]:
    from saev_tpu_torch.ops import _build

    lines = []
    for name, r in sorted(_build.ptxas_resources(_build.ptxas_log().read_text(), "encode_").items()):
        lines.append(f"ptxas {name}: {r.get('registers')} registers, stack frame {r.get('stack_frame')}, "
                     f"spill stores {r.get('spill_stores')}, spill loads {r.get('spill_loads')}")
    for name, ops in sorted(_build.function_opcodes(_build.dump_sass(), "encode_").items()):
        lines.append(f"SASS {name}: {sum(ops.values())} instructions, HGMMA {ops['HGMMA']}, UTMALDG "
                     f"{ops['UTMALDG']}, HMMA {ops['HMMA']}")
    return lines


def timings() -> list[str]:
    import torch

    from saev_tpu_torch.nn import modeling
    from saev_tpu_torch.ops import cuda_topk
    from saev_tpu_torch.scripts import kprof, proto_encode_stats as pe

    inp = pe.inputs()
    x, wb, b_enc = inp["x"], inp["wb"], inp["b_enc"]
    h = modeling._linear_bias(x, wb, b_enc, "default")
    cases = {
        "P1 encode_stats": lambda: pe.encode_stats(x, wb, b_enc, pe.K),
        ENCODER: lambda: modeling._linear_bias(x, wb, b_enc, "default"),
        K1: lambda: cuda_topk.topk_stats_cuda(h, pe.K),
    }
    lines, ms = [], {}
    with torch.no_grad():
        for name, fn in cases.items():
            ms[name] = _events_ms(fn)
            rows = kprof.device_profile(fn, n=N_EVENTS, warmup=1)
            lines.append(f"{name:22s} {ms[name]:.4f} ms a call (CUDA events), {kprof.total_device_ms(rows):.4f} ms "
                         "device (profiler): " + "; ".join(f"{k[:70]} {t:.4f} x{c}" for k, t, c in rows))
    lines.append(f"two calls (bf16 encoder + K1) {ms[ENCODER] + ms[K1]:.4f} ms a call (CUDA events); P1 "
                 f"{ms['P1 encode_stats']:.4f}")
    return lines


def variants() -> list[str]:
    """`VARIANTS` of this checkout's encode_stats.cu, each built alone and
    timed by CUDA events on the bench's operands."""
    import torch

    from saev_tpu_torch.ops import _build
    from saev_tpu_torch.scripts import proto_encode_stats as pe

    src = (_build.CSRC / "encode_stats.cu").read_text()
    inp = pe.inputs()
    x, wb, b_enc = inp["x"], inp["wb"], inp["b_enc"]
    b, d = x.shape
    s = wb.shape[1]
    xb = torch.empty((b, d), dtype=torch.bfloat16, device="cuda")
    h = torch.empty((b, s), device="cuda")
    kth, l0, l1 = (torch.empty((b, 1), device="cuda") for _ in range(3))
    f = torch.empty((b, s), dtype=torch.bfloat16, device="cuda")
    live = torch.zeros(s, dtype=torch.int32, device="cuda")
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        builds = []
        for i, (name, subs) in enumerate(VARIANTS.items()):
            copy = src
            for text, new in subs:
                if copy.count(text) != 1:
                    raise ValueError(f"encode_stats.cu: the variant's text {text!r} is not there once")
                copy = copy.replace(text, new)
            dst = pathlib.Path(tmp) / f"v{i}"
            dst.mkdir()
            for hdr in ("hopper.cuh", "order_key.cuh", "prefix_walk.cuh", "topk_row.cuh"):
                (dst / hdr).write_text((_build.CSRC / hdr).read_text())
            (dst / "encode_stats.cu").write_text(copy)
            out = dst / "p1.so"
            cmd = [_build.cuda_tool("nvcc"), *_build.NVCC_FLAGS, "-shared", "-o", str(out), str(dst / "encode_stats.cu")]
            builds.append((name, out, subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True)))
        for name, out, proc in builds:
            log = proc.communicate()[1]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for the variant {name}:\n{log}")
            lib = ctypes.CDLL(str(out))
            lib.saev_encode_stats.argtypes = _build.SIGNATURES["saev_encode_stats"]

            def call(lib=lib):
                live.zero_()
                _build.check(lib.saev_encode_stats(x.data_ptr(), wb.data_ptr(), b_enc.data_ptr(), b, d, s, pe.K,
                                                   xb.data_ptr(), h.data_ptr(), kth.data_ptr(), f.data_ptr(),
                                                   live.data_ptr(), l0.data_ptr(), l1.data_ptr(), None,
                                                   torch.cuda.current_stream().cuda_stream), name)

            lines.append(f"variant {name:44s} {_events_ms(call):.4f} ms a call (CUDA events)")
    return lines


def main(argv: list[str]) -> None:
    args = [a for a in argv if a not in ("--phases", "--variants")]
    root = pathlib.Path(args[0] if args else pathlib.Path(__file__).resolve().parents[2]).resolve()
    sys.path.insert(0, str(root))

    import saev_tpu_torch
    from saev_tpu_torch.ops import _build
    from saev_tpu_torch.scripts import kprof

    where = pathlib.Path(saev_tpu_torch.__file__).resolve()
    if root not in where.parents:
        raise SystemExit(f"saev_tpu_torch came from {where}, not from {root}")
    print(f"encode_probe of {root}: {kprof.card()}", flush=True)
    _build.lib()
    print("\n".join(resources()), flush=True)
    print("\n".join(timings()), flush=True)
    if "--phases" in argv:
        from saev_tpu_torch.scripts import select_probe

        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
            print("\n".join(select_probe.p1_phases(pathlib.Path(tmp))), flush=True)
    if "--variants" in argv:
        print("\n".join(variants()), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
