"""P4's and P3's pass kernels (csrc/kth_ops.cu) in one tree of this
repository, to set two trees side by side on one card, and a sweep of the
kernels' independent accumulators.

    python saev_tpu_torch/scripts/pass_probe.py [ROOT] [--sass FILE] [--sweep]

Imports `saev_tpu_torch` from ROOT (default: the checkout that holds this
file), builds its kernels and prints:
- the card's name and power limit;
- registers, stack frame and spills of every instantiation of P4's and P3's
  kernels, and of K6's, from ptxas's report of the build;
- at 16384 x 16384 (the scripts' `inputs`: Gaussian rows for P4 and K6, keys
  drawn from [1, 2^31) for P3), k 32: CUDA-event ms a launch over 10
  launches, and device ms by `kprof.device_profile`, of K6, of P4 in each
  mode, of `torch.topk`, and of P3 at 32, 16 and 8 passes.
With --sass FILE it writes the SASS of P4's and P3's kernels to FILE; read
it with `python -m saev_tpu_torch.scripts.proto_kth_ops --sass FILE`.
With --sweep (this checkout's sources) it builds copies of kth_ops.cu alone
with one constant changed each (kAcc 1, 4, 8; kLoopAcc 2, 4, 16; kMxuAcc
2, 4; kMinBlocks 2) and one with the count written in C (`c += a >= b` in place of add_ge's
compare and predicated add), prints each copy's ptxas resources and
pass-loop SASS report at VPT 64 and 256 threads, and times P4's modes and
P3's pass counts by CUDA events, each held bit for bit to its plain
version.
Run it once with each tree's root in one call, in the order parent, change,
change, parent.
"""

import ctypes
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

N_EVENTS = 10
# The sweep's copies: kth_ops.cu's constants, and whether add_ge's compare
# and predicated add become the C expression `c += a >= b`.
SWEEP = (
    ({"kAcc": 1}, False), ({"kAcc": 4}, False), ({"kAcc": 8}, False), ({"kLoopAcc": 2}, False),
    ({"kLoopAcc": 4}, False), ({"kLoopAcc": 16}, False), ({"kMxuAcc": 2}, False), ({"kMxuAcc": 4}, False),
    ({"kMinBlocks": 2}, False), ({}, True),
)
_ADD_GE_ASM = re.compile(r'asm\("\{\\n \.reg \.pred p;\\n setp\.ge\.[us]32 p, %1, %2;\\n @p add\.[a-z0-9]+ %0, %0, '
                         r'[0-9a-fA-F]+;\\n\}" : "\+[rf]"\(c\) : "r"\(a\), "r"\(b\)\);')


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


def _resources(log: str) -> list[str]:
    from saev_tpu_torch.ops import _build

    lines = []
    for fragment in ("kth_ops", "count_loop", "kth_stream_kernel"):
        for name, r in sorted(_build.ptxas_resources(log, fragment).items()):
            m = re.search(r"((?:kth_ops|count_loop|kth)_(?:stream_)?kernelI(?:Li[0-9]+E)+E)", name)
            lines.append(f"ptxas {m[1] if m else name}: {r.get('registers')} registers, stack frame "
                         f"{r.get('stack_frame')}, spill stores {r.get('spill_stores')}, spill loads "
                         f"{r.get('spill_loads')}")
    return lines


def _pass_sass(sass: str) -> str:
    """The functions of `cuobjdump --dump-sass` output that are P4's or P3's
    kernels."""
    keep, out = False, []
    for line in sass.splitlines():
        if "Function :" in line:
            keep = "kth_ops_" in line or "count_loop_" in line
        if keep:
            out.append(line)
    return "\n".join(out) + "\n"


def timings() -> list[str]:
    import torch

    from saev_tpu_torch.ops import cuda_kth
    from saev_tpu_torch.scripts import kprof, microbench_kth, proto_kth_ops

    k = proto_kth_ops.K
    h = proto_kth_ops.inputs()["h"]
    cases = {f"K6 kth_value, k {k}": lambda: cuda_kth.kth_value_cuda(h, k)}
    for mode in proto_kth_ops.MODES:
        cases[f"P4 kth_ops {mode}, k {k}"] = lambda mode=mode: proto_kth_ops.kth_ops(h, k, mode)
    cases[f"torch.topk, k {k}"] = lambda: torch.topk(h, k, dim=1).values[:, -1:]
    key = microbench_kth.inputs()["key"]
    for n in (32, 16, 8):
        cases[f"P3 count_loop, {n} passes"] = lambda n=n: microbench_kth.count_loop(key, n)
    lines = []
    for name, fn in cases.items():
        ms = _events_ms(fn)
        dev = kprof.total_device_ms(kprof.device_profile(fn, n=N_EVENTS, warmup=1))
        lines.append(f"{name:28s} {ms:.4f} ms a launch (CUDA events), {dev:.4f} ms device (profiler)")
    return lines


def sweep() -> list[str]:
    """Copies of this checkout's kth_ops.cu (`SWEEP`), each built alone,
    reported and timed; a copy that differs from the plain version
    raises."""
    import torch

    from saev_tpu_torch.ops import _build
    from saev_tpu_torch.scripts import microbench_kth, proto_kth_ops

    src = (_build.CSRC / "kth_ops.cu").read_text()
    k = proto_kth_ops.K
    h = proto_kth_ops.inputs()["h"]
    key = microbench_kth.inputs()["key"]
    want = {mode: proto_kth_ops.kth_ops_plain(h, k, mode) for mode in proto_kth_ops.MODES}
    want_p3 = {n: microbench_kth.count_loop_plain(key, n) for n in (32, 16, 8)}
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        builds = []
        for i, (consts, c_form) in enumerate(SWEEP):
            d = pathlib.Path(tmp) / f"copy{i}"
            d.mkdir()
            for f in ("order_key.cuh", "row_stream.cuh", "hopper.cuh", "tile_mma.cuh"):
                shutil.copy(_build.CSRC / f, d / f)
            copy = src
            for name, n in consts.items():
                copy, found = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {n};", copy)
                if found != 1:
                    raise ValueError(f"kth_ops.cu: {name} is not there once")
            if c_form:
                copy, found = _ADD_GE_ASM.subn("c += a >= b;", copy)
                if found != 4:
                    raise ValueError(f"kth_ops.cu: {found} of add_ge's 4 bodies found")
            (d / "kth_ops.cu").write_text(copy)
            out = d / "kth_ops.so"
            cmd = [_build.cuda_tool("nvcc"), *_build.NVCC_FLAGS, "-shared", "-o", str(out), str(d / "kth_ops.cu")]
            tag = "sweep " + ", ".join([f"{k} {v}" for k, v in consts.items()] + ["count in C"] * c_form)
            builds.append((tag, out, subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True)))
        for tag, out, proc in builds:
            log = proc.communicate()[1]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {tag}:\n{log}")
            lib = ctypes.CDLL(str(out))
            for name in ("saev_kth_ops", "saev_count_loop"):
                getattr(lib, name).argtypes = _build.SIGNATURES[name]
            lines += [f"{tag}: {line}" for line in _resources(log) if "Li64ELi256E" in line]
            sass = subprocess.run([_build.cuda_tool("cuobjdump"), "--dump-sass", str(out)], capture_output=True,
                                  text=True, check=True, timeout=300).stdout
            lines += [f"{tag}: {line}" for line in proto_kth_ops.sass_report(proto_kth_ops.parse_sass(sass))[1:]]
            stream = torch.cuda.current_stream().cuda_stream
            for mode in proto_kth_ops.MODES:
                got = torch.empty((h.shape[0], 1), device="cuda")
                fn = lambda mode=mode, got=got: _build.check(  # noqa: E731
                    lib.saev_kth_ops(h.data_ptr(), h.shape[0], h.shape[1], k, proto_kth_ops.MODES.index(mode),
                                     got.data_ptr(), stream), "sweep kth_ops")
                ms = _events_ms(fn)
                if not torch.equal(got.view(torch.int32), want[mode].view(torch.int32)):
                    raise AssertionError(f"{tag}: P4 {mode} differs from its plain version")
                lines.append(f"{tag}: P4 {mode} {ms:.4f} ms a launch, bitwise equal to its plain version")
            for n, w in want_p3.items():
                got = torch.empty((key.shape[0], 1), dtype=torch.int32, device="cuda")
                fn = lambda n=n, got=got: _build.check(  # noqa: E731
                    lib.saev_count_loop(key.data_ptr(), key.shape[0], key.shape[1], n, got.data_ptr(), stream),
                    "sweep count_loop")
                ms = _events_ms(fn)
                if not torch.equal(got, w):
                    raise AssertionError(f"{tag}: P3 at {n} passes differs from its plain version")
                lines.append(f"{tag}: P3 {n} passes {ms:.4f} ms a launch, equal to its plain version")
    return lines


def main(argv: list[str]) -> None:
    args = list(argv)
    sass_file = None
    if "--sass" in args:
        i = args.index("--sass")
        sass_file = pathlib.Path(args[i + 1])
        del args[i:i + 2]
    do_sweep = "--sweep" in args
    args = [a for a in args if a != "--sweep"]
    root = pathlib.Path(args[0] if args else pathlib.Path(__file__).resolve().parents[2]).resolve()
    sys.path.insert(0, str(root))

    import saev_tpu_torch
    from saev_tpu_torch.ops import _build
    from saev_tpu_torch.scripts import kprof

    where = pathlib.Path(saev_tpu_torch.__file__).resolve()
    if root not in where.parents:
        raise SystemExit(f"saev_tpu_torch came from {where}, not from {root}")
    print(f"pass_probe of {root}: {kprof.card()}", flush=True)
    _build.lib()
    print("\n".join(_resources(_build.ptxas_log().read_text())), flush=True)
    if sass_file is not None:
        sass_file.parent.mkdir(parents=True, exist_ok=True)
        sass_file.write_text(_pass_sass(_build.dump_sass()))
        print(f"SASS of P4's and P3's kernels written to {sass_file}", flush=True)
    print("\n".join(timings()), flush=True)
    if do_sweep:
        print("\n".join(sweep()), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
