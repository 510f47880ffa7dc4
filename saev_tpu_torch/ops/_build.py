"""Build the hand-written CUDA kernels in `saev_tpu_torch/csrc` and load them.

Each `.cu` source is compiled by its own `nvcc`, all started together, and the
objects are linked into one shared library with a plain C interface, loaded
with `ctypes` (no PyTorch headers, so a build takes seconds). The library
lands in `BUILD_DIR` under a name that carries the hash of the sources, so an
edited source rebuilds on first use and an unchanged one loads the existing
library. Nothing here runs at import time.

Every C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `check` turns a non-zero code into an exception.

ptxas reports each kernel's registers and spills (`-Xptxas -v`); the build
keeps that report beside the library (`ptxas_log`, read by
`ptxas_resources`).
"""

import collections
import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
import threading

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int

# Entry point -> argument types (pointers and the stream as void*, ints as int).
SIGNATURES = {
    "saev_topk_stats": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    "saev_kth": [_P, _I, _I, _I, _P, _P, _P],
    "saev_kth_masked": [_P, _P, _I, _I, _I, _P, _P],
    "saev_topk_stats_wide": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    "saev_topk_stats_given": [_P, _I, _I, _P, _P, _P, _P, _P, _P],
    "saev_topk_stats_given_wide": [_P, _I, _I, _P, _P, _P, _P, _P, _P],
    "saev_kth_candidates": [_P, _P, _I, _I, _I, _P, _P, _P],
    "saev_kth_wide": [_P, _I, _I, _I, _P, _P, _P],
    "saev_kth_masked_wide": [_P, _P, _I, _I, _I, _P, _P, _P, _P],
    "saev_wide_cluster_ctas": [_I],
    "saev_wide_clusters": [_I],
    "saev_prefix_err": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "saev_dgrad": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "saev_wgrad": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    "saev_prefix_base": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "saev_prefix_occupancy": [_I],
    "saev_prefix_err_gouter": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "saev_encode_stats": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "saev_count_loop": [_P, _I, _I, _I, _P, _P],
    "saev_kth_ops": [_P, _I, _I, _I, _I, _P, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources() -> list[pathlib.Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _digest() -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def cuda_tool(name: str) -> str:
    """The path of a CUDA toolkit program (nvcc, cuobjdump): on PATH, else in
    the toolkit PyTorch finds."""
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which(name)
    if found:
        return found
    if CUDA_HOME:
        cand = pathlib.Path(CUDA_HOME) / "bin" / name
        if cand.exists():
            return str(cand)
    raise RuntimeError(f"{name} not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> pathlib.Path:
    return BUILD_DIR / f"libsaev_kernels_{_digest()}.so"


def _run_all(cmds: list[list[str]], verbose: bool) -> list[str]:
    """Start the commands together, wait for every one, then raise on the
    first that failed; returns each one's standard error."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    errs = [p.communicate()[1] for p in procs]
    for cmd, proc, err in zip(cmds, procs, errs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{err}")
        if verbose:
            print(err, end="")
    return errs


def build(verbose: bool = False) -> pathlib.Path:
    """Compile the kernels unless a library for these sources exists; returns
    its path. The build writes into a temporary directory and renames the
    library into place, so a cut build leaves nothing half-written behind."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_tool("nvcc")
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cu = [p for p in _sources() if p.suffix == ".cu"]
        objs = [os.path.join(tmp, p.stem + ".o") for p in cu]
        errs = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(p)] for p, o in zip(cu, objs)],
                        verbose)
        ptxas_log().write_text("".join(errs))
        lib_tmp = os.path.join(tmp, out.name)
        _run_all([[nvcc, "-shared", "-o", lib_tmp, *objs]], verbose)
        os.replace(lib_tmp, out)
    return out


def ptxas_log():
    """The ptxas report of the library's build, written beside it."""
    return library_path().with_suffix(".ptxas.txt")


_PTXAS_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PTXAS_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def ptxas_resources(log: str, fragment: str) -> dict[str, dict[str, int]]:
    """Mangled name -> registers, stack frame and spill bytes, from a
    `-Xptxas -v` report, of each kernel whose name contains `fragment`."""
    found: dict[str, dict[str, int]] = {}
    current = None
    for line in log.splitlines():
        if m := _PTXAS_ENTRY.search(line):
            current = found.setdefault(m[1], {}) if fragment in m[1] else None
        elif current is None:
            continue
        elif m := _PTXAS_SPILL.search(line):
            current.update(stack_frame=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
        elif m := _PTXAS_REGS.search(line):
            current["registers"] = int(m[1])
    return found


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            loaded = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(loaded, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = loaded
        return _lib


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def stream_ptr(t) -> int:
    """The raw handle of the current stream on `t`'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


# A SASS instruction line: its address, an optional predicate, then the
# opcode's base (the part before the first dot) and its modifiers.
SASS_OP = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_]*)((?:\.[A-Za-z0-9_]+)*)")


def dump_sass() -> str:
    """`cuobjdump --dump-sass` of the built library."""
    return subprocess.run(
        [cuda_tool("cuobjdump"), "--dump-sass", str(build())],
        capture_output=True, text=True, check=True, timeout=300,
    ).stdout


def function_forms(sass: str, fragment: str) -> dict[str, collections.Counter]:
    """Mangled name -> counts (static, as written) of each full instruction
    form, the opcode with its modifiers (as `UTMALDG.2D.MULTICAST`), of each
    function in `cuobjdump --dump-sass` output whose name contains
    `fragment`."""
    funcs: dict[str, collections.Counter] = {}
    counts = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts = funcs.setdefault(name, collections.Counter()) if fragment in name else None
        elif counts is not None and (m := SASS_OP.search(line)):
            counts[m[2] + m[3]] += 1
    return funcs


def function_opcodes(sass: str, fragment: str) -> dict[str, collections.Counter]:
    """`function_forms` with the forms cut at their first dot: the counts of
    each opcode."""
    funcs = {}
    for name, forms in function_forms(sass, fragment).items():
        funcs[name] = collections.Counter()
        for form, n in forms.items():
            funcs[name][form.split(".", 1)[0]] += n
    return funcs
