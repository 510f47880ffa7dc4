"""Build the hand-written CUDA kernels in `saev_tpu_torch/csrc` and load them.

The sources are compiled with `nvcc` into one shared library with a plain C
interface and loaded with `ctypes` (no PyTorch headers, so a build takes
seconds). The library lands in `BUILD_DIR` under a name that carries the hash
of the sources, so an edited source rebuilds on first use and an unchanged one
loads the existing library. Nothing here runs at import time.

Every C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `check` turns a non-zero code into an exception.
"""

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int

# Entry point -> argument types (pointers and the stream as void*, ints as int).
SIGNATURES = {
    "saev_topk_stats": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "saev_prefix_err": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "saev_dgrad": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "saev_wgrad": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
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


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME:
        cand = pathlib.Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> pathlib.Path:
    return BUILD_DIR / f"libsaev_kernels_{_digest()}.so"


def build(verbose: bool = False) -> pathlib.Path:
    """Compile the kernels unless a library for these sources exists; returns
    its path. The build writes to a temporary file and renames it, so a cut
    build leaves nothing half-written behind."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(p) for p in _sources() if p.suffix == ".cu"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, *cu]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}"
        )
    if verbose:
        print(proc.stderr, end="")
    os.replace(tmp, out)
    return out


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
