"""Lazy-built native I/O helpers (C++ via ctypes; see shard_io.cpp, a copy of
saev_tpu/data/_native's).

The shared object builds once per source hash into `saev_tpu_torch/_build/`
with g++ at first use; every entry point degrades to the JAX package's own
host route (os.pread, no readahead hints) when the toolchain or platform is
unavailable, so the loaders never hard-depend on it. `route()` says which
route this process runs, "native" or "numpy", and the first load logs it.
"""

import ctypes
import hashlib
import logging
import os
import pathlib
import subprocess
import threading

import numpy as np

logger = logging.getLogger("data.native")

_SRC = pathlib.Path(__file__).parent / "shard_io.cpp"
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_TRIED = False


# The kernels' build directory (ops/_build.py), listed in .gitignore.
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "_build"


def _build_dir() -> pathlib.Path:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return BUILD_DIR


def _load() -> ctypes.CDLL | None:
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        try:
            src = _SRC.read_bytes()
            tag = hashlib.sha256(src).hexdigest()[:12]
            so_path = _build_dir() / f"shard_io_{tag}.so"
            if not so_path.exists():
                # Build beside the target and rename: two processes may race.
                tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(
                    [
                        "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                        str(_SRC), "-o", str(tmp),
                    ],
                    check=True, capture_output=True,
                )
                os.replace(tmp, so_path)
                logger.info("Built native shard_io -> %s", so_path)
            lib = ctypes.CDLL(str(so_path))
            lib.sx_open.restype = ctypes.c_int
            lib.sx_open.argtypes = [ctypes.c_char_p]
            lib.sx_close.restype = ctypes.c_int
            lib.sx_close.argtypes = [ctypes.c_int]
            for fn in (lib.sx_advise_sequential, lib.sx_prefetch):
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_int, ctypes.c_int64, ctypes.c_int64]
            lib.sx_read_block.restype = ctypes.c_int64
            lib.sx_read_block.argtypes = [
                ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ]
            _LIB = lib
            logger.info("Shard I/O route: native (%s).", so_path.name)
        except Exception as err:  # noqa: BLE001 - any failure means "no native"
            logger.info("Shard I/O route: numpy (native shard_io unavailable: %s).", err)
            _LIB = None
        return _LIB


def available() -> bool:
    return _load() is not None


def route() -> str:
    """The shard I/O route of this process: "native" (the g++ build) or
    "numpy" (os.pread, no readahead hints)."""
    return "native" if available() else "numpy"


class ShardFile:
    """A shard file handle with readahead hints and pread access.

    Falls back to pure-Python (os.pread, no hints) when the native library
    cannot build.
    """

    def __init__(self, path: os.PathLike | str):
        self.path = str(path)
        self._lib = _load()
        if self._lib is not None:
            fd = self._lib.sx_open(self.path.encode())
            if fd < 0:
                raise OSError(-fd, os.strerror(-fd), self.path)
            self.fd = fd
        else:
            self.fd = os.open(self.path, os.O_RDONLY)

    def advise_sequential(self, offset: int = 0, size: int = 0) -> None:
        if self._lib is not None:
            self._lib.sx_advise_sequential(self.fd, offset, size)

    def prefetch(self, offset: int, size: int) -> None:
        """Async readahead hint: fault the byte range into the page cache."""
        if self._lib is not None:
            self._lib.sx_prefetch(self.fd, offset, size)

    def read_block(self, offset: int, size: int) -> np.ndarray:
        """Read `size` bytes at `offset` into a fresh buffer (uint8)."""
        out = np.empty(size, dtype=np.uint8)
        if self._lib is not None:
            n = self._lib.sx_read_block(
                self.fd, offset, size, out.ctypes.data_as(ctypes.c_void_p)
            )
            if n < 0:
                raise OSError(-n, os.strerror(-n), self.path)
        else:
            data = os.pread(self.fd, size, offset)
            n = len(data)
            out[:n] = np.frombuffer(data, dtype=np.uint8)
        assert n == size, f"Short read: {n} != {size} at {offset} of {self.path}"
        return out

    def close(self) -> None:
        if getattr(self, "fd", -1) >= 0:
            if self._lib is not None:
                self._lib.sx_close(self.fd)
            else:
                os.close(self.fd)
            self.fd = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass
