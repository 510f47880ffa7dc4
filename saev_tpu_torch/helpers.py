"""Shared utilities: the cache directory, filesystem-safe names, progress
logging, JSON dumps, dotted-dict access and flattening, batching math,
hashing, and top-k over numpy arrays and scipy sparse matrices (saev_tpu/
helpers.py but its Slurm helpers, copied so the port imports nothing of the
JAX package).

Functional parity with the reference's `src/saev/helpers.py` (see file:line citations on
each function), implemented without orjson/beartype dependencies.
"""

import dataclasses
import enum
import json
import logging
import math
import os
import pathlib
import re
import subprocess
import time
import typing as tp
from collections.abc import Hashable, Iterable

import numpy as np

__all__ = [
    "get_cache_dir",
    "fssafe",
    "progress",
    "flattened",
    "get",
    "batched_idx",
    "current_git_commit",
    "make_hashable",
    "jdump",
    "jdumps",
    "np_topk",
    "csr_topk",
    "NumpyTopK",
]


class RemovedFeatureError(RuntimeError):
    """Feature existed before but is no longer supported."""


def get_cache_dir() -> str:
    """Get cache directory from env vars, defaulting to the current working directory.

    Mirrors reference helpers.py:27-37 ($SAEV_CACHE / $HF_HOME / $HF_HUB_CACHE), as
    saev_tpu/helpers.py:44 does, so both packages look for weights in one place.
    """
    cache_dir = ""
    for var in ("SAEV_CACHE", "HF_HOME", "HF_HUB_CACHE"):
        cache_dir = cache_dir or os.environ.get(var, "")
    return cache_dir or "."


def fssafe(s: str) -> str:
    """Convert a string to be filesystem-safe by replacing special characters.

    Mirrors reference helpers.py:41-71 (saev_tpu/helpers.py:55).
    """
    for old in '/\\:*?"<>| ':
        s = s.replace(old, "_")
    return "".join(c if c.isalnum() or c in "-_." else "_" for c in s)


class progress:
    """Log-based progress wrapper (tqdm without control codes), suitable for output
    redirected to files / batch logs. Mirrors reference helpers.py:75-135.

    Args:
        it: Iterable to wrap.
        every: How many iterations between logging progress.
        desc: Logger name.
        total: If non-zero, how long the iterable is.
    """

    def __init__(
        self, it: Iterable, *, every: int = 10, desc: str = "progress", total: int = 0
    ):
        self.it = it
        self.every = max(every, 1)
        self.logger = logging.getLogger(desc)
        self.total = total

    def __len__(self) -> int:
        if self.total > 0:
            return self.total
        return len(self.it)  # may raise TypeError; callers handle

    def __iter__(self):
        start = time.time()
        try:
            total = len(self)
        except TypeError:
            total = None

        for i, obj in enumerate(self.it):
            yield obj

            if (i + 1) % self.every == 0:
                duration_s = time.time() - start
                per_min = (i + 1) / (duration_s / 60)
                if total is not None and total > 0:
                    pred_min = (total - (i + 1)) / per_min
                    self.logger.info(
                        "%d/%d (%.1f%%) | %.1f it/m (expected finish in %.1fm)",
                        i + 1,
                        total,
                        (i + 1) / total * 100,
                        per_min,
                        pred_min,
                    )
                else:
                    self.logger.info("%d/? | %.1f it/m", i + 1, per_min)


def flattened(dct: dict[str, object], *, sep: str = ".") -> dict[str, object]:
    """Flatten a nested dict into a single-level dict with dotted keys.

    Mirrors reference helpers.py:137-153.
    """
    new = {}
    for key, value in dct.items():
        if isinstance(value, dict):
            for nested_key, nested_value in flattened(value, sep=sep).items():
                new[f"{key}{sep}{nested_key}"] = nested_value
        else:
            new[key] = value
    return new


def get(dct: dict[str, object], key: str, *, sep: str = ".") -> object:
    """Look up a dotted key in a nested dict. Mirrors reference helpers.py:156-165."""
    key_parts = key.split(sep)
    value = dct
    for part in key_parts:
        value = value[part]
    return value


def batched_idx(
    total_size: int, batch_size: int
) -> tp.Iterator[tuple[int, int]]:
    """Iterate over (start, end) indices covering total_size in chunks of batch_size.

    Mirrors reference helpers.py:168-193.
    """
    for start in range(0, total_size, batch_size):
        stop = min(start + batch_size, total_size)
        yield start, stop


def current_git_commit() -> str | None:
    """Best-effort current git commit hash. Mirrors reference helpers.py:196-224."""
    try:
        result = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            capture_output=True,
            text=True,
            check=True,
            timeout=5,
        )
        commit = result.stdout.strip()
        return commit if re.fullmatch(r"[0-9a-f]{40}", commit) else None
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        return None


def make_hashable(x: object) -> Hashable:
    """Recursively convert nested containers/dataclasses to hashable tuples.

    Mirrors reference helpers.py:415-484.
    """
    if x is None or isinstance(x, (bool, int, str, bytes)):
        return x
    if isinstance(x, float):
        if math.isnan(x):
            return ("float_nan",)
        return x
    if isinstance(x, (bytearray, memoryview)):
        return bytes(x)
    if isinstance(x, pathlib.PurePath):
        return ("path", str(x))
    if isinstance(x, tuple):
        return ("tuple", tuple(make_hashable(e) for e in x))
    if isinstance(x, list):
        return ("list", tuple(make_hashable(e) for e in x))
    if isinstance(x, set):
        return ("set", frozenset(make_hashable(e) for e in x))
    if isinstance(x, frozenset):
        return ("frozenset", frozenset(make_hashable(e) for e in x))
    if isinstance(x, dict):
        return (
            "dict",
            frozenset((make_hashable(k), make_hashable(v)) for k, v in x.items()),
        )
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (
            "dataclass",
            x.__class__,
            tuple(
                (f.name, make_hashable(getattr(x, f.name)))
                for f in dataclasses.fields(x)
            ),
        )
    if hasattr(x, "__dict__"):
        return ("object", x.__class__, make_hashable(vars(x)))
    if hasattr(x, "__slots__"):
        items = []
        for name in x.__slots__:
            if hasattr(x, name):
                items.append((name, make_hashable(getattr(x, name))))
        return ("object_slots", x.__class__, frozenset(items))
    raise TypeError(f"Unsupported type {type(x).__name__}; add a converter if needed.")


def _json_default(obj: object):
    """Conversions for JSON serialization of non-native types.

    The reference serializes with orjson (helpers.py:486-498), which natively handles
    dataclasses (by field order) and enums (by value); Paths go through a `default`
    hook. We replicate those semantics with stdlib json.
    """
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        # Field-definition order, like orjson's native dataclass serialization.
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, pathlib.Path):
        return str(obj)
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    raise TypeError(f"Type {type(obj)} is not JSON serializable")


def jdumps(
    obj: object, *, indent: int | None = None, sort_keys: bool = False
) -> bytes:
    """Compact JSON serialization to bytes (orjson-style output with stdlib json).

    Mirrors reference helpers.py:495-498; keyword flags replace orjson option ints.
    """
    # ensure_ascii=False matches orjson's raw-UTF-8 output: the shard content
    # hash (shards.Metadata.hash) depends on these exact bytes.
    if indent is not None:
        text = json.dumps(
            obj, indent=indent, sort_keys=sort_keys, default=_json_default,
            ensure_ascii=False,
        )
    else:
        text = json.dumps(
            obj, separators=(",", ":"), sort_keys=sort_keys, default=_json_default,
            ensure_ascii=False,
        )
    return text.encode("utf-8")


def jdump(
    obj: object,
    fd: tp.BinaryIO,
    *,
    indent: int | None = None,
    sort_keys: bool = False,
    append_newline: bool = False,
):
    """Write compact JSON bytes to a binary file. Mirrors reference helpers.py:491-493."""
    fd.write(jdumps(obj, indent=indent, sort_keys=sort_keys))
    if append_newline:
        fd.write(b"\n")


class NumpyTopK(tp.NamedTuple):
    values: np.ndarray
    indices: np.ndarray


def np_topk(arr: np.ndarray, k: int, axis: int | None = None) -> NumpyTopK:
    """Numpy top-k along an axis (flattened if axis is None), descending, stable.

    Mirrors reference helpers.py:502-534.
    """
    if axis is None:
        arr = arr.flatten()
        axis = 0
    if axis < 0:
        axis = arr.ndim + axis

    sort_indices = np.argsort(-arr, axis=axis, kind="stable")
    topk_indices = np.take(sort_indices, np.arange(k), axis=axis)
    topk_values = np.take_along_axis(arr, topk_indices, axis=axis)
    return NumpyTopK(values=topk_values, indices=topk_indices)


def _csr_topk_axis0(arr, k: int, batch_size: int) -> NumpyTopK:
    """Axis=0 top-k over a CSR matrix: top-k values across rows for each column.

    Streaming min-tracking over row batches so the dense intermediate stays
    (batch_size, n_cols). Mirrors reference helpers.py:537-...
    """
    n_rows, n_cols = arr.shape

    topk_values = np.full((k, n_cols), -np.inf, dtype=np.float64)
    topk_indices = np.zeros((k, n_cols), dtype=np.int64)

    for start, end in batched_idx(n_rows, batch_size):
        block = np.asarray(arr[start:end].todense())
        block_rows = np.arange(start, end)

        # Merge current top-k with this block, then re-select top-k per column.
        cand_values = np.concatenate([topk_values, block], axis=0)
        cand_indices = np.concatenate(
            [topk_indices, np.broadcast_to(block_rows[:, None], block.shape)], axis=0
        )
        order = np.argsort(-cand_values, axis=0, kind="stable")[:k]
        topk_values = np.take_along_axis(cand_values, order, axis=0)
        topk_indices = np.take_along_axis(cand_indices, order, axis=0)

    # Columns with fewer than k finite entries keep -inf values; callers may mask.
    return NumpyTopK(values=topk_values.astype(arr.dtype), indices=topk_indices)


def _csr_topk_axis1(arr, k: int, batch_size: int) -> NumpyTopK:
    """Axis=1 top-k over a CSR matrix: top-k values within each row."""
    n_rows, n_cols = arr.shape
    out_values = np.zeros((n_rows, k), dtype=arr.dtype)
    out_indices = np.zeros((n_rows, k), dtype=np.int64)

    for start, end in batched_idx(n_rows, batch_size):
        block = np.asarray(arr[start:end].todense())
        res = np_topk(block, k, axis=1)
        out_values[start:end] = res.values
        out_indices[start:end] = res.indices

    return NumpyTopK(values=out_values, indices=out_indices)


def csr_topk(arr, k: int, axis: int, batch_size: int = 4096) -> NumpyTopK:
    """Streaming top-k over a scipy CSR sparse matrix along either axis.

    Used for top-activating-example retrieval over `token_acts.npz` artifacts.
    Mirrors reference helpers.py:537-710 (axis-0 vectorized min-tracking).

    Args:
        arr: scipy.sparse csr_array/csr_matrix of shape (n_rows, n_cols).
        k: Number of top elements.
        axis: 0 (top rows per column) or 1 (top columns per row).
        batch_size: Rows per processing batch.

    Returns:
        NumpyTopK(values, indices): shape (k, n_cols) for axis=0, (n_rows, k) for axis=1.
    """
    import scipy.sparse

    assert scipy.sparse.issparse(arr), "csr_topk requires a scipy sparse matrix"
    arr = arr.tocsr()
    if axis == 0:
        assert k <= arr.shape[0], f"k={k} > n_rows={arr.shape[0]}"
        return _csr_topk_axis0(arr, k, batch_size)
    elif axis == 1:
        assert k <= arr.shape[1], f"k={k} > n_cols={arr.shape[1]}"
        return _csr_topk_axis1(arr, k, batch_size)
    else:
        raise ValueError(f"axis must be 0 or 1, got {axis}")
