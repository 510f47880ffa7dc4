"""Shared utilities: the cache directory, filesystem-safe names, progress
logging, JSON dumps, dotted-dict access and flattening, batching math,
hashing, top-k over numpy arrays and scipy sparse matrices, and Slurm
introspection and array-aware job submission (saev_tpu/helpers.py, copied so
the port imports nothing of the JAX package).

Functional parity with the reference's `src/saev/helpers.py` (see file:line citations on
each function), implemented without orjson/beartype dependencies.
"""

import dataclasses
import enum
import importlib
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
    "get_slurm_max_array_size",
    "get_slurm_job_count",
    "submit_job_array",
    "optional_import",
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


def _csr_topk_axis0(arr, k: int) -> NumpyTopK:
    """Axis=0 top-k over a CSR matrix: top-k values across rows for each column.

    The result of the reference's streaming form (helpers.py:537-..., a
    stable descending argsort of dense row batches merged with the running
    top-k): each column's k largest values, the implicit zeros included,
    ties to the lower row. It is computed from the stored entries alone:
    sorted by (column, value descending, row), each column's positive
    entries come first, then its zero rows in ascending order (the rows it
    stores no nonzero for), then its negative entries. A dense batch's sort
    costs O(rows x columns log rows); this is O(nnz log nnz) plus a pass
    over the columns with fewer than k positive entries.
    """
    n_rows, n_cols = arr.shape
    csc = arr.tocsc()
    counts = np.diff(csc.indptr)
    cols = np.repeat(np.arange(n_cols), counts)
    vals = csc.data.astype(np.float64)
    order = np.lexsort((csc.indices, -vals, cols))
    rows, vals = csc.indices[order].astype(np.int64), vals[order]
    rank = np.arange(len(vals)) - csc.indptr[cols]

    topk_values = np.zeros((k, n_cols), dtype=np.float64)
    topk_indices = np.zeros((k, n_cols), dtype=np.int64)
    pos = (vals > 0) & (rank < k)
    topk_values[rank[pos], cols[pos]] = vals[pos]
    topk_indices[rank[pos], cols[pos]] = rows[pos]

    n_pos = np.bincount(cols[vals > 0], minlength=n_cols)
    for j in np.flatnonzero(n_pos < k):
        lo, hi = csc.indptr[j], csc.indptr[j + 1]
        col_rows, col_vals = rows[lo:hi], vals[lo:hi]
        nonzero = col_rows[col_vals != 0]
        need = k - n_pos[j]
        zero_rows = np.setdiff1d(np.arange(min(n_rows, need + len(nonzero))), nonzero)[:need]
        fill = np.concatenate([zero_rows, col_rows[col_vals < 0][: need - len(zero_rows)]])
        fill_vals = np.concatenate([np.zeros(len(zero_rows)), col_vals[col_vals < 0][: need - len(zero_rows)]])
        topk_indices[n_pos[j] :, j] = fill
        topk_values[n_pos[j] :, j] = fill_vals

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
        batch_size: Rows per processing batch (axis 1; axis 0 reads the stored
            entries whole).

    Returns:
        NumpyTopK(values, indices): shape (k, n_cols) for axis=0, (n_rows, k) for axis=1.
    """
    import scipy.sparse

    assert scipy.sparse.issparse(arr), "csr_topk requires a scipy sparse matrix"
    arr = arr.tocsr()
    if axis == 0:
        assert k <= arr.shape[0], f"k={k} > n_rows={arr.shape[0]}"
        return _csr_topk_axis0(arr, k)
    elif axis == 1:
        assert k <= arr.shape[1], f"k={k} > n_cols={arr.shape[1]}"
        return _csr_topk_axis1(arr, k, batch_size)
    else:
        raise ValueError(f"axis must be 0 or 1, got {axis}")


# ---------------------------------------------------------------------------
# Slurm introspection + array-aware batch submission (saev_tpu/helpers.py:372-453,
# reference helpers.py:227-411). Host-only.
# ---------------------------------------------------------------------------


def get_slurm_max_array_size(default: int = 1000) -> int:
    """MaxArraySize from `scontrol show config`; `default` when not on Slurm
    (reference helpers.py:296-331)."""
    logger = logging.getLogger("helpers.slurm")
    try:
        result = subprocess.run(
            ["scontrol", "show", "config"], capture_output=True, text=True, check=True
        )
        match = re.search(r"MaxArraySize\s*=\s*(\d+)", result.stdout)
        if match:
            return int(match.group(1))
        logger.warning("Could not find MaxArraySize; using default %d.", default)
    except (subprocess.CalledProcessError, FileNotFoundError):
        logger.info("scontrol unavailable; assuming MaxArraySize=%d.", default)
    return default


def get_slurm_job_count() -> int:
    """Number of queued/running jobs for the current user, counting array
    elements individually (reference helpers.py:389-411). 0 off-Slurm."""
    import getpass

    try:
        result = subprocess.run(
            ["squeue", "-r", "-u", getpass.getuser(), "-h"],
            capture_output=True, text=True, check=True,
        )
        return len([line for line in result.stdout.splitlines() if line.strip()])
    except (subprocess.CalledProcessError, FileNotFoundError):
        return 0


def submit_job_array(
    executor,
    fn: tp.Callable,
    args_list: list,
    *,
    logger: logging.Logger | None = None,
    margin: float = 0.8,
):
    """Submit jobs in MaxArraySize-respecting batches; yields (index, result),
    with None results for jobs that did not finish (reference helpers.py:227-292)."""
    try:
        from submitit.core.utils import UncompletedJobError
    except ImportError:
        class UncompletedJobError(Exception):
            """Sentinel that never matches: without submitit, job exceptions
            must propagate rather than be swallowed as 'did not finish'."""

    arr_size = max(int(get_slurm_max_array_size() * margin), 1)
    n_total = len(args_list)

    for arr_start, arr_end in batched_idx(n_total, arr_size):
        batch_args = args_list[arr_start:arr_end]
        if logger:
            logger.info(
                "Submitting batch of %d jobs (%d-%d of %d).",
                len(batch_args), arr_start + 1, arr_end, n_total,
            )
        with executor.batch():
            jobs = [executor.submit(fn, arg) for arg in batch_args]
        time.sleep(getattr(executor, "_saev_sleep_s", 5.0))
        for i, job in enumerate(jobs):
            global_idx = arr_start + i
            try:
                yield global_idx, job.result()
            except UncompletedJobError:
                if logger:
                    logger.warning(
                        "Job %s (%d) did not finish.", job.job_id, global_idx
                    )
                yield global_idx, None


# What to install for each optional package that host-side analysis imports.
_DISTRIBUTIONS = {"sklearn": "scikit-learn", "matplotlib": "matplotlib", "pandas": "pandas", "PIL": "Pillow"}


def optional_import(name: str, needed_by: str):
    """Import the optional package (or submodule) `name` for `needed_by`.
    Where it is not installed, raise an ImportError that names what needs it
    and what to install: nothing falls back to another method."""
    try:
        return importlib.import_module(name)
    except ImportError as err:
        top = name.split(".")[0]
        raise ImportError(
            f"{needed_by} needs {top} (pip install {_DISTRIBUTIONS.get(top, top)}), which cannot be imported here: {err}"
        ) from err
