"""The port's jax-free library surface that reads a run, against the JAX
package's, on the same numpy inputs:

- `saev_tpu_torch.nn.__all__` names the JAX package's `nn` surface, and
  each name is the port's own (classes, functions, modules);
- `helpers.np_topk` (axis None, 0, 1, -1) and `helpers.csr_topk` (axis 0
  and 1, with batches smaller than the rows and ties in the values; axis 0
  also on columns with fewer than k positive entries, stored zeros and
  negative values): values and indices equal; `flattened` equal; `RemovedFeatureError` a
  RuntimeError;
- `statistics.PercentileEstimator` on one seeded stream, scalar and
  per-column: equal estimates at every step;
- `scheduling.Warmup` and `WarmupCosine`: equal step sequences, and
  `warmup_cosine(t)` the value after t steps within f32 rounding.
"""

import types

import numpy as np
import pytest
import scipy.sparse
import torch

import saev_tpu.nn as jnn
import saev_tpu_torch.nn as tnn
from saev_tpu import helpers as jhelpers
from saev_tpu.utils import scheduling as jscheduling
from saev_tpu.utils import statistics as jstatistics
from saev_tpu_torch import helpers
from saev_tpu_torch.utils import scheduling, statistics


def test_nn_surface_matches_jax():
    assert set(tnn.__all__) == set(jnn.__all__)
    for name in tnn.__all__:
        obj = getattr(tnn, name)
        assert type(obj) is type(getattr(jnn, name)) or isinstance(obj, types.FunctionType), name
        assert getattr(obj, "__name__", "").startswith("saev_tpu_torch") or obj.__module__.startswith(
            "saev_tpu_torch"), name


@pytest.mark.parametrize("axis", [None, 0, 1, -1])
def test_np_topk_matches_jax(axis):
    arr = np.random.default_rng(0).integers(0, 20, size=(17, 23)).astype(np.float32)  # ties
    got, want = helpers.np_topk(arr, 5, axis=axis), jhelpers.np_topk(arr, 5, axis=axis)
    assert isinstance(got, helpers.NumpyTopK)
    np.testing.assert_array_equal(got.values, want.values)
    np.testing.assert_array_equal(got.indices, want.indices)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("batch_size", [7, 4096])
def test_csr_topk_matches_jax(axis, batch_size):
    rng = np.random.default_rng(1)
    dense = rng.integers(1, 6, size=(50, 30)).astype(np.float32) * (rng.random((50, 30)) < 0.2)
    arr = scipy.sparse.csr_array(dense)
    got, want = helpers.csr_topk(arr, 4, axis, batch_size), jhelpers.csr_topk(arr, 4, axis, batch_size)
    assert got.values.shape == want.values.shape == ((4, 30) if axis == 0 else (50, 4))
    assert got.values.dtype == want.values.dtype
    np.testing.assert_array_equal(got.values, want.values)
    np.testing.assert_array_equal(got.indices, want.indices)
    for pkg in (helpers, jhelpers):
        with pytest.raises(ValueError, match="axis must be 0 or 1"):
            pkg.csr_topk(arr, 4, 2)


@pytest.mark.parametrize("seed", range(6))
def test_csr_topk_axis0_sparse_columns_match_jax(seed):
    """Axis 0 reads the stored entries: columns with fewer than k positive
    entries (their zero rows, stored or not, then their negative entries),
    ties to the lower row, k up to the row count, as the JAX package's
    streaming dense form gives them."""
    rng = np.random.default_rng(10 + seed)
    n_rows, n_cols = int(rng.integers(3, 40)), int(rng.integers(1, 30))
    dense = (rng.integers(-2, 4, size=(n_rows, n_cols)) * (rng.random((n_rows, n_cols)) < rng.random())).astype(np.float32)
    dense[:, 0] = -1.0  # a column of negatives alone
    arr = scipy.sparse.csr_array(dense)
    arr.data[rng.random(arr.nnz) < 0.2] = 0.0  # stored zeros
    k = int(rng.integers(1, n_rows + 1))
    for batch_size in (1, 5, 4096):
        got, want = helpers.csr_topk(arr, k, 0, batch_size), jhelpers.csr_topk(arr, k, 0, batch_size)
        assert got.values.dtype == want.values.dtype and got.indices.dtype == want.indices.dtype
        np.testing.assert_array_equal(got.values, want.values)
        np.testing.assert_array_equal(got.indices, want.indices)


def test_flattened_matches_jax():
    dct = {"a": 1, "b": {"c": 2, "d": {"e": 3}}, "f": {"g": [4]}}
    assert helpers.flattened(dct) == jhelpers.flattened(dct) == {"a": 1, "b.c": 2, "b.d.e": 3, "f.g": [4]}
    assert helpers.flattened(dct, sep="/") == jhelpers.flattened(dct, sep="/")
    assert issubclass(helpers.RemovedFeatureError, RuntimeError)


@pytest.mark.parametrize("shape", [(), (5,)])
def test_percentile_estimator_matches_jax(shape):
    stream = np.random.default_rng(2).normal(size=(200,) + shape)
    mine, theirs = statistics.PercentileEstimator(90, 200, shape=shape), jstatistics.PercentileEstimator(
        90, 200, shape=shape)
    for x in stream:
        mine.update(x)
        theirs.update(x)
        np.testing.assert_array_equal(mine.estimate, theirs.estimate)
    assert np.all(mine.estimate > 0)


def test_schedulers_match_jax():
    pairs = [
        (scheduling.Warmup(0.0, 1e-3, 10), jscheduling.Warmup(0.0, 1e-3, 10)),
        (scheduling.WarmupCosine(0.0, 5, 4e-4, 30, 1e-5), jscheduling.WarmupCosine(0.0, 5, 4e-4, 30, 1e-5)),
    ]
    for mine, theirs in pairs:
        assert repr(mine) == repr(theirs)
        assert [mine.step() for _ in range(40)] == [theirs.step() for _ in range(40)]
    sched = scheduling.WarmupCosine(0.0, 5, 4e-4, 30, 1e-5)
    for t in range(1, 40):
        want = sched.step()
        got = float(scheduling.warmup_cosine(torch.tensor(t), 0.0, 5.0, 4e-4, 30.0, 1e-5))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), t
    with pytest.raises(NotImplementedError):
        scheduling.Scheduler().step()
