"""Streaming statistics for training-time observability: `PercentileEstimator`
and `calc_batch_entropy`, copies of saev_tpu/utils/statistics.py's
(reference statistics.py:12-91), numpy on the host.
"""

import math
from collections.abc import Sequence

import numpy as np

IndexLike = np.ndarray | Sequence[int]


class PercentileEstimator:
    """SGD-style streaming percentile estimator (reference statistics.py:12-50)."""

    def __init__(
        self,
        percentile: float | int,
        total: int,
        lr: float = 1e-3,
        shape: tuple[int, ...] = (),
    ):
        self.percentile = percentile
        self.total = total
        self.lr = lr
        self._estimate = np.zeros(shape, dtype=np.float64)
        self._step = 0

    def update(self, x: float | np.ndarray):
        """Nudge the estimate toward the target percentile with a decaying step."""
        self._step += 1
        step_size = self.lr * (self.total - self._step) / self.total
        self._estimate = self._estimate + step_size * (
            np.sign(x - self._estimate) + 2 * self.percentile / 100 - 1.0
        )

    @property
    def estimate(self):
        return self._estimate


def calc_batch_entropy(
    example_idx: IndexLike,
    token_idx: IndexLike,
    n_examples: int,
    content_tokens_per_example: int,
) -> dict[str, float]:
    """Entropy and coverage metrics for a batch of shuffled indices
    (reference statistics.py:57-91). Keys match the reference's wandb names."""
    example_idx = np.asarray(example_idx, dtype=np.int64)
    token_idx = np.asarray(token_idx, dtype=np.int64)
    if n_examples <= 0:
        raise ValueError("n_examples must be positive.")
    if content_tokens_per_example <= 0:
        raise ValueError("content_tokens_per_example must be positive.")
    if example_idx.ndim != 1:
        raise ValueError("example_idx must be 1D.")
    if token_idx.ndim != 1:
        raise ValueError("token_idx must be 1D.")
    if example_idx.size == 0:
        raise ValueError("example_idx must contain at least one element.")
    if example_idx.shape != token_idx.shape:
        raise ValueError("example_idx and token_idx must have the same length.")

    return {
        **_add_prefix("loader/example", _entropy_metrics(example_idx, n_examples)),
        **_add_prefix(
            "loader/token", _entropy_metrics(token_idx, content_tokens_per_example)
        ),
    }


def _entropy_metrics(indices: np.ndarray, support: int) -> dict[str, float]:
    _, counts = np.unique(indices, return_counts=True)
    counts = counts.astype(np.float64)
    if counts.size == 0:
        return {"entropy": 0.0, "entropy_normalized": 0.0, "coverage": 0.0}
    probs = counts / counts.sum()
    entropy = float(-(probs * np.log(probs)).sum())
    coverage = counts.size / support
    normalized = 0.0 if support <= 1 else entropy / math.log(support)
    return {"entropy": entropy, "entropy_normalized": normalized, "coverage": coverage}


def _add_prefix(prefix: str, metrics: dict[str, float]) -> dict[str, float]:
    return {f"{prefix}_{key}": value for key, value in metrics.items()}
