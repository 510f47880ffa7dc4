"""Validated reconstruction metrics for one evaluation corpus (a copy of
saev_tpu/metrics.py, standard library only, held to the original by
tests/test_torch_inference.py).

Field names and the metrics.json artifact layout are pinned by the reference
(`src/saev/metrics.py:15-159`) so runs are interchangeable; the implementation
is table-driven: every derived metric is a ratio of two primary fields,
declared once in `_RATIOS`, and all cross-checks/serialization iterate that
table instead of being spelled out per field.
"""

import dataclasses
import math
from collections import abc

# The spec: derived field -> (numerator, denominator), all names of primary
# fields. `from_accumulators` computes these; `__post_init__` re-checks them.
_RATIOS: dict[str, tuple[str, str]] = {
    "mse_per_dim": ("sse_recon", "n_elements"),
    "mse_per_token": ("sse_recon", "n_tokens"),
    "normalized_mse": ("sse_recon", "sse_baseline"),
    "baseline_mse_per_dim": ("sse_baseline", "n_elements"),
    "baseline_mse_per_token": ("sse_baseline", "n_tokens"),
}

# Primary size/total fields and their admissibility predicates.
_PRIMARY: dict[str, abc.Callable[[float], bool]] = {
    "sse_recon": lambda v: v >= 0.0,
    "sse_baseline": lambda v: v > 0.0,
    "n_tokens": lambda v: v > 0,
    "d_model": lambda v: v > 0,
    "n_elements": lambda v: v > 0,
}

_INT_FIELDS = frozenset({"n_tokens", "d_model", "n_elements"})


def close(a: float, b: float) -> bool:
    return math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-12)


@dataclasses.dataclass(frozen=True)
class Metrics:
    """Validated reconstruction metrics.

    Primary totals: `sse_recon` (SAE reconstruction SSE) and `sse_baseline`
    (mean-baseline SSE). Sizes: `n_tokens`, `d_model`,
    `n_elements = n_tokens * d_model`. Every other field is a `_RATIOS` entry
    (e.g. `normalized_mse = sse_recon / sse_baseline`), and construction
    re-derives and cross-checks each one, so a hand-edited or corrupted
    metrics.json cannot load silently.
    """

    mse_per_dim: float
    mse_per_token: float
    normalized_mse: float
    baseline_mse_per_dim: float
    baseline_mse_per_token: float
    sse_recon: float
    sse_baseline: float
    n_tokens: int
    d_model: int
    n_elements: int

    def __post_init__(self):
        for name in _INT_FIELDS:
            v = getattr(self, name)
            assert type(v) is int, f"{name} must be an int, got {type(v)}."
        for name, admissible in _PRIMARY.items():
            v = getattr(self, name)
            assert admissible(v), f"{name}={v} fails its admissibility bound."
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, int | float):
                assert math.isfinite(v), f"{f.name} must be finite, got {v}."
        assert self.n_elements == self.n_tokens * self.d_model, (
            f"n_elements={self.n_elements} != n_tokens*d_model="
            f"{self.n_tokens * self.d_model}."
        )
        for name, (num, den) in _RATIOS.items():
            got = getattr(self, name)
            want = getattr(self, num) / getattr(self, den)
            assert close(got, want), (
                f"{name}={got} is inconsistent with {num}/{den}={want}."
            )

    @classmethod
    def from_accumulators(
        cls, *, sse_recon: float, sse_baseline: float, n_tokens: int, d_model: int
    ) -> "Metrics":
        """Derive the full record from aggregate sums + shape info."""
        primary = {
            "sse_recon": sse_recon,
            "sse_baseline": sse_baseline,
            "n_tokens": n_tokens,
            "d_model": d_model,
            "n_elements": n_tokens * d_model,
        }
        for name, admissible in _PRIMARY.items():
            assert admissible(primary[name]), (
                f"{name}={primary[name]} fails its admissibility bound."
            )
        derived = {
            name: primary[num] / primary[den] for name, (num, den) in _RATIOS.items()
        }
        return cls(**primary, **derived)

    @classmethod
    def from_dict(cls, dct: abc.Mapping[str, object]) -> "Metrics":
        """Strict parse of a metrics.json mapping (bools rejected; ints stay
        ints, everything else coerces to float)."""
        values: dict[str, int | float] = {}
        for f in dataclasses.fields(cls):
            assert f.name in dct, f"Missing metric key: {f.name}."
            v = dct[f.name]
            assert not isinstance(v, bool), f"{f.name} must be numeric, got bool."
            if f.name in _INT_FIELDS:
                assert isinstance(v, int), f"{f.name} must be int, got {type(v)}."
                values[f.name] = v
            else:
                assert isinstance(v, int | float), (
                    f"{f.name} must be int/float, got {type(v)}."
                )
                values[f.name] = float(v)
        return cls(**values)  # type: ignore[arg-type]

    def to_dict(self) -> dict[str, float | int]:
        return dataclasses.asdict(self)
