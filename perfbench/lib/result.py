"""What a driver hands back to `run.py`, and the correctness numbers.

A driver fills a `Run`: its end-to-end values, what the per-layer readers
read (host spans, CUDA-event spans, counts, the trace, the model's least
times), the correctness numbers beside their limits, and the device's peak
memory. `run.py` turns it into the contract's last line.
"""

import dataclasses
import math

import torch


@dataclasses.dataclass
class Check:
    """One number compared, beside its limit: correct when value <= limit
    (a NaN or a missing number is not)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return isinstance(self.value, (int, float)) and not math.isnan(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Run:
    cell: object
    end_to_end: dict[str, float] = dataclasses.field(default_factory=dict)
    # Per-layer inputs: host-clock seconds and CUDA-event ms by span name,
    # counts, the trace, the model's least times.
    host_s: dict[str, float] = dataclasses.field(default_factory=dict)
    event_ms: dict[str, float] = dataclasses.field(default_factory=dict)
    counts: dict[str, float] = dataclasses.field(default_factory=dict)
    model_s: dict[str, float] = dataclasses.field(default_factory=dict)
    trace: object = None
    checks: list[Check] = dataclasses.field(default_factory=list)
    attempted: int = 0
    memory_peak_bytes: int = 0

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks)

    @property
    def failed(self) -> int:
        return sum(not c.ok for c in self.checks)

    def check(self, name: str, value: float) -> None:
        self.checks.append(Check(name, float(value), float(self.cell.checks[name])))


def rel_gap(a: float, b: float) -> float:
    """|a - b| / |b| (|a| where b is 0)."""
    return abs(a - b) / abs(b) if b else abs(a)


def norm_gap(prog: dict[str, list[float]], ref: dict[str, list[float]], skip=frozenset()) -> float:
    """The worst leaf's gap between two sets of norms ({leaf: [norm a SAE]}):
    |program - reference| over the larger of the reference's norm of that
    leaf and of the median leaf (of that SAE); leaves in `skip` ((leaf, SAE)
    pairs) left out."""
    worst = 0.0
    n_sae = len(next(iter(ref.values())))
    for i in range(n_sae):
        median = sorted(ref[leaf][i] for leaf in ref)[len(ref) // 2]
        for leaf in ref:
            if (leaf, i) in skip:
                continue
            scale = max(ref[leaf][i], median)
            worst = max(worst, abs(prog[leaf][i] - ref[leaf][i]) / scale if scale else abs(prog[leaf][i]))
    return worst


def device_fields(count: int, peak_bytes: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(peak_bytes)}
