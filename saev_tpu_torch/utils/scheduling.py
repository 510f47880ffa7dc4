"""Learning-rate schedules and the loader's step budget (counterpart of
saev_tpu/utils/scheduling.py): `_ramp` and `_cosine_decay` hold the math
once, the host-side `Scheduler` classes (`Warmup`, `WarmupCosine`) count
steps over them, `warmup_cosine` is the same schedule as a tensor function
of the train step's counter, and `BatchLimiter` stops a loader after a
number of samples."""

import collections.abc
import math
import typing as tp

import torch


def _ramp(t: float, lo: float, hi: float, n: int) -> float:
    """Linear interpolation lo -> hi over n steps, clamped at hi."""
    if t < n:
        return lo + (hi - lo) * (t / n)
    return hi


def _cosine_decay(t: float, n_warmup: int, peak: float, n_steps: int, final: float) -> float:
    """Half-cosine from peak at t=n_warmup down to final at t=n_steps."""
    if t >= n_steps:
        return final
    progress = (t - n_warmup) / (n_steps - n_warmup)
    return final + (peak - final) * (1 + math.cos(math.pi * progress)) / 2


class Scheduler:
    def step(self) -> float:
        raise NotImplementedError(f"{self.__class__.__name__} must implement step().")

    def __repr__(self) -> str:
        raise NotImplementedError(f"{self.__class__.__name__} must implement __repr__().")


class Warmup(Scheduler):
    """Linearly increases from `init` to `final` over `n_steps` steps."""

    def __init__(self, init: float, final: float, n_steps: int):
        self.init, self.final, self.n_steps = init, final, n_steps
        self._t = 0

    def step(self) -> float:
        self._t += 1
        return _ramp(self._t, self.init, self.final, self.n_steps)

    def __repr__(self) -> str:
        return f"Warmup(init={self.init}, final={self.final}, n_steps={self.n_steps})"


class WarmupCosine(Scheduler):
    """Linear warmup from `init` to `peak` over `n_warmup` steps, then cosine
    decay to `final` over the remaining `n_steps - n_warmup` steps."""

    def __init__(self, init: float, n_warmup: int, peak: float, n_steps: int, final: float):
        self.init, self.peak, self.final = init, peak, final
        self.n_warmup, self.n_steps = n_warmup, n_steps
        self._t = 0

    def step(self) -> float:
        self._t += 1
        if self._t < self.n_warmup:
            return _ramp(self._t, self.init, self.peak, self.n_warmup)
        return _cosine_decay(self._t, self.n_warmup, self.peak, self.n_steps, self.final)

    def __repr__(self) -> str:
        return (
            f"WarmupCosine(init={self.init}, peak={self.peak}, final={self.final}, "
            f"n_warmup={self.n_warmup}, n_steps={self.n_steps})"
        )


def warmup_cosine(step, init, n_warmup, peak, n_steps, final) -> torch.Tensor:
    """WarmupCosine as a tensor function of the step counter.

    `warmup_cosine(t, ...)` is the learning rate after t scheduler steps, so
    t = 0 gives `init` (lr = 0 at the first step when init is 0). `n_warmup`,
    `peak` and the other knobs may be per-SAE tensors; the result broadcasts
    over them. Computed in float32.
    """
    tensors = [v for v in (step, init, n_warmup, peak, n_steps, final)
               if isinstance(v, torch.Tensor)]
    device = tensors[0].device if tensors else None

    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32, device=device)

    step, n_warmup, n_steps = f32(step), f32(n_warmup), f32(n_steps)
    init, peak, final = f32(init), f32(peak), f32(final)
    warm = init + (peak - init) * (step / torch.clamp(n_warmup, min=1.0))
    progress = (step - n_warmup) / torch.clamp(n_steps - n_warmup, min=1.0)
    cosine = final + (peak - final) * (1 + torch.cos(math.pi * progress)) / 2
    return torch.where(step < n_warmup, warm, torch.where(step < n_steps, cosine, final))


@tp.runtime_checkable
class DataLoaderLike(tp.Protocol):
    drop_last: bool
    batch_size: int

    def __iter__(self) -> tp.Iterator[tp.Any]: ...


class BatchLimiter:
    """Infinite-epoch wrapper stopping after `n_samples` total samples
    (reference scheduling.py:83-122), with attribute passthrough."""

    def __init__(self, dataloader: DataLoaderLike, n_samples: int):
        self.dataloader = dataloader
        self.n_samples = n_samples
        self.batch_size = dataloader.batch_size
        self.drop_last = dataloader.drop_last

    def __len__(self) -> int:
        return math.ceil(self.n_samples / self.batch_size)

    def __getattr__(self, name: str) -> tp.Any:
        try:
            return getattr(self.dataloader, name)
        except AttributeError:
            raise AttributeError(
                f"'{self.__class__.__name__}' object and its wrapped dataloader "
                f"have no attribute '{name}'"
            )

    def __iter__(self):
        self.n_seen = 0
        while True:
            for batch in self.dataloader:
                yield batch
                self.n_seen += _infer_batch_size(batch, fallback=self.batch_size)
                if self.n_seen >= self.n_samples:
                    return
            # Mitigate partial-final-batch drift when the loader keeps the last
            # short batch (reference scheduling.py:120-122).
            if not self.dataloader.drop_last:
                self.n_seen -= self.batch_size


def _infer_batch_size(batch: tp.Any, fallback: int) -> int:
    """Best-effort batch-size extraction (reference scheduling.py:125-152):
    the leading length of a mapping's first value, or of the batch itself."""
    probe = batch
    if isinstance(batch, collections.abc.Mapping):
        values = iter(batch.values())
        probe = next(values, None)
        if probe is None:
            return fallback
    try:
        n = len(probe)
    except Exception:
        return fallback
    return n if isinstance(n, int) and n > 0 else fallback
