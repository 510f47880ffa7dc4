"""Dataloader host-side monitoring.

A copy of saev_tpu/utils/monitoring.py, itself a mirror of the reference's
`src/saev/utils/monitoring.py` (DataloaderMonitor at :12-220): IO bytes/s + CPU% +
reservoir fill, with graceful degradation when psutil or its counters are
unavailable. The shuffled loader runs its I/O threads *in-process*, so this
monitors this process rather than a spawned manager process. Metric names match the reference's wandb keys.
"""

import logging
import os
import time
import typing as tp

logger = logging.getLogger(__name__)

try:
    import psutil

    _PSUTIL = True
except ImportError:  # pragma: no cover - psutil is in the image, but stay graceful
    psutil = None
    _PSUTIL = False


class DataloaderMonitor:
    """Tracks IO and CPU activity of the dataloading threads plus reservoir fill.

    Construct with the dataloader, then call `compute()` whenever metrics are
    needed. All failures degrade to fewer metrics, never exceptions.
    """

    def __init__(self, dataloader: object, process: tp.Any | None = None) -> None:
        self.dataloader = dataloader
        self._proc = process
        self._reset_state()

    def attach(self, dataloader: object) -> None:
        if dataloader is self.dataloader:
            return
        self.dataloader = dataloader
        self._reset_state()

    def _reset_state(self) -> None:
        self.last_read_bytes: int | None = None
        self.last_time: float | None = None
        self.warned_io = False
        self.warned_cpu = False
        if self._proc is None and _PSUTIL:
            try:
                self._proc = psutil.Process(os.getpid())
            except Exception:
                self._proc = None
        if self._proc is not None:
            try:
                self._proc.cpu_percent(interval=None)  # prime the sampler
            except Exception:
                pass

    def compute(self, now: float | None = None) -> dict[str, float]:
        if now is None:
            now = time.time()

        metrics: dict[str, float] = {
            "loader/buffer_fill": self._get_reservoir_fill(self.dataloader)
        }
        if self._proc is None:
            return metrics

        try:
            io = self._proc.io_counters()
            read_bytes = io.read_bytes
        except Exception:
            if not self.warned_io:
                logger.warning("Cannot read IO counters; skipping IO metrics.")
                self.warned_io = True
            read_bytes = None

        if read_bytes is not None:
            metrics["loader/read_mb"] = read_bytes / 1e6
            if self.last_read_bytes is not None and self.last_time is not None:
                dt = now - self.last_time
                if dt > 0:
                    metrics["loader/read_mb_s"] = (
                        (read_bytes - self.last_read_bytes) / 1e6 / dt
                    )
            self.last_read_bytes = read_bytes
            self.last_time = now

        try:
            metrics["loader/cpu_util"] = float(self._proc.cpu_percent(interval=None))
        except Exception:
            if not self.warned_cpu:
                logger.warning("Cannot read CPU percent; skipping CPU metrics.")
                self.warned_cpu = True

        return metrics

    @staticmethod
    def _get_reservoir_fill(dataloader: object) -> float:
        fill = getattr(dataloader, "buffer_fill", None)
        if fill is None:
            reservoir = getattr(dataloader, "reservoir", None)
            fill = getattr(reservoir, "fill", None)
        if callable(fill):
            try:
                return float(fill())
            except Exception:
                return 0.0
        if isinstance(fill, (int, float)):
            return float(fill)
        return 0.0
