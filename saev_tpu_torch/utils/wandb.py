"""Parallel experiment tracking: one live run + queued replays per SAE.

A copy of saev_tpu/utils/wandb.py, a mirror of the reference's `src/saev/utils/wandb.py` (ParallelWandbRun at :8-72): N SAEs
train in one process but each gets its own run id; SAE-0 logs live, the others'
metrics are queued and replayed into fresh runs at finish().

When the `wandb` package is unavailable (as on a machine without it or without a network), a local
JSONL backend records the same streams under `<dir>/<run_id>/` so training is fully
observable offline; the interface is identical.
"""

import json
import pathlib
import secrets

try:
    import wandb as _wandb

    _WANDB = True
except ImportError:
    _wandb = None
    _WANDB = False

MetricQueue = list[tuple[int, dict[str, object]]]


class _LocalRun:
    """wandb.Run-alike writing JSONL metrics + config to a local directory."""

    def __init__(self, project: str, cfg: dict | None, tags: list[str], dir: str):
        self.id = secrets.token_hex(4)
        self.dir = pathlib.Path(dir) / project / self.id
        self.dir.mkdir(parents=True, exist_ok=True)
        self.summary: dict[str, object] = {}
        with open(self.dir / "config.json", "w") as fd:
            json.dump({"config": _jsonable(cfg), "tags": tags}, fd, indent=2)
        self._metrics_fd = open(self.dir / "metrics.jsonl", "a")

    def log(self, metrics: dict[str, object], *, step: int):
        self._metrics_fd.write(
            json.dumps({"step": step, **_jsonable(metrics)}) + "\n"
        )
        # wandb semantics: run.summary defaults to the LAST logged value per
        # key — the analysis layer reads eval metrics from summary.json
        # (tdiscovery.analysis.tracker_record), so mirror that here.
        self.summary.update(_jsonable(metrics))

    def finish(self):
        with open(self.dir / "summary.json", "w") as fd:
            json.dump(_jsonable(self.summary), fd, indent=2)
        self._metrics_fd.close()


def _jsonable(obj):
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    if hasattr(obj, "tolist"):
        arr = obj.tolist()
        return arr if not isinstance(arr, list) or len(arr) <= 4096 else "<large array>"
    if hasattr(obj, "item"):
        return obj.item()
    return str(obj)


def _init_run(project: str, cfg, mode: str, tags: list[str], dir: str):
    if _WANDB:
        return _wandb.init(
            project=project,
            config=cfg,
            mode=mode,
            tags=tags,
            dir=dir,
            settings=_wandb.Settings(init_timeout=300),
        )
    return _LocalRun(project, cfg, tags, dir)


class ParallelWandbRun:
    """One live run + queued metric replays so N parallel SAEs each get their own
    run id (reference wandb.py:8-72)."""

    def __init__(
        self,
        project: str,
        cfgs: list[dict[str, object]],
        mode: str,
        tags: list[str],
        dir: str = ".wandb",
    ):
        cfg, *cfgs = cfgs
        self.project = project
        self.cfgs = cfgs
        self.mode = mode
        self.tags = tags
        self.dir = dir
        self.summary_updates: dict[str, object] = {}

        self.live_run = _init_run(project, cfg, mode, tags, dir)
        self.metric_queues: list[MetricQueue] = [[] for _ in self.cfgs]

    def log(self, metrics: list[dict[str, object]], *, step: int):
        metric, *metrics = metrics
        self.live_run.log(metric, step=step)
        for queue, metric in zip(self.metric_queues, metrics):
            queue.append((step, metric))

    def set_summary(self, key: str, value: object):
        self.summary_updates[key] = value
        self.live_run.summary[key] = value

    def finish(self) -> list[str]:
        ids = [self.live_run.id]
        self.live_run.finish()

        for queue, cfg in zip(self.metric_queues, self.cfgs):
            run = _init_run(
                self.project, cfg, self.mode, list(self.tags) + ["queued"], self.dir
            )
            for key, value in self.summary_updates.items():
                run.summary[key] = value
            for step, metric in queue:
                run.log(metric, step=step)
            ids.append(run.id)
            run.finish()

        return ids


class NullParallelRun:
    """ParallelWandbRun stand-in for non-primary processes in multi-host
    training: the SPMD train loop calls log/set_summary/finish on every
    process, but only process 0 may own run ids or write tracker files
    (parallel.is_primary). finish() returns no ids, so run-dir creation
    (keyed on ids) also skips on secondaries."""

    def log(self, metrics: list[dict[str, object]], *, step: int) -> None:
        pass

    def set_summary(self, key: str, value: object) -> None:
        pass

    def finish(self) -> list[str]:
        return []
