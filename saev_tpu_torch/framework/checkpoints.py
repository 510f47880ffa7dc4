"""Mid-training checkpoint/resume for the SAE train loop (counterpart of
saev_tpu/framework/checkpoints.py).

Each save writes the whole `SweepState` of one cohort (params, the
optimizer's nested state: Adam's moments, or Muon's momentum with the Adam
state of its 1-D leaves; BatchTopK thresholds, dead-latent counters, step)
with `torch.save`, where the
JAX package uses orbax, keyed by a stable hash of the training group's
config so that a re-submitted job resumes where it stopped. The directory
layout and the pruning rules are the JAX package's:
`runs_root/.train_state/<group_key>/step_<8 digits>/`, one directory a step
(here holding `state.pt`), the older steps pruned only once every cohort saved
the newer one.

The data stream is not checkpointed: on resume the shuffled loader restarts
with its seeded RNG and reads the data in a new random order.

In a job of several processes every process calls `save`, rank 0 with the
whole cohort (`parallel.to_host`, its latents gathered too); rank 0 writes
and prunes, and a barrier ends each call, so another rank reads only what is
written. Every process restores the whole cohort and keeps its own SAEs and
latents (`restore(mesh=..., d_sae=...)`), so a checkpoint resumes under any
(data, sweep, feature) layout.
"""

import logging
import os
import pathlib
import shutil
import typing as tp

import torch

from .. import parallel

logger = logging.getLogger("checkpoints")

_FILE = "state.pt"


def state_dir(runs_root: pathlib.Path, group_key: str) -> pathlib.Path:
    return pathlib.Path(runs_root) / ".train_state" / group_key


def _to_cpu(tree: tp.Any) -> tp.Any:
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: _to_cpu(getattr(tree, f)) for f in tree._fields}
    return torch.as_tensor(tree).detach().cpu()


def save(
    runs_root: pathlib.Path,
    group_key: str,
    step: int,
    state: tp.Any,
    *,
    prune: bool = True,
) -> pathlib.Path:
    """Write the sweep state at `step`; by default keeps only the latest
    checkpoint. Callers saving several groups that must stay resumable
    together (the train loop's cohorts) pass prune=False and call
    `prune_below` only after every group's save at `step` succeeded:
    pruning inside each save would leave no common restorable step if a
    crash landed between them. The step's directory appears whole or not at
    all (written under another name, then renamed). Every process of a job
    calls it; rank 0 writes its `state` (the others' is not read, and may be
    None), and all return once it has."""
    root = state_dir(runs_root, group_key)
    path = root / f"step_{step:08d}"
    if parallel.is_primary():
        root.mkdir(parents=True, exist_ok=True)
        tmp = root / f".tmp_step_{step:08d}_{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save(_to_cpu(state), tmp / _FILE)
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
        if prune:
            for old in sorted(root.glob("step_*"))[:-1]:
                shutil.rmtree(old, ignore_errors=True)
        logger.info("Saved train state at step %d to '%s'.", step, path)
    parallel.sync()
    return path


def prune_below(runs_root: pathlib.Path, group_key: str, step: int) -> None:
    """Delete checkpoints older than `step` (rank 0; a barrier ends the
    call). Call after all cooperating groups saved at `step` (see
    `save(prune=False)`)."""
    root = state_dir(runs_root, group_key)
    if parallel.is_primary() and root.exists():
        for p in root.glob("step_*"):
            if int(p.name.split("_")[1]) < step:
                shutil.rmtree(p, ignore_errors=True)
    parallel.sync()


def available_steps(runs_root: pathlib.Path, group_key: str) -> list[int]:
    """Sorted steps with a saved checkpoint for this group."""
    root = state_dir(runs_root, group_key)
    if not root.exists():
        return []
    return sorted(int(p.name.split("_")[1]) for p in root.glob("step_*"))


def latest_step(runs_root: pathlib.Path, group_key: str) -> int | None:
    steps = available_steps(runs_root, group_key)
    return steps[-1] if steps else None


def _like(template: tp.Any, saved: tp.Any) -> tp.Any:
    """`saved` (nested dicts of CPU tensors) in `template`'s structure, each
    tensor on its template leaf's device with its dtype and shape."""
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_like(getattr(template, f), saved[f]) for f in template._fields))
    if isinstance(template, dict):
        return {k: _like(v, saved[k]) for k, v in template.items()}
    t = torch.as_tensor(template)
    if tuple(saved.shape) != tuple(t.shape):
        raise ValueError(f"checkpoint leaf has shape {tuple(saved.shape)}; expected {tuple(t.shape)}")
    return saved.to(device=t.device, dtype=t.dtype)


def restore(
    runs_root: pathlib.Path, group_key: str, step: int, template: tp.Any,
    mesh: parallel.Mesh | None = None, d_sae: int | None = None,
) -> tp.Any:
    """Restore the sweep state saved at `step`, shaped and placed like
    `template` (only its structure, shapes, dtypes and devices are read).
    Under a `mesh`, `template` holds this rank's SAEs (and, with a feature
    axis, its latents of each, which `d_sae`, the whole dictionary's width,
    locates) and the saved cohort's slice of them is taken
    (`parallel.shard_features`)."""
    path = state_dir(runs_root, group_key) / f"step_{step:08d}"
    saved = torch.load(path / _FILE, weights_only=True, map_location="cpu")
    if mesh is not None:
        if mesh.n_feature > 1 and d_sae is None:
            raise ValueError("restoring under a feature axis needs the dictionary's d_sae")
        saved = parallel.shard_features(mesh, saved, d_sae) if mesh.n_feature > 1 else parallel.shard_sweep(mesh, saved)
    restored = _like(template, saved)
    logger.info("Restored train state from '%s'.", path)
    return restored
