"""Select, stage, and publish pareto-optimal DINOv3 SAE checkpoints to HF
(counterpart of contrib/trait_discovery/scripts/push_dinov3.py).

Capability mirror of reference contrib/trait_discovery/scripts/push_dinov3.py:
gather (L0, MSE) eval metrics for a curated run list, keep up to `max_n`
pareto-frontier runs per layer (endpoints + log-L0-quantile interior picks),
preflight-load every checkpoint, stage them as `layer_<L>/<id>/sae.pt` with
sha256 manifests, generate the model-card README, and (outside --dry-run)
upload the staging tree to a HuggingFace model repo.

Reference deltas: metrics come from the offline JSONL tracker or each run
dir's own eval summary instead of the wandb API, and upload is isolated in
`upload()` so everything else runs hermetically.

Usage:
    python -m saev_tpu_torch.tdiscovery.scripts.push_dinov3 push \\
        --runs-root runs --repo-id you/dinov3-saes --dry-run true
"""

import dataclasses
import hashlib
import json
import logging
import math
import pathlib
import shutil

from ... import helpers

logger = logging.getLogger("push_dinov3")


@dataclasses.dataclass(frozen=True)
class Config:
    runs_root: pathlib.Path = pathlib.Path("./runs")
    run_ids: pathlib.Path | None = None
    """JSON file {layer: [run_id, ...]}; None scans every run dir."""
    tracker_root: pathlib.Path | None = None
    """Offline tracker root for eval metrics (fallback: run metrics.json)."""
    staging: pathlib.Path = pathlib.Path("./staging/dinov3-saes")
    repo_id: str = "osunlp/SAE_DINOv3_24K_IN1K"
    title: str = "DINOv3 ViT-L/16"
    max_n: int = 6
    """Max checkpoints per layer after pareto + log-L0 spacing."""
    dry_run: bool = True
    """Stage + README only; no network upload."""
    device: str = "cuda"
    """Where the preflight loads each checkpoint ("cpu" to load on the CPU)."""


@dataclasses.dataclass(frozen=True)
class RunMetrics:
    run_id: str
    layer: int
    l0: float
    mse: float


@dataclasses.dataclass(frozen=True)
class StagedRun:
    run_id: str
    layer: int
    l0: float
    mse: float
    path: str
    sha256: str


def ckpt_fpath(runs_root: pathlib.Path, run_id: str) -> pathlib.Path:
    return runs_root / run_id / "checkpoint" / "sae.pt"


def _eval_summary(cfg: Config, run_id: str) -> dict:
    """eval metrics from the offline tracker, else the run's metrics.json.

    The tracker's summary.json carries FLAT wandb-style keys ("eval/l0",
    "eval/mse" — utils/wandb._LocalRun); nested {"eval": {...}} is accepted
    as a fallback shape."""
    if cfg.tracker_root is not None:
        for project_dir in sorted(p for p in cfg.tracker_root.glob("*") if p.is_dir()):
            fpath = project_dir / run_id / "summary.json"
            if fpath.exists():
                try:
                    summary = json.loads(fpath.read_text())
                except json.JSONDecodeError:
                    continue
                flat = {
                    key.removeprefix("eval/"): value
                    for key, value in summary.items()
                    if key.startswith("eval/")
                }
                nested = summary.get("eval", {})
                if flat or nested:
                    return {**nested, **flat}
    fpath = cfg.runs_root / run_id / "metrics.json"
    if fpath.exists():
        try:
            return json.loads(fpath.read_text())
        except json.JSONDecodeError:
            pass
    return {}


def fetch_metrics(run_ids: dict[int, list[str]], cfg: Config) -> list[RunMetrics]:
    """(L0, MSE) per run; runs missing either metric are skipped with a
    warning (reference fetch_metrics :130-147)."""
    metrics = []
    for layer, ids in sorted(run_ids.items()):
        for run_id in ids:
            summary = _eval_summary(cfg, run_id)
            l0, mse = summary.get("l0"), summary.get("mse")
            if l0 is None or mse is None:
                logger.warning(
                    "Run %s missing metrics (l0=%s, mse=%s), skipping.",
                    run_id, l0, mse,
                )
                continue
            metrics.append(RunMetrics(run_id, int(layer), float(l0), float(mse)))
    return metrics


def select_pareto(metrics: list[RunMetrics], *, max_n: int = 6) -> list[RunMetrics]:
    """Up to max_n pareto runs per layer: the (L0, MSE) frontier, then
    endpoints + interior picks at log1p(L0) quantiles (reference :151-191)."""
    by_layer: dict[int, list[RunMetrics]] = {}
    for m in metrics:
        by_layer.setdefault(m.layer, []).append(m)

    selected: list[RunMetrics] = []
    for layer in sorted(by_layer):
        runs = sorted(by_layer[layer], key=lambda r: (r.l0, r.mse))
        frontier, best = [], float("inf")
        for run in runs:
            if run.mse < best:
                best = run.mse
                frontier.append(run)
        if not frontier:
            continue
        if len(frontier) <= max_n:
            selected.extend(frontier)
            continue
        picked: set[int] = {0, len(frontier) - 1}
        n_interior = max_n - 2
        lo = math.log1p(frontier[0].l0)
        hi = math.log1p(frontier[-1].l0)
        for i in range(1, n_interior + 1):
            target = lo + (hi - lo) * i / (n_interior + 1)
            best_j = min(
                (j for j in range(len(frontier)) if j not in picked),
                key=lambda j: abs(math.log1p(frontier[j].l0) - target),
            )
            picked.add(best_j)
        selected.extend(frontier[j] for j in sorted(picked))
    return selected


def preflight(selected: list[RunMetrics], runs_root: pathlib.Path, *, device: str = "cuda") -> None:
    """Every staged checkpoint must exist AND load through nn.load, on the
    card unless `device` says otherwise."""
    from ... import nn

    for run in selected:
        fpath = ckpt_fpath(runs_root, run.run_id)
        assert fpath.exists(), f"Checkpoint missing: {fpath}"
        nn.load(fpath, device=device)
        logger.info("OK %s (layer %d)", run.run_id, run.layer)


def sha256_file(fpath: pathlib.Path) -> str:
    h = hashlib.sha256()
    with open(fpath, "rb") as fd:
        for chunk in iter(lambda: fd.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def stage(selected: list[RunMetrics], staging: pathlib.Path,
          runs_root: pathlib.Path) -> list[StagedRun]:
    staged = []
    for run in selected:
        rel = f"layer_{run.layer}/{run.run_id}/sae.pt"
        dst = staging / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(ckpt_fpath(runs_root, run.run_id), dst)
        staged.append(StagedRun(run.run_id, run.layer, run.l0, run.mse, rel,
                                sha256_file(dst)))
    return staged


def make_readme(cfg: Config, staged: list[StagedRun]) -> str:
    ordered = sorted(staged, key=lambda s: (s.layer, s.l0))
    rows = "\n".join(
        f"| {s.run_id} | {s.layer} | {s.l0:.1f} | {s.mse:.4f} | `{s.path}` |"
        for s in ordered
    )
    example = ordered[-1]
    return f"""---
license: mit
---

# SAEs for {cfg.title} trained on ImageNet-1K activations

Pareto-selected sparse autoencoders over residual-stream activations, one
directory per (layer, run). Every file ships with its sha256 in
manifest.json.

| run id | layer | L0 | MSE | path |
|---|---|---|---|---|
{rows}

```python
import saev_tpu_torch.nn

cfg, params, state = saev_tpu_torch.nn.load("{example.path}")
```
"""


def push(cfg: Config) -> list[StagedRun]:
    """Select -> preflight -> stage -> README/manifest [-> upload]."""
    if cfg.run_ids is not None:
        run_ids = {
            int(layer): list(ids)
            for layer, ids in json.loads(cfg.run_ids.read_text()).items()
        }
    else:
        run_ids = {0: sorted(
            p.name for p in cfg.runs_root.iterdir()
            if (p / "checkpoint" / "sae.pt").exists()
        )}

    metrics = fetch_metrics(run_ids, cfg)
    selected = select_pareto(metrics, max_n=cfg.max_n)
    assert selected, "No runs selected — check metrics availability."
    preflight(selected, cfg.runs_root, device=cfg.device)
    staged = stage(selected, cfg.staging, cfg.runs_root)

    (cfg.staging / "README.md").write_text(make_readme(cfg, staged))
    (cfg.staging / "manifest.json").write_text(
        json.dumps([dataclasses.asdict(s) for s in staged], indent=2)
    )
    logger.info("Staged %d checkpoints in %s.", len(staged), cfg.staging)

    if cfg.dry_run:
        logger.info("Dry run: skipping upload to %s.", cfg.repo_id)
        return staged
    upload(cfg)
    return staged


def upload(cfg: Config) -> None:
    """Upload the staging tree to the HF model repo (network)."""
    huggingface_hub = helpers.optional_import("huggingface_hub", "push_dinov3.upload")

    api = huggingface_hub.HfApi()
    api.create_repo(cfg.repo_id, repo_type="model", exist_ok=True)
    api.upload_folder(repo_id=cfg.repo_id, folder_path=str(cfg.staging),
                      repo_type="model")
    logger.info("Uploaded %s to %s.", cfg.staging, cfg.repo_id)


def main(argv: list[str] | None = None) -> None:
    from ...utils import cli

    logging.basicConfig(level=logging.INFO, format="[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s")
    cli.run({"push": push}, argv)


if __name__ == "__main__":
    main()
