"""Extraction entry point: record a frozen ViT's residual activations to shards
(the counterpart of saev_tpu/framework/shards.py).

    python -m saev_tpu_torch.framework.shards data:bird-clef2025 --data.root ... \
        --family bird-mae --ckpt Bird-MAE-Large=<file.pt> ... [--device cpu]

CLI-contract mirror of reference `src/saev/framework/shards.py:30-138` (field
names/defaults are the public interface), with `device` defaulting to "cuda".
The body just routes the config into `saev_tpu_torch.data.extract.worker_fn`,
locally or through a Slurm job.
"""

import dataclasses
import inspect
import logging
import pathlib
import typing as tp

from ..data import PixelAgg, datasets, extract

logger = logging.getLogger("shards")

Family = tp.Literal[
    "bird-mae",
    "clip",
    "dinov2",
    "dinov3",
    "fake-clip",
    "pe-core",
    "pe-spatial",
    "siglip",
]


@dataclasses.dataclass(frozen=True)
class Config:
    """Everything needed to turn (model, dataset) into an activation shard dir."""

    # -- what to extract --------------------------------------------------
    data: datasets.Config = dataclasses.field(default_factory=datasets.FakeImg)
    """Dataset config (any member of the datasets.Config union)."""
    family: Family = "clip"
    """Model family key in the registry."""
    ckpt: str = "ViT-L-14/openai"
    """Checkpoint identifier within the family."""
    layers: tuple[int, ...] = (-2,)
    """Residual-stream layers to record (default: second-to-last)."""
    # -- model geometry (family/ckpt-dependent, not inferred) -------------
    d_model: int = 1024
    """Residual width of the chosen checkpoint."""
    content_tokens_per_example: int = 256
    """Patch-token count per example for the chosen input size."""
    cls_token: bool = True
    """True when the model prepends a [CLS] token."""
    # -- output -----------------------------------------------------------
    shards_root: pathlib.Path = pathlib.Path("$SAEV_SCRATCH/saev/shards/")
    """Directory that will hold the content-addressed shard dir."""
    max_tokens_per_shard: int = 2_400_000
    """Shard size cap; 2.4M tokens ~= 10 GB at d=1024 fp32."""
    pixel_agg: PixelAgg = PixelAgg.MAJORITY
    """Pixel->patch label aggregation rule for segmentation datasets."""
    # -- execution --------------------------------------------------------
    batch_size: int = 1024
    """Examples per ViT forward."""
    n_workers: int = 8
    """Host dataloader worker threads."""
    device: str = "cuda"
    """Torch device the model runs on: "cuda" (raises without a card) or "cpu"."""
    # -- Slurm (optional; empty slurm_acct = run inline) ------------------
    n_hours: float = 24.0
    """Job wall-clock limit."""
    slurm_acct: str = ""
    """Account to bill; empty disables submission."""
    slurm_partition: str = ""
    """Partition name."""
    log_to: str = "./logs"
    """Job stdout/stderr directory."""


def _worker_kwargs(cfg: Config) -> dict:
    """Map config fields onto `extract.worker_fn`'s keyword parameters by
    name, so the two signatures cannot drift apart silently."""
    accepted = set(inspect.signature(extract.worker_fn).parameters)
    out = {}
    for field in dataclasses.fields(cfg):
        if field.name not in accepted:
            continue  # Slurm-only knobs
        value = getattr(cfg, field.name)
        out[field.name] = list(value) if field.name == "layers" else value
    missing = accepted - set(out)
    assert not missing, f"extract.worker_fn params not covered by Config: {missing}"
    return out


def cli(cfg: Config) -> None:
    """Entry point behind `python -m saev_tpu_torch.framework.shards`."""
    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s",
    )
    kwargs = _worker_kwargs(cfg)

    if not cfg.slurm_acct:
        extract.worker_fn(**kwargs)
        return

    try:
        import submitit
    except ImportError as err:
        raise RuntimeError(
            "slurm_acct set but submitit is not installed; run without Slurm."
        ) from err
    executor = submitit.SlurmExecutor(folder=cfg.log_to)
    executor.update_parameters(
        time=int(cfg.n_hours * 60),
        partition=cfg.slurm_partition,
        ntasks_per_node=1,
        cpus_per_task=cfg.n_workers + 4,
        stderr_to_stdout=True,
        account=cfg.slurm_acct,
    )
    job = executor.submit(extract.worker_fn, **kwargs)
    logger.info("Running job '%s'.", job.job_id)
    job.result()


if __name__ == "__main__":
    import sys

    from saev_tpu_torch.framework import shards as _shards
    from saev_tpu_torch.utils import cli as _cli

    _cli.run({"shards": _shards.cli}, ["shards", *sys.argv[1:]])
