"""Render mimic-pair feature overlays: per-task, per-latent image strips
(counterpart of contrib/mimics/src/mimics/render.py; the reference render
stage, the `launch.py render` pipeline that contrib/mimics/exps/
001-heliconius/{render,render_sweep}.py sweeps configure and exps/*/viewer.py
browse): for each scored task, take the top-separation latents from
mimic_scores.json and render, per latent, one highlight strip per class side:
the class's top-activating images with the latent's patch activations
overlaid. Output:

    run/inference/<shard>/mimics/<task>/<latent>/{side}_{j}.png
    run/inference/<shard>/mimics/<task>/index.json

index.json records the strip layout + per-latent AUROC so the viewer needs
no recomputation. Host-only; the dataset opens its images with Pillow, and
the model family is built on the CPU, since only its patch size and resize
are read.
"""

import dataclasses
import json
import logging
import pathlib

import numpy as np
import scipy.sparse

from .. import disk, viz
from ..data import Metadata, datasets, models
from . import scoring

logger = logging.getLogger("mimics.render")


@dataclasses.dataclass(frozen=True)
class Config:
    run: pathlib.Path = pathlib.Path("./runs/abcdefg")
    shards: pathlib.Path = pathlib.Path("./shards/abcdef01")
    labels: tuple[str, ...] = ()
    """Per-image class labels in dataset order (same as scoring.Config)."""
    task_names: tuple[str, ...] = ()
    """Tasks (from mimic_scores.json) to render; empty = all scored tasks."""
    n_features: int = 10
    """Top-separation latents rendered per task."""
    n_per_class: int = 8
    """Images per class strip."""
    img_scale: float = 1.0


def render_task(
    cfg: Config,
    task_name: str,
    task_scores: dict,
    pooled: np.ndarray,
    token_acts: scipy.sparse.csr_matrix,
    img_ds,
    md: Metadata,
    out_root: pathlib.Path,
) -> dict:
    """One task: strips for its top latents. Returns the index entry."""
    labels_arr = np.asarray(cfg.labels)
    side_a, side_b = task_name.split("_vs_", 1)
    patch_size = int(
        models.load_model_cls(md.family)(md.ckpt, device="cpu").patch_size * cfg.img_scale
    )
    tpi = md.content_tokens_per_example

    entries = []
    for item in task_scores["top10"][: cfg.n_features]:
        latent = int(item["latent"])
        latent_dir = out_root / task_name / str(latent)
        latent_dir.mkdir(parents=True, exist_ok=True)
        strips: dict[str, list[str]] = {}
        upper = float(pooled[:, latent].max())
        for side in (side_a, side_b):
            member_idx = np.where(labels_arr == side)[0]
            ranked = member_idx[np.argsort(-pooled[member_idx, latent])]
            names = []
            for j, ex in enumerate(ranked[: cfg.n_per_class].tolist()):
                tokens = np.asarray(
                    token_acts[ex * tpi : (ex + 1) * tpi, latent].todense()
                ).reshape(-1)
                img = img_ds[ex]["data"]
                highlighted = viz.add_highlights(
                    img, tokens.astype(np.float64), patch_size,
                    upper=max(upper, 1e-9),
                )
                fname = f"{side}_{j}.png"
                highlighted.save(latent_dir / fname)
                names.append(fname)
            strips[side] = names
        entries.append({
            "latent": latent,
            "auroc": item["auroc"],
            "strips": strips,
        })

    index = {
        "task": task_name,
        "sides": [side_a, side_b],
        "n_per_class": cfg.n_per_class,
        "features": entries,
    }
    (out_root / task_name / "index.json").write_text(json.dumps(index, indent=2))
    return index


def worker_fn(cfg: Config) -> dict[str, dict]:
    run = disk.Run(cfg.run)
    art = run.inference / cfg.shards.name
    scores = json.loads((art / "mimic_scores.json").read_text())
    tasks = list(cfg.task_names) or list(scores)

    md = Metadata.load(cfg.shards)
    assert len(cfg.labels) == md.n_examples
    token_acts = scipy.sparse.load_npz(art / "token_acts.npz").tocsr()
    pooled = scoring.max_pool_csr(
        token_acts, md.n_examples, md.content_tokens_per_example
    )

    model_cls = models.load_model_cls(md.family)
    resize_tr = model_cls.make_resize(
        md.ckpt, md.content_tokens_per_example, scale=cfg.img_scale
    )
    img_ds = datasets.get_dataset(md.make_data_cfg(), data_transform=resize_tr)

    out_root = art / "mimics"
    indexes = {}
    for task_name in tasks:
        assert task_name in scores, f"Task {task_name!r} not in mimic_scores.json"
        indexes[task_name] = render_task(
            cfg, task_name, scores[task_name], pooled, token_acts, img_ds, md,
            out_root,
        )
        logger.info(
            "Rendered %d features for task %s.",
            len(indexes[task_name]["features"]), task_name,
        )
    return indexes
