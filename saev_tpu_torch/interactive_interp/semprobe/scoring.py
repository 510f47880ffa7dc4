"""Score SAE latents as binary concept detectors.

Counterpart of contrib/interactive_interp/semprobe/scoring.py (reference
semprobe/__main__.py score :21-169): run the SAE over activations of a
curated image set whose labels are "<task>-positive" / "<task>-negative",
mark a latent as predicting an image positive when its summed patch
activation exceeds a threshold, and report per-task F1 for every latent plus
the top-k latents per task.

The encode (TopK's threshold by kernel K6) and the per-image sums run on the
card unless `device` is "cpu": the (n_images, d_sae) float64 total stays on
the device and goes to the host once.

    python -m saev_tpu_torch.interactive_interp.semprobe.scoring score --sae-ckpt F --shards S --labels a-positive,a-negative,...
    python -m saev_tpu_torch.interactive_interp.semprobe.scoring negatives --shards S --dump-to D
"""

import dataclasses
import json
import logging
import pathlib
import typing as tp

import numpy as np
import torch

from ... import nn
from ...data import Metadata, OrderedConfig, OrderedDataLoader
from .. import device_of
from ..semseg import quantitative

logger = logging.getLogger("semprobe")


@dataclasses.dataclass(frozen=True)
class Score:
    """Scoring config (reference semprobe/config.py:11-39): the JAX
    package's fields and defaults but for `device`."""

    sae_ckpt: pathlib.Path = pathlib.Path("./checkpoints/abcdefg/sae.pt")
    """Path to the SAE checkpoint."""
    shards: pathlib.Path = pathlib.Path("./shards/abcdef01")
    """Shards extracted over the curated examples."""
    labels: tuple[str, ...] = ()
    """Per-image labels, '<task>-positive' / '<task>-negative', in dataset
    order (the reference reads these from an ImageFolder layout)."""
    batch_size: int = 2048
    threshold: float = 0.0
    """Summed-activation threshold for a positive prediction."""
    top_k: int = 5
    """Top latents reported per task."""
    include_latents: tuple[int, ...] = ()
    """Latents to always report."""
    dump_to: pathlib.Path = pathlib.Path("./logs/semprobe")
    device: tp.Literal["cuda", "cpu"] = "cuda"
    """Where the encodes and sums run: the card unless "cpu" is asked for."""


@torch.no_grad()
def image_latent_sums(
    sae_cfg, params, state, shards: pathlib.Path, batch_size: int
) -> np.ndarray:
    """(n_images, d_sae) summed patch activations per image, on the device of
    `params` (float64 sums by `index_add_`), copied to the host once."""
    device = params["W_enc"].device
    md = Metadata.load(shards)
    ctpe = md.content_tokens_per_example
    batch_size = max(batch_size // ctpe * ctpe, ctpe)
    dl = OrderedDataLoader(
        OrderedConfig(shards=shards, layer=md.layers[0], batch_size=batch_size)
    )
    sums = torch.zeros((md.n_examples, sae_cfg.d_sae), dtype=torch.float64, device=device)
    try:
        for batch in dl:
            f_x = quantitative.encode_f(sae_cfg, params, state, quantitative.batch_acts(batch, device))
            idx = torch.from_numpy(np.asarray(batch["example_idx"], np.int64)).to(device)
            sums.index_add_(0, idx, f_x.to(torch.float64))
    finally:
        dl.shutdown()
    return sums.cpu().numpy()


def f1_scores(preds_sn: np.ndarray, true_n: np.ndarray) -> np.ndarray:
    """(d_sae,) F1 of each latent's binary predictions against true labels."""
    tp = (preds_sn & (true_n > 0)).sum(axis=1).astype(np.float64)
    fp = (preds_sn & (true_n == 0)).sum(axis=1).astype(np.float64)
    fn = ((~preds_sn) & (true_n > 0)).sum(axis=1).astype(np.float64)
    return 2 * tp / np.maximum(2 * tp + fp + fn, 1.0)


def score(cfg: Score) -> dict[str, object]:
    sae_cfg, params, state = nn.load(cfg.sae_ckpt, device=device_of(cfg.device))
    md = Metadata.load(cfg.shards)
    assert len(cfg.labels) == md.n_examples, (
        f"Need one '<task>-positive/negative' label per image: got "
        f"{len(cfg.labels)} labels for {md.n_examples} images."
    )

    sums = image_latent_sums(sae_cfg, params, state, cfg.shards, cfg.batch_size)
    preds_sn = (sums > cfg.threshold).T  # (d_sae, n_images)

    tasks: dict[str, list[int]] = {}
    polarity = np.zeros(md.n_examples)
    for i, label in enumerate(cfg.labels):
        task, _, pol = label.rpartition("-")
        assert pol in ("positive", "negative"), f"Bad label {label!r}"
        tasks.setdefault(task, []).append(i)
        polarity[i] = 1.0 if pol == "positive" else 0.0

    results: dict[str, object] = {}
    for task, idxs in tasks.items():
        idxs_np = np.asarray(idxs)
        f1 = f1_scores(preds_sn[:, idxs_np], polarity[idxs_np])
        order = np.argsort(-f1)[: cfg.top_k].tolist()
        top = [
            {"latent": int(latent), "f1": float(f1[latent])}
            for latent in list(cfg.include_latents) + order
        ]
        results[task] = {
            "top_latents": top,
            "best_f1": float(f1.max()),
            "n_images": len(idxs),
        }
        logger.info("task %s: best F1 %.3f (latent %d)", task, f1.max(), f1.argmax())

    cfg.dump_to.mkdir(parents=True, exist_ok=True)
    with open(cfg.dump_to / "semprobe_scores.json", "w") as fd:
        json.dump(results, fd, indent=2)
    return results


@dataclasses.dataclass(frozen=True)
class Negatives:
    """Sample negative images for each probe task (reference
    semprobe/config.py:43-59, __main__.py:137-162)."""

    dump_to: pathlib.Path = pathlib.Path("./data/semprobe/test")
    """Where to save negative samples (one '<class>-negative' dir each)."""
    shards: pathlib.Path | None = None
    """Shards whose metadata names the source dataset; mutually exclusive
    with `data`."""
    data: object | None = None
    """A datasets.Config to sample from directly."""
    classes: tuple[str, ...] = ("brazil", "cool")
    """Task names needing negatives."""
    n_imgs: int = 20
    """Negatives per class."""
    skip: tuple[int, ...] = ()
    """Dataset indices to exclude (e.g. known positives)."""
    seed: int = 42


def negatives(cfg: Negatives) -> dict[str, int]:
    """Randomly sample `n_imgs` images per class into
    `<dump_to>/<class>-negative/` (the curated-set counterpart to hand-picked
    positives). Needs Pillow: the dataset decodes each sample to an image."""
    import random

    from ...data import datasets

    if cfg.data is not None:
        data_cfg = cfg.data
    else:
        assert cfg.shards is not None, "Provide either `shards` or `data`."
        data_cfg = Metadata.load(cfg.shards).make_data_cfg()
    ds = datasets.get_dataset(data_cfg)

    indices = list(range(len(ds)))
    rng = random.Random(cfg.seed)
    saved: dict[str, int] = {}
    for cls in cfg.classes:
        rng.shuffle(indices)
        dpath = pathlib.Path(cfg.dump_to) / f"{cls}-negative"
        dpath.mkdir(parents=True, exist_ok=True)
        n_saved = 0
        for i in indices:
            if i in cfg.skip:
                continue
            sample = ds[i]
            sample["data"].save(dpath / f"example_{cls}_{i}.png")
            n_saved += 1
            if n_saved >= cfg.n_imgs:
                break
        saved[cls] = n_saved
        logger.info("Saved %d negatives for task %s -> %s", n_saved, cls, dpath)
    return saved


if __name__ == "__main__":
    from ...utils import cli as cli_mod

    logging.basicConfig(level=logging.INFO)
    cli_mod.run({"score": score, "negatives": negatives})
