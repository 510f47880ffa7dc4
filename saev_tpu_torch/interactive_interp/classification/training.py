"""Train a grid of linear probes on [CLS] activations from shards.

Counterpart of contrib/interactive_interp/classification/training.py
(reference :33 main, :make_models, per-epoch AdamW loop over a live CLIP
forward). The [CLS] activations come straight from the shard protocol
(`tokens="special"` — CLS is token 0), the whole probe grid is stacked
(M, D, C) and (M, C) tensors trained by the semseg probes' AdamW step
(`semseg.training.step`: one f32 product with TF32 off, the gradient by
hand, a learning rate and a weight decay a probe) on the card unless
`device` is "cpu", and image targets come from the dataset recorded in the
shard metadata.
"""

import dataclasses
import json
import logging
import pathlib
import typing as tp

import numpy as np
import torch

from ... import configs as saev_configs
from ...data import IndexedConfig, IndexedDataset, Metadata, datasets
from .. import device_of
from ..semseg import training as semseg_training

logger = logging.getLogger("classification.training")


@dataclasses.dataclass(frozen=True)
class Train:
    """One probe's config (reference classification/config.py:10-35): the
    JAX package's fields and defaults but for `device`."""

    train_shards: pathlib.Path = pathlib.Path("./shards/abcdef01")
    """Shards extracted WITH cls_token=True."""
    val_shards: pathlib.Path = pathlib.Path("./shards/abcdef02")
    layer: int = -2
    learning_rate: float = 1e-4
    weight_decay: float = 1e-3
    n_epochs: int = 20
    batch_size: int = 512
    ckpt_path: pathlib.Path = pathlib.Path("./checkpoints/classification")
    seed: int = 42
    device: tp.Literal["cuda", "cpu"] = "cuda"
    """Where the probes train: the card unless "cpu" is asked for."""


def grid(cfg: Train, sweep_dct: dict[str, object]) -> tuple[list["Train"], list[str]]:
    """Expand a sweep dict into configs (reference config.py:39-47)."""
    cfgs, errs = [], []
    for d, dct in enumerate(saev_configs.expand(sweep_dct)):
        try:
            cfgs.append(dataclasses.replace(cfg, **dct, seed=cfg.seed + d))
        except Exception as err:
            errs.append(str(err))
    return cfgs, errs


def load_cls_features(shards: pathlib.Path, layer: int) -> np.ndarray:
    """(n_examples, d_model) CLS activations via the indexed dataset
    (tokens='special': one CLS vector per example)."""
    md = Metadata.load(shards)
    assert md.cls_token, f"Shards at {shards} were extracted without a CLS token."
    ds = IndexedDataset(
        IndexedConfig(shards=shards, tokens="special", layer=layer)
    )
    out = np.empty((md.n_examples, md.d_model), np.float32)
    for i in range(md.n_examples):
        out[i] = ds[i]["act"]
    return out


def load_targets(shards: pathlib.Path) -> np.ndarray:
    """Per-example integer targets from the dataset recorded in the shard
    metadata. Loads samples (incl. image bytes) — fine for probe-scale
    datasets; datasets with cheap metadata should override upstream."""
    md = Metadata.load(shards)
    ds = datasets.get_dataset(md.make_data_cfg())
    return np.asarray([int(ds[i]["target"]) for i in range(len(ds))], np.int64)


def train(cfgs: list[Train], init: dict | None = None) -> tuple[dict, list[str]]:
    """Train all probes jointly (one AdamW step over the stacks); returns
    stacked numpy params {w (M, D, C), b (M, C)} and the class list. `init`
    ({"w", "b"} arrays) replaces the heads' draw (`semseg.training.draw_heads`)."""
    cfg = cfgs[0]
    assert all(
        c.train_shards == cfg.train_shards and c.layer == cfg.layer for c in cfgs
    ), "All probes must share shards/layer."
    device = device_of(cfg.device)

    x = load_cls_features(cfg.train_shards, cfg.layer)
    y = load_targets(cfg.train_shards)
    assert len(x) == len(y)
    n_classes = int(y.max()) + 1
    d_model = x.shape[1]
    m = len(cfgs)

    if init is None:
        params = semseg_training.draw_heads(m, d_model, n_classes, cfg.seed, device)
    else:
        params = semseg_training._params_from(init, device)
    opt = semseg_training.init_opt(params)
    lr = torch.tensor([c.learning_rate for c in cfgs], dtype=torch.float32, device=device)
    wd = torch.tensor([c.weight_decay for c in cfgs], dtype=torch.float32, device=device)
    x_dev = torch.from_numpy(x).to(device)
    y_dev = torch.from_numpy(y).to(device)

    rng = np.random.default_rng(cfg.seed)
    n = len(x)
    bsz = min(cfg.batch_size, n)
    losses = None
    for _epoch in range(cfg.n_epochs):
        perm = rng.permutation(n)
        for start in range(0, n - bsz + 1, bsz):
            idx = torch.from_numpy(perm[start : start + bsz]).to(device)
            params, opt, losses = semseg_training.step(params, opt, x_dev[idx], y_dev[idx], lr, wd)
    logger.info("Trained %d probes, final losses %s.", m, None if losses is None else losses.cpu().numpy())
    return {k: v.cpu().numpy() for k, v in params.items()}, [str(c) for c in range(n_classes)]


def evaluate(params: dict, shards: pathlib.Path, layer: int) -> np.ndarray:
    """(M,) validation accuracy per probe (host numpy, as in the JAX
    package)."""
    x = load_cls_features(shards, layer)
    y = load_targets(shards)
    logits = np.einsum("bd,mdc->mbc", x, np.asarray(params["w"])) + np.asarray(
        params["b"]
    )[:, None, :]
    preds = logits.argmax(axis=-1)
    return (preds == y[None]).mean(axis=1)


def dump(ckpt_path: pathlib.Path, cfgs: list[Train], params: dict,
         accs: np.ndarray) -> pathlib.Path:
    ckpt_path = pathlib.Path(ckpt_path)
    ckpt_path.mkdir(parents=True, exist_ok=True)
    np.savez(ckpt_path / "probes.npz", w=params["w"], b=params["b"])
    with open(ckpt_path / "report.json", "w") as fd:
        json.dump(
            [
                {**dataclasses.asdict(c), "val_accuracy": float(a)}
                for c, a in zip(cfgs, accs)
            ],
            fd, indent=2, default=str,
        )
    return ckpt_path / "probes.npz"


def main(cfgs: list[Train]) -> np.ndarray:
    """Train the grid, evaluate, checkpoint (reference training.py:33-120)."""
    cfg = cfgs[0]
    params, _classes = train(cfgs)
    accs = evaluate(params, cfg.val_shards, cfg.layer)
    dump(cfg.ckpt_path, cfgs, params, accs)
    for c, a in zip(cfgs, accs):
        logger.info("lr=%g wd=%g: val acc %.4f", c.learning_rate, c.weight_decay, a)
    return accs
