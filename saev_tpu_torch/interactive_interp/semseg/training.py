"""Train parallel linear patch-segmentation probes on shard activations.

Counterpart of contrib/interactive_interp/semseg/training.py (reference
main :33, make_models :284, dump/load :166-264, get_class_ious :379): M linear
heads predict per-patch class labels from residual activations; heads train in
parallel on a shared batch.

Probes train directly from activation shards (labels.bin supplies the
per-patch classes) through the shuffled loader. The M heads are stacked
(M, D, C) and (M, C) tensors: one step computes every head's logits with one
f32 product (TF32 off), its gradient by hand, and one AdamW update over the
stacks with a learning rate and a weight decay a head. torch.optim.AdamW
takes one rate a parameter tensor and puts eps elsewhere, so the update is
written out as the JAX package writes it.
"""

import dataclasses
import json
import logging
import pathlib
import typing as tp

import numpy as np
import torch

from ...data import ShuffledConfig, ShuffledDataLoader
from ...nn import modeling
from ...utils import scheduling
from .. import device_of

logger = logging.getLogger("semseg.training")

B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class Train:
    """One probe's config (reference semseg/config.py): the JAX package's
    fields and defaults but for `device`."""

    shards: pathlib.Path = pathlib.Path("./shards/abcdef01")
    """Activation shards WITH labels.bin."""
    layer: int = -2
    n_classes: int = 151
    learning_rate: float = 1e-4
    weight_decay: float = 1e-3
    n_train: int = 200_000
    batch_size: int = 4096
    seed: int = 42
    ckpt_path: pathlib.Path = pathlib.Path("./checkpoints/semseg")
    device: tp.Literal["cuda", "cpu"] = "cuda"
    """Where the probes train: the card unless "cpu" is asked for."""


def make_models(cfgs: list[Train], d_model: int) -> dict[str, torch.Tensor]:
    """Stacked (M, d_model, n_classes) linear heads + biases on the configs'
    device (`draw_heads`)."""
    n_classes = cfgs[0].n_classes
    assert all(c.n_classes == n_classes for c in cfgs)
    return draw_heads(len(cfgs), d_model, n_classes, cfgs[0].seed, device_of(cfgs[0].device))


def draw_heads(m: int, d_model: int, n_classes: int, seed: int, device: torch.device) -> dict[str, torch.Tensor]:
    """M heads N(0, 1 / d_model) from a torch.Generator seeded by `seed` (not
    the JAX package's values: those come from `jax.random`), zero biases."""
    gen = torch.Generator().manual_seed(seed)
    w = torch.randn((m, d_model, n_classes), generator=gen) / np.sqrt(d_model)
    return {"w": w.to(device), "b": torch.zeros((m, n_classes), device=device)}


def init_opt(params: dict[str, torch.Tensor]) -> dict:
    return {
        "m": {k: torch.zeros_like(v) for k, v in params.items()},
        "v": {k: torch.zeros_like(v) for k, v in params.items()},
        "count": 0,
    }


def _params_from(init: dict, device: torch.device) -> dict[str, torch.Tensor]:
    return {k: torch.tensor(np.asarray(init[k], np.float32), device=device) for k in ("w", "b")}


@torch.no_grad()
def step(
    params: dict[str, torch.Tensor], opt: dict, acts: torch.Tensor, labels: torch.Tensor,
    lr: torch.Tensor, wd: torch.Tensor,
) -> tuple[dict[str, torch.Tensor], dict, torch.Tensor]:
    """One AdamW step of every head on one batch (the JAX package's `_make_step`
    body): each head's loss is the mean negative log-likelihood of its
    log-softmax, its gradient (softmax - onehot) / B. Returns (params, opt,
    losses (M,))."""
    w, b = params["w"], params["b"]
    m_, d, c = w.shape
    n = acts.shape[0]
    with modeling._f32_products():
        logits = (acts @ w.permute(1, 0, 2).reshape(d, m_ * c)).view(n, m_, c) + b[None]
        logp = torch.log_softmax(logits, dim=-1)  # (B, M, C)
        idx = labels.view(n, 1, 1).expand(n, m_, 1)
        losses = -logp.gather(2, idx)[..., 0].mean(dim=0)  # (M,)
        g = logp.exp()
        g.scatter_add_(2, idx, torch.full((n, m_, 1), -1.0, device=g.device))
        g /= n
        grads = {
            "w": (acts.T @ g.view(n, m_ * c)).view(d, m_, c).permute(1, 0, 2),
            "b": g.sum(dim=0),
        }
    count = opt["count"] + 1
    bc1, bc2 = 1 - B1**count, 1 - B2**count
    new_params, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        gk = grads[k]
        m = B1 * opt["m"][k] + (1 - B1) * gk
        v = B2 * opt["v"][k] + (1 - B2) * gk * gk
        shape = (-1,) + (1,) * (p.ndim - 1)
        update = (m / bc1) / (torch.sqrt(v / bc2) + EPS)
        new_params[k] = p - lr.view(shape) * (update + wd.view(shape) * p)  # decoupled weight decay
        new_m[k], new_v[k] = m, v
    return new_params, {"m": new_m, "v": new_v, "count": count}, losses


def _make_step(n_classes: int):
    """The step function `train` runs (tests and chip_smoke.py wrap it to read
    each step's losses)."""
    return step


def train(cfgs: list[Train], init: dict | None = None) -> dict[str, np.ndarray]:
    """Train all probes on one shared stream; returns stacked numpy params.
    `init` ({"w": (M, D, C), "b": (M, C)} arrays) replaces `make_models`'s
    draw."""
    cfg = cfgs[0]
    assert all(c.shards == cfg.shards and c.layer == cfg.layer for c in cfgs), (
        "All probes must share shards/layer (one data stream)."
    )
    device = device_of(cfg.device)
    dl = ShuffledDataLoader(
        ShuffledConfig(
            shards=cfg.shards, layer=cfg.layer, batch_size=cfg.batch_size,
            n_threads=2, seed=cfg.seed,
        )
    )
    limited = scheduling.BatchLimiter(dl, cfg.n_train)
    md = dl.metadata
    d_model = md.d_model

    labels_fpath = pathlib.Path(cfg.shards) / "labels.bin"
    assert labels_fpath.exists(), (
        f"Shards at {cfg.shards} have no labels.bin; semseg probes need "
        "per-patch labels."
    )
    labels_mmap = np.memmap(
        labels_fpath, mode="r", dtype=np.uint8,
        shape=(md.n_examples, md.content_tokens_per_example),
    )

    params = make_models(cfgs, d_model) if init is None else _params_from(init, device)
    opt = init_opt(params)
    lr = torch.tensor([c.learning_rate for c in cfgs], dtype=torch.float32, device=device)
    wd = torch.tensor([c.weight_decay for c in cfgs], dtype=torch.float32, device=device)
    step_fn = _make_step(cfg.n_classes)

    n_steps = 0
    try:
        for batch in limited:
            acts = torch.from_numpy(np.asarray(batch["act"], np.float32)).to(device)
            # The shuffled loader yields (example_idx, token_idx); join the
            # labels from the labels.bin memmap host-side.
            labels_np = labels_mmap[
                np.asarray(batch["example_idx"]), np.asarray(batch["token_idx"])
            ]
            labels = torch.from_numpy(labels_np.astype(np.int64)).to(device)
            params, opt, _losses = step_fn(params, opt, acts, labels, lr, wd)
            n_steps += 1
    finally:
        dl.shutdown()
    logger.info("Trained %d probes for %d steps.", len(cfgs), n_steps)
    return {k: v.cpu().numpy() for k, v in params.items()}


def dump(ckpt_path: pathlib.Path, cfgs: list[Train], params: dict) -> pathlib.Path:
    ckpt_path = pathlib.Path(ckpt_path)
    ckpt_path.mkdir(parents=True, exist_ok=True)
    fpath = ckpt_path / "probes.npz"
    np.savez(
        fpath,
        w=_numpy(params["w"]),
        b=_numpy(params["b"]),
    )
    with open(ckpt_path / "cfgs.json", "w") as fd:
        json.dump([dataclasses.asdict(c) for c in cfgs], fd, indent=2, default=str)
    return fpath


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def load(ckpt_path: pathlib.Path) -> dict:
    with np.load(pathlib.Path(ckpt_path) / "probes.npz") as fd:
        return {"w": fd["w"], "b": fd["b"]}


def load_latest(root: pathlib.Path) -> dict:
    """Load the newest probe checkpoint under `root` — largest `_step<N>`
    suffix on the checkpoint dir name, falling back to directory mtime
    (reference semseg/training.py:199-237 load_latest)."""
    import re

    root = pathlib.Path(root)
    candidates = sorted(p.parent for p in root.rglob("probes.npz"))
    if not candidates:
        raise FileNotFoundError(f"No probe checkpoints under {root}")

    def step_of(dpath: pathlib.Path) -> int:
        match = re.search(r"_step(\d+)$", dpath.name)
        return int(match.group(1)) if match else -1

    steps = [step_of(d) for d in candidates]
    if max(steps) >= 0:
        best = candidates[int(np.argmax(steps))]
    else:
        best = max(candidates, key=lambda d: d.stat().st_mtime)
        logger.warning("No _step suffixes under %s; using newest: %s", root, best)
    logger.info("Loading probe checkpoint %s.", best)
    return load(best)


def predict(params: dict, acts: np.ndarray, probe_i: int = 0) -> np.ndarray:
    """Per-token class predictions for one probe."""
    logits = acts @ _numpy(params["w"][probe_i]) + _numpy(params["b"][probe_i])
    return logits.argmax(axis=-1)


def get_class_ious(
    preds: np.ndarray, labels: np.ndarray, n_classes: int
) -> np.ndarray:
    """Per-class IoU (reference semseg/training.py:379-...). NaN for absent
    classes."""
    ious = np.full(n_classes, np.nan)
    for c in range(n_classes):
        pred_c = preds == c
        true_c = labels == c
        union = (pred_c | true_c).sum()
        if union == 0:
            continue
        ious[c] = (pred_c & true_c).sum() / union
    return ious
