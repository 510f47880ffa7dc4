"""Run a trained SAE over an image and visualize top latents as heatmaps (the
counterpart of examples/inference.py).

The ViT forward goes through the family's `Recorder` (`data.models`); the SAE
forward is `nn.modeling.forward` on the device that holds the SAE, whose
TopK takes its threshold from kernel K6 on a CUDA tensor
(`ops.exact_kth_value`, csrc/kth.cu). Both run on the card unless the config
asks for the CPU (`device="cpu"`). Pillow is imported where an image is read
or written.

The reference's published DINOv2 SAEs expect activations normalized as
`(acts - mean) / scalar` with constants derived from IN1K activations. Pass
`--normalize-from <shards-dir>` to compute the same (per-dim mean vector +
global scalar) from a local shard dataset, or omit for raw activations.

Usage (hermetic demo on the fake backend):
    python -m saev_tpu_torch.examples.inference demo --out /tmp/sae_demo [--device cpu]

Usage (real checkpoint):
    python -m saev_tpu_torch.examples.inference run --sae-ckpt runs/<id>/checkpoint/sae.pt \\
        --family dinov2 --ckpt dinov2_vitb14_reg --layer -2 --image img.jpg
"""

import dataclasses
import logging
import pathlib

import numpy as np
import torch

logger = logging.getLogger("examples.inference")


@dataclasses.dataclass(frozen=True)
class RunConfig:
    sae_ckpt: pathlib.Path = pathlib.Path("./runs/abcdefg/checkpoint/sae.pt")
    """Path to a sae.pt checkpoint (reference schema, any version)."""
    family: str = "dinov2"
    """ViT family."""
    ckpt: str = "dinov2_vitb14_reg"
    """ViT checkpoint name (weights resolved from the local cache)."""
    layer: int = -2
    """Residual layer to read."""
    content_tokens: int = 256
    """Content tokens per image for this model/resolution."""
    image: pathlib.Path = pathlib.Path("./image.jpg")
    """Input image."""
    normalize_from: pathlib.Path | None = None
    """Optional shards dir to derive (mean, scalar) activation normalization."""
    k: int = 5
    """How many latents to visualize."""
    select: str = "filtered"
    """Latent selection heuristic: variance | max | filtered."""
    out: pathlib.Path = pathlib.Path("./sae_viz")
    """Output directory for heatmap PNGs."""
    device: str = "cuda"
    """Where the ViT and the SAE run ("cpu" on request)."""


def select_top_latents_by_variance(f_x: np.ndarray, k: int = 5) -> np.ndarray:
    """Latents with the largest spatial variance."""
    return np.argsort(-f_x.var(axis=0))[:k]


def select_top_latents_by_max(f_x: np.ndarray, k: int = 5) -> np.ndarray:
    """Latents with the largest max activation."""
    return np.argsort(-f_x.max(axis=0))[:k]


def select_top_latents_filtered(
    f_x: np.ndarray,
    k: int = 5,
    min_frac: float = 0.05,
    max_frac: float = 0.5,
    act_threshold: float = 0.1,
) -> np.ndarray:
    """Max-activation latents filtered to a single-image sparsity band: active
    on 5-50% of patches — localized, not uniform and not a single spike."""
    frac_active = (f_x > act_threshold).mean(axis=0)
    in_band = (frac_active >= min_frac) & (frac_active <= max_frac)
    scores = np.where(in_band, f_x.max(axis=0), -np.inf)
    order = np.argsort(-scores)[:k]
    return order[np.isfinite(scores[order])]


SELECTORS = {
    "variance": select_top_latents_by_variance,
    "max": select_top_latents_by_max,
    "filtered": select_top_latents_filtered,
}


def normalization_from_shards(shards_dir: pathlib.Path, layer: int):
    """Derive the (per-dim mean, global scalar) normalization the reference's
    DINOv2 SAEs expect: acts' = (acts - mean) / scalar with scalar chosen so
    the mean L2 of normalized acts = sqrt(d_model). Reads the shards on the
    host (`data.IndexedDataset`)."""
    from ..data import IndexedConfig, IndexedDataset

    ds = IndexedDataset(IndexedConfig(shards=shards_dir, layer=layer))
    n = min(len(ds), 16384)
    rng = np.random.default_rng(0)
    idx = rng.choice(len(ds), size=n, replace=False)
    acts = np.stack([ds[int(i)]["act"] for i in idx]).astype(np.float64)
    mean = acts.mean(axis=0)
    centered = acts - mean
    d = acts.shape[1]
    scalar = float(np.linalg.norm(centered, axis=1).mean() / np.sqrt(d))
    return mean.astype(np.float32), scalar


def sae_forward(sae_cfg, params, state, patch_acts: np.ndarray):
    """(f_x, x_hat) as numpy of one image's (tokens, d_model) activations,
    through `modeling.forward` on the device that holds `params`."""
    from ..nn import modeling

    x = torch.from_numpy(np.ascontiguousarray(patch_acts, dtype=np.float32)).to(params["W_enc"].device)
    with torch.no_grad():
        out, _ = modeling.forward(sae_cfg, params, state, x)
    return out.f_x.cpu().numpy(), out.x_hats[:, -1, :].cpu().numpy()


def extract_features(model, sae_cfg, params, state, img, img_tr, layer, normalize=None):
    """Image → (patch_acts, f_x, x_hat), numpy."""
    from ..data import models as base

    rec = base.Recorder(model, model_content_tokens(model), cls_token=True, layers=[layer])
    x = img_tr(img)
    batch = np.asarray(x)[None]
    _, acts = rec(batch)
    patch_acts = acts[0, 0, 1:, :]  # strip CLS
    if normalize is not None:
        mean, scalar = normalize
        patch_acts = (patch_acts - mean) / scalar
    f_x, x_hat = sae_forward(sae_cfg, params, state, patch_acts)
    return patch_acts, f_x, x_hat


def model_content_tokens(model) -> int:
    # For square grids; flexible-grid models pass content_tokens explicitly.
    return getattr(model, "_content_tokens", None) or 256


def save_heatmaps(disp, f_x: np.ndarray, latents, patch_size: int, out: pathlib.Path) -> list[pathlib.Path]:
    """One PNG a latent: its patch activations over `disp`, scaled to its
    largest value."""
    from .. import viz

    out.mkdir(parents=True, exist_ok=True)
    paths = []
    for latent in latents:
        acts_p = f_x[:, int(latent)].astype(np.float64)
        heat = viz.add_highlights(disp, acts_p, patch_size, upper=max(float(acts_p.max()), 1e-9))
        fpath = out / f"latent_{int(latent)}.png"
        heat.save(fpath)
        paths.append(fpath)
        logger.info("Saved %s (max act %.3f)", fpath, acts_p.max())
    return paths


def run(cfg: RunConfig) -> dict:
    """Returns {"latents", "f_x", "patch_acts", "paths"} of the image."""
    from PIL import Image

    from .. import nn
    from ..data import models as base

    logging.basicConfig(level=logging.INFO)
    model_cls = base.load_model_cls(cfg.family)
    model = model_cls(cfg.ckpt, device=cfg.device)
    model._content_tokens = cfg.content_tokens
    img_tr, _ = model_cls.make_transforms(cfg.ckpt, cfg.content_tokens)
    sae_cfg, params, state = nn.load(cfg.sae_ckpt, device=cfg.device)

    normalize = None
    if cfg.normalize_from is not None:
        normalize = normalization_from_shards(cfg.normalize_from, cfg.layer)
        logger.info("Normalizing with scalar %.4f from %s", normalize[1], cfg.normalize_from)

    img = Image.open(cfg.image)
    layer = cfg.layer % model.n_layers
    patch_acts, f_x, _ = extract_features(model, sae_cfg, params, state, img, img_tr, layer, normalize)

    latents = SELECTORS[cfg.select](f_x, k=cfg.k)
    logger.info("Selected latents: %s", latents.tolist())

    resize = model_cls.make_resize(cfg.ckpt, cfg.content_tokens)
    disp = resize(img.convert("RGB"))
    paths = save_heatmaps(disp, f_x, latents, model.patch_size, cfg.out)
    return {"latents": latents, "f_x": f_x, "patch_acts": patch_acts, "paths": paths}


@dataclasses.dataclass(frozen=True)
class DemoConfig:
    out: pathlib.Path = pathlib.Path("./sae_demo")
    """Output directory."""
    device: str = "cuda"
    """Where extraction, the ViT and the SAE run ("cpu" on request)."""


def demo(cfg: DemoConfig) -> list[pathlib.Path]:
    """Hermetic end-to-end demo on the fake backend: extract a small shard
    set, initialize a tiny SAE, then visualize latents on a fake image.
    Returns the heatmaps' paths."""
    import shutil
    import tempfile

    from PIL import Image

    from ..data import datasets, extract, fake_vit
    from ..data import models as base
    from ..nn import modeling

    logging.basicConfig(level=logging.INFO)
    tmp = pathlib.Path(tempfile.mkdtemp())
    try:
        shards_root = tmp / "saev" / "shards"
        shards_root.mkdir(parents=True)
        extract.worker_fn(
            family="fake-clip", ckpt=fake_vit.CKPT,
            content_tokens_per_example=fake_vit.N_PATCHES, cls_token=True,
            d_model=fake_vit.D_MODEL, layers=[0],
            data=datasets.FakeImg(n_examples=32), batch_size=8, n_workers=2,
            max_tokens_per_shard=4096, shards_root=shards_root, device=cfg.device,
        )
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    sae_cfg = modeling.SparseAutoencoderConfig(
        d_model=fake_vit.D_MODEL, d_sae=64, activation=modeling.TopK(top_k=4)
    )
    params, state = modeling.init(sae_cfg, torch.Generator(cfg.device).manual_seed(0), device=cfg.device)

    model = base.load_model_cls("fake-clip")(fake_vit.CKPT, device=cfg.device)
    model._content_tokens = fake_vit.N_PATCHES
    img_tr, _ = model.make_transforms(fake_vit.CKPT, fake_vit.N_PATCHES)
    img = datasets.FakeImgDataset(datasets.FakeImg(n_examples=1))[0]["data"]
    if not isinstance(img, Image.Image):
        img = Image.fromarray(np.asarray(img))

    _, f_x, _ = extract_features(model, sae_cfg, params, state, img, img_tr, 0)
    latents = select_top_latents_by_max(f_x, k=3)
    disp = model.make_resize(fake_vit.CKPT, fake_vit.N_PATCHES)(img.convert("RGB"))
    paths = save_heatmaps(disp, f_x, latents, model.patch_size, cfg.out)
    logger.info("Demo wrote %d heatmaps to %s", len(latents), cfg.out)
    return paths


if __name__ == "__main__":
    from ..utils import cli as cli_mod

    cli_mod.run({"run": run, "demo": demo})
