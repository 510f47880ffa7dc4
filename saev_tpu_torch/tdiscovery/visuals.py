"""Top-activating-image grids per SAE latent (counterpart of
contrib/trait_discovery/src/tdiscovery/visuals.py; reference Config :37,
Example :89, worker_fn :191-443): reads the inference artifacts
(token_acts.npz CSR + mean_values/sparsity), ranks examples per latent with
the streaming `helpers.csr_topk`, writes `var.parquet` (per-latent stats +
top-k example ids), and renders per-latent image folders with activation
heatmaps (and segmentation overlays when available).

As in contrib, the parquet is pandas' (with pyarrow) and the default palette
`viz._distinct_colors`. Host-only: Pillow and pandas are imported where
used, matplotlib only for the activation-distribution figure; each raises
an ImportError that names it where it is missing. The model family is
built on the CPU, since only its patch size and resize are read.
"""

import dataclasses
import logging
import os
import pathlib
import random

import numpy as np
import scipy.sparse

from .. import disk, helpers, viz
from ..data import Metadata, datasets, models
from ..data import shards as shards_mod

logger = logging.getLogger("visuals")


@dataclasses.dataclass(frozen=True)
class Config:
    """Configuration for latent visualization (reference visuals.py:37-84)."""

    run: pathlib.Path = pathlib.Path("./runs/016lmihg")
    """Run directory."""
    shards: pathlib.Path = pathlib.Path("./shards/abcdef01")
    """Activations."""
    img_scale: float = 1.0
    """How much to scale images by (use higher numbers for high-res visuals)."""
    ignore_labels: tuple[int, ...] = ()
    """Which patch labels to ignore when calculating summarized image activations."""
    palette: pathlib.Path | None = None
    """Path to a palette .txt file."""
    save_seg: bool = True
    """Whether to render segmentation maps."""
    log_freq_range: tuple[float, float] = (-6.0, 1.0)
    """Log10 frequency range for which to save images."""
    log_value_range: tuple[float, float] = (-3.0, 3.0)
    """Log10 value range for which to save images."""
    latents: tuple[int, ...] = ()
    """Latents to always include, no matter what."""
    n_distributions: int = 25
    """Number of latents to plot activation distributions for."""
    save_distributions: bool = True
    """Whether to render the activation-distribution grid figure."""
    n_latents: int = 400
    """Number of latents to save images for."""
    top_k: int = 20
    """Number of top images to visualize per feature."""
    seed: int = 42
    """Random seed."""
    slurm_acct: str = ""
    slurm_partition: str = ""
    n_hours: float = 2.0
    mem_gb: int = 80
    log_to: str = os.path.join(".", "logs")


@dataclasses.dataclass(frozen=True)
class Example:
    img: object  # a PIL image
    seg: object | None
    tokens: np.ndarray  # (content_tokens_per_example,)
    idx: int


def _load_pt(path: pathlib.Path) -> np.ndarray:
    import torch

    return torch.load(path, weights_only=True, map_location="cpu").numpy()


def worker_fn(cfg: Config) -> None:
    """Generate visual outputs for particular latents (reference visuals.py:191-443)."""
    run = disk.Run(cfg.run)
    art = run.inference / cfg.shards.name
    try:
        token_acts = scipy.sparse.load_npz(art / "token_acts.npz").tocsr()
        mean_values_s = _load_pt(art / "mean_values.pt")
        sparsity_s = _load_pt(art / "sparsity.pt")
    except FileNotFoundError as err:
        logger.error("Required activation files not found: %s. Run inference.", err)
        return
    d_sae = token_acts.shape[1]
    assert mean_values_s.size == d_sae
    assert sparsity_s.size == d_sae

    md = Metadata.load(cfg.shards)
    model = models.load_model_cls(md.family)(md.ckpt, device="cpu")
    resize_tr = model.make_resize(
        md.ckpt, md.content_tokens_per_example, scale=cfg.img_scale
    )
    seg_resize_tr = model.make_resize(
        md.ckpt, md.content_tokens_per_example, scale=cfg.img_scale,
        resample="NEAREST",
    )
    img_cfg = md.make_data_cfg()
    img_ds = datasets.get_dataset(
        img_cfg, data_transform=resize_tr, mask_transform=seg_resize_tr
    )
    logger.info("Loaded data.")

    # Streaming top-k over the CSR activation matrix (helpers.csr_topk,
    # reference helpers.py:537-710).
    topk = helpers.csr_topk(token_acts, k=cfg.top_k, axis=0)
    topk_example_idx = topk.indices // md.content_tokens_per_example  # (k, d_sae)

    with np.errstate(divide="ignore"):
        log10_freq = np.log10(sparsity_s)
        log10_value = np.log10(mean_values_s)

    pd = helpers.optional_import("pandas", "tdiscovery.visuals's var.parquet")

    var_df = pd.DataFrame({
        "feature": np.arange(d_sae),
        "log10_freq": log10_freq,
        "log10_value": log10_value,
        "topk_example_idx": list(topk_example_idx.T),
    })
    var_fpath = art / "var.parquet"
    var_df.to_parquet(var_fpath)
    logger.info("Saved var.parquet with %d rows to '%s'.", len(var_df), var_fpath)

    min_lf, max_lf = cfg.log_freq_range
    min_lv, max_lv = cfg.log_value_range
    band = (
        (min_lf < log10_freq) & (log10_freq < max_lf)
        & (min_lv < log10_value) & (log10_value < max_lv)
    )

    features = list(cfg.latents)
    random_features = np.arange(d_sae)[band].tolist()
    random.seed(cfg.seed)
    random.shuffle(random_features)
    features += random_features[: cfg.n_latents]

    topk_ex = topk_example_idx.T[features]  # (n_feat, k)
    ctpe = md.content_tokens_per_example
    patch_size = int(model.patch_size * cfg.img_scale)

    palette = None
    if cfg.save_seg:
        if cfg.palette is not None:
            palette = viz.load_palette(cfg.palette)
        else:
            palette = viz._distinct_colors(256, [])
        logger.info("Generated palette with %d colors.", len(palette))

    for f_i, f in enumerate(
        helpers.progress(features, desc="saving imgs", every=1)
    ):
        feature_dir = art / "images" / str(f)
        feature_dir.mkdir(exist_ok=True, parents=True)

        token_idx = (
            topk_ex[f_i][:, None] * ctpe + np.arange(ctpe)[None, :]
        )  # (k, ctpe)
        token_values = np.asarray(
            token_acts[token_idx.ravel()][:, f].todense()
        ).reshape(cfg.top_k, ctpe)

        examples, seen = [], set()
        for example_idx, token_values_p in zip(topk_ex[f_i].tolist(), token_values):
            if example_idx in seen:
                continue
            sample = img_ds[example_idx]
            examples.append(
                Example(
                    img=sample["data"],
                    seg=sample.get("patch_labels"),
                    tokens=token_values_p,
                    idx=example_idx,
                )
            )
            seen.add(example_idx)

        upper = float(token_values.max())
        for j, example in enumerate(examples):
            display = example.tokens.copy()
            # The dataset's mask_transform yields a FULL-RESOLUTION pixel
            # mask; both the ignore-mask and the seg renders need per-patch
            # labels (same conversion the extraction worker applies,
            # shards.pixel_to_patch_labels).
            patch_seg = None
            if example.seg is not None:
                patch_seg = shards_mod.pixel_to_patch_labels(
                    np.asarray(example.seg.convert("L")), ctpe, patch_size
                )
            if cfg.ignore_labels and patch_seg is not None:
                display = np.where(
                    np.isin(patch_seg, cfg.ignore_labels), 0.0, display
                )
            display = display.astype(np.float64)

            # Reference file layout (visuals.py:337-364): original, highlighted
            # original, flat segmentation, highlighted segmentation.
            example.img.save(feature_dir / f"{j}_img.png")
            viz.add_highlights(
                example.img, display, patch_size, upper=max(upper, 1e-9)
            ).save(feature_dir / f"{j}_sae_img.png")

            if cfg.save_seg and patch_seg is not None and palette is not None:
                seg_img = _render_seg(patch_seg, palette, patch_size, example.img.size)
                seg_img.save(feature_dir / f"{j}_seg.png")
                viz.add_highlights(
                    seg_img, display, patch_size, upper=max(upper, 1e-9)
                ).save(feature_dir / f"{j}_sae_seg.png")

    logger.info("Saved images for %d features.", len(features))

    if cfg.save_distributions:
        try:
            distributions = _load_pt(art / "distributions.pt")
        except FileNotFoundError:
            logger.info("No distributions.pt; skipping distribution figure.")
            return
        fig = plot_activation_distributions(cfg, distributions)
        fig_fpath = art / f"{cfg.n_distributions}_activation_distributions.png"
        fig.savefig(fig_fpath, dpi=150)
        logger.info("Saved activation distributions to '%s'.", fig_fpath)


def plot_activation_distributions(cfg: Config, distributions: np.ndarray):
    """Log-log histogram grid of per-latent activation distributions
    (reference plot_activation_distributions, visuals.py:98-149)."""
    helpers.optional_import("matplotlib", "tdiscovery.visuals's distribution figure").use("Agg")
    plt = helpers.optional_import("matplotlib.pyplot", "tdiscovery.visuals's distribution figure")

    # distributions.pt is (n_samples, n_dists): COLUMNS are the first
    # n_dists latents (framework/inference.py artifact layout).
    m = min(cfg.n_distributions, distributions.shape[1])
    n_cols = int(np.ceil(np.sqrt(m)))
    n_rows = int(np.ceil(m / n_cols))
    fig, axes = plt.subplots(
        n_rows, n_cols, figsize=(2.2 * n_cols, 1.8 * n_rows), squeeze=False
    )
    for i in range(n_rows * n_cols):
        ax = axes[i // n_cols][i % n_cols]
        if i >= m:
            ax.axis("off")
            continue
        vals = np.asarray(distributions[:, i], dtype=np.float64)
        vals = vals[vals > 0]
        if vals.size:
            bins = np.logspace(
                np.log10(max(vals.min(), 1e-9)), np.log10(vals.max() + 1e-9), 20
            )
            ax.hist(vals, bins=bins, color="#1f78b4")
            ax.set_xscale("log")
            ax.set_yscale("log")
        ax.set_title(f"latent {i}", fontsize=6)
        ax.tick_params(labelsize=5)
    fig.tight_layout()
    return fig


def _render_seg(
    patch_labels: np.ndarray,
    palette: list[tuple[float, float, float]],
    patch_size: int,
    img_size: tuple[int, int],
):
    """Render per-patch labels as a flat-color image (reference make_seg,
    visuals.py:151-183)."""
    image = helpers.optional_import("PIL.Image", "tdiscovery.visuals")
    w, h = img_size
    wp = w // patch_size
    labels2d = np.asarray(patch_labels).reshape(-1, wp)
    rgb = np.zeros((*labels2d.shape, 3), dtype=np.uint8)
    for label in np.unique(labels2d):
        color = palette[int(label) % len(palette)]
        rgb[labels2d == label] = [int(c * 255) for c in color]
    return image.fromarray(rgb).resize(img_size, image.NEAREST)


def cli(cfg: Config) -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s",
    )
    worker_fn(cfg)
