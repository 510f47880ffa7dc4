"""Paper-figure assets for interactive_interp: patch montages + highlights.

Counterpart of contrib/interactive_interp/scripts/make_figures.py (reference
make_figures.py :48-250): split an image into its ViT patch grid and save
individual patch tiles, save a binary-mask highlight overlay (flat rose fill
per selected patch, alpha-composited), bar-chart probability panels for the
before/after-intervention figure, and a colorbar legend. All functions are
pure file-in/file-out so the same commands regenerate every figure asset.
Host only (Pillow, matplotlib), each imported where it is used.

Usage:
    python -m saev_tpu_torch.interactive_interp.scripts.make_figures overview \\
        --image in.jpg --out figures/ --patches 0,17
"""

import dataclasses
import logging
import math
import pathlib

logger = logging.getLogger("ii.figures")


def add_highlights(img, patches: list[bool]):
    """Flat binary-mask overlay: each selected patch filled rose at 50% alpha
    (reference add_highlights :48-75 — distinct from viz's value-weighted
    heatmap)."""
    from PIL import Image, ImageDraw

    if not patches:
        return img
    side = int(math.sqrt(len(patches)))
    assert side * side == len(patches), (
        f"patch list of length {len(patches)} is not a square grid"
    )
    iw, ih = img.size
    pw, ph = iw // side, ih // side

    overlay = Image.new("RGBA", img.size, (0, 0, 0, 0))
    draw = ImageDraw.Draw(overlay)
    for p, on in enumerate(patches):
        if not on:
            continue
        x, y = p % side, p // side
        draw.rectangle(
            [(x * pw, y * ph), (x * pw + pw, y * ph + ph)],
            fill=(225, 29, 72, 128),
        )
    return Image.alpha_composite(img.convert("RGBA"), overlay)


def patchify(
    img, grid: int, out: pathlib.Path, *, stem: str,
    keep: list[int] | None = None,
) -> list[pathlib.Path]:
    """Save individual patch tiles `<stem>_patch<i>.png` (reference
    make_figure_semseg patch export :87-103)."""
    iw, ih = img.size
    pw, ph = iw // grid, ih // grid
    out.mkdir(parents=True, exist_ok=True)
    saved = []
    for p in range(grid * grid) if keep is None else keep:
        x, y = p % grid, p // grid
        tile = img.crop((x * pw, y * ph, x * pw + pw, y * ph + ph))
        fpath = out / f"{stem}_patch{p}.png"
        tile.save(fpath)
        saved.append(fpath)
    return saved


@dataclasses.dataclass(frozen=True)
class Overview:
    image: pathlib.Path = pathlib.Path("./starfish.jpg")
    out: pathlib.Path = pathlib.Path("./figures")
    size: int = 448
    grid: int = 16
    patches: tuple[int, ...] = ()
    """Patch indices to highlight AND export as tiles."""
    stem: str = ""


def overview(cfg: Overview) -> pathlib.Path:
    """Resize-crop -> patch tiles -> highlighted image (reference
    make_figure_overview / make_figure_semseg / make_figure_classification all
    share this skeleton; the stem names the figure)."""
    from PIL import Image

    img = Image.open(cfg.image).convert("RGB")
    w, h = img.size
    scale = cfg.size * 8 // 7 / min(w, h)  # resize short side, center crop
    img = img.resize((round(w * scale), round(h * scale)), Image.BICUBIC)
    left = (img.width - cfg.size) // 2
    top = (img.height - cfg.size) // 2
    img = img.crop((left, top, left + cfg.size, top + cfg.size))

    stem = cfg.stem or pathlib.Path(cfg.image).stem
    cfg.out.mkdir(parents=True, exist_ok=True)
    patchify(img, cfg.grid, cfg.out, stem=stem, keep=list(cfg.patches) or None)
    mask = [p in set(cfg.patches) for p in range(cfg.grid * cfg.grid)]
    highlighted = add_highlights(img, mask)
    fpath = cfg.out / f"{stem}_highlighted.png"
    highlighted.save(fpath)
    logger.info("Wrote %s (+%d patch tiles).", fpath, len(cfg.patches) or cfg.grid**2)
    return fpath


@dataclasses.dataclass(frozen=True)
class Barchart:
    values: tuple[float, ...] = ()
    labels: tuple[str, ...] = ()
    out: pathlib.Path = pathlib.Path("./figures/probs.png")
    ylim_max: float = 100.0


def barchart(cfg: Barchart) -> pathlib.Path:
    """Probability bars for the before/after-intervention panel (reference
    barchart :112-137, probs_before/probs_after :228-230)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    assert len(cfg.values) == len(cfg.labels)
    fig, ax = plt.subplots(figsize=(3.2, 2.4), layout="constrained")
    colors = ["#1f78b4", "#33a02c", "#e31a1c", "#ff7f00", "#a6cee3"]
    ax.bar(cfg.labels, cfg.values, color=colors[: len(cfg.values)])
    ax.set_ylim(0, cfg.ylim_max)
    ax.set_ylabel("probability (%)")
    ax.tick_params(axis="x", rotation=30, labelsize=8)
    cfg.out.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(cfg.out, dpi=200)
    plt.close(fig)
    return cfg.out


@dataclasses.dataclass(frozen=True)
class Legend:
    out: pathlib.Path = pathlib.Path("./figures/legend.png")
    cmap: str = "plasma"
    label: str = "SAE activation"


def legend(cfg: Legend) -> pathlib.Path:
    """Standalone colorbar legend (reference make_colorbar_legend :234-250)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import cm, colors

    fig, ax = plt.subplots(figsize=(3.2, 0.6), layout="constrained")
    fig.colorbar(
        cm.ScalarMappable(norm=colors.Normalize(0, 1), cmap=cfg.cmap),
        cax=ax, orientation="horizontal", label=cfg.label,
    )
    cfg.out.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(cfg.out, dpi=300)
    plt.close(fig)
    return cfg.out


if __name__ == "__main__":
    from ...utils import cli as cli_mod

    logging.basicConfig(level=logging.INFO)
    cli_mod.run({"overview": overview, "barchart": barchart, "legend": legend})
