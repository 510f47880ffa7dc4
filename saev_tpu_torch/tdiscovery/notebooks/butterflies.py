"""Butterfly segmentation-mask gallery: dataset → palette-rendered previews.

The port's copy of `contrib/trait_discovery/notebooks/butterflies.py`:
the same cells, environment variables, defaults, printed lines and
artifacts, on saev_tpu_torch (no JAX).

Capability mirror of the reference's marimo notebook
(`contrib/trait_discovery/notebooks/butterflies.py`, 84 lines): render a
dataset's segmentation masks with a distinct-color palette next to the
images, as a quick data-quality gallery. Palette machinery lives in
`saev_tpu_torch.viz` (load_palette/_distinct_colors).

Env: BF_ROOT=<formatted butterfly segfolder> [BF_N=12] [BF_OUT=./figures/butterflies]
"""

# %%
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[3]))

import numpy as np  # noqa: E402
from PIL import Image  # noqa: E402

import saev_tpu_torch.viz  # noqa: E402
from saev_tpu_torch.data import datasets  # noqa: E402

ROOT = os.environ.get("BF_ROOT", "")
N = int(os.environ.get("BF_N", "12"))
OUT = pathlib.Path(os.environ.get("BF_OUT", "./figures/butterflies"))


def make_seg(seg: Image.Image, palette: list) -> Image.Image:
    """Palette-rendered RGB view of a paletted/grayscale mask (reference
    butterflies.py make_seg :35-52)."""
    seg_np = np.asarray(seg)
    rgb = np.zeros((*seg_np.shape, 3), dtype=np.uint8)
    for value in np.unique(seg_np):
        rgb[seg_np == value] = palette[int(value) % len(palette)]
    return Image.fromarray(rgb)


# %%
if __name__ == "__main__":
    if not ROOT:
        raise SystemExit("Set BF_ROOT to a formatted butterfly segfolder.")
    cfg = datasets.ImgSegFolder(root=pathlib.Path(ROOT))
    # The identity mask transform surfaces the raw segmentation mask in the
    # sample's patch_labels slot.
    ds = datasets.get_dataset(cfg, mask_transform=lambda seg: seg)
    palette = [
        tuple(int(c * 255) for c in rgb)
        for rgb in saev_tpu_torch.viz._distinct_colors(64, [])
    ]
    OUT.mkdir(parents=True, exist_ok=True)
    for i in range(min(N, len(ds))):
        sample = ds[i]
        img = sample["data"]
        seg = sample.get("patch_labels")
        if seg is None:
            continue
        if not isinstance(seg, Image.Image):
            seg = Image.fromarray(np.asarray(seg, dtype=np.uint8))
        pair = Image.new("RGB", (img.width * 2, img.height))
        pair.paste(img, (0, 0))
        pair.paste(make_seg(seg, palette).resize(img.size, Image.NEAREST),
                   (img.width, 0))
        pair.save(OUT / f"pair_{i}.png")
        print(f"Saved {OUT / f'pair_{i}.png'}")
