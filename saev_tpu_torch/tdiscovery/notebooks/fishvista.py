"""FishVista dataset exploration: aspect ratios, patch-grid resizing previews.

The port's copy of `contrib/trait_discovery/notebooks/fishvista.py`:
the same cells, environment variables, defaults, printed lines and
artifacts, on saev_tpu_torch (no JAX).

Capability mirror of the reference's marimo notebook
(`contrib/trait_discovery/notebooks/fishvista.py`, 369 lines): histogram the
dataset's native aspect ratios, preview `resize_to_patch_grid` outputs with
their ratio/patch-count stats, and print the achievable aspect-ratio menu per
patch budget. The resize math lives in `saev_tpu_torch.data.transforms`
(resize_to_patch_grid, aspect_ratios — tested in tests/test_transforms*.py).

Env: FV_ROOT=<formatted FishVista segfolder> [FV_N=1000] [FV_PATCH=16]
     [FV_BUDGET=192] [FV_OUT=./figures/fishvista]
"""

# %%
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[3]))

from PIL import Image  # noqa: E402

from saev_tpu_torch.data import datasets, transforms  # noqa: E402

ROOT = os.environ.get("FV_ROOT", "")
N = int(os.environ.get("FV_N", "1000"))
PATCH = int(os.environ.get("FV_PATCH", "16"))
BUDGET = int(os.environ.get("FV_BUDGET", "192"))
OUT = pathlib.Path(os.environ.get("FV_OUT", "./figures/fishvista"))

# %% [markdown]
# ## Achievable aspect-ratio menu per patch budget
# `resize_to_patch_grid` snaps each image to the nearest r*c == N grid shape;
# this is the menu it chooses from (reference fishvista.py:145-172).

# %%
if __name__ == "__main__":
    for n in range(128, 1280, 128):
        usable = [r for r in transforms.aspect_ratios(n) if 0.1 < r <= 8]
        print(f"N={n}: {len(usable)} usable ratios, e.g. {usable[:6]}")

    # %% [markdown]
    # ## Dataset aspect-ratio histogram + resize previews

    # %%
    if ROOT:
        cfg = datasets.ImgSegFolder(root=pathlib.Path(ROOT))
        ds = datasets.get_dataset(cfg)
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        ratios = []
        for i in range(min(N, len(ds))):
            img = ds[i]["data"]
            ratios.append(img.size[0] / img.size[1])
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.hist(ratios, bins=40)
        ax.set_xlabel("native aspect ratio (w/h)")
        ax.set_ylabel("images")
        OUT.mkdir(parents=True, exist_ok=True)
        fig.savefig(OUT / "aspect_hist.png", dpi=120)
        print(f"Saved {OUT / 'aspect_hist.png'} over {len(ratios)} images")

        for i in range(min(4, len(ds))):
            img = ds[i]["data"]
            resized = transforms.resize_to_patch_grid(img, p=PATCH, n=BUDGET)
            w, h = img.size
            rw, rh = resized.size
            n_patches = (rw // PATCH) * (rh // PATCH)
            assert n_patches == BUDGET, (n_patches, BUDGET)
            print(
                f"sample {i}: ratio {w / h:.3f} -> {rw / rh:.3f}, "
                f"{resized.size} px, {n_patches} patches"
            )
            resized.save(OUT / f"resized_{i}.png")
    else:
        print("Set FV_ROOT to preview a formatted FishVista segfolder.")
