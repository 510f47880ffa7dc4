"""Image transforms shared by training, figures, and the web app.

Counterpart of contrib/interactive_interp/classification/transforms.py
(reference :19 for_training, :25 for_figures, :37 for_webapp). The contract:
every surface sees the same object-centric crop — resize so the shortest
side is 512 px, then take the centered 448x448 window — so patch coordinates
computed in one place (e.g. the web app) line up with activations extracted
in another. The functions take and return Pillow images; Pillow is imported
where it is used, so the module imports without it.
"""

import numpy as np

SHORT_SIDE = 512
CROP = 448


def for_training(family: str, ckpt: str):
    """The model family's own data transform (what extraction uses)."""
    from ...data import models

    data_tr, _ = models.load_model_cls(family).make_transforms(
        ckpt, content_tokens_per_example=196
    )
    return data_tr


def resize_shortest(img, short: int = SHORT_SIDE):
    """Resize so min(w, h) == short, preserving aspect ratio (bicubic)."""
    from PIL import Image

    w, h = img.size
    if w > h:
        size = (round(w * short / h), short)
    else:
        size = (short, round(h * short / w))
    return img.resize(size, resample=Image.Resampling.BICUBIC)


def center_crop(img, crop: int = CROP):
    w, h = img.size
    left = (w - crop) / 2
    top = (h - crop) / 2
    return img.crop((left, top, left + crop, top + crop))


def for_webapp(img):
    """Resize-512 + center-crop-448, returning a PIL image for the browser."""
    return center_crop(resize_shortest(img))


def for_figures(img) -> np.ndarray:
    """Same geometry as the web app, as an (448, 448, 3) uint8 array for
    matplotlib compositing."""
    return np.asarray(for_webapp(img.convert("RGB")))
