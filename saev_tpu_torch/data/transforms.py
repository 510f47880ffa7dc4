"""Image → token transforms: flexible patch-grid resizing and patchification
(the counterpart of saev_tpu/data/transforms.py).

Numpy/PIL re-implementation of the reference's `src/saev/data/transforms.py:15-141`
(which uses torchvision). Patchify is the host-side half of the "unfolded
conv": images become (N, c*p*p) token matrices so the model's patch embedding
is a single product instead of a conv. `patchify`, `unfolded_conv2d` and
`to_chw_float` are numpy; Pillow is imported only by the functions that resize
an image, and resampling filters are given by name ("LANCZOS", "NEAREST", ...)
and resolved then (`resample_filter`).
"""

import math
import typing as tp

import numpy as np


def resample_filter(resample: str | int) -> int:
    """A Pillow resampling filter from its name ("LANCZOS", "BICUBIC",
    "NEAREST", ...) or as given when it is already a filter."""
    if not isinstance(resample, str):
        return resample
    from PIL import Image

    return getattr(Image.Resampling, resample.upper())


def resize_to_patch_grid(
    img,
    *,
    p: int,
    n: int,
    resample: str | int = "LANCZOS",
):
    """Resize image to (w, h) such that w % p == 0, h % p == 0,
    (h/p)*(w/p) == n, minimizing aspect-ratio distortion.

    Mirrors reference transforms.py:37-75.
    """
    if p <= 0 or n <= 0:
        raise ValueError("p and n must be positive integers")

    w0, h0 = img.size
    a0 = w0 / h0

    best_c = 0
    best_dist = float("inf")
    for i in range(1, int(math.sqrt(n) + 1)):
        if n % i != 0:
            continue
        for d in (i, n // i):
            c, r = d, n // d
            dist = abs(c / r - a0)
            if dist < best_dist:
                best_c = d
                best_dist = dist

    c = best_c
    r = n // c
    return img.resize((c * p, r * p), resample=resample_filter(resample))


def aspect_ratios(n: int) -> list[float]:
    """Sorted aspect ratios (w/h) achievable with an r*c == n patch grid —
    the menu of shapes `resize_to_patch_grid` can snap an image to (reference
    contrib/trait_discovery/notebooks/fishvista.py:145-166)."""
    import fractions

    if n <= 0:
        raise ValueError("n must be a positive integer")
    ratios = set()
    r = 1
    while r * r <= n:
        if n % r == 0:
            c = n // r
            ratios.add(fractions.Fraction(c, r))
            ratios.add(fractions.Fraction(r, c))
        r += 1
    return [float(x) for x in sorted(ratios, key=float)]


class FlexResize:
    """Callable resizing a PIL image onto an exact n-patch grid."""

    def __init__(
        self,
        patch_size: int,
        n_patches: int,
        resample: str | int = "LANCZOS",
    ):
        self.patch_size = patch_size
        self.n_patches = n_patches
        self.resample = resample

    def __call__(self, inpt: tp.Any):
        from PIL import Image

        if isinstance(inpt, Image.Image):
            return resize_to_patch_grid(
                inpt, p=self.patch_size, n=self.n_patches, resample=self.resample
            )
        raise TypeError(type(inpt))


def patchify(img_chw: np.ndarray, patch_size: int) -> tuple[np.ndarray, np.ndarray]:
    """(c, h, w) image → ((hp*wp, c*p*p) tokens, grid=(hp, wp)).

    Token order matches the reference's einops rearrange
    `c (hp p1) (wp p2) -> (hp wp) (c p1 p2)` (transforms.py:93-95).
    """
    c, h, w = img_chw.shape
    p = patch_size
    assert (h % p == 0) and (w % p == 0), f"Got {h}x{w}, patch={p}"
    hp, wp = h // p, w // p
    tokens = (
        img_chw.reshape(c, hp, p, wp, p)
        .transpose(1, 3, 0, 2, 4)
        .reshape(hp * wp, c * p * p)
    )
    grid = np.array([hp, wp], dtype=np.int16)
    return np.ascontiguousarray(tokens), grid


class Patchify:
    """Sample-dict transform: rewrites sample[key] (c,h,w) into patch tokens and adds
    sample['grid'] = (hp, wp). Mirrors reference transforms.py:79-102.
    """

    def __init__(self, patch_size: int, n_patches: int, key: str = "data"):
        self.patch_size = patch_size
        self.n_patches = n_patches
        self.key = key

    def __call__(self, sample: dict[str, object]) -> dict[str, object]:
        assert self.key in sample
        img = np.asarray(sample[self.key])
        tokens, grid = patchify(img, self.patch_size)
        n, d = tokens.shape
        assert n == self.n_patches, f"Expected n={self.n_patches}, got {n}"
        sample[self.key] = tokens
        sample["grid"] = grid
        return sample


def unfolded_conv2d(
    x_bchw: np.ndarray,
    weight_dckk: np.ndarray,
    bias_d: np.ndarray | None = None,
) -> np.ndarray:
    """Non-overlapping conv2d as patchify + matmul: returns tokens (B, L, D).

    Equivalent to a Conv2d with stride == kernel_size, padding 0, groups 1 — the
    patch-embedding primitive that maps to a single product.
    Mirrors reference transforms.py:106-132.
    """
    d_out, c, k, k2 = weight_dckk.shape
    assert k == k2
    b, c2, h, w = x_bchw.shape
    assert c == c2 and h % k == 0 and w % k == 0

    hp, wp = h // k, w // k
    tokens = (
        x_bchw.reshape(b, c, hp, k, wp, k)
        .transpose(0, 2, 4, 1, 3, 5)
        .reshape(b, hp * wp, c * k * k)
    )
    w_dp = weight_dckk.reshape(d_out, c * k * k)
    out = tokens @ w_dp.T
    if bias_d is not None:
        out = out + bias_d[None, None, :]
    return out


def to_chw_float(img, *, mean=None, std=None) -> np.ndarray:
    """PIL RGB image → normalized float32 (c, h, w) in [0, 1] (then standardized)."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None].repeat(3, axis=2)
    arr = arr.transpose(2, 0, 1)
    if mean is not None:
        arr = arr - np.asarray(mean, dtype=np.float32)[:, None, None]
    if std is not None:
        arr = arr / np.asarray(std, dtype=np.float32)[:, None, None]
    return arr
