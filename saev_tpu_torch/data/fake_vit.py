"""Fake ViT family ("fake-clip") for fast hermetic tests (the counterpart of
saev_tpu/data/fake_vit.py).

A tiny pre-LN ViT (8x8 images, 2x2 patches, 16 content tokens + CLS,
d_model=128, 3 blocks, tanh GELU, LayerNorm eps 1e-5) in the params layout of
the JAX package's `_make_params`, run on the shared engine (`models.vit`).
Its weights are drawn from a seeded `torch.Generator`: they have the JAX
package's shapes and scales, not its values, which come from `jax.random`.
`Vit(ckpt, params=...)` takes any tree of that layout instead, the JAX
package's included, and carries it to `device` once.
"""

from collections.abc import Callable

import numpy as np
import torch

from ..models import vit
from . import models, transforms

D_MODEL = 128
N_LAYERS = 3
N_HEADS = 4
IMG_SIZE = 8
PATCH_SIZE = 2
N_PATCHES = (IMG_SIZE // PATCH_SIZE) ** 2  # 16
SEQ = N_PATCHES + 1  # CLS + patches
GRID = (IMG_SIZE // PATCH_SIZE, IMG_SIZE // PATCH_SIZE)

CKPT = "hf-hub:hf-internal-testing/tiny-open-clip-model"

SPEC = vit.Spec(
    d_model=D_MODEL, n_layers=N_LAYERS, n_heads=N_HEADS, patch_size=PATCH_SIZE,
    act="gelu_tanh", ln_eps=1e-5, pos_kind="learned",
)
"""The engine's view of the fake model: jax.nn.gelu's default is the tanh
form, and the fake's LayerNorm takes eps 1e-5 (saev_tpu/data/fake_vit.py:63-95)."""


def _make_params(seed: int) -> dict:
    """Random weights in saev_tpu/data/fake_vit.py:_make_params's layout and
    scales, drawn from a seeded torch.Generator on the CPU."""
    g = torch.Generator().manual_seed(seed)

    def normal(*shape, scale):
        return torch.randn(shape, generator=g) * scale

    def dense(d_in, d_out):
        return {"w": normal(d_in, d_out, scale=1.0 / np.sqrt(d_in)), "b": torch.zeros(d_out)}

    def ln():
        return {"g": torch.ones(D_MODEL), "b": torch.zeros(D_MODEL)}

    params = {
        "patch_embed": dense(3 * PATCH_SIZE * PATCH_SIZE, D_MODEL),
        "cls": normal(D_MODEL, scale=0.02),
        "pos": normal(SEQ, D_MODEL, scale=0.02),
        "blocks": [],
        "ln_f": ln(),
    }
    for _ in range(N_LAYERS):
        params["blocks"].append({
            "ln1": ln(),
            "qkv": dense(D_MODEL, 3 * D_MODEL),
            "proj": dense(D_MODEL, D_MODEL),
            "ln2": ln(),
            "fc1": dense(D_MODEL, 4 * D_MODEL),
            "fc2": dense(4 * D_MODEL, D_MODEL),
        })
    return params


def engine_params(params: dict) -> dict:
    """The fake's layout → the engine's (attention and MLP under their own keys)."""
    return {
        "patch_embed": params["patch_embed"],
        "cls": params["cls"],
        "pos": params["pos"],
        "ln_f": params["ln_f"],
        "blocks": [
            {
                "ln1": blk["ln1"],
                "attn": {"qkv": blk["qkv"], "proj": blk["proj"]},
                "ln2": blk["ln2"],
                "mlp": {"fc1": blk["fc1"], "fc2": blk["fc2"]},
            }
            for blk in params["blocks"]
        ],
    }


class Vit(models.Transformer):
    """Tiny deterministic ViT registered as family "fake-clip"."""

    family: str = "fake-clip"

    def __init__(
        self,
        ckpt: str,
        *,
        params: dict | None = None,
        device: str = "cuda",
        precision: str = "default",
    ):
        assert ckpt == CKPT, f"FakeVit only supports the tiny test checkpoint, got {ckpt}"
        self._ckpt = ckpt
        self.precision = precision
        if params is None:
            params = _make_params(seed=0)
        self.params = vit.to_device(engine_params(params), device)

    @property
    def ckpt(self) -> str:
        return self._ckpt

    @property
    def patch_size(self) -> int:
        return PATCH_SIZE

    @property
    def d_model(self) -> int:
        return D_MODEL

    @property
    def n_layers(self) -> int:
        return N_LAYERS

    @staticmethod
    def make_transforms(
        ckpt: str, content_tokens_per_example: int
    ) -> tuple[Callable, Callable | None]:
        def img_transform(img) -> np.ndarray:
            img = img.convert("RGB").resize(
                (IMG_SIZE, IMG_SIZE), transforms.resample_filter("BICUBIC")
            )
            return transforms.to_chw_float(img, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5))

        return img_transform, None

    @staticmethod
    def make_resize(
        ckpt: str,
        content_tokens_per_example: int = -1,
        *,
        scale: float = 1.0,
        resample: str | int = "LANCZOS",
    ) -> Callable:
        def resize(img):
            size_px = (int(IMG_SIZE * scale), int(IMG_SIZE * scale))
            return img.resize(size_px, resample=transforms.resample_filter(resample))

        return resize

    def get_token_i(self, content_tokens_per_example: int) -> slice:
        return slice(None, None, None)

    def forward_recorded(
        self, batch: np.ndarray, layers: tuple[int, ...], **kwargs
    ) -> tuple[np.ndarray, np.ndarray]:
        """(B, 3, 8, 8) images → (pooled CLS after ln_f, taps). Negative
        layer indices are allowed, as in the shared engine."""
        x = np.asarray(batch, dtype=np.float32)
        b = x.shape[0]
        hp = IMG_SIZE // PATCH_SIZE
        tokens = (
            x.reshape(b, 3, hp, PATCH_SIZE, hp, PATCH_SIZE)
            .transpose(0, 2, 4, 1, 3, 5)
            .reshape(b, N_PATCHES, 3 * PATCH_SIZE * PATCH_SIZE)
        )
        out, taps = vit.run(SPEC, self.params, tokens, tuple(layers), GRID, precision=self.precision)
        return out[:, 0, :], taps


models.register_family(Vit)
