"""Image ViT families: clip, siglip, dinov2, pe-core, pe-spatial (the
counterpart of saev_tpu/models/families.py).

Capability mirror of reference `src/saev/data/{clip,siglip,dinov2,pe}.py`, on
the shared torch engine (`models.vit`) with per-family weight converters
(`models.convert`). The reference downloads torch weights at runtime; here the
weights come from a local checkpoint file resolved in this order:

1. `ckpt` contains "=": "<arch>=<path>" uses the explicit file path;
2. `$SAEV_CACHE/saev_tpu/<family>/<fssafe(arch)>.{safetensors,pt,pth,bin}`;
3. otherwise a FileNotFoundError explains how to provide the file.

Preprocessing is PIL+numpy (the reference uses torchvision/open_clip transforms):
resize → center-crop → normalize with each family's published statistics.
Pillow is imported only where an image is resized; a position table that
changes its grid (DINOv2's 37 x 37 onto 16 x 16) takes `vit.interpolate_pos`,
a numpy copy of Pillow's bicubic resize, so loading needs no Pillow. The model
is built on `device` ("cuda" unless the caller asks for "cpu").
"""

import dataclasses
import pathlib
import typing as tp
from collections.abc import Callable

import numpy as np

from .. import helpers
from ..data import models as base
from ..data import transforms
from . import convert, vit

IMAGENET_MEAN = (0.4850, 0.4560, 0.4060)
IMAGENET_STD = (0.2290, 0.2240, 0.2250)
OPENAI_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_STD = (0.26862954, 0.26130258, 0.27577711)
SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)


@dataclasses.dataclass(frozen=True)
class Preset:
    spec: vit.Spec
    img_size: int
    resize_size: int
    mean: tuple[float, float, float]
    std: tuple[float, float, float]
    converter: tp.Literal["openclip", "timm"] = "timm"
    resize_mode: tp.Literal["shortest", "squash"] = "shortest"
    """Resize semantics before the center crop: "shortest" = torchvision
    Resize(int) (short edge to resize_size, aspect preserved) + CenterCrop —
    the CLIP/timm default; "squash" = Resize((s, s)) distorting to a square —
    open_clip's SigLIP preprocessing."""

    @property
    def grid(self) -> tuple[int, int]:
        g = self.img_size // self.spec.patch_size
        return (g, g)


def _clip_spec(d, layers, heads, p, *, quick=True) -> vit.Spec:
    return vit.Spec(
        d_model=d, n_layers=layers, n_heads=heads, patch_size=p,
        act="quick_gelu" if quick else "gelu",
        pre_norm=True, ln_eps=1e-5, pos_kind="learned",
    )


def _dinov2_spec(d, layers, heads, *, n_reg=0, swiglu=False, ratio=4.0) -> vit.Spec:
    return vit.Spec(
        d_model=d, n_layers=layers, n_heads=heads, patch_size=14,
        mlp_kind="swiglu" if swiglu else "gelu", mlp_ratio=ratio,
        layerscale=True, n_registers=n_reg, ln_eps=1e-6, pos_kind="learned",
    )


CLIP_PRESETS: dict[str, Preset] = {
    "ViT-B-32": Preset(_clip_spec(768, 12, 12, 32), 224, 224, OPENAI_MEAN, OPENAI_STD, "openclip"),
    "ViT-B-16": Preset(_clip_spec(768, 12, 12, 16), 224, 224, OPENAI_MEAN, OPENAI_STD, "openclip"),
    "ViT-L-14": Preset(_clip_spec(1024, 24, 16, 14), 224, 224, OPENAI_MEAN, OPENAI_STD, "openclip"),
    "ViT-L-14-336": Preset(_clip_spec(1024, 24, 16, 14), 336, 336, OPENAI_MEAN, OPENAI_STD, "openclip"),
}

DINOV2_PRESETS: dict[str, Preset] = {
    "dinov2_vits14": Preset(_dinov2_spec(384, 12, 6), 224, 256, IMAGENET_MEAN, IMAGENET_STD),
    "dinov2_vitb14": Preset(_dinov2_spec(768, 12, 12), 224, 256, IMAGENET_MEAN, IMAGENET_STD),
    "dinov2_vitl14": Preset(_dinov2_spec(1024, 24, 16), 224, 256, IMAGENET_MEAN, IMAGENET_STD),
    "dinov2_vitg14": Preset(
        _dinov2_spec(1536, 40, 24, swiglu=True, ratio=8192 / 3 / 1536), 224, 256,
        IMAGENET_MEAN, IMAGENET_STD,
    ),
}
DINOV2_PRESETS.update({
    f"{k}_reg": dataclasses.replace(
        v, spec=dataclasses.replace(v.spec, n_registers=4)
    )
    for k, v in DINOV2_PRESETS.items()
})

SIGLIP_PRESETS: dict[str, Preset] = {
    "ViT-B-16-SigLIP": Preset(
        vit.Spec(d_model=768, n_layers=12, n_heads=12, patch_size=16,
                 cls_token=False, ln_eps=1e-6, pos_kind="learned"),
        224, 224, SIGLIP_MEAN, SIGLIP_STD, resize_mode="squash",
    ),
    "ViT-L-16-SigLIP-384": Preset(
        vit.Spec(d_model=1024, n_layers=24, n_heads=16, patch_size=16,
                 cls_token=False, ln_eps=1e-6, pos_kind="learned"),
        384, 384, SIGLIP_MEAN, SIGLIP_STD, resize_mode="squash",
    ),
    "ViT-SO400M-14-SigLIP-384": Preset(
        vit.Spec(d_model=1152, n_layers=27, n_heads=16, patch_size=14,
                 mlp_ratio=4304 / 1152, cls_token=False, ln_eps=1e-6,
                 pos_kind="learned"),
        384, 384, SIGLIP_MEAN, SIGLIP_STD, resize_mode="squash",
    ),
}

# Perception Encoder (Bolya et al. 2025; reference pe.py:24-170 loads these via
# timm). Spec derived from Meta's published perception_models architecture:
# CLIP-lineage pre-LN ViT with CLS token, a learned absolute positional table
# *and* 2-D RoPE (theta=10000, raw integer patch coords, complex/interleaved
# rotation — handled by rope_style="pe" + the converter's q/k channel
# permutation, convert.interleave_to_halves), ln_pre, LayerScale, GELU MLP.
# The JAX engine's agreement with a minimal torch reimplementation under this
# spec is pinned in tests/test_converter_parity.py; this engine's with the JAX
# engine's in tests/test_torch_vit.py.
def _pe_spec(d, layers, heads, p) -> vit.Spec:
    return vit.Spec(
        d_model=d, n_layers=layers, n_heads=heads, patch_size=p,
        pos_kind="rope", rope_style="pe", rope_base=10000.0, rope_abs_pos=True,
        pre_norm=True, ln_eps=1e-5, layerscale=True,
    )


PE_PRESETS: dict[str, Preset] = {
    "vit_pe_core_base_patch16_224.fb": Preset(
        _pe_spec(768, 12, 12, 16), 224, 224, SIGLIP_MEAN, SIGLIP_STD,
    ),
    "vit_pe_core_large_patch14_336.fb": Preset(
        _pe_spec(1024, 24, 16, 14), 336, 336, SIGLIP_MEAN, SIGLIP_STD,
    ),
    "vit_pe_spatial_base_patch16_512.fb": Preset(
        _pe_spec(768, 12, 12, 16), 512, 512, SIGLIP_MEAN, SIGLIP_STD,
    ),
    "vit_pe_spatial_large_patch14_448.fb": Preset(
        _pe_spec(1024, 24, 16, 14), 448, 448, SIGLIP_MEAN, SIGLIP_STD,
    ),
}


def resolve_weights(family: str, arch: str) -> pathlib.Path:
    """Find the local checkpoint file for (family, arch)."""
    root = pathlib.Path(helpers.get_cache_dir()) / "saev_tpu" / family
    stem = helpers.fssafe(arch)
    for suffix in (".safetensors", ".pt", ".pth", ".bin"):
        fpath = root / f"{stem}{suffix}"
        if fpath.exists():
            return fpath
    raise FileNotFoundError(
        f"No local weights for {family}/{arch}. Weights are never downloaded; "
        f"place the checkpoint at {root / stem}.safetensors (or .pt/.pth/"
        f'.bin), or pass ckpt="{arch}=<path>".'
    )


class _TorchVit(base.Transformer):
    """Shared Transformer wrapper over the generic engine
    (saev_tpu/models/families.py:164)."""

    family: str = ""
    presets: dict[str, Preset] = {}

    def __init__(
        self,
        ckpt: str,
        *,
        params: dict | None = None,
        device: str = "cuda",
        precision: str = "default",
    ):
        arch, _, fpath = ckpt.partition("=")
        arch = self._normalize_arch(arch)
        if arch not in self.presets:
            raise ValueError(
                f"Unknown {self.family} checkpoint {arch!r}; known: "
                f"{sorted(self.presets)}"
            )
        self._ckpt = ckpt
        self.arch = arch
        self.preset = self.presets[arch]
        self.spec = self.preset.spec
        self.precision = precision

        if params is not None:
            self.params = params
            self._pos = params.get("pos")
        else:
            sd = convert.load_state_dict(
                pathlib.Path(fpath) if fpath else resolve_weights(self.family, arch)
            )
            if self.preset.converter == "openclip":
                self.params, pos = convert.from_openclip(sd, self.spec)
            else:
                self.params, pos = convert.from_timm(sd, self.spec)
            self._pos = self._arrange_pos(pos)
            if self._pos is not None:
                self.params["pos"] = self._pos
        # One-time host->device transfer (vit.to_device docstring).
        self.params = vit.to_device(self.params, device)

    @classmethod
    def _normalize_arch(cls, arch: str) -> str:
        # "ViT-B-16/openai" -> "ViT-B-16"; "hf-hub:org/x" kept as-is if preset.
        if arch in cls.presets:
            return arch
        if "/" in arch and arch.split("/")[0] in cls.presets:
            return arch.split("/")[0]
        if arch.startswith("hf-hub:"):
            tail = arch.split("/")[-1]
            if tail in cls.presets:
                return tail
        return arch

    def _arrange_pos(self, pos: np.ndarray | None) -> np.ndarray | None:
        """Fit the checkpoint's positional table to [prefix..., patches...] at this
        preset's grid. Registers get zero positional entries (DINOv2 inserts
        registers after the pos add)."""
        has_learned = self.spec.pos_kind == "learned" or (
            self.spec.pos_kind == "rope" and self.spec.rope_abs_pos
        )
        if pos is None or not has_learned:
            return None
        n_prefix_pos = int(self.spec.cls_token)  # pos covers CLS + patches
        n_patches = pos.shape[0] - n_prefix_pos
        g0 = int(round(np.sqrt(n_patches)))
        assert g0 * g0 == n_patches, f"Non-square pos table: {pos.shape}"
        pos = vit.interpolate_pos(pos, n_prefix_pos, (g0, g0), self.preset.grid)
        if self.spec.n_registers:
            zeros = np.zeros((self.spec.n_registers, pos.shape[1]), pos.dtype)
            pos = np.concatenate([pos[:n_prefix_pos], zeros, pos[n_prefix_pos:]], 0)
        return pos

    # --- Transformer interface -------------------------------------------------

    @property
    def ckpt(self) -> str:
        return self._ckpt

    @property
    def patch_size(self) -> int:
        return self.spec.patch_size

    @property
    def d_model(self) -> int:
        return self.spec.d_model

    @property
    def n_layers(self) -> int:
        return self.spec.n_layers

    def get_token_i(self, content_tokens_per_example: int) -> slice | np.ndarray:
        if self.spec.n_registers:
            # Skip register tokens: CLS at 0, patches start at 1 + n_reg
            # (reference dinov2.py:43-48).
            return np.concatenate([
                np.array([0]),
                np.arange(
                    self.spec.n_registers + 1,
                    self.spec.n_registers + 1 + content_tokens_per_example,
                ),
            ])
        return slice(None, None, None)

    def forward_recorded(
        self, batch: np.ndarray, layers: tuple[int, ...], **kwargs
    ) -> tuple[np.ndarray, np.ndarray]:
        tokens = np.asarray(batch, dtype=np.float32)
        assert tokens.ndim == 3, (
            f"Expected pre-patchified (B, N, c*p*p) tokens, got {tokens.shape}"
        )
        return vit.run(
            self.spec, self.params, tokens, tuple(layers), self.preset.grid,
            precision=self.precision,
        )

    @classmethod
    def make_transforms(
        cls, ckpt: str, content_tokens_per_example: int
    ) -> tuple[Callable, Callable | None]:
        preset = cls.presets[cls._normalize_arch(ckpt.partition("=")[0])]
        expected = preset.grid[0] * preset.grid[1]
        assert content_tokens_per_example == expected, (
            f"{cls.family}/{ckpt} produces {expected} content tokens, "
            f"got content_tokens_per_example={content_tokens_per_example}"
        )

        def img_transform(img) -> np.ndarray:
            img = _resize_center_crop(
                img.convert("RGB"), preset.resize_size, preset.img_size,
                mode=preset.resize_mode,
            )
            chw = transforms.to_chw_float(img, mean=preset.mean, std=preset.std)
            tokens, _ = transforms.patchify(chw, preset.spec.patch_size)
            return tokens

        return img_transform, None

    @classmethod
    def make_resize(
        cls,
        ckpt: str,
        content_tokens_per_example: int = -1,
        *,
        scale: float = 1.0,
        resample: str | int = "LANCZOS",
    ) -> Callable:
        preset = cls.presets[cls._normalize_arch(ckpt.partition("=")[0])]

        def resize(img):
            rs = int(preset.resize_size * scale)
            cs = int(preset.img_size * scale)
            return _resize_center_crop(
                img, rs, cs, mode=preset.resize_mode, resample=resample
            )

        return resize


def _resize_center_crop(
    img, resize: int, crop: int, mode: str = "shortest",
    resample: str | int = "BICUBIC",
):
    """torchvision semantics: Resize(resize) scales the SHORT edge to `resize`
    preserving aspect ratio, then CenterCrop(crop) crops both dims; "squash"
    resizes to an exact square (open_clip SigLIP). `img` is a PIL image."""
    resample = transforms.resample_filter(resample)
    if mode == "squash":
        img = img.resize((resize, resize), resample)
    else:
        w, h = img.size
        if w <= h:
            nw, nh = resize, max(round(h * resize / w), resize)
        else:
            nw, nh = max(round(w * resize / h), resize), resize
        img = img.resize((nw, nh), resample)
    w, h = img.size
    left = (w - crop) // 2
    top = (h - crop) // 2
    return img.crop((left, top, left + crop, top + crop))


class Clip(_TorchVit):
    """OpenCLIP-style ViT (reference clip.py:13-113)."""

    family = "clip"
    presets = CLIP_PRESETS


class Siglip(_TorchVit):
    """SigLIP ViT — no CLS token (reference siglip.py:15-89)."""

    family = "siglip"
    presets = SIGLIP_PRESETS


class Dinov2(_TorchVit):
    """DINOv2 (+registers) ViT (reference dinov2.py:14-82)."""

    family = "dinov2"
    presets = DINOV2_PRESETS


class PeCore(_TorchVit):
    """Meta Perception Encoder, CLIP-aligned (reference pe.py:114-141)."""

    family = "pe-core"
    presets = {k: v for k, v in PE_PRESETS.items() if "core" in k}


class PeSpatial(_TorchVit):
    """Meta Perception Encoder, dense/SAM-distilled (reference pe.py:144-170)."""

    family = "pe-spatial"
    presets = {k: v for k, v in PE_PRESETS.items() if "spatial" in k}


for _cls in (Clip, Siglip, Dinov2, PeCore, PeSpatial):
    base.register_family(_cls)
