"""DINOv3 family: RoPE ViT with storage tokens and flexible patch grids (the
counterpart of saev_tpu/models/dinov3.py).

Capability mirror of reference `src/saev/data/dinov3.py` (Config :20, PatchEmbed
:77, RopePositionEmbedding :131, LinearKMaskedBias :230, Encoder :402,
_PRETRAINED_CFGS :459, load :598, Vit :612), on the shared torch engine:

- Inputs are pre-patchified `(B, N, c*p*p)` token matrices with a per-example
  `grid` (the reference's FlexResize+Patchify path; transforms.py:15-102), so
  arbitrary aspect ratios with the same N share one batch.
- RoPE sin/cos tables are computed on the host from the checkpoint's `periods`
  buffer (numpy trig on N × d_head/4 values, trivially cheap) and carried to
  the device with the batch — per-example tables when grids differ within a
  batch.
- `LinearKMaskedBias` (a qkv bias whose K-third is zeroed via a mask buffer) is
  folded in at conversion time: we store `bias * bias_mask`.
"""

import functools
import logging
import pathlib
from collections.abc import Callable

import numpy as np

from ..data import models as base
from ..data import transforms
from . import convert, vit

logger = logging.getLogger(__name__)

IMAGENET_MEAN = (0.4850, 0.4560, 0.4060)
IMAGENET_STD = (0.2290, 0.2240, 0.2250)


def _spec(d, depth, heads, *, ratio=4.0, swiglu=False) -> vit.Spec:
    return vit.Spec(
        d_model=d,
        n_layers=depth,
        n_heads=heads,
        patch_size=16,
        mlp_ratio=ratio,
        mlp_kind="swiglu" if swiglu else "gelu",
        pos_kind="rope",
        rope_base=100.0,
        rope_normalize_coords="separate",
        cls_token=True,
        n_registers=4,  # storage tokens
        layerscale=True,
        ln_eps=1e-5,
        mask_k_bias=True,
    )


# Reference _PRETRAINED_CFGS (dinov3.py:459-595).
PRETRAINED_SPECS: dict[str, vit.Spec] = {
    "dinov3_vits16": _spec(384, 12, 6),
    "dinov3_vits16plus": _spec(384, 12, 6, ratio=6.0, swiglu=True),
    "dinov3_vitb16": _spec(768, 12, 12),
    "dinov3_vitl16": _spec(1024, 24, 16),
    "dinov3_vitl16plus": _spec(1024, 24, 16, ratio=6.0, swiglu=True),
    "dinov3_vith16plus": _spec(1280, 32, 20, ratio=6.0, swiglu=True),
    # 7B: no qkv bias (conversion zero-fills missing biases) and ffn
    # "swiglu64" (hidden aligned to 64 — conversion reads real shapes from the
    # checkpoint, so the ratio here only affects random-init sizing). DINOv3
    # has no qk-norm in any variant (reference Config, dinov3.py:459-595).
    "dinov3_vit7b16": _spec(4096, 40, 32, ratio=3.0, swiglu=True),
}


def convert_encoder(
    sd: dict[str, np.ndarray], spec: vit.Spec
) -> tuple[dict, np.ndarray]:
    """DINOv3 Encoder state dict → (params, rope periods)."""
    params: dict = {
        "cls": sd["cls_token"].reshape(-1),
        "reg": sd["storage_tokens"].reshape(-1, spec.d_model),
        "patch_embed": convert._conv_patch_embed(
            sd["patch_embed.proj.weight"], sd.get("patch_embed.proj.bias")
        ),
        "ln_f": convert._ln(sd, "norm"),
        "blocks": [],
    }
    periods = sd.get("rope_embed.periods")
    if periods is None:
        periods = vit.rope_periods(spec)

    for i in range(spec.n_layers):
        p = f"blocks.{i}"
        qkv_w = sd[f"{p}.attn.qkv.weight"]
        qkv_b = sd.get(f"{p}.attn.qkv.bias")
        if qkv_b is None:
            qkv_b = np.zeros((qkv_w.shape[0],), dtype=qkv_w.dtype)
        mask = sd.get(f"{p}.attn.qkv.bias_mask")
        if mask is not None:
            qkv_b = qkv_b * mask  # fold LinearKMaskedBias statically
        blk: dict = {
            "ln1": convert._ln(sd, f"{p}.norm1"),
            "attn": {
                "qkv": {"w": np.ascontiguousarray(qkv_w.T), "b": qkv_b},
                "proj": convert._lin(sd, f"{p}.attn.proj"),
            },
            "ln2": convert._ln(sd, f"{p}.norm2"),
            "ls1": sd[f"{p}.ls1.gamma"],
            "ls2": sd[f"{p}.ls2.gamma"],
        }
        if spec.mlp_kind == "swiglu":
            if f"{p}.mlp.w12.weight" in sd:
                blk["mlp"] = {
                    "w12": convert._lin(sd, f"{p}.mlp.w12"),
                    "w3": convert._lin(sd, f"{p}.mlp.w3"),
                }
            else:
                w1 = convert._lin(sd, f"{p}.mlp.w1")
                w2 = convert._lin(sd, f"{p}.mlp.w2")
                blk["mlp"] = {
                    "w12": {
                        "w": np.concatenate([w1["w"], w2["w"]], axis=1),
                        "b": np.concatenate([w1["b"], w2["b"]]),
                    },
                    "w3": convert._lin(sd, f"{p}.mlp.w3"),
                }
        else:
            blk["mlp"] = {
                "fc1": convert._lin(sd, f"{p}.mlp.fc1"),
                "fc2": convert._lin(sd, f"{p}.mlp.fc2"),
            }
        params["blocks"].append(blk)
    return params, np.asarray(periods, dtype=np.float64)


class Vit(base.Transformer):
    """DINOv3 wrapper with flexible aspect-ratio grids (reference dinov3.py:612-689)."""

    family: str = "dinov3"

    def __init__(
        self,
        ckpt: str,
        *,
        params: dict | None = None,
        name: str | None = None,
        device: str = "cuda",
        precision: str = "default",
    ):
        self._ckpt_path = ckpt
        name = name or self._parse_name(ckpt)
        if name not in PRETRAINED_SPECS:
            raise ValueError(f"Name '{name}' not in {list(PRETRAINED_SPECS)}.")
        self._name = name
        self.spec = PRETRAINED_SPECS[name]
        self.precision = precision
        if params is not None:
            self.params = params
            self.periods = vit.rope_periods(self.spec)
        else:
            sd = convert.load_state_dict(ckpt)
            self.params, self.periods = convert_encoder(sd, self.spec)
        self.params = vit.to_device(self.params, device)

    @staticmethod
    def _parse_name(dinov3_ckpt: str) -> str:
        # e.g. dinov3_vitb16_pretrain_lvd1689m-<sha>.pth (reference dinov3.py:641-646)
        name_ds, _, _sha = pathlib.Path(dinov3_ckpt).stem.partition("-")
        parts = name_ds.split("_")
        if "pretrain" in parts:
            parts = parts[: parts.index("pretrain")]
        return "_".join(parts)

    @property
    def ckpt(self) -> str:
        return self._name

    @property
    def patch_size(self) -> int:
        return self.spec.patch_size

    @property
    def d_model(self) -> int:
        return self.spec.d_model

    @property
    def n_layers(self) -> int:
        return self.spec.n_layers

    def get_token_i(self, content_tokens_per_example: int) -> np.ndarray:
        n_reg = self.spec.n_registers
        return np.concatenate([
            np.array([0]),
            np.arange(n_reg + 1, n_reg + 1 + content_tokens_per_example),
        ])

    def forward_recorded(
        self, batch: np.ndarray, layers: tuple[int, ...], **kwargs
    ) -> tuple[np.ndarray, np.ndarray]:
        grid = kwargs.pop("grid", None)
        tokens = np.asarray(batch, dtype=np.float32)
        assert tokens.ndim == 3, f"Expected (B, N, c*p*p) tokens, got {tokens.shape}"
        b, n, _ = tokens.shape
        if grid is None:
            g = int(round(np.sqrt(n)))
            assert g * g == n, f"Non-square token count {n} requires a grid kwarg"
            grid = np.tile(np.array([[g, g]], dtype=np.int64), (b, 1))
        grid = np.asarray(grid)

        # Host-side RoPE tables; one shared table when all grids match.
        uniq = {(int(h), int(w)) for h, w in grid}
        if len(uniq) == 1:
            (gh, gw) = next(iter(uniq))
            sin, cos = vit.rope_sincos_from_periods(
                self.periods, gh, gw, self.spec.rope_normalize_coords
            )
        else:
            tables = [
                vit.rope_sincos_from_periods(
                    self.periods, int(h), int(w), self.spec.rope_normalize_coords
                )
                for h, w in grid
            ]
            sin = np.stack([t[0] for t in tables])
            cos = np.stack([t[1] for t in tables])

        return vit.run(
            self.spec, self.params, tokens, tuple(int(i) for i in layers),
            (1, n),  # unused under rope_sincos
            rope_sincos=(sin, cos), precision=self.precision,
        )

    @staticmethod
    def make_transforms(
        ckpt: str, content_tokens_per_example: int
    ) -> tuple[Callable, Callable | None]:
        flex = transforms.FlexResize(patch_size=16, n_patches=content_tokens_per_example)

        def img_transform(img) -> np.ndarray:
            img = flex(img.convert("RGB"))
            return transforms.to_chw_float(img, mean=IMAGENET_MEAN, std=IMAGENET_STD)

        sample_transform = transforms.Patchify(
            patch_size=16, n_patches=content_tokens_per_example
        )
        return img_transform, sample_transform

    @staticmethod
    def make_resize(
        ckpt: str,
        content_tokens_per_example: int = -1,
        *,
        scale: float = 1.0,
        resample: str | int = "LANCZOS",
    ) -> Callable:
        return functools.partial(
            transforms.resize_to_patch_grid,
            p=int(16 * scale),
            n=content_tokens_per_example,
            resample=resample,
        )


base.register_family(Vit)
