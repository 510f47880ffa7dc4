"""Transformer interface + family registry for activation extraction (the
counterpart of saev_tpu/data/models.py, with no Pillow at import).

As in the JAX package, every family implements a *functional tap* in place of
the reference's forward hooks (reference `src/saev/data/models.py:15-90`,
`src/saev/data/shards.py:189-301`): `forward_recorded(batch, layers)` returns
the model output **and** the residual-stream activations at the requested
layers from a single forward pass. Resampling filters are given by name
("LANCZOS", "NEAREST", ...) and resolved by `transforms.resample_filter` when
an image is resized, so this module needs no Pillow.
"""

import abc
import logging
import typing as tp
from collections.abc import Callable

import numpy as np

logger = logging.getLogger(__name__)


class Transformer(abc.ABC):
    """Interface every ViT family implements."""

    family: str

    @property
    @abc.abstractmethod
    def ckpt(self) -> str: ...

    @property
    @abc.abstractmethod
    def patch_size(self) -> int:
        """Patch size in pixels (e.g., 14 or 16)."""

    @property
    @abc.abstractmethod
    def d_model(self) -> int:
        """Residual-stream width."""

    @property
    @abc.abstractmethod
    def n_layers(self) -> int:
        """Number of transformer blocks (residual tap points)."""

    @property
    def name(self) -> str:
        return f"{self.family}/{self.ckpt}"

    @staticmethod
    @abc.abstractmethod
    def make_transforms(
        ckpt: str, content_tokens_per_example: int
    ) -> tuple[Callable, Callable | None]:
        """Create preprocessing: (data_transform, sample_transform | None).

        data_transform maps a PIL image (or waveform) to a numpy array ready for the
        model; sample_transform optionally rewrites the whole sample dict.
        """

    @staticmethod
    @abc.abstractmethod
    def make_resize(
        ckpt: str,
        content_tokens_per_example: int,
        *,
        scale: float = 1.0,
        resample: str | int = "LANCZOS",
    ) -> Callable:
        """Resize transform for visualization / segmentation masks on PIL
        images (use resample="NEAREST" for masks)."""

    @abc.abstractmethod
    def get_token_i(self, content_tokens_per_example: int) -> slice | np.ndarray:
        """Indices selecting the relevant tokens from the raw token axis
        (e.g. skipping register tokens). CLS handling happens in the Recorder."""

    @abc.abstractmethod
    def forward_recorded(
        self, batch: np.ndarray, layers: tuple[int, ...], **kwargs
    ) -> tuple[np.ndarray, np.ndarray]:
        """Run the model and tap the residual stream.

        Args:
            batch: (B, ...) preprocessed inputs.
            layers: which transformer layers to record.

        Returns:
            (model_output, activations) where activations has shape
            (B, len(layers), n_raw_tokens, d_model) — the residual stream *after*
            each requested block, token axis in model-native order (CLS first when
            the model has one).
        """


_global_model_registry: dict[str, type[Transformer]] = {}


def load_model_cls(family: str) -> type[Transformer]:
    """Load a transformer family's class."""
    if family not in _global_model_registry:
        raise ValueError(f"Family '{family}' not found.")
    return _global_model_registry[family]


def register_family(cls: type[Transformer]):
    """Register a new transformer family's class."""
    if cls.family in _global_model_registry:
        logger.warning("Overwriting key '%s' in registry.", cls.family)
    _global_model_registry[cls.family] = cls


def list_families() -> list[str]:
    """List all registered ViT family names."""
    return list(_global_model_registry.keys())


class Recorder:
    """Functional analog of the reference's RecordedTransformer (shards.py:189-301).

    Wraps a Transformer; `__call__(batch)` returns `(out, acts)` where acts has shape
    (batch, n_layers, tokens_per_example, d_model) with the CLS token included iff
    `cls_token=True` and the requested token selection applied.
    """

    def __init__(
        self,
        model: Transformer,
        content_tokens_per_example: int,
        cls_token: bool,
        layers: tp.Sequence[int],
    ):
        self.model = model
        self.content_tokens_per_example = content_tokens_per_example
        self.cls_token = cls_token
        self.layers = tuple(int(i) for i in layers)
        self.token_i = model.get_token_i(content_tokens_per_example)
        self.logger = logging.getLogger(f"recorder({model.name})")

    @property
    def tokens_per_example(self) -> int:
        return self.content_tokens_per_example + int(self.cls_token)

    def __call__(self, batch, **kwargs) -> tuple[np.ndarray, np.ndarray]:
        out, acts = self.model.forward_recorded(batch, self.layers, **kwargs)
        # acts: (B, L, T_raw, D). Select tokens, then drop CLS if unwanted.
        selected = np.asarray(acts)[:, :, self.token_i, :]
        if (
            not self.cls_token
            and selected.shape[2] == self.content_tokens_per_example + 1
        ):
            # Model has a CLS token but we don't want to store it.
            selected = selected[:, :, 1:, :]

        assert selected.shape[2] == self.tokens_per_example, (
            f"Shape mismatch: got {selected.shape[2]} tokens, expected "
            f"{self.tokens_per_example} (content_tokens_per_example="
            f"{self.content_tokens_per_example}, cls_token={self.cls_token})"
        )
        return out, selected
