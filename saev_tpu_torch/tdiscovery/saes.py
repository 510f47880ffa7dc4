"""Scorer wrapper for pre-trained sparse autoencoders (counterpart of
contrib/trait_discovery/src/tdiscovery/saes.py; reference
SparseAutoencoderScorer :14-48): presents a trained SAE through the same
score interface as the dictionary baselines, so the FishVista evaluation
treats SAE latents, k-means centroids, PCA components and random directions
alike.
"""

import numpy as np
import torch

from .. import nn
from ..nn import modeling
from . import device_of


class SparseAutoencoderScorer:
    """Score activations with a pre-trained SAE's latent activations, on the
    card unless `device="cpu"`."""

    method = "sae"

    def __init__(self, ckpt_fpath: str, device: str = "cuda"):
        self.ckpt_fpath = str(ckpt_fpath)
        self.device = device_of(device)
        self.cfg, self.params, self.state = nn.load(ckpt_fpath, device=self.device)

    @property
    def n_prototypes(self) -> int:
        return self.cfg.d_sae

    @property
    def kwargs(self) -> dict[str, object]:
        return {"ckpt_fpath": self.ckpt_fpath}

    def partial_fit(self, batch: np.ndarray) -> "SparseAutoencoderScorer":
        """Pre-trained SAEs don't need fitting."""
        return self

    @torch.no_grad()
    def transform(self, batch: np.ndarray) -> np.ndarray:
        """Latent activations f_x (batch, d_sae): the eval-mode forward
        (TopK's threshold by kernel K6 on the card; JumpReLU for BatchTopK)
        at "highest" (f32, TF32 off), like every inference path."""
        x = torch.from_numpy(np.asarray(batch, dtype=np.float32)).to(self.device)
        out, _ = modeling.encode(self.cfg, self.params, self.state, x, training=False, precision="highest")
        return out.f_x.cpu().numpy()
