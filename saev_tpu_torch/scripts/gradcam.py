"""Standalone Grad-CAM baseline over the port's ViT zoo (the counterpart of
scripts/gradcam.py): a saliency baseline to compare SAE heatmaps against.

The grad-cam family reduces to "gradient-weighted activations at a chosen
layer": the residual tap comes from `vit.forward`, detached, and torch
autograd takes the gradient of a scalar score of the final pooled output
through `vit.forward_from` (the blocks after the tap and the final norm). At
`precision="default"` on the card the ViT's products take bf16 operands with
float32 results, forward and backward (`modeling._Matmul`), as extraction's
forward; `tap` and `score` at "highest" are the float32 forward and
backward, TF32 off. The model runs on the card unless the caller asks for
the CPU (`--device cpu`).

Methods:
- gradcam: ReLU( mean_d(grad) . act ) per patch
- eigencam: first principal component of the patch-activation matrix
- gradcam++ : alpha-weighted positive gradients

Usage:
    python -m saev_tpu_torch.scripts.gradcam run --family dinov2 --ckpt dinov2_vitb14 \\
        --image-path img.jpg --layer -2 --method gradcam --out cam.png [--device cpu]
"""

import dataclasses
import logging
import pathlib

import numpy as np
import torch

logger = logging.getLogger("gradcam")


@dataclasses.dataclass(frozen=True)
class Args:
    family: str = "dinov2"
    ckpt: str = "dinov2_vitb14"
    image_path: pathlib.Path = pathlib.Path("./examples/both.png")
    layer: int = -2
    content_tokens: int = 256
    method: str = "gradcam"
    """gradcam | gradcam++ | eigencam"""
    target: int = -1
    """Output dim to explain; -1 = L2 norm of the pooled output."""
    out: pathlib.Path = pathlib.Path("./cam.png")
    device: str = "cuda"
    """Where the ViT runs ("cpu" on request)."""


def compute_cam(
    acts_nd: np.ndarray, grads_nd: np.ndarray, method: str
) -> np.ndarray:
    """(N_patches,) saliency from patch activations + their gradients."""
    if method == "eigencam":
        centered = acts_nd - acts_nd.mean(axis=0, keepdims=True)
        _, _, vt = np.linalg.svd(centered, full_matrices=False)
        cam = centered @ vt[0]
    elif method == "gradcam++":
        g = grads_nd
        alpha = g**2 / (2 * g**2 + (acts_nd * g**3).sum(axis=0, keepdims=True) + 1e-9)
        weights = (alpha * np.maximum(g, 0)).sum(axis=0)
        cam = acts_nd @ weights
    else:  # gradcam
        weights = grads_nd.mean(axis=0)
        cam = acts_nd @ weights
    cam = np.maximum(cam, 0)
    return cam / max(cam.max(), 1e-9)


def tap(spec, params, tokens: torch.Tensor, layer: int, grid, precision: str = "default") -> torch.Tensor:
    """The residual stream after block `layer`, (B, 1, T, D), detached and
    requiring grad: the leaf Grad-CAM differentiates at."""
    from ..models import vit

    with torch.no_grad():
        _, taps = vit.forward(spec, params, tokens, (layer,), grid=grid, precision=precision)
    return taps.detach().requires_grad_()


def score(spec, params, taps: torch.Tensor, layer: int, grid, target: int, precision: str = "default"):
    """Continue the network from the tap and score the FINAL pooled output
    (CLS, or the mean token without one): its `target` dim, or its L2 norm
    for target -1, so gradients at the tap reflect downstream use."""
    from ..models import vit

    out = vit.forward_from(spec, params, taps[:, 0], layer, grid=grid, precision=precision)
    pooled = out[0, 0, :] if spec.cls_token else out[0].mean(dim=0)
    if target >= 0:
        return pooled[target]
    return torch.linalg.vector_norm(pooled)


def value_and_grad(spec, params, tokens: torch.Tensor, layer: int, grid, target: int):
    """(score, taps, d score / d taps): one forward to the tap, one
    `forward_from` and its backward, at "default"."""
    taps = tap(spec, params, tokens, layer, grid)
    s = score(spec, params, taps, layer, grid, target)
    (grads,) = torch.autograd.grad(s, taps)
    return float(s.detach()), taps.detach(), grads


def run(args: Args) -> dict:
    """Returns {"score", "cam", "acts", "grads"} of the image, numpy."""
    from PIL import Image

    from .. import viz
    from ..data import models as base
    from ..models import vit

    logging.basicConfig(level=logging.INFO)
    model_cls = base.load_model_cls(args.family)
    model = model_cls(args.ckpt, device=args.device)
    img_tr, _ = model_cls.make_transforms(args.ckpt, args.content_tokens)
    img = Image.open(args.image_path)
    tokens = np.asarray(img_tr(img))[None]

    layer = args.layer % model.n_layers
    spec, params = model.spec, model.params
    grid = model.preset.grid if hasattr(model, "preset") else (
        int(np.sqrt(args.content_tokens)),
    ) * 2

    x = torch.from_numpy(np.ascontiguousarray(tokens, dtype=np.float32)).to(vit.params_device(params))
    s, taps, tap_grads = value_and_grad(spec, params, x, layer, grid, args.target)

    n_prefix = spec.n_prefix_tokens
    acts_nd = taps[0, 0, n_prefix:, :].cpu().numpy()
    grads_nd = tap_grads[0, 0, n_prefix:, :].cpu().numpy()
    cam = compute_cam(acts_nd, grads_nd, args.method)

    disp = model_cls.make_resize(args.ckpt, args.content_tokens)(img.convert("RGB"))
    heat = viz.add_highlights(
        disp, cam.astype(np.float64), model.patch_size, upper=1.0
    )
    heat.save(args.out)
    logger.info("Saved %s (%s, score %.4f)", args.out, args.method, s)
    return {"score": s, "cam": cam, "acts": acts_nd, "grads": grads_nd}


if __name__ == "__main__":
    from ..utils import cli as cli_mod

    cli_mod.run({"run": run})
