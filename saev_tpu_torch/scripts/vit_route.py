"""Random checkpoints and inputs for the extraction engine, and the error of
the card's bf16 route against the float32 forward.

    python -m saev_tpu_torch.scripts.vit_route [--d-model 128] [--n-layers 24] [--clips 2] [--device cuda]

On the card (`--device cuda`, the default; without a card it raises) it
runs the card's bf16 route on Bird-MAE's spec at the given width and depth,
from the random timm-layout checkpoint and the synthetic clips that
chip_smoke.py writes at full width, and prints, for each tapped layer, the
relative norm of the difference from the float32 forward (one JSON line).
`--device cpu` runs the route's CPU model instead (`modeling._bf16_operands`
patched to True: bf16-rounded operands with float32 products, attention's
plain version on bf16 q, k, v and probabilities), and its line says so.

chip_smoke.py builds its extraction phase from the same functions:
`synth_clip`, `bird_mae_state_dict`, `openclip_state_dict`,
`dinov2_state_dict` and `random_params`.
"""

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from ..models import bird_mae, convert, vit
from ..nn import modeling


def synth_clip(rng: np.random.Generator, n: int = bird_mae.SR_HZ * bird_mae.CLIP_SEC,
               sr: int = bird_mae.SR_HZ) -> np.ndarray:
    """An int16 clip: two tones with vibrato, a chirp, bursts and noise."""
    t = np.arange(n) / sr
    f0, f1 = rng.uniform(1500, 7000, size=2)
    vib = rng.uniform(2, 12)
    x = 0.3 * np.sin(2 * np.pi * f0 * t + 3 * np.sin(2 * np.pi * vib * t))
    x += 0.2 * np.sin(2 * np.pi * (f1 * t + rng.uniform(200, 2000) * t**2))
    bursts = (np.sin(2 * np.pi * rng.uniform(0.5, 3) * t) > 0.3).astype(np.float64)
    x = x * (0.3 + 0.7 * bursts) + rng.uniform(0.01, 0.1) * rng.normal(size=n)
    return np.clip(x * 16000, -32768, 32767).astype(np.int16)


def _normal(g: torch.Generator, *shape, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=g) * scale


def _linear(sd: dict, key: str, g: torch.Generator, d_out: int, d_in: int) -> None:
    sd[f"{key}.weight"] = _normal(g, d_out, d_in, scale=d_in**-0.5)
    sd[f"{key}.bias"] = _normal(g, d_out, scale=0.02)


def _norm(sd: dict, key: str, g: torch.Generator, d: int) -> None:
    sd[f"{key}.weight"] = 1.0 + _normal(g, d, scale=0.05)
    sd[f"{key}.bias"] = _normal(g, d, scale=0.02)


def bird_mae_state_dict(spec: vit.Spec, g: torch.Generator) -> dict[str, torch.Tensor]:
    """A random Bird-MAE checkpoint in timm's layout (the keys
    `convert.from_timm` reads and `bird_mae.Transformer` loads): weights at
    1/sqrt(fan-in), the fixed sincos position table, fc_norm."""
    d, p = spec.d_model, spec.patch_size
    sd = {
        "patch_embed.proj.weight": _normal(g, d, spec.in_chans, p, p, scale=(spec.in_chans * p * p) ** -0.5),
        "patch_embed.proj.bias": _normal(g, d, scale=0.02),
        "cls_token": _normal(g, 1, 1, d, scale=0.02),
        "pos_embed": torch.from_numpy(bird_mae.pos_table(d))[None],
    }
    for i in range(spec.n_layers):
        b = f"blocks.{i}"
        _norm(sd, f"{b}.norm1", g, d)
        _linear(sd, f"{b}.attn.qkv", g, 3 * d, d)
        _linear(sd, f"{b}.attn.proj", g, d, d)
        _norm(sd, f"{b}.norm2", g, d)
        _linear(sd, f"{b}.mlp.fc1", g, spec.d_mlp, d)
        _linear(sd, f"{b}.mlp.fc2", g, d, spec.d_mlp)
    _norm(sd, "norm", g, d)
    _norm(sd, "fc_norm", g, d)
    return sd


def openclip_state_dict(spec: vit.Spec, g: torch.Generator, n_pos: int) -> dict[str, torch.Tensor]:
    """A random OpenCLIP visual tower (the keys `convert.from_openclip` reads,
    under "visual."), nn.MultiheadAttention's packed in_proj."""
    d, p = spec.d_model, spec.patch_size
    sd = {
        "conv1.weight": _normal(g, d, 3, p, p, scale=(3 * p * p) ** -0.5),
        "class_embedding": _normal(g, d, scale=0.02),
        "positional_embedding": _normal(g, n_pos, d, scale=0.02),
    }
    _norm(sd, "ln_pre", g, d)
    for i in range(spec.n_layers):
        b = f"transformer.resblocks.{i}"
        _norm(sd, f"{b}.ln_1", g, d)
        sd[f"{b}.attn.in_proj_weight"] = _normal(g, 3 * d, d, scale=d**-0.5)
        sd[f"{b}.attn.in_proj_bias"] = _normal(g, 3 * d, scale=0.02)
        _linear(sd, f"{b}.attn.out_proj", g, d, d)
        _norm(sd, f"{b}.ln_2", g, d)
        _linear(sd, f"{b}.mlp.c_fc", g, spec.d_mlp, d)
        _linear(sd, f"{b}.mlp.c_proj", g, d, spec.d_mlp)
    _norm(sd, "ln_post", g, d)
    return {f"visual.{k}": v for k, v in sd.items()}


def dinov2_state_dict(spec: vit.Spec, g: torch.Generator, n_pos: int) -> dict[str, torch.Tensor]:
    """A random DINOv2 checkpoint in torch.hub's layout (the keys
    `convert.from_timm` reads): an `n_pos`-entry position table (1 + 37 x 37
    in every released checkpoint, for 518 px), register tokens where the spec
    has them, LayerScale gammas near 0.1, a GELU or fused SwiGLU MLP."""
    d, p = spec.d_model, spec.patch_size
    sd = {
        "patch_embed.proj.weight": _normal(g, d, spec.in_chans, p, p, scale=(spec.in_chans * p * p) ** -0.5),
        "patch_embed.proj.bias": _normal(g, d, scale=0.02),
        "cls_token": _normal(g, 1, 1, d, scale=0.02),
        "pos_embed": _normal(g, 1, n_pos, d, scale=0.02),
        "mask_token": torch.zeros(1, d),
    }
    if spec.n_registers:
        sd["register_tokens"] = _normal(g, 1, spec.n_registers, d, scale=0.02)
    for i in range(spec.n_layers):
        b = f"blocks.{i}"
        _norm(sd, f"{b}.norm1", g, d)
        _linear(sd, f"{b}.attn.qkv", g, 3 * d, d)
        _linear(sd, f"{b}.attn.proj", g, d, d)
        _norm(sd, f"{b}.norm2", g, d)
        if spec.mlp_kind == "swiglu":
            _linear(sd, f"{b}.mlp.w12", g, 2 * spec.d_mlp, d)
            _linear(sd, f"{b}.mlp.w3", g, d, spec.d_mlp)
        else:
            _linear(sd, f"{b}.mlp.fc1", g, spec.d_mlp, d)
            _linear(sd, f"{b}.mlp.fc2", g, d, spec.d_mlp)
        sd[f"{b}.ls1.gamma"] = 0.1 + _normal(g, d, scale=0.02)
        sd[f"{b}.ls2.gamma"] = 0.1 + _normal(g, d, scale=0.02)
    _norm(sd, "norm", g, d)
    return sd


def random_params(spec: vit.Spec, g: torch.Generator, *, n_pos: int | None = None) -> dict:
    """`vit.init`'s tree with LayerNorm gains near 1, small biases (the K
    third of qkv's zero where `mask_k_bias`, as DINOv3's conversion folds
    it) and LayerScales near 0.1, so that no block is close to the identity."""
    params = vit.init(spec, g, n_pos=n_pos)
    d = spec.d_model

    def fill(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                fill(v)
            elif isinstance(v, list):
                for blk in v:
                    fill(blk)
            elif k == "g":
                v.add_(torch.randn(v.shape, generator=g, device=v.device) * 0.05)
            elif k == "b":
                v.copy_(torch.randn(v.shape, generator=g, device=v.device) * 0.02)
            elif k in ("ls1", "ls2"):
                v.copy_(0.1 + 0.02 * torch.randn(v.shape, generator=g, device=v.device))

    fill(params)
    if spec.mask_k_bias:
        for blk in params["blocks"]:
            blk["attn"]["qkv"]["b"][d:2 * d] = 0.0
    return params


def route_error(spec: vit.Spec, params: dict, tokens: torch.Tensor, grid, layers) -> list[float]:
    """Relative norm of (route - float32) for each tapped layer. On a CPU
    tensor the route is its CPU model; on a CUDA tensor, the card's."""
    _, f32 = vit.forward(spec, params, tokens, layers, grid=grid, precision="highest")
    real = modeling._bf16_operands
    if not tokens.is_cuda:
        modeling._bf16_operands = lambda t: True
    try:
        _, b16 = vit.forward(spec, params, tokens, layers, grid=grid)
    finally:
        modeling._bf16_operands = real
    return [float(torch.linalg.vector_norm(b16[:, i] - f32[:, i]) / torch.linalg.vector_norm(f32[:, i]))
            for i in range(len(layers))]


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--n-layers", type=int, default=24)
    ap.add_argument("--n-heads", type=int, default=None, help="default: d_model / 64")
    ap.add_argument("--clips", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: the card's route; cpu: its CPU model")
    args = ap.parse_args(argv)
    device = args.device
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("vit_route: no CUDA card; pass --device cpu for the route's CPU model")
    spec = dataclasses.replace(
        bird_mae.PRETRAINED_SPECS["Bird-MAE-Large"], d_model=args.d_model, n_layers=args.n_layers,
        n_heads=args.n_heads or max(1, args.d_model // 64),
    )
    g = torch.Generator().manual_seed(args.seed)
    params, _ = convert.from_timm({k: v.numpy() for k, v in bird_mae_state_dict(spec, g).items()}, spec)
    params["pos"] = bird_mae.pos_table(spec.d_model)
    params = vit.to_device(params, device)
    rng = np.random.default_rng(args.seed)
    tokens = np.stack([bird_mae.spectrogram_to_tokens(bird_mae.transform(synth_clip(rng) / 32767.0))
                       for _ in range(args.clips)])
    layers = tuple(range(spec.n_layers))
    t0 = time.perf_counter()
    errs = route_error(spec, params, torch.from_numpy(tokens).to(device), (bird_mae.N_TIME_PATCHES,
                       bird_mae.N_MEL_PATCHES), layers)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0) if device == "cuda" else "cpu (CPU model of the route)",
        "spec": {"d_model": spec.d_model, "n_layers": spec.n_layers, "n_heads": spec.n_heads,
                 "tap_point": spec.tap_point},
        "clips": args.clips, "rel_norm_by_layer": errs, "max": max(errs),
        "seconds": time.perf_counter() - t0,
    }))


if __name__ == "__main__":
    main()
