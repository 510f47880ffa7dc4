"""Torch-checkpoint → params converters for the model zoo (a copy of
saev_tpu/models/convert.py; numpy only, and torch only as the file codec).

The reference downloads weights at runtime through open_clip / timm / torch.hub
(reference src/saev/data/{clip,siglip,dinov2,pe}.py). Here each family loads a
*local* checkpoint file (torch .pt/.pth/.bin or .safetensors) and converts the
state dict into the `models.vit` params tree, the same numpy tree as the JAX
package's converters build, which `vit.to_device` then carries to the card.

Converters are keyed by the source naming scheme, not the family:
- `from_openclip`  — OpenCLIP VisionTransformer (clip family; nn.MultiheadAttention packing)
- `from_timm`      — timm VisionTransformer (siglip, pe-core, pe-spatial, dinov2 hub —
                     DINOv2's torch.hub module uses timm-style key names too)

All torch Linear weights are (out, in) and transpose into our (in, out) layout;
conv patch embeddings (d, c, p, p) flatten to (c*p*p, d) matching
`transforms.patchify` token order (c, p1, p2).
"""

import pathlib

import numpy as np
import torch

from . import vit


def load_state_dict(fpath: pathlib.Path | str) -> dict[str, np.ndarray]:
    """Read a torch or safetensors checkpoint file into numpy arrays."""
    fpath = pathlib.Path(fpath)
    if not fpath.exists():
        raise FileNotFoundError(
            f"Checkpoint file not found: {fpath}. Weights are never downloaded; "
            "pass a local path to a .pt/.pth/.bin/.safetensors file."
        )
    if fpath.suffix == ".safetensors":
        import safetensors.numpy

        return dict(safetensors.numpy.load_file(fpath))
    obj = torch.load(fpath, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if isinstance(obj, dict) and "model" in obj and isinstance(obj["model"], dict):
        obj = obj["model"]
    # numpy has no bfloat16: such tensors are widened to float32 (exactly).
    return {
        k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
        for k, v in obj.items()
        if isinstance(v, torch.Tensor)
    }


def _strip_prefix(sd: dict[str, np.ndarray], prefixes: tuple[str, ...]) -> dict:
    for prefix in prefixes:
        if any(k.startswith(prefix) for k in sd):
            return {
                k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)
            }
    return sd


def _lin(sd: dict, key: str) -> dict[str, np.ndarray]:
    """torch Linear -> {"w": (in, out), "b": (out,)}."""
    w = sd[f"{key}.weight"]
    b = sd.get(f"{key}.bias")
    if b is None:
        b = np.zeros((w.shape[0],), dtype=w.dtype)
    return {"w": np.ascontiguousarray(w.T), "b": np.ascontiguousarray(b)}


def _ln(sd: dict, key: str) -> dict[str, np.ndarray]:
    return {"g": sd[f"{key}.weight"], "b": sd[f"{key}.bias"]}


def _conv_patch_embed(w_dckk: np.ndarray, b: np.ndarray | None) -> dict:
    d = w_dckk.shape[0]
    w = w_dckk.reshape(d, -1).T  # (c*p*p, d), order (c, p1, p2) == patchify
    if b is None:
        b = np.zeros((d,), dtype=w.dtype)
    return {"w": np.ascontiguousarray(w), "b": np.ascontiguousarray(b)}


def from_openclip(
    sd: dict[str, np.ndarray], spec: vit.Spec
) -> tuple[dict, np.ndarray]:
    """OpenCLIP VisionTransformer state dict → (params, pos_table).

    Keys (optionally under "visual."): conv1.weight, class_embedding,
    positional_embedding, ln_pre, transformer.resblocks.{i}.{ln_1,attn,ln_2,mlp},
    ln_post. nn.MultiheadAttention packs q/k/v rows in in_proj_weight (3d, d).
    """
    sd = _strip_prefix(sd, ("visual.", "module.visual."))
    params: dict = {
        "patch_embed": _conv_patch_embed(sd["conv1.weight"], sd.get("conv1.bias")),
        "cls": sd["class_embedding"].reshape(-1),
        "ln_pre": _ln(sd, "ln_pre"),
        "ln_f": _ln(sd, "ln_post"),
        "blocks": [],
    }
    pos = np.ascontiguousarray(sd["positional_embedding"])
    for i in range(spec.n_layers):
        p = f"transformer.resblocks.{i}"
        qkv_w = sd[f"{p}.attn.in_proj_weight"]  # (3d, d)
        qkv_b = sd[f"{p}.attn.in_proj_bias"]
        params["blocks"].append({
            "ln1": _ln(sd, f"{p}.ln_1"),
            "attn": {
                "qkv": {"w": np.ascontiguousarray(qkv_w.T), "b": qkv_b},
                "proj": _lin(sd, f"{p}.attn.out_proj"),
            },
            "ln2": _ln(sd, f"{p}.ln_2"),
            "mlp": {
                "fc1": _lin(sd, f"{p}.mlp.c_fc"),
                "fc2": _lin(sd, f"{p}.mlp.c_proj"),
            },
        })
    return params, pos


def interleave_to_halves(d_head: int) -> np.ndarray:
    """Channel permutation mapping interleaved-RoPE weights to halves-RoPE.

    Sources that rotate interleaved channel pairs (2m, 2m+1) — Meta PE's
    complex-multiply Rope2D and timm's `apply_rot_embed_cat` — are equivalent
    to this engine's halves-based rotate_half (pairs (m, m+d/2), vit.apply_rope)
    after permuting q/k head channels so engine channel m holds source channel
    2m and engine channel m+d/2 holds source channel 2m+1. The attention dot
    product q·k is invariant to any shared per-head channel permutation, so v
    and the output projection stay untouched.
    """
    half = d_head // 2
    perm = np.empty(d_head, dtype=np.int64)
    perm[:half] = 2 * np.arange(half)
    perm[half:] = 2 * np.arange(half) + 1
    return perm


def _permute_qk(params: dict, spec: vit.Spec) -> None:
    """In-place q/k channel permutation (interleave→halves) on every block."""
    d, n_heads, d_head = spec.d_model, spec.n_heads, spec.d_head
    perm = interleave_to_halves(d_head)
    for blk in params["blocks"]:
        qkv = blk["attn"]["qkv"]
        w = qkv["w"]  # (d_in, 3d) columns [q | k | v]
        b = qkv["b"]
        for sec in range(2):  # q and k only
            cols = w[:, sec * d : (sec + 1) * d].reshape(-1, n_heads, d_head)
            w[:, sec * d : (sec + 1) * d] = cols[:, :, perm].reshape(-1, d)
            bs = b[sec * d : (sec + 1) * d].reshape(n_heads, d_head)
            b[sec * d : (sec + 1) * d] = bs[:, perm].reshape(d)
        for key in ("q_norm", "k_norm"):
            if key in blk["attn"]:
                ln = blk["attn"][key]
                ln["g"] = ln["g"][perm]
                ln["b"] = ln["b"][perm]


def from_timm(
    sd: dict[str, np.ndarray], spec: vit.Spec
) -> tuple[dict, np.ndarray | None]:
    """timm VisionTransformer state dict → (params, pos_table | None).

    Covers siglip (no CLS), pe-core/pe-spatial (CLS), and DINOv2 torch.hub
    (CLS + register_tokens + ls{1,2}.gamma LayerScale) — they share the
    patch_embed.proj / blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2}
    naming.
    """
    sd = _strip_prefix(sd, ("trunk.", "model.", "backbone."))
    params: dict = {
        "patch_embed": _conv_patch_embed(
            sd["patch_embed.proj.weight"], sd.get("patch_embed.proj.bias")
        ),
        "blocks": [],
    }
    if "cls_token" in sd:
        params["cls"] = sd["cls_token"].reshape(-1)
    if "register_tokens" in sd:
        params["reg"] = sd["register_tokens"].reshape(-1, spec.d_model)
    if "reg_token" in sd:
        params["reg"] = sd["reg_token"].reshape(-1, spec.d_model)
    if "norm.weight" in sd:
        params["ln_f"] = _ln(sd, "norm")
    for pre_key in ("norm_pre", "ln_pre"):
        # timm calls the pre-block LayerNorm `norm_pre`; Meta PE exports use
        # `ln_pre`. Required when spec.pre_norm is set.
        if f"{pre_key}.weight" in sd:
            params["ln_pre"] = _ln(sd, pre_key)
            break
    if spec.pre_norm and "ln_pre" not in params:
        raise KeyError(
            "spec.pre_norm=True but the checkpoint has no norm_pre/ln_pre keys"
        )

    pos = sd.get("pos_embed")
    if pos is not None:
        pos = np.ascontiguousarray(pos.reshape(-1, spec.d_model))

    for i in range(spec.n_layers):
        p = f"blocks.{i}"
        blk: dict = {
            "ln1": _ln(sd, f"{p}.norm1"),
            "attn": {
                "qkv": _lin(sd, f"{p}.attn.qkv"),
                "proj": _lin(sd, f"{p}.attn.proj"),
            },
            "ln2": _ln(sd, f"{p}.norm2"),
        }
        if spec.mlp_kind == "swiglu":
            # DINOv2-giant SwiGLUFFNFused stores fused w12 + w3; some exports
            # keep separate w1/w2 (same handling as dinov3.convert_encoder).
            if f"{p}.mlp.w12.weight" in sd:
                blk["mlp"] = {
                    "w12": _lin(sd, f"{p}.mlp.w12"),
                    "w3": _lin(sd, f"{p}.mlp.w3"),
                }
            else:
                w1 = _lin(sd, f"{p}.mlp.w1")
                w2 = _lin(sd, f"{p}.mlp.w2")
                blk["mlp"] = {
                    "w12": {
                        "w": np.concatenate([w1["w"], w2["w"]], axis=1),
                        "b": np.concatenate([w1["b"], w2["b"]]),
                    },
                    "w3": _lin(sd, f"{p}.mlp.w3"),
                }
        else:
            blk["mlp"] = {
                "fc1": _lin(sd, f"{p}.mlp.fc1"),
                "fc2": _lin(sd, f"{p}.mlp.fc2"),
            }
        if f"{p}.attn.q_norm.weight" in sd:
            blk["attn"]["q_norm"] = _ln(sd, f"{p}.attn.q_norm")
            blk["attn"]["k_norm"] = _ln(sd, f"{p}.attn.k_norm")
        for ls_key, ours in (("ls1", "ls1"), ("ls2", "ls2")):
            gamma = sd.get(f"{p}.{ls_key}.gamma")
            if gamma is None:
                gamma = sd.get(f"{p}.{ls_key}.scale")
            if gamma is not None:
                blk[ours] = gamma
        params["blocks"].append(blk)
    if spec.pos_kind == "rope" and spec.rope_style == "pe":
        # Writable copies (torch->numpy views can be read-only), then permute.
        for blk in params["blocks"]:
            qkv = blk["attn"]["qkv"]
            qkv["w"] = np.array(qkv["w"])
            qkv["b"] = np.array(qkv["b"])
        _permute_qk(params, spec)
    return params, pos
