"""Generic ViT engine: one configurable forward covering every family in the zoo
(the counterpart of saev_tpu/models/vit.py, on torch tensors).

- The patch embedding is patchify + ONE product (`transforms.patchify` on the
  host), never a conv: a stride == kernel conv is exactly a reshaped product.
- Activations tap the residual stream *after* each requested block from a single
  forward (or `block.norm2`'s output for Bird-MAE), the functional analog of the
  reference's forward hooks (reference shards.py:239-301).
- Products follow the JAX package's DEFAULT, as `nn.modeling.matmul` maps it:
  with `precision="default"` (extraction's) each product takes bf16 operands
  with float32 accumulation and result on the card (`modeling._mm_bf16`, which
  raises where torch has no such product) and is a float32 product on the CPU,
  as JAX-CPU's DEFAULT is. Attention on that route is
  `F.scaled_dot_product_attention` on bf16 q, k and v on the card; on the CPU
  its plain version, the same matmul-softmax-matmul on the bf16-rounded
  operands. `precision="highest"` is the float32 forward everywhere, TF32 off.
  The JAX package computes attention as two einsums and a softmax
  (saev_tpu/models/vit.py:372-376), in no Pallas kernel.
- `run` takes numpy tokens and returns float32 numpy, as JAX's does; it runs
  on the device that holds the params (`to_device`), with no jit cache and no
  mesh (extraction over several cards runs a process a card, `data/extract.py`).
- `interpolate_pos` resizes a learned position table in numpy, Pillow's
  bicubic bit for bit, so no family needs Pillow to load.

Families map onto `Spec` as:
    CLIP/OpenCLIP ViT  pre-LN, learned pos, CLS, GELU MLP, pre-proj LN
    SigLIP (timm)      pre-LN, learned pos, no CLS, GELU MLP, attn-pool head (unused)
    DINOv2             pre-LN, learned pos (interp), CLS + registers, LayerScale
    DINOv3             pre-LN, axial RoPE, CLS + storage tokens, LayerScale,
                       SwiGLU or GELU, masked K bias (LinearKMaskedBias)
    PE core/spatial    pre-LN, learned pos, CLS, GELU
    Bird-MAE           pre-LN, 2-D sincos pos, CLS, LayerScale, GELU (audio input)
"""

import contextlib
import dataclasses
import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

from ..nn import modeling

PRECISIONS = ("default", "highest")


@dataclasses.dataclass(frozen=True)
class Spec:
    """Architecture description; every family is an instance of this
    (saev_tpu/models/vit.py:38, field for field but its unused `rope_dtype`).
    The residual stream stays float32: the JAX package's `compute_dtype`,
    which no caller sets, has no counterpart."""

    d_model: int
    n_layers: int
    n_heads: int
    patch_size: int
    mlp_ratio: float = 4.0
    mlp_kind: tp.Literal["gelu", "swiglu"] = "gelu"
    act: tp.Literal["gelu", "gelu_tanh", "quick_gelu"] = "gelu"
    """MLP nonlinearity: exact erf GELU (timm/dinov2), tanh-approx, or
    QuickGELU x*sigmoid(1.702x) (OpenAI CLIP checkpoints)."""
    pre_norm: bool = False
    """LayerNorm before the first block (OpenCLIP ViT ln_pre)."""
    pos_kind: tp.Literal["learned", "sincos2d", "rope", "none"] = "learned"
    cls_token: bool = True
    n_registers: int = 0
    """DINOv2 register / DINOv3 storage tokens, placed after CLS."""
    layerscale: bool = False
    ln_eps: float = 1e-6
    in_chans: int = 3
    final_norm: bool = True
    qk_norm: bool = False
    """Per-head LayerNorm on q and k (some PE variants)."""
    mask_k_bias: bool = False
    """DINOv3 LinearKMaskedBias: the K projection carries a zeroed-out bias."""
    tap_point: tp.Literal["block", "norm2"] = "block"
    """Where the residual tap records: after the full block (most families), or
    the norm2 output mid-block (Bird-MAE hooks block.norm2; reference
    bird_mae.py:608)."""
    rope_base: float = 100.0
    """DINOv3 RoPE period base."""
    rope_min_period: float | None = None
    rope_max_period: float | None = None
    rope_normalize_coords: tp.Literal["min", "max", "separate"] = "separate"
    rope_style: tp.Literal["dinov3", "pe"] = "dinov3"
    """Angle-table construction. "dinov3": patch-center coords normalized to
    [-1, 1], angle = coord·2π/period, h-angles then w-angles (reference
    dinov3.py:178-215). "pe": Meta Perception Encoder Rope2D — raw integer
    patch coords (t_x = idx % W, t_y = idx // W), freq = base^(-4m/d_head),
    x-angles then y-angles. The PE source rotates interleaved channel pairs
    (2m, 2m+1) via complex multiply; this engine always rotates halves pairs
    (m, m+d/2), so PE converters permute q/k head channels
    (convert.interleave_to_halves) to make the two exactly equal."""
    rope_abs_pos: bool = False
    """PE uses a learned absolute positional table *and* RoPE; when set (with
    pos_kind="rope"), params["pos"] is added exactly like pos_kind="learned"."""

    @property
    def d_head(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads

    @property
    def d_mlp(self) -> int:
        return int(self.d_model * self.mlp_ratio)

    @property
    def n_prefix_tokens(self) -> int:
        return int(self.cls_token) + self.n_registers


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init(
    spec: Spec, generator: torch.Generator, *, n_pos: int | None = None
) -> dict:
    """Random small-scale init, drawn from `generator` (on its device), in the
    params tree layout of the JAX package's `init` (saev_tpu/models/vit.py:107)
    and of the converters. Not the JAX package's values: those come from
    `jax.random`."""
    d = spec.d_model
    dev = generator.device

    def normal(*shape, scale):
        return torch.randn(shape, generator=generator, device=dev) * scale

    def dense(d_in, d_out):
        return {"w": normal(d_in, d_out, scale=1.0 / np.sqrt(d_in)),
                "b": torch.zeros(d_out, device=dev)}

    def lnp(n=d):
        return {"g": torch.ones(n, device=dev), "b": torch.zeros(n, device=dev)}

    params: dict = {"patch_embed": dense(spec.in_chans * spec.patch_size**2, d)}
    if spec.cls_token:
        params["cls"] = normal(d, scale=0.02)
    if spec.n_registers:
        params["reg"] = normal(spec.n_registers, d, scale=0.02)
    if spec.pos_kind == "learned" or (spec.pos_kind == "rope" and spec.rope_abs_pos):
        assert n_pos is not None, "learned pos embeddings need n_pos"
        params["pos"] = normal(n_pos, d, scale=0.02)
    if spec.pre_norm:
        params["ln_pre"] = lnp()

    blocks = []
    for _ in range(spec.n_layers):
        blk: dict = {
            "ln1": lnp(),
            "attn": {"qkv": dense(d, 3 * d), "proj": dense(d, d)},
            "ln2": lnp(),
        }
        if spec.qk_norm:
            blk["attn"]["q_norm"] = lnp(spec.d_head)
            blk["attn"]["k_norm"] = lnp(spec.d_head)
        if spec.mlp_kind == "swiglu":
            blk["mlp"] = {"w12": dense(d, 2 * spec.d_mlp), "w3": dense(spec.d_mlp, d)}
        else:
            blk["mlp"] = {"fc1": dense(d, spec.d_mlp), "fc2": dense(spec.d_mlp, d)}
        if spec.layerscale:
            blk["ls1"] = torch.full((d,), 1e-5, device=dev)
            blk["ls2"] = torch.full((d,), 1e-5, device=dev)
        blocks.append(blk)
    params["blocks"] = blocks
    if spec.final_norm:
        params["ln_f"] = lnp()
    return params


def to_device(params, device: str | torch.device = "cuda"):
    """Carry a params tree (numpy from a converter, the JAX package's arrays,
    or torch tensors) to `device` as float32 tensors, once
    (saev_tpu/models/vit.py:629). Model wrappers call this at construction, so
    no batch uploads the weights again."""
    if isinstance(params, dict):
        return {k: to_device(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(to_device(v, device) for v in params)
    if isinstance(params, torch.Tensor):
        return params.to(device=device, dtype=torch.float32)
    # A copy: the tensor never shares (possibly read-only) memory with the caller's array.
    return torch.from_numpy(np.array(params, dtype=np.float32)).to(device)


def params_device(params: dict) -> torch.device:
    return params["patch_embed"]["w"].device


# ---------------------------------------------------------------------------
# Positional embeddings (numpy tables, verbatim copies of the JAX package's)
# ---------------------------------------------------------------------------


def sincos_2d(d_model: int, grid_h: int, grid_w: int) -> np.ndarray:
    """Fixed 2-D sine-cosine positional embeddings, (grid_h*grid_w, d_model)
    (reference bird_mae.py:89-130 semantics: half the dims encode h, half w)."""
    assert d_model % 4 == 0
    d_half = d_model // 2

    def one_axis(positions: np.ndarray) -> np.ndarray:
        omega = np.arange(d_half // 2, dtype=np.float64) / (d_half / 2.0)
        omega = 1.0 / 10000**omega
        out = np.einsum("p,f->pf", positions.astype(np.float64), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    gh = np.arange(grid_h, dtype=np.float64)
    gw = np.arange(grid_w, dtype=np.float64)
    # Row-major grid: token (i, j) at index i*grid_w + j.
    emb_h = np.repeat(one_axis(gh), grid_w, axis=0)
    emb_w = np.tile(one_axis(gw), (grid_h, 1))
    return np.concatenate([emb_w, emb_h], axis=1).astype(np.float32)


def rope_periods(spec: Spec) -> np.ndarray:
    """The D_head/4 RoPE periods: log-spaced in [min_period, max_period], or
    base**(4k/d_head) (reference dinov3.py:166-176)."""
    d_head = spec.d_head
    assert d_head % 4 == 0
    n_per = d_head // 4
    if spec.rope_min_period is not None and spec.rope_max_period is not None:
        exps = np.linspace(0.0, 1.0, n_per, dtype=np.float64)
        return spec.rope_min_period * (
            (spec.rope_max_period / spec.rope_min_period) ** exps
        )
    return spec.rope_base ** (
        2.0 * np.arange(n_per, dtype=np.float64) / (d_head // 2)
    )


def rope_sincos_from_periods(
    periods: np.ndarray,
    grid_h: int,
    grid_w: int,
    normalize_coords: str = "separate",
) -> tuple[np.ndarray, np.ndarray]:
    """Axial RoPE sin/cos tables for a (grid_h, grid_w) patch grid.

    DINOv3-style (reference dinov3.py:178-215): patch-center coordinates
    normalized to [-1, 1]; per position the angle vector is
    [h·2π/periods, w·2π/periods] tiled twice across the head dim, pairing with
    the halves-based rotate_half. Returns (sin, cos), each (grid_h*grid_w, d_head).
    """
    if normalize_coords == "max":
        norm_h = norm_w = max(grid_h, grid_w)
    elif normalize_coords == "min":
        norm_h = norm_w = min(grid_h, grid_w)
    else:
        norm_h, norm_w = grid_h, grid_w
    ch = (np.arange(grid_h, dtype=np.float64) + 0.5) / norm_h * 2.0 - 1.0
    cw = (np.arange(grid_w, dtype=np.float64) + 0.5) / norm_w * 2.0 - 1.0

    hh = np.repeat(ch, grid_w)
    ww = np.tile(cw, grid_h)
    ang_h = hh[:, None] * (2.0 * np.pi / periods)[None, :]
    ang_w = ww[:, None] * (2.0 * np.pi / periods)[None, :]
    angles = np.concatenate([ang_h, ang_w], axis=1)  # (N, d_head/2)
    angles = np.tile(angles, (1, 2))  # (N, d_head)
    return np.sin(angles).astype(np.float32), np.cos(angles).astype(np.float32)


def rope_sincos_pe(
    d_head: int, base: float, grid_h: int, grid_w: int
) -> tuple[np.ndarray, np.ndarray]:
    """Meta Perception Encoder Rope2D angle tables (halves layout).

    Per the PE source (perception_models rope.py, mirrored by timm's port):
    freq_m = base^(-4m/d_head) for m < d_head/4; token at flat index i has
    integer coords t_x = i % W, t_y = i // W; the angle vector is
    [t_x·freq..., t_y·freq...]. The source applies these to interleaved
    channel pairs; here they are laid out for halves-based rotate_half, which
    matches exactly once q/k channels are permuted by
    `convert.interleave_to_halves`.
    """
    assert d_head % 4 == 0
    n_per = d_head // 4
    freq = 1.0 / base ** (
        4.0 * np.arange(n_per, dtype=np.float64) / d_head
    )
    idx = np.arange(grid_h * grid_w)
    tx = (idx % grid_w).astype(np.float64)
    ty = (idx // grid_w).astype(np.float64)
    ang_x = tx[:, None] * freq[None, :]
    ang_y = ty[:, None] * freq[None, :]
    angles = np.concatenate([ang_x, ang_y], axis=1)  # (N, d_head/2)
    angles = np.tile(angles, (1, 2))  # (N, d_head)
    return np.sin(angles).astype(np.float32), np.cos(angles).astype(np.float32)


def rope_angles(spec: Spec, grid_h: int, grid_w: int) -> tuple[np.ndarray, np.ndarray]:
    """Spec-derived RoPE tables (see rope_sincos_from_periods / rope_sincos_pe)."""
    if spec.rope_style == "pe":
        return rope_sincos_pe(spec.d_head, spec.rope_base, grid_h, grid_w)
    return rope_sincos_from_periods(
        rope_periods(spec), grid_h, grid_w, spec.rope_normalize_coords
    )


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(
    x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor, n_prefix: int
) -> torch.Tensor:
    """Apply RoPE to patch tokens only; prefix (CLS/storage) tokens untouched.

    x: (B, H, N, d_head); sin/cos: (N_patches, d_head) shared across the batch, or
    (B, N_patches, d_head) per-example (DINOv3 variable aspect grids).
    """
    if sin.ndim == 3:
        sin = sin[:, None, :, :]
        cos = cos[:, None, :, :]
    prefix, patches = x[:, :, :n_prefix, :], x[:, :, n_prefix:, :]
    rotated = patches * cos + _rotate_half(patches) * sin
    return torch.cat([prefix, rotated.to(x.dtype)], dim=2)


# ---------------------------------------------------------------------------
# Products
# ---------------------------------------------------------------------------


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")


def _bf16(x: torch.Tensor, precision: str) -> bool:
    """Whether this forward's products take bf16 operands: "default" where
    `modeling._bf16_operands` says so (on the card)."""
    return precision == "default" and modeling._bf16_operands(x)


def _dense(x: torch.Tensor, p: dict, bf16: bool) -> torch.Tensor:
    """x @ w + b with a float32 result; x (..., d_in)."""
    if bf16:
        lead = x.shape[:-1]
        y = modeling._mm_bf16(x.reshape(-1, x.shape[-1]), p["w"])
        return y.reshape(*lead, y.shape[-1]) + p["b"]
    return x @ p["w"] + p["b"]


def _attention(q, k, v, scale: float, bf16: bool) -> torch.Tensor:
    """softmax(q k^T * scale) v over (B, H, T, d_head), float32 result.

    On the bf16 route a CUDA tensor takes `F.scaled_dot_product_attention` on
    bf16 q, k and v (its probabilities in bf16 before the second product, as
    a fused attention kernel keeps them); a CPU tensor takes its plain
    version, matmul-softmax-matmul on the same rounded operands. Otherwise the
    JAX package's float32 algebra: (q * scale) k^T, softmax, then v."""
    if bf16:
        q16, k16, v16 = (t.to(torch.bfloat16) for t in (q, k, v))
        if q.is_cuda:
            return F.scaled_dot_product_attention(q16, k16, v16, scale=scale).float()
        s = (q16.float() @ k16.float().transpose(-1, -2)) * scale
        p = torch.softmax(s, dim=-1).to(torch.bfloat16)
        return p.float() @ v16.float()
    attn = (q * scale) @ k.transpose(-1, -2)
    return torch.softmax(attn, dim=-1) @ v


def _layer_norm(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p["g"], p["b"], eps)


def _act(h: torch.Tensor, act: str) -> torch.Tensor:
    if act == "quick_gelu":
        return h * torch.sigmoid(1.702 * h)
    return F.gelu(h, approximate="tanh" if act == "gelu_tanh" else "none")


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def embed_tokens(spec: Spec, params: dict, tokens: torch.Tensor, *, bf16: bool = False) -> torch.Tensor:
    """Patch tokens (B, N, c*p*p) -> embedded sequence with CLS/registers.

    Input is pre-patchified (host-side `transforms.patchify`), so the embedding is
    one product.
    """
    b = tokens.shape[0]
    x = _dense(tokens, params["patch_embed"], bf16)
    prefix = []
    if spec.cls_token:
        prefix.append(params["cls"].expand(b, 1, spec.d_model))
    if spec.n_registers:
        prefix.append(params["reg"].expand(b, spec.n_registers, spec.d_model))
    if prefix:
        x = torch.cat(prefix + [x], dim=1)
    return x


def _apply_block(spec: Spec, blk: dict, x, sin, cos, bf16: bool = False):
    """One transformer block; returns (x_out, sites) where sites maps every
    internal tap point (norm1/attn_out/norm2/mlp_out) to its activation
    (saev_tpu/models/vit.py:344)."""
    b, t, d = x.shape
    n_prefix = spec.n_prefix_tokens
    scale = 1.0 / np.sqrt(spec.d_head)

    h = _layer_norm(x, blk["ln1"], spec.ln_eps)
    h_norm1 = h
    qkv = _dense(h, blk["attn"]["qkv"], bf16)

    def heads(z):
        return z.reshape(b, t, spec.n_heads, spec.d_head).transpose(1, 2)

    q, k, v = (heads(z) for z in qkv.chunk(3, dim=-1))
    if spec.qk_norm:
        q = _layer_norm(q, blk["attn"]["q_norm"], spec.ln_eps)
        k = _layer_norm(k, blk["attn"]["k_norm"], spec.ln_eps)
    if sin is not None:
        q = apply_rope(q, sin, cos, n_prefix)
        k = apply_rope(k, sin, cos, n_prefix)

    o = _attention(q, k, v, scale, bf16)
    o = o.transpose(1, 2).reshape(b, t, d)
    o = _dense(o, blk["attn"]["proj"], bf16)
    if spec.layerscale:
        o = o * blk["ls1"]
    attn_out = o
    x = x + o

    h = _layer_norm(x, blk["ln2"], spec.ln_eps)
    h_norm2 = h
    if spec.mlp_kind == "swiglu":
        h1, h2 = _dense(h, blk["mlp"]["w12"], bf16).chunk(2, dim=-1)
        h = _dense(F.silu(h1) * h2, blk["mlp"]["w3"], bf16)
    else:
        h = _act(_dense(h, blk["mlp"]["fc1"], bf16), spec.act)
        h = _dense(h, blk["mlp"]["fc2"], bf16)
    if spec.layerscale:
        h = h * blk["ls2"]
    x = x + h
    sites = {
        "norm1": h_norm1,
        "attn_out": attn_out,
        "norm2": h_norm2,
        "mlp_out": h,
    }
    return x, sites


def _as_table(t, device) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.float32).to(device)


def _rope_tables(spec: Spec, grid, rope_sincos, device):
    if spec.pos_kind != "rope":
        return None, None
    if rope_sincos is None:
        rope_sincos = rope_angles(spec, *grid)
    return tuple(_as_table(t, device) for t in rope_sincos)


def _embed_with_pos(
    spec: Spec,
    params: dict,
    tokens: torch.Tensor,
    grid: tuple[int, int],
    *,
    pos_override: torch.Tensor | None = None,
    rope_sincos=None,
    bf16: bool = False,
):
    """Shared forward preamble: patch embedding + positional encoding + rope
    tables + pre-norm (saev_tpu/models/vit.py:425). Returns (x, sin, cos)."""
    x = embed_tokens(spec, params, tokens, bf16=bf16)
    _, t, d = x.shape
    n_prefix = spec.n_prefix_tokens
    gh, gw = grid

    if spec.pos_kind == "learned" or (spec.pos_kind == "rope" and spec.rope_abs_pos):
        pos = pos_override if pos_override is not None else params["pos"]
        assert pos.shape[0] == t, (
            f"pos table has {pos.shape[0]} entries for {t} tokens; interpolate "
            "with `interpolate_pos` before calling forward"
        )
        x = x + _as_table(pos, x.device)
    elif spec.pos_kind == "sincos2d":
        pos = sincos_2d(d, gh, gw)
        if n_prefix:
            pos = np.concatenate([np.zeros((n_prefix, d), pos.dtype), pos], axis=0)
        x = x + _as_table(pos, x.device)

    sin, cos = _rope_tables(spec, grid, rope_sincos, x.device)
    if spec.pre_norm:
        x = _layer_norm(x, params["ln_pre"], spec.ln_eps)
    return x, sin, cos


def _precision_scope(precision: str):
    """For "highest", float32 products with TF32 off."""
    _check_precision(precision)
    return modeling._f32_products() if precision == "highest" else contextlib.nullcontext()


def forward(
    spec: Spec,
    params: dict,
    tokens: torch.Tensor,
    layers: tuple[int, ...],
    *,
    grid: tuple[int, int],
    pos_override: torch.Tensor | None = None,
    rope_sincos=None,
    precision: str = "default",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the ViT, tapping the residual stream after each layer in `layers`
    (saev_tpu/models/vit.py:472).

    Args:
        tokens: (B, N_patches, c*p*p) pre-patchified pixels.
        layers: block indices to record (negative indices allowed).
        grid: (grid_h, grid_w) patch grid.
        pos_override: optional (n_tokens, d_model) positional table overriding the
            spec's default (used for learned-pos interpolation).
        rope_sincos: optional host-built (sin, cos) tables, (N_patches, d_head)
            or per example (B, N_patches, d_head).
        precision: "default" (bf16 operands on the card) or "highest".

    Returns:
        (x_final, taps) — x_final (B, T, D) after final norm; taps
        (B, len(layers), T, D) raw residual stream (pre-final-norm), CLS first.
    """
    layers = tuple(i % spec.n_layers for i in layers)
    with _precision_scope(precision):
        bf16 = _bf16(tokens, precision)
        x, sin, cos = _embed_with_pos(
            spec, params, tokens, grid,
            pos_override=pos_override, rope_sincos=rope_sincos, bf16=bf16,
        )
        taps = []
        for i, blk in enumerate(params["blocks"]):
            x, sites = _apply_block(spec, blk, x, sin, cos, bf16)
            if i in layers:
                tap = sites["norm2"] if spec.tap_point == "norm2" else x
                taps.append(tap.float())

        assert len(taps) == len(set(layers)), (
            f"Requested layers {layers} out of range for n_layers={spec.n_layers}"
        )
        # Taps were appended in block order; reorder to match the requested order.
        taps_arr = torch.stack(taps, dim=1)
        block_order = sorted(set(layers))
        idx = [block_order.index(i) for i in layers]
        if idx != list(range(len(layers))):
            taps_arr = taps_arr[:, idx]

        x_out = x.float()
        if spec.final_norm:
            x_out = _layer_norm(x_out, params["ln_f"], spec.ln_eps)
    return x_out, taps_arr


SITE_NAMES = ("resid", "norm1", "attn_out", "norm2", "mlp_out")


def forward_sites(
    spec: Spec,
    params: dict,
    tokens: torch.Tensor,
    *,
    grid: tuple[int, int],
    precision: str = "default",
) -> dict[str, torch.Tensor]:
    """Run the ViT recording EVERY internal site of EVERY block
    (saev_tpu/models/vit.py:529).

    Returns {site: (B, n_layers, T, D) float32} for sites `SITE_NAMES`
    ("resid" is the residual stream after each block).
    """
    with _precision_scope(precision):
        bf16 = _bf16(tokens, precision)
        x, sin, cos = _embed_with_pos(spec, params, tokens, grid, bf16=bf16)
        recorded: dict[str, list] = {name: [] for name in SITE_NAMES}
        for blk in params["blocks"]:
            x, sites = _apply_block(spec, blk, x, sin, cos, bf16)
            recorded["resid"].append(x.float())
            for name in ("norm1", "attn_out", "norm2", "mlp_out"):
                recorded[name].append(sites[name].float())
    return {name: torch.stack(acts, dim=1) for name, acts in recorded.items()}


def forward_from(
    spec: Spec,
    params: dict,
    x_tap: torch.Tensor,
    start_layer: int,
    *,
    grid: tuple[int, int],
    rope_sincos=None,
    precision: str = "default",
) -> torch.Tensor:
    """Continue the forward from a residual tap: run blocks [start_layer+1:)
    plus the final norm (saev_tpu/models/vit.py:557).

    Only valid for `tap_point == "block"` taps (the residual stream after block
    `start_layer`).
    """
    assert spec.tap_point == "block"
    with _precision_scope(precision):
        bf16 = _bf16(x_tap, precision)
        sin, cos = _rope_tables(spec, grid, rope_sincos, x_tap.device)
        x = x_tap
        for blk in params["blocks"][start_layer + 1 :]:
            x, _ = _apply_block(spec, blk, x, sin, cos, bf16)
        x = x.float()
        if spec.final_norm:
            x = _layer_norm(x, params["ln_f"], spec.ln_eps)
    return x


def _bicubic(x: float) -> float:
    """Pillow's bicubic kernel (a = -0.5, support 2; Resample.c
    `bicubic_filter`), in its order of operations."""
    a = -0.5
    if x < 0.0:
        x = -x
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _bicubic_taps(n_in: int, n_out: int) -> list[tuple[int, list[float]]]:
    """Each output's first input and its weights, as Pillow's
    `precompute_coeffs` makes them for a resize of the whole axis: centers at
    (i + 0.5) * scale, the support widened by the scale where the axis
    shrinks, bounds rounded by truncation, weights normalized to sum to 1."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ss = 1.0 / filterscale
    taps = []
    for i in range(n_out):
        center = (i + 0.5) * scale
        first = max(int(center - support + 0.5), 0)
        count = min(int(center + support + 0.5), n_in) - first
        weights = [_bicubic((x + first - center + 0.5) * ss) for x in range(count)]
        total = 0.0
        for w in weights:
            total += w
        if total != 0.0:
            weights = [w / total for w in weights]
        taps.append((first, weights))
    return taps


def _resample_axis(img: np.ndarray, axis: int, n_out: int) -> np.ndarray:
    """One pass of Pillow's BICUBIC resize of a float32 image ("F" mode) along
    `axis`: each output a float64 sum taken tap by tap in order, stored as
    float32 (Resample.c `ImagingResample{Horizontal,Vertical}_32bpc`). An
    axis that keeps its size is passed through, as Pillow skips its pass."""
    if img.shape[axis] == n_out:
        return img
    src = np.moveaxis(img, axis, 0)
    out = np.empty((n_out,) + src.shape[1:], np.float32)
    for i, (first, weights) in enumerate(_bicubic_taps(src.shape[0], n_out)):
        acc = np.zeros(src.shape[1:], np.float64)
        for j, w in enumerate(weights):
            acc += src[first + j].astype(np.float64) * w
        out[i] = acc
    return np.moveaxis(out, 0, axis)


def interpolate_pos(
    pos: np.ndarray, n_prefix: int, grid_from: tuple[int, int], grid_to: tuple[int, int]
) -> np.ndarray:
    """Bicubic-interpolate a learned positional table to a new patch grid
    (DINOv2-style; prefix entries pass through): the JAX package's Pillow
    resize of each channel as a mode-"F" image (saev_tpu/models/vit.py:592),
    in numpy, bit for bit: the horizontal pass, then the vertical pass on its
    float32 result."""
    if grid_from == grid_to:
        return pos
    prefix, patch = pos[:n_prefix], pos[n_prefix:]
    h0, w0 = grid_from
    h1, w1 = grid_to
    d = patch.shape[1]
    img = patch.reshape(h0, w0, d).astype(np.float32)
    out = _resample_axis(_resample_axis(img, 1, w1), 0, h1)
    return np.concatenate([prefix, out.reshape(h1 * w1, d)], axis=0).astype(np.float32)


def run(
    spec: Spec,
    params: dict,
    tokens,
    layers: tuple[int, ...],
    grid: tuple[int, int],
    *,
    rope_sincos=None,
    precision: str = "default",
) -> tuple[np.ndarray, np.ndarray]:
    """`forward` on the params' device from host tokens; returns float32 numpy
    (out, taps) (saev_tpu/models/vit.py:640). One device: where the JAX
    package shards a batch over its devices, the port splits the work by
    whole batches, one process a card (`data/extract.py`'s `worker_fn`,
    `parallel.batch_spans`)."""
    device = params_device(params)
    x = torch.as_tensor(np.asarray(tokens, dtype=np.float32)).to(device)
    with torch.no_grad():
        out, taps = forward(
            spec, params, x, tuple(layers), grid=tuple(grid), rope_sincos=rope_sincos,
            precision=precision,
        )
    return out.cpu().numpy(), taps.cpu().numpy()
