"""Sparse autoencoder core on PyTorch tensors (counterpart of
saev_tpu/nn/modeling.py).

The configs are jax-free copies of the JAX package's dataclasses, with the
same field names and defaults, so sweep files and checkpoint headers read the
same in both packages (tests hold the copies to the originals). Parameters are
a plain dict with the JAX package's keys and layouts:
`{"W_enc": (d_model, d_sae), "b_enc": (d_sae,), "W_dec": (d_sae, d_model),
"b_dec": (d_model,)}`.

Matmul precision, as the JAX package names it (saev_tpu/nn/modeling.py:38-50):
the products here take a `precision`, "highest" or "default" (`matmul`).
"highest", the default of `encode`, `decode` and the log-step metrics, is a
full float32 product (torch's float32 matmul precision "highest", its default,
TF32 off). "default", the train step's, means bf16 operands with float32
accumulation and result on the card, as on the TPU: each operand rounded to
bf16 to nearest even, `torch.mm(..., out_dtype=torch.float32)`, the bias
added in float32 after the product; the backward's products take bf16
operands too. On a CPU tensor "default" is a float32 product, as JAX-CPU's
DEFAULT is. "high" (bf16x3 in the JAX package) belongs to the decode path,
which is not ported yet, and raises.
"""

import dataclasses
import typing as tp

import numpy as np
import torch

from .. import ops

Params = dict[str, torch.Tensor]
State = dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Sparsity / aux-loss / activation configs (saev_tpu/nn/modeling.py:59-156).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NoSparsity:
    """No explicit sparsity penalty (TopK/BatchTopK control sparsity via k)."""

    key: tp.Literal["no-sparsity"] = "no-sparsity"

    def loss(self, f_x: torch.Tensor) -> torch.Tensor:
        return torch.zeros((), dtype=f_x.dtype, device=f_x.device)


@dataclasses.dataclass(frozen=True)
class L1Sparsity:
    key: tp.Literal["l1-sparsity"] = "l1-sparsity"
    coeff: float = 1e-4

    def loss(self, f_x: torch.Tensor) -> torch.Tensor:
        return f_x.abs().sum(dim=1).mean(dim=0) * self.coeff


Sparsity = NoSparsity | L1Sparsity


@dataclasses.dataclass(frozen=True)
class NoAux:
    """No auxiliary loss (e.g., for ReLU)."""

    key: tp.Literal["no-aux"] = "no-aux"


@dataclasses.dataclass(frozen=True)
class AuxK:
    """AuxK auxiliary reconstruction loss for dead latents."""

    key: tp.Literal["auxk"] = "auxk"
    k_aux: int = 512
    alpha: float = 1 / 32


Aux = AuxK | NoAux


@dataclasses.dataclass(frozen=True)
class Relu:
    """Vanilla ReLU."""

    key: tp.Literal["relu"] = "relu"
    sparsity: Sparsity = L1Sparsity(coeff=4e-4)
    aux: Aux = NoAux()


@dataclasses.dataclass(frozen=True)
class TopK:
    key: tp.Literal["top-k"] = "top-k"
    top_k: int = 32
    """How many values are allowed to be non-zero."""
    sparsity: Sparsity = NoSparsity()
    aux: Aux = AuxK()

    def __post_init__(self):
        if self.top_k <= 0:
            raise ValueError("top_k must be a positive integer.")


@dataclasses.dataclass(frozen=True)
class BatchTopK:
    key: tp.Literal["batch-top-k"] = "batch-top-k"
    top_k: int = 32
    """Average non-zero values per sample across the batch."""
    sparsity: Sparsity = NoSparsity()
    momentum: float = 0.1
    aux: AuxK = AuxK()

    def __post_init__(self):
        if self.top_k <= 0:
            raise ValueError("top_k must be a positive integer.")


ActivationConfig = Relu | TopK | BatchTopK


@dataclasses.dataclass(frozen=True)
class SparseAutoencoderConfig:
    """SAE architecture + init/optimization knobs."""

    d_model: int = 1024
    """Size of x."""
    d_sae: int = 1024 * 16
    """Number of features in SAE latent space; size of f(x)."""
    activation: ActivationConfig = TopK()
    """Activation function."""
    reinit_blend: float = 0.8
    """Blend factor between real datapoints and Kaiming noise at init."""
    reinit_enc_dec_tranpose: bool = True
    """Whether datapoint init also sets W_dec = W_enc^T."""
    remove_parallel_grads: bool = True
    """Project decoder grads off the unit-norm row direction."""
    normalize_w_dec: bool = True
    """Keep W_dec rows unit-norm."""


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


class EncodeOut(tp.NamedTuple):
    h_x: torch.Tensor  # (batch, d_sae) pre-activations
    f_x: torch.Tensor  # (batch, d_sae) activated latents


def init(
    cfg: SparseAutoencoderConfig,
    generator: torch.Generator | None = None,
    device: torch.device | str = "cuda",
) -> tuple[Params, State]:
    """W_dec ~ Kaiming-uniform (bound sqrt(6/d_model)), rows normalized,
    W_enc = W_dec^T, zero biases. The random stream differs from the JAX
    package's by design: only trained weights carry over."""
    bound = float(np.sqrt(6.0 / cfg.d_model))
    w_dec = torch.empty((cfg.d_sae, cfg.d_model), dtype=torch.float32, device=device)
    w_dec.uniform_(-bound, bound, generator=generator)
    if cfg.normalize_w_dec:
        w_dec = w_dec / torch.linalg.norm(w_dec, dim=1, keepdim=True)
    params = {
        "W_dec": w_dec,
        "b_dec": torch.zeros((cfg.d_model,), dtype=torch.float32, device=device),
        "W_enc": w_dec.T.contiguous(),
        "b_enc": torch.zeros((cfg.d_sae,), dtype=torch.float32, device=device),
    }
    return params, init_state(cfg, device)


def init_state(cfg: SparseAutoencoderConfig, device: torch.device | str = "cuda") -> State:
    return {"threshold": torch.zeros((), dtype=torch.float32, device=device)}


def params_from_numpy(params: dict[str, np.ndarray], device) -> Params:
    """Carry weights over from the JAX package (arrays from `np.asarray`)."""
    return {
        k: torch.tensor(np.asarray(v), device=device) for k, v in params.items()
    }


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


# saev_tpu/nn/modeling.py:44: eval and inference always run at "highest".
MATMUL_PRECISION = "highest"
PRECISIONS = ("highest", "high", "default")


def has_bf16_mm_f32() -> bool:
    """Whether the installed torch has `torch.mm(..., out_dtype=...)`, a
    product of bf16 operands with an f32 result."""
    return "dtype" in torch.ops.aten.mm.overloads()


def _bf16_operands(t: torch.Tensor) -> bool:
    """Whether "default" takes bf16 operands for a product on t's device: on
    the card, as on the TPU; JAX-CPU's DEFAULT is f32, and so is this
    package's on the CPU. Tests monkeypatch this to run the card's algebra on
    the CPU, where `_mm_bf16` then takes its plain version."""
    return t.is_cuda


def _mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16(a) @ bf16(b) with f32 accumulation and result (2-D operands,
    either may be a transposed view). On a CUDA tensor one cuBLAS product;
    on a CPU tensor its plain version, an f32 product of the rounded
    operands (the products of two bf16 values are exact in f32)."""
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if not a.is_cuda:
        return a16.float() @ b16.float()
    if not has_bf16_mm_f32():
        raise RuntimeError(
            f'matmul_precision "default" takes bf16 operands with an f32 result, and torch '
            f"{torch.__version__} has no torch.mm(..., out_dtype=torch.float32)"
        )
    return torch.mm(a16, b16, out_dtype=torch.float32)


class _MatmulBF16(torch.autograd.Function):
    """a @ b at "default": bf16 operands, f32 result; the backward's two
    products take bf16 operands too, as the transpose of the JAX package's
    dot at DEFAULT does. Saves the bf16 operands, not the f32 ones."""

    @staticmethod
    def forward(ctx, a, b):
        a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
        ctx.save_for_backward(a16, b16)
        return _mm_bf16(a16, b16)

    @staticmethod
    def backward(ctx, g):
        a16, b16 = ctx.saved_tensors
        da = _mm_bf16(g, b16.T) if ctx.needs_input_grad[0] else None
        db = _mm_bf16(a16.T, g) if ctx.needs_input_grad[1] else None
        return da, db


def _check_precision(precision: str) -> None:
    if precision == "high":
        raise NotImplementedError('matmul_precision "high" (bf16x3) takes the decode path, not ported yet')
    if precision not in PRECISIONS:
        raise ValueError(f"Unknown matmul precision: {precision!r}; expected one of {PRECISIONS}")


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b for 2-D f32 operands at `precision` ("highest" or "default", as
    the module docstring defines them)."""
    _check_precision(precision)
    if precision == "default" and _bf16_operands(a):
        return _MatmulBF16.apply(a, b)
    return a @ b


class _LinearBias(torch.autograd.Function):
    """x @ w + b whose backward computes dW and db in one product:
    d[W; b] = [x; 1]^T @ dh (saev_tpu/nn/modeling.py:288-318), at the
    forward's precision, so db takes the same rounding as dW; dx only when it
    is asked for."""

    @staticmethod
    def forward(ctx, x, w, b, precision):
        _check_precision(precision)
        ctx.bf16 = precision == "default" and _bf16_operands(x)
        if ctx.bf16:
            # The rounded operands are what the backward reads: save them.
            x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
            ctx.save_for_backward(x, w if ctx.needs_input_grad[0] else None)
            return _mm_bf16(x, w) + b
        ctx.save_for_backward(x, w)
        return x @ w + b

    @staticmethod
    def backward(ctx, dh):
        x, w = ctx.saved_tensors
        mm = _mm_bf16 if ctx.bf16 else torch.mm
        dx = dw = db = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            # [x; 1], padded with zero columns to a multiple of 8 so that a
            # bf16 operand's rows stay 16-byte aligned for cuBLAS.
            d = x.shape[1]
            xa = torch.zeros((x.shape[0], -(-(d + 1) // 8) * 8), dtype=x.dtype, device=x.device)
            xa[:, :d] = x
            xa[:, d] = 1
            dwb = mm(xa.T, dh)
            dw, db = dwb[:d], dwb[d]
        if ctx.needs_input_grad[0]:
            dx = mm(dh, w.T)
        return dx, dw, db, None


def _linear_bias(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    return _LinearBias.apply(x, w, b, precision)


def topk_activation(h: torch.Tensor, k: int) -> torch.Tensor:
    """Per-row TopK as a threshold mask: keeps every entry >= the exact k-th
    largest, ties included (torch.topk's mask would keep exactly k)."""
    kth = ops.exact_kth_value(h.detach(), min(k, h.shape[-1]))
    return torch.where(h >= kth, h, torch.zeros((), dtype=h.dtype, device=h.device))


def encode(
    cfg: SparseAutoencoderConfig, params: Params, state: State, x: torch.Tensor, *,
    training: bool, precision: str | None = None,
) -> tuple[EncodeOut, State]:
    """x @ W_enc + b_enc at `precision` (None: MATMUL_PRECISION), then the
    activation. Ported for TopK (the threshold mask is the same in train
    and eval mode)."""
    if x.ndim != 2 or x.shape[1] != params["W_enc"].shape[0]:
        raise ValueError(
            f"x has shape {tuple(x.shape)}; expected (batch, {cfg.d_model}) "
            f"activations for this {cfg.d_model}-d SAE"
        )
    act = cfg.activation
    if not isinstance(act, TopK):
        raise NotImplementedError(f"encode for {type(act).__name__} is not ported yet")
    h_x = _linear_bias(x, params["W_enc"], params["b_enc"], precision or MATMUL_PRECISION)
    return EncodeOut(h_x=h_x, f_x=topk_activation(h_x, act.top_k)), state


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def decode(
    cfg: SparseAutoencoderConfig, params: Params, f_x: torch.Tensor,
    prefixes: torch.Tensor | None = None, *, precision: str | None = None,
) -> torch.Tensor:
    """Decode latents to per-prefix reconstructions (batch, n_prefixes,
    d_model). Ported for prefixes=None and a single prefix (which must be
    d_sae): one product at `precision` (None: MATMUL_PRECISION) plus b_dec,
    returned as (batch, 1, d_model).

    The multi-prefix decode (saev_tpu/nn/modeling.py:413-467), which eval and
    high-precision training take, raises NotImplementedError.
    """
    if f_x.ndim != 2 or f_x.shape[1] != params["W_dec"].shape[0]:
        raise ValueError(
            f"f_x has shape {tuple(f_x.shape)}; expected (batch, {cfg.d_sae}) "
            f"latents for this {cfg.d_sae}-latent SAE"
        )
    if prefixes is not None and prefixes.shape[0] > 1:
        raise NotImplementedError("the multi-prefix decode is not ported yet")
    return (matmul(f_x, params["W_dec"], precision or MATMUL_PRECISION) + params["b_dec"])[:, None, :]


# ---------------------------------------------------------------------------
# Decoder-norm constraints
# ---------------------------------------------------------------------------


def normalize_w_dec(cfg: SparseAutoencoderConfig, params: Params) -> Params:
    """Unit-norm W_dec rows (no-op if cfg.normalize_w_dec is False). Works on
    one SAE's params or on a stacked sweep (leading n_sae axis)."""
    if not cfg.normalize_w_dec:
        return params
    w = params["W_dec"]
    return {**params, "W_dec": w / torch.linalg.norm(w, dim=-1, keepdim=True)}


def remove_parallel_grads(cfg: SparseAutoencoderConfig, params: Params, grads: Params) -> Params:
    """Remove the gradient component parallel to each W_dec row (rows are
    unit-norm constrained, so that component only fights normalize_w_dec)."""
    if not cfg.remove_parallel_grads:
        return grads
    w = params["W_dec"]
    g = grads["W_dec"]
    parallel = torch.sum(g * w, dim=-1)
    norm_sq = torch.sum(w * w, dim=-1)
    scales = torch.where(
        norm_sq > 0, parallel / torch.where(norm_sq > 0, norm_sq, 1.0), 0.0
    )
    return {**grads, "W_dec": g - scales[..., None] * w}
