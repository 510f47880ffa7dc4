"""Sparse autoencoder core on PyTorch tensors (counterpart of
saev_tpu/nn/modeling.py).

The configs are jax-free copies of the JAX package's dataclasses, with the
same field names and defaults, so sweep files and checkpoint headers read the
same in both packages (tests hold the copies to the originals). Parameters are
a plain dict with the JAX package's keys and layouts:
`{"W_enc": (d_model, d_sae), "b_enc": (d_sae,), "W_dec": (d_sae, d_model),
"b_dec": (d_model,)}`.

Matmul precision: the plain f32 matmuls here (the encoder and its backward)
run in full float32, torch's default with TF32 off. That is what the train
step's `matmul_precision="default"` maps to in this package; the bf16
operands that "default" means on the TPU enter only through the kernels'
inputs, as on the TPU's fused path.
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
    device: torch.device | str = "cpu",
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


def init_state(cfg: SparseAutoencoderConfig, device: torch.device | str = "cpu") -> State:
    return {"threshold": torch.zeros((), dtype=torch.float32, device=device)}


def params_from_numpy(params: dict[str, np.ndarray], device) -> Params:
    """Carry weights over from the JAX package (arrays from `np.asarray`)."""
    return {
        k: torch.tensor(np.asarray(v), device=device) for k, v in params.items()
    }


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


class _LinearBias(torch.autograd.Function):
    """x @ w + b whose backward computes dW and db in one product:
    d[W; b] = [x; 1]^T @ dh (saev_tpu/nn/modeling.py:288-322)."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return x @ w + b

    @staticmethod
    def backward(ctx, dh):
        x, w = ctx.saved_tensors
        dx = dw = db = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            xa = torch.cat([x, torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device)], dim=1)
            dwb = xa.T @ dh.to(x.dtype)
            dw, db = dwb[:-1], dwb[-1]
        if ctx.needs_input_grad[0]:
            dx = (dh.to(w.dtype) @ w.T).to(x.dtype)
        return dx, dw, db


def _linear_bias(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _LinearBias.apply(x, w, b)


def topk_activation(h: torch.Tensor, k: int) -> torch.Tensor:
    """Per-row TopK as a threshold mask: keeps every entry >= the exact k-th
    largest, ties included (torch.topk's mask would keep exactly k)."""
    kth = ops.exact_kth_value(h.detach(), min(k, h.shape[-1]))
    return torch.where(h >= kth, h, torch.zeros((), dtype=h.dtype, device=h.device))


def encode(
    cfg: SparseAutoencoderConfig, params: Params, state: State, x: torch.Tensor, *,
    training: bool,
) -> tuple[EncodeOut, State]:
    """x @ W_enc + b_enc, then the activation. Ported for TopK (the
    threshold mask is the same in train and eval mode)."""
    if x.ndim != 2 or x.shape[1] != params["W_enc"].shape[0]:
        raise ValueError(
            f"x has shape {tuple(x.shape)}; expected (batch, {cfg.d_model}) "
            f"activations for this {cfg.d_model}-d SAE"
        )
    act = cfg.activation
    if not isinstance(act, TopK):
        raise NotImplementedError(f"encode for {type(act).__name__} is not ported yet")
    h_x = _linear_bias(x, params["W_enc"], params["b_enc"])
    return EncodeOut(h_x=h_x, f_x=topk_activation(h_x, act.top_k)), state


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
