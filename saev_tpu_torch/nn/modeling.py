"""Sparse autoencoder core on PyTorch tensors (counterpart of
saev_tpu/nn/modeling.py).

The configs are jax-free copies of the JAX package's dataclasses, with the
same field names and defaults, so sweep files and checkpoint headers read the
same in both packages (tests hold the copies to the originals). Parameters are
a plain dict with the JAX package's keys and layouts:
`{"W_enc": (d_model, d_sae), "b_enc": (d_sae,), "W_dec": (d_sae, d_model),
"b_dec": (d_model,)}`.

Matmul precision, as the JAX package names it (saev_tpu/nn/modeling.py:38-50):
the products here take a `precision`, "highest", "high" or "default"
(`matmul`). "highest", the default of `encode`, `decode`, `forward`, eval
and the log-step metrics, is a full float32 product: TF32 is off inside the
call, whatever the caller's torch.set_float32_matmul_precision says, and the
caller's setting is restored after (`_f32_products`); the backward's
products too. "default", the train step's, means bf16 operands with float32
accumulation and result on the card, as on the TPU: each operand rounded to
bf16 to nearest even, `torch.mm(..., out_dtype=torch.float32)`, the bias
added in float32 after the product; the backward's products take bf16
operands too. "high" is the TPU's bf16x3 on the card: each operand split
into hi = bf16(a) and lo = bf16(a - hi), and hi_a @ lo_b + lo_a @ hi_b +
hi_a @ hi_b summed in float32, the two small terms first, each a bf16
product with an f32 result (`_mm_bf16x3`), for about 16 bits of each
operand; the backward's products too. It is not TF32, whose operands keep
10 bits. On a CPU tensor "default" and "high" are float32 products, as
JAX-CPU's DEFAULT and HIGH are.

Latent-sharded ("feature-parallel") SAEs: with a `feature` group of
saev_tpu_torch.parallel, the params hold this member's latents [o, o +
d_sae / F) (W_enc's columns, b_enc, W_dec's rows; b_dec whole) and the
config keeps the whole d_sae. `encode` takes the whole row's TopK threshold
and BatchTopK's whole-batch one over the group, and `decode` sums each
member's partial products over it (differentiably, `parallel.sum_over`), so
every member gets the whole reconstruction.
"""

import contextlib
import dataclasses
import typing as tp

import numpy as np
import torch

from .. import ops, parallel

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


class Output(tp.NamedTuple):
    """Full SAE forward outputs for objectives and metrics
    (saev_tpu/nn/modeling.py:179)."""

    h_x: torch.Tensor  # (batch, d_sae)
    f_x: torch.Tensor  # (batch, d_sae)
    x_hats: torch.Tensor  # (batch, n_prefixes, d_model)


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
    """Whether "default" and "high" take bf16 operands for a product on t's
    device: on the card, as on the TPU; JAX-CPU's DEFAULT and HIGH are f32,
    and so are this package's on the CPU. Tests monkeypatch this to run the
    card's algebra on the CPU, where `_mm_bf16` and `_mm_bf16x3` then take
    their plain versions."""
    return t.is_cuda


# A product's form: an f32 product with TF32 off, bf16 operands ("default"
# on the card), or bf16x3 ("high" on the card).
F32, BF16, BF16X3 = "f32", "bf16", "bf16x3"


def _mode(precision: str, t: torch.Tensor) -> str:
    """The form of a product at `precision` on t's device."""
    _check_precision(precision)
    if precision == "highest" or not _bf16_operands(t):
        return F32
    return BF16 if precision == "default" else BF16X3


def _mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16(a) @ bf16(b) with f32 accumulation and result (2-D operands, or
    3-D ones batched over their leading axis; either may be a transposed
    view). On a CUDA tensor one cuBLAS
    product; on a CPU tensor its plain version, an f32 product of the rounded
    operands (the products of two bf16 values are exact in f32)."""
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if not a.is_cuda:
        return a16.float() @ b16.float()
    if not has_bf16_mm_f32():
        raise RuntimeError(
            f'matmul_precision "default" and "high" take bf16 operands with an f32 result, and torch '
            f"{torch.__version__} has no torch.mm(..., out_dtype=torch.float32)"
        )
    if a16.ndim == 2:
        return torch.mm(a16, b16, out_dtype=torch.float32)
    return torch.bmm(a16, b16, out_dtype=torch.float32)


def _split_bf16(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """a = hi + lo + r: hi = bf16(a), lo = bf16(a - hi), both to nearest
    even; a - hi is exact in f32, so |r| <= 2^-8 |a - hi| <= 2^-16 |a|."""
    hi = a.to(torch.bfloat16)
    return hi, (a - hi.float()).to(torch.bfloat16)


def _mm_bf16x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """"high" on the card, the TPU's bf16x3: (hi_a @ lo_b + lo_a @ hi_b) +
    hi_a @ hi_b, each term a bf16 product with f32 accumulation and result
    (`_mm_bf16`: one cuBLAS product on a CUDA tensor, its plain version on a
    CPU tensor), the two small terms summed first. lo_a @ lo_b is left out,
    as bf16x3 leaves it out: about 2^-16 of the product."""
    a_hi, a_lo = _split_bf16(a)
    b_hi, b_lo = _split_bf16(b)
    out = _mm_bf16(a_hi, b_lo)
    out += _mm_bf16(a_lo, b_hi)
    out += _mm_bf16(a_hi, b_hi)
    return out


@contextlib.contextmanager
def _f32_products():
    """TF32 off for the products inside: "highest" is a float32 product
    whatever the caller's torch.set_float32_matmul_precision says. The
    caller's setting is restored after."""
    prev = torch.get_float32_matmul_precision()
    if prev == "highest":
        yield
        return
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _mm(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == BF16:
        return _mm_bf16(a, b)
    if mode == BF16X3:
        return _mm_bf16x3(a, b)
    with _f32_products():
        return a @ b


class _Matmul(torch.autograd.Function):
    """a @ b in a product's form (`_mode`): with bf16 operands the operands
    are rounded once and the rounded ones saved, so the backward's two
    products take them, as the transpose of the JAX package's dot at
    DEFAULT does; at bf16x3 the f32 operands are saved and the backward's
    products are bf16x3 too, as HIGH's transpose is; an f32 product runs
    with TF32 off, forward and backward. 2-D operands, or 3-D ones batched
    over the leading axis."""

    @staticmethod
    def forward(ctx, a, b, mode):
        if mode == BF16:
            a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
        ctx.mode = mode
        ctx.save_for_backward(a, b)
        return _mm(a, b, mode)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = _mm(g, b.mT, ctx.mode) if ctx.needs_input_grad[0] else None
        db = _mm(a.mT, g, ctx.mode) if ctx.needs_input_grad[1] else None
        return da, db, None


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"Unknown matmul precision: {precision!r}; expected one of {PRECISIONS}")


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b for f32 operands at `precision` ("highest", "high" or
    "default", as the module docstring defines them): 2-D, or 3-D batched
    over the leading axis."""
    return _Matmul.apply(a, b, _mode(precision, a))


class _LinearBias(torch.autograd.Function):
    """x @ w + b whose backward computes dW and db in one product:
    d[W; b] = [x; 1]^T @ dh (saev_tpu/nn/modeling.py:288-318), in the
    forward's form, so db takes the same rounding as dW; dx only when it
    is asked for."""

    @staticmethod
    def forward(ctx, x, w, b, precision):
        ctx.mode = _mode(precision, x)
        if ctx.mode == BF16:
            # The rounded operands are what the backward reads: save them.
            x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
        ctx.save_for_backward(x, w if ctx.needs_input_grad[0] else None)
        return _mm(x, w, ctx.mode) + b

    @staticmethod
    def backward(ctx, dh):
        x, w = ctx.saved_tensors

        def mm(a, b):
            return _mm(a, b, ctx.mode)
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


def _width(h: torch.Tensor, feature: parallel.Group | None) -> int:
    """The whole row's width of this member's columns of it."""
    return h.shape[-1] * (1 if feature is None else feature.size)


def topk_activation(h: torch.Tensor, k: int, feature: parallel.Group | None = None) -> torch.Tensor:
    """Per-row TopK as a threshold mask: keeps every entry >= the exact k-th
    largest, ties included (torch.topk's mask would keep exactly k). With a
    `feature` group, of the whole row."""
    kth = ops.exact_kth_value(h.detach(), min(k, _width(h, feature)), group=feature)
    return torch.where(h >= kth, h, torch.zeros((), dtype=h.dtype, device=h.device))


def batch_topk_train(
    h: torch.Tensor, k: int, momentum: torch.Tensor | float, threshold: torch.Tensor,
    group: parallel.Group | None = None, feature: parallel.Group | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """BatchTopK in training mode (saev_tpu/nn/modeling.py:249-273): keeps
    every entry >= the batch's k * B-th largest (`ops.batch_global_kth_value`,
    ties kept), then moves the EMA of the least positive kept value, the
    eval-time threshold: (1 - momentum) * threshold + momentum * that value,
    or the threshold unchanged where no kept value is positive. Returns (f,
    new threshold).

    With a data `group` (saev_tpu_torch.parallel), `h` is this rank's rows
    of the batch: B, the k * B-th value and the least positive kept value
    are the whole batch's, the same on every rank of the group. With a
    `feature` group, `h` is this member's columns, and both are the whole
    dictionary's too."""
    bsz = h.shape[0] * (1 if group is None else group.size)
    d_sae = _width(h, feature)
    kth = ops.batch_global_kth_value(h, min(k * bsz, d_sae * bsz), group=group, feature=feature)
    zero = torch.zeros((), dtype=h.dtype, device=h.device)
    f = torch.where(h >= kth, h, zero)
    with torch.no_grad():
        pos_min = torch.where(f > 0, f, torch.full((), float("inf"), dtype=h.dtype, device=h.device)).min()
        parallel.all_reduce(parallel.all_reduce(pos_min, "min", group), "min", feature)
        new_threshold = torch.where(
            torch.isfinite(pos_min), (1.0 - momentum) * threshold + momentum * pos_min, threshold
        )
    return f, new_threshold


def batch_topk_eval(h: torch.Tensor, threshold: torch.Tensor) -> torch.Tensor:
    """BatchTopK in eval mode: JumpReLU at the learned threshold, plain ReLU
    where it is <= 0 (saev_tpu/nn/modeling.py:276-283)."""
    zero = torch.zeros((), dtype=h.dtype, device=h.device)
    return torch.where(h > torch.maximum(threshold, zero), h, zero)


def encode(
    cfg: SparseAutoencoderConfig, params: Params, state: State, x: torch.Tensor, *,
    training: bool, momentum: torch.Tensor | float | None = None, precision: str | None = None,
    group: parallel.Group | None = None, feature: parallel.Group | None = None,
) -> tuple[EncodeOut, State]:
    """x @ W_enc + b_enc at `precision` (None: MATMUL_PRECISION), then the
    activation (saev_tpu/nn/modeling.py:325-370): Relu, TopK (the threshold
    mask, the same in train and eval mode) or BatchTopK.

    Returns (EncodeOut, new_state): a BatchTopK forward in training mode
    carries the moved EMA threshold, every other returns `state`.
    `momentum` overrides BatchTopK's configured momentum with a per-SAE
    value (the sweep's hp["momentum"]). A data `group` makes BatchTopK's
    training forward take the whole batch's threshold (`batch_topk_train`);
    a `feature` group makes the params this member's latents and TopK's and
    BatchTopK's thresholds the whole dictionary's (module doc)."""
    if x.ndim != 2 or x.shape[1] != params["W_enc"].shape[0]:
        raise ValueError(
            f"x has shape {tuple(x.shape)}; expected (batch, {cfg.d_model}) "
            f"activations for this {cfg.d_model}-d SAE"
        )
    h_x = _linear_bias(x, params["W_enc"], params["b_enc"], precision or MATMUL_PRECISION)
    act = cfg.activation
    new_state = state
    if isinstance(act, Relu):
        f_x = torch.relu(h_x)
    elif isinstance(act, TopK):
        f_x = topk_activation(h_x, act.top_k, feature)
    elif isinstance(act, BatchTopK):
        if training:
            f_x, threshold = batch_topk_train(
                h_x, act.top_k, act.momentum if momentum is None else momentum, state["threshold"], group, feature
            )
            new_state = {**state, "threshold": threshold}
        else:
            f_x = batch_topk_eval(h_x, state["threshold"])
    else:
        tp.assert_never(act)
    return EncodeOut(h_x=h_x, f_x=f_x), new_state


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def decode(
    cfg: SparseAutoencoderConfig, params: Params, f_x: torch.Tensor,
    prefixes: torch.Tensor | None = None, *, group_size: int = 1024,
    precision: str | None = None, feature: parallel.Group | None = None,
) -> torch.Tensor:
    """Decode latents to per-prefix reconstructions (batch, n_prefixes,
    d_model) (saev_tpu/nn/modeling.py:373-467): x_hats[:, j] = f_x[:, :p_j]
    @ W_dec[:p_j] + b_dec for ascending prefixes p_1 < ... < p_P = d_sae;
    with prefixes=None or one prefix (which must be d_sae), the full
    reconstruction as (batch, 1, d_model).

    As in the JAX package, the latent axis is split into groups of
    `group_size` (zero-padded at the end): one batched product gives each
    group's partial sum (batch, G, d_model), one (J, G) prefix-mask product
    contracts them to the J cut points, and each prefix adds the masked
    product of the group its cut falls in. Every product is at `precision`
    (None: MATMUL_PRECISION), the mask contraction's too: at bf16 it would
    round the partial sums, the dominant term of every reconstruction
    (saev_tpu/nn/modeling.py:436-450). The cuts are read on the host.

    With a `feature` group, f_x and W_dec hold this member's latents [o, o +
    n) of the whole dictionary and the prefixes count the whole one: each
    member takes the partial products of its latents below each cut (the
    cuts clip(p_j - o, 0, n), which may be 0 or n), in groups of
    min(group_size, n), and their sum over the group plus b_dec is every
    member's reconstruction.
    """
    if f_x.ndim != 2 or f_x.shape[1] != params["W_dec"].shape[0]:
        raise ValueError(
            f"f_x has shape {tuple(f_x.shape)}; expected (batch, {cfg.d_sae}) "
            f"latents for this {cfg.d_sae}-latent SAE"
        )
    precision = precision or MATMUL_PRECISION
    w_dec = params["W_dec"]
    if prefixes is None or prefixes.shape[0] == 1:
        partial = matmul(f_x, w_dec, precision)[:, None, :]
    else:
        n = w_dec.shape[0]
        offset = 0 if feature is None else feature.index * n
        cuts = [min(max(int(p) - offset, 0), n) for p in prefixes.tolist()]
        partial = _prefix_products(f_x, w_dec, cuts, group_size, precision)
    return parallel.sum_over(partial, feature) + params["b_dec"]


def _prefix_products(
    f_x: torch.Tensor, w_dec: torch.Tensor, cuts: list[int], group_size: int, precision: str
) -> torch.Tensor:
    """(batch, J, d_model): f_x[:, :p_j] @ W_dec[:p_j] for each cut p_j (0 <=
    p_j <= d_sae, ascending), by `decode`'s grouped products."""
    b, d_sae = f_x.shape
    d_model = w_dec.shape[1]
    g = min(group_size, d_sae)
    n_groups = -(-d_sae // g)
    pad = n_groups * g - d_sae
    f_pad = torch.nn.functional.pad(f_x, (0, pad)) if pad else f_x
    w_pad = torch.nn.functional.pad(w_dec, (0, 0, 0, pad)) if pad else w_dec

    # One batched product over all groups: (G, b, g) x (G, g, d) -> (G, b, d).
    partial = matmul(
        f_pad.reshape(b, n_groups, g).transpose(0, 1), w_pad.reshape(n_groups, g, d_model), precision
    )
    m = [p // g for p in cuts]  # group holding each cut
    r = [p - mj * g for p, mj in zip(cuts, m)]  # lanes of that group below the cut
    group_mask = (
        torch.arange(n_groups, device=f_x.device)[None, :] < torch.tensor(m, device=f_x.device)[:, None]
    ).to(partial.dtype)  # (J, G)
    # base[:, j] = the sum of the groups wholly below cut j: (J, G) x (G, b*d).
    base = matmul(group_mask, partial.reshape(n_groups, b * d_model), precision).reshape(-1, b, d_model)

    lane = torch.arange(g, device=f_x.device)
    x_hats = []
    for j in range(len(cuts)):
        # The remainder group; its start clamped into range as
        # lax.dynamic_slice clamps it (r == 0 masks it out then).
        start = min(m[j] * g, n_groups * g - g)
        f_m = f_pad[:, start : start + g]
        rem = matmul(
            torch.where(lane < r[j], f_m, torch.zeros((), dtype=f_m.dtype, device=f_m.device)),
            w_pad[start : start + g], precision,
        )
        x_hats.append(base[j] + rem)
    return torch.stack(x_hats, dim=1)


def forward(
    cfg: SparseAutoencoderConfig, params: Params, state: State, x: torch.Tensor, *,
    training: bool = False, prefixes: torch.Tensor | None = None,
) -> tuple[Output, State]:
    """Full SAE forward (saev_tpu/nn/modeling.py:470-487), at "highest"."""
    enc, new_state = encode(cfg, params, state, x, training=training)
    x_hats = decode(cfg, params, enc.f_x, prefixes)
    return Output(h_x=enc.h_x, f_x=enc.f_x, x_hats=x_hats), new_state


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
