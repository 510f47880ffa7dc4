"""The yardstick: peaks of the card, and the operations and bytes that a
product, a layer or a whole step needs, from shapes alone.

Bounds follow one rule: each input is read once and each output written
once, and work is what these inputs need. Where an operand is sparse (the
TopK latents, their gradient, the AuxK activations), a product counts its
nonzeros, not the dense work a kernel may do. A roofline share is the least
time, the larger of bytes over the memory rate and operations over the peak
of their precision, over the measured time.

Peaks (NVIDIA's data sheet, H100 SXM, dense, at 700 W): 989 TFLOP/s bf16 and
fp16, 67 TFLOP/s f32 outside the tensor cores, 1979 TFLOP/s fp8, 80 GB of HBM3
at 3.35 TB/s.
"""

PEAK_OPS = {"bf16": 989e12, "f16": 989e12, "f32": 67e12, "fp8": 1979e12}
HBM_BYTES_S = 3.35e12


def bound_s(ops: float, precision: str, n_bytes: float) -> float:
    return max(ops / PEAK_OPS[precision], n_bytes / HBM_BYTES_S)


# ---------------------------------------------------------------------------
# Products as the trace records them (aten matmul calls and their shapes)
# ---------------------------------------------------------------------------

MATMUL_OPS = frozenset({"aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm", "aten::addbmm",
                        "aten::mv", "aten::addmv", "aten::dot", "aten::_scaled_mm"})
_DTYPES = {"c10::BFloat16": ("bf16", 2), "c10::Half": ("f16", 2), "float": ("f32", 4),
           "c10::Float8_e4m3fn": ("fp8", 1), "c10::Float8_e5m2": ("fp8", 1)}


def _operands(name: str, shapes: list) -> tuple[list, list] | None:
    """The two matrix operands' shapes of a matmul call (bias and scalars
    left out), or None when the shapes are not recorded."""
    mats = [s for s in shapes if isinstance(s, (list, tuple)) and len(s) >= 1]
    if name in ("aten::addmm", "aten::baddbmm", "aten::addbmm", "aten::addmv"):
        mats = mats[1:]
    if len(mats) < 2:
        return None
    return list(mats[0]), list(mats[1])


# cuBLAS's kernel names by operand precision, for a trace that records no
# dtypes (torch 2.11's does not): "nvjet_" then the types of A/B, compute and
# output ("t" bf16, "h" f16, "s" f32), or a named f32 GEMM.
_KERNEL_PRECISION = (("f32f32_f32f32", "f32"), ("sgemm", "f32"), ("nvjet_s", "f32"), ("nvjet_t", "bf16"),
                     ("bf16", "bf16"), ("nvjet_h", "f16"))
_BYTES = {"bf16": 2, "f16": 2, "f32": 4, "fp8": 1}


def precision_of(dtypes: list, kernels: tuple = ()) -> str | None:
    """A matmul call's operand precision: from its recorded input dtypes, or
    else from its kernels' names; None where neither tells."""
    kinds = [_DTYPES[d][0] for d in (dtypes or []) if d in _DTYPES]
    if kinds:
        return "f32" if all(k == "f32" for k in kinds) else min(kinds, key=lambda k: _BYTES[k])
    found = {p for name in kernels for pattern, p in _KERNEL_PRECISION if pattern in name}
    return found.pop() if len(found) == 1 else None


def product_bound_s(name: str, shapes: list, dtypes: list, batch: int, density, kernels: tuple = ()) -> float | None:
    """The least time of one recorded matmul call: 2 m k n operations at the
    peak of its operands' precision, bytes of both operands read once and
    the product written once; the precision from the recorded dtypes or the
    kernels' names (`precision_of`). `density(width)` gives the share of nonzero
    entries of a latent-valued matrix of `batch` rows by `width` columns (None
    for a width that is not a latent axis): a product that contracts such an
    operand (latents @ W, x^T @ d(latents)) or makes one that is needed only
    where its latents are nonzero counts that share of the work. None where
    the call's shapes or precision are unknown."""
    ops_shapes = _operands(name, shapes)
    if ops_shapes is None:
        return None
    a, b = ops_shapes
    precision = precision_of(dtypes, kernels)
    if precision is None:
        return None
    in_bytes = _BYTES[precision]
    if len(a) == 1:  # mv / dot
        a = [1] + a
    if len(b) == 1:
        b = b + [1]
    groups = 1
    for g in a[:-2]:
        groups *= g
    m, k, n = a[-2], a[-1], b[-1]
    share = None
    if m == batch:
        share = density(k)  # latents @ W
        if share is None:
            share = density(n, output=True)  # d(latents), needed at their nonzeros
    elif k == batch:
        share = density(n) if density(n) is not None else density(m)  # x^T @ d(latents)
    ops = 2.0 * groups * m * k * n * (1.0 if share is None else share)
    n_bytes = groups * ((m * k + k * n) * in_bytes + m * n * min(in_bytes, 4))
    return bound_s(ops, precision, n_bytes)


def latent_density(d_sae: int, d_model: int, k: int, k_aux: int | None = None):
    """`density(width, output=False)` for `product_bound_s`: the TopK
    latents (k of d_sae nonzero a row); with AuxK, any other width but
    d_model is a subspace of latents with at most k_aux nonzero a row. A
    product whose output is d_sae wide is the encoder's, whose every
    pre-activation is needed."""
    def density(width: int, output: bool = False) -> float | None:
        if width == d_sae:
            return None if output else k / d_sae
        if k_aux is not None and width != d_model:
            return min(1.0, k_aux / width)
        return None
    return density


# ---------------------------------------------------------------------------
# The train step and inference, from the configuration's shapes
# ---------------------------------------------------------------------------


def train_step_model_s(b: int, d: int, s: int, k: int, n_dead: int, k_aux: int) -> dict[str, float]:
    """The least time of one SAE's steady train step by layer, in seconds,
    from what its inputs need (the Matryoshka prefixes' reconstructions are
    running sums of the products between cuts, so their count adds no
    product):
    - "matryoshka": the prefix reconstructions and their gradient (f has k
      nonzeros a row): f read once as stored (B S bf16), W_dec, x and b_dec
      read, the full reconstruction, dW_dec and df at f's nonzeros written;
    - "select": TopK over h (B S f32 read, f's nonzeros and the row's
      statistics written, one f32 operation an element) and AuxK's
      threshold over the dead columns;
    - "model": the product operations at bf16's peak ("default"), for the
      MFU: the encoder's forward (2 B D S, dense: every pre-activation is
      needed to select), its weight gradient (dh has k nonzeros a row), the
      AuxK products over the dead latents (the pre-activations of the
      n_dead columns; k_aux nonzeros a row in the reconstruction and its
      gradients), and the decoder's (k nonzeros a row)."""
    aux_ops = 2.0 * b * d * n_dead + 3 * 2.0 * b * k_aux * d
    mat = bound_s(3 * 2.0 * b * k * d, "bf16", 2.0 * b * s + 4.0 * (2 * s * d + 2 * b * d + 2 * d + b * k))
    topk = bound_s(1.0 * b * s, "f32", 4.0 * b * s + 6.0 * b * k + 12.0 * b + s)
    kth_aux = bound_s(1.0 * b * n_dead, "f32", 4.0 * b * n_dead + s + 4.0 * b)
    flops = 2.0 * b * d * s + 2.0 * b * k * (d + 1) + aux_ops + 3 * 2.0 * b * k * d
    return {"matryoshka": mat, "select": topk + kth_aux,
            "model": flops / PEAK_OPS["bf16"]}


def log_step_model_s(b: int, d: int, s: int, k: int) -> dict[str, float]:
    """The least time of one SAE's log-step metrics: K6's threshold over h,
    and the products' operations at f32's peak: the encoder (2 B D S), the
    decode (k nonzeros a row), the coherence of the decoder's rows (S^2 D:
    each pair's product once)."""
    kth = bound_s(1.0 * b * s, "f32", 4.0 * b * s + 4.0 * b)
    flops_s = (2.0 * b * d * s + 2.0 * b * k * d + 1.0 * s * s * d) / PEAK_OPS["f32"]
    return {"select": kth, "model": flops_s}


def infer_batch_model_s(b: int, d: int, s: int, k: int) -> dict[str, float]:
    """The least time of one inference batch: K6's threshold over h, and
    the products' operations at f32's peak ("highest"): the encoder
    (2 B D S) and the decode (k nonzeros a row)."""
    kth = bound_s(1.0 * b * s, "f32", 4.0 * b * s + 4.0 * b)
    flops_s = (2.0 * b * d * s + 2.0 * b * k * d) / PEAK_OPS["f32"]
    return {"select": kth, "model": flops_s}
