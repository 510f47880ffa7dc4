"""The plain reference of a Matryoshka TopK SAE with AuxK, trained with Adam,
and of its inference: plain PyTorch, float32 with TF32 off, from saev's
equations (`src/saev/nn/modeling.py`, `nn/objectives.py`,
`framework/train.py` and `framework/inference.py` of the upstream project).
It imports nothing of the program: no kernel, no step, no helper.

Every product goes through `mm(a, b, mode)`: "f32" (TF32 off), or one of the
lower precisions the correctness control runs in: "fp8" (each operand scaled
by its largest magnitude into float8 e4m3 and rounded, the product in f32),
"tf32" (each operand rounded to TF32's 10 mantissa bits, the product in f32)
and "bf16" (operands rounded to bfloat16); the backward's products round
their operands the same way.

Departures from the published code, each exact: the Matryoshka reconstructions
are cumulative sums of the products of the latents between consecutive cuts
(the same sums as each prefix's own product); AuxK reads the dead latents of
the whole dictionary (the port's subspace holds all of them whenever its
step router picks it).
"""

import contextlib
import math

import torch

TOKS_CAP = 1 << 30
F8_MAX = 448.0  # float8 e4m3's largest finite value


@contextlib.contextmanager
def f32_products():
    """TF32 off inside, the caller's switches after. Where torch has the
    per-backend switch only that one is read and set (torch refuses to read a
    precision the two APIs set differently)."""
    cuda = torch.backends.cuda.matmul
    if hasattr(cuda, "fp32_precision"):
        prev = cuda.fp32_precision
        cuda.fp32_precision = "ieee"
        try:
            yield
        finally:
            cuda.fp32_precision = prev
    else:
        prev = cuda.allow_tf32
        cuda.allow_tf32 = False
        try:
            yield
        finally:
            cuda.allow_tf32 = prev


def round_operand(a: torch.Tensor, mode: str) -> torch.Tensor:
    """`a` (f32) rounded to the precision of `mode`, returned in f32."""
    if mode == "f32":
        return a
    if mode == "bf16":
        return a.to(torch.bfloat16).float()
    if mode == "tf32":
        # Round to nearest even at mantissa bit 13: TF32 keeps 10 of f32's 23.
        bits = a.contiguous().view(torch.int32)
        lsb = (bits >> 13) & 1
        rounded = (bits + 0xFFF + lsb) & ~0x1FFF
        return torch.where(torch.isfinite(a), rounded.view(torch.float32), a)
    if mode == "fp8":
        scale = a.detach().abs().amax().clamp(min=1e-30) / F8_MAX
        return (a / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"unknown mode {mode!r}")


class _MM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, mode):
        a, b = round_operand(a, mode), round_operand(b, mode)
        ctx.mode = mode
        ctx.save_for_backward(a, b)
        with f32_products():
            return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_operand(g, ctx.mode)
        with f32_products():
            da = g @ b.mT if ctx.needs_input_grad[0] else None
            db = a.mT @ g if ctx.needs_input_grad[1] else None
        return da, db, None


def mm(a: torch.Tensor, b: torch.Tensor, mode: str = "f32") -> torch.Tensor:
    return _MM.apply(a, b, mode)


def kth_largest(h: torch.Tensor, k: int) -> torch.Tensor:
    """(rows, 1): each row's k-th largest value."""
    return torch.topk(h, k, dim=1, sorted=True).values[:, k - 1:k]


def topk(h: torch.Tensor, k: int) -> torch.Tensor:
    """Every entry at or above its row's k-th largest, the rest 0."""
    return torch.where(h >= kth_largest(h.detach(), k), h, torch.zeros((), device=h.device))


def encode(params: dict, x: torch.Tensor, k: int, mode: str = "f32") -> tuple[torch.Tensor, torch.Tensor]:
    """(h, f): pre-activations x @ W_enc + b_enc and their TopK."""
    h = mm(x, params["W_enc"], mode) + params["b_enc"]
    return h, topk(h, k)


def prefix_reconstructions(f: torch.Tensor, w_dec: torch.Tensor, b_dec: torch.Tensor, cuts: list[int],
                           mode: str = "f32") -> torch.Tensor:
    """(B, J, d_model): f[:, :p_j] @ W_dec[:p_j] + b_dec for ascending cuts
    p_1 < ... < p_J = d_sae, as running sums of the products between cuts."""
    out, acc, lo = [], None, 0
    for p in cuts:
        part = mm(f[:, lo:p], w_dec[lo:p], mode)
        acc = part if acc is None else acc + part
        out.append(acc)
        lo = p
    return torch.stack(out, dim=1) + b_dec


def normalize_rows(w: torch.Tensor) -> torch.Tensor:
    return w / torch.linalg.norm(w, dim=-1, keepdim=True)


def warmup_cosine(step: int, n_warmup: float, peak: float, n_steps: float) -> float:
    """saev's WarmupCosine from 0 to `peak` and back to 0, after `step` steps."""
    if step < n_warmup:
        return peak * step / max(n_warmup, 1.0)
    if step < n_steps:
        progress = (step - n_warmup) / max(n_steps - n_warmup, 1.0)
        return peak * (1 + math.cos(math.pi * progress)) / 2
    return 0.0


def loss_terms(cfg: dict, params: dict, toks: torch.Tensor, x: torch.Tensor, cuts: list[int], k: int,
               mode: str = "f32", rows: slice | None = None):
    """One SAE's training objective on batch x: the Matryoshka MSE over every
    prefix, plus AuxK over the dead latents (those whose counter, after this
    batch, reaches dead_threshold_tokens). Returns (loss, terms, new counters).
    `rows` keeps only some of the batch's rows (a fault the correctness check
    must catch: the mean over the rest)."""
    if rows is not None:
        x = x[rows]
    b = x.shape[0]
    h, f = encode(params, x, k, mode)
    live = (f.detach() != 0).any(dim=0)
    toks = torch.clamp(toks + b, max=TOKS_CAP)
    toks = torch.where(live, torch.zeros((), dtype=toks.dtype, device=toks.device), toks)
    dead = toks >= cfg["dead_threshold_tokens"]
    x_hats = prefix_reconstructions(f, params["W_dec"], params["b_dec"], cuts, mode)
    mse = torch.mean((x_hats - x[:, None, :]) ** 2)
    n_dead = int(dead.sum())
    aux = torch.zeros((), device=x.device)
    if n_dead:
        residual = (x - x_hats[:, -1]).detach()
        k_aux = min(cfg["k_aux"], cfg["d_sae"])
        masked = torch.where(dead, h.detach(), torch.full((), -math.inf, device=x.device))
        kth = kth_largest(masked, k_aux)
        keep = (h.detach() >= kth) & dead
        aux_acts = torch.where(keep, h, torch.zeros((), device=x.device))
        aux_recon = mm(aux_acts, params["W_dec"], mode) + params["b_dec"]
        aux = cfg["aux_alpha"] * torch.mean((aux_recon - residual) ** 2)
    fd = f.detach()
    terms = {
        "loss": float((mse + aux).detach()), "mse": float(mse.detach()), "aux": float(aux.detach()), "n_dead": n_dead,
        "l0": float((fd != 0).float().sum(dim=1).mean()), "l1": float(fd.abs().sum(dim=1).mean()),
    }
    return mse + aux, terms, toks


LEAVES = ("W_enc", "b_enc", "W_dec", "b_dec")


def train_step(cfg: dict, sae: dict, x: torch.Tensor, cuts: list[int], step: int, mode: str = "f32",
               rows: slice | None = None) -> tuple[dict, dict, dict]:
    """One Adam step of one SAE. `sae` holds "params", "toks", "m", "v",
    "count" and "hp" ({"lr", "top_k"}); returns (new sae, loss terms, the
    clipped gradient the optimizer got). W_dec's rows are normalized before
    the forward, the gradient's part along each row removed, the whole
    gradient clipped to `grad_clip`, the learning rate warmup-cosine at
    `step`."""
    params = dict(sae["params"])
    if cfg["normalize_w_dec"]:
        params["W_dec"] = normalize_rows(params["W_dec"])
    leaves = {name: params[name].detach().clone().requires_grad_(True) for name in LEAVES}
    loss, terms, toks = loss_terms(cfg, leaves, sae["toks"], x, cuts, sae["hp"]["top_k"], mode, rows)
    grads = dict(zip(LEAVES, torch.autograd.grad(loss, [leaves[n] for n in LEAVES])))
    del loss, leaves
    if cfg["remove_parallel_grads"]:
        w, g = params["W_dec"], grads["W_dec"]
        grads["W_dec"] = g - (torch.sum(g * w, dim=-1) / torch.sum(w * w, dim=-1))[:, None] * w
    norm = math.sqrt(sum(float(torch.sum(g.double() ** 2)) for g in grads.values()))
    clip = min(cfg["grad_clip"] / (norm + 1e-6), 1.0)
    grads = {n: g * clip for n, g in grads.items()}
    count = sae["count"] + 1
    lr = warmup_cosine(step, cfg["n_lr_warmup"], sae["hp"]["lr"], cfg["n_steps"])
    b1, b2, eps = 0.9, 0.999, 1e-8
    bc1, bc2 = 1 - b1 ** count, 1 - b2 ** count
    new_params, m, v = {}, {}, {}
    for n in LEAVES:
        m[n] = b1 * sae["m"][n] + (1 - b1) * grads[n]
        v[n] = b2 * sae["v"][n] + (1 - b2) * grads[n] ** 2
        new_params[n] = params[n] - lr * (m[n] / bc1) / (torch.sqrt(v[n] / bc2) + eps)
    terms["grad_norm"] = norm
    new = {**sae, "params": new_params, "toks": toks, "m": m, "v": v, "count": count}
    return new, terms, grads


@torch.no_grad()
def log_metrics(cfg: dict, params: dict, x: torch.Tensor, k: int, mode: str = "f32",
                block: int = 1024) -> dict[str, float]:
    """The log step's metrics of one SAE on batch x, at f32: explained
    variance, the share of latents that never fired, dictionary coherence
    (the largest |cosine| between two decoder rows), the mean decoder row
    norm, and the SSE of the reconstruction and of the batch mean."""
    h, f = encode(params, x, k, mode)
    del h
    x_hat = mm(f, params["W_dec"], mode) + params["b_dec"]
    residual = x - x_hat
    fired = (f.abs() > 1e-12).sum(dim=0)
    del f, x_hat
    sse = float(torch.sum(residual.double() ** 2))
    explained = 1.0 - float(torch.var(residual.double(), correction=0) / torch.var(x.double(), correction=0))
    w = params["W_dec"]
    wn = normalize_rows(w)
    coherence = 0.0
    for start in range(0, w.shape[0], block):
        gram = torch.abs(mm(wn[start:start + block], wn.T, mode))
        idx = torch.arange(start, min(start + block, w.shape[0]), device=w.device)
        gram[torch.arange(len(idx), device=w.device), idx] = 0.0
        coherence = max(coherence, float(gram.max()))
    xd = x.double()
    baseline = float(torch.sum(xd * xd) - torch.dot(xd.sum(0), xd.sum(0)) / x.shape[0])
    return {
        "explained_variance": explained, "dead_unit_pct": float((fired == 0).float().mean()),
        "dictionary_coherence": coherence, "avg_decoder_row_norm": float(torch.linalg.norm(w, dim=1).mean()),
        "sse_sae": sse, "sse_baseline": baseline, "normalized_mse": sse / baseline,
    }


@torch.no_grad()
def infer_rows(params: dict, x: torch.Tensor, k: int, mode: str = "f32") -> tuple[torch.Tensor, torch.Tensor]:
    """(h, kth) of some rows: their pre-activations and each row's k-th
    largest, the TopK threshold."""
    h = mm(x, params["W_enc"], mode) + params["b_enc"]
    return h, kth_largest(h, k)


@torch.no_grad()
def infer_stats(params: dict, x: torch.Tensor, k: int, mode: str = "f32", block: int = 4096) -> dict:
    """A batch's inference statistics, every row kept, in row blocks: the
    count of tokens, the reconstruction's SSE, the sum of squares and the sum
    of x, each latent's sum of activations and count of positive ones."""
    d_sae = params["W_enc"].shape[1]
    out = {"n_tokens": x.shape[0], "sse_recon": 0.0, "sum_sq": 0.0,
           "sum_vec": torch.zeros(x.shape[1], dtype=torch.float64, device=x.device),
           "mean_values": torch.zeros(d_sae, dtype=torch.float64, device=x.device),
           "sparsity": torch.zeros(d_sae, dtype=torch.float64, device=x.device)}
    for start in range(0, x.shape[0], block):
        xb = x[start:start + block]
        h, kth = infer_rows(params, xb, k, mode)
        f = torch.where(h >= kth, h, torch.zeros((), device=x.device))
        del h
        x_hat = mm(f, params["W_dec"], mode) + params["b_dec"]
        out["sse_recon"] += float(torch.sum((xb - x_hat).double() ** 2))
        out["sum_sq"] += float(torch.sum(xb.double() ** 2))
        out["sum_vec"] += xb.double().sum(0)
        out["mean_values"] += f.double().sum(0)
        out["sparsity"] += (f > 0).double().sum(0)
    return out
