"""P1, the encoder product fused with K1's TopK statistics, and its bench
(counterpart of scripts/proto_encode_stats.py).

    python -m saev_tpu_torch.scripts.proto_encode_stats            # A/B timing
    python -m saev_tpu_torch.scripts.proto_encode_stats --check    # numerics

P1 computes h = bf16(x) @ W_enc + b_enc with f32 accumulation and K1's
statistics of that same h in one call of two launches (csrc/encode_stats.cu:
x rounded to bf16, then a wgmma + TMA product whose epilogue selects each
row's k-th value without reading h back; rows its candidate buffer cannot
hold take K1's row routine on their h, the exact route). `--check`
holds h to the plain version (rel-norm 1e-5) and the statistics, bitwise, to
K1 and to K1's plain version applied to P1's own h. The A/B times the fused
kernel against two two-pass forms under the device profiler: the port's
encoder (`modeling._linear_bias`) at "highest", an f32 product, and at
"default", the train step's bf16-operand product with an f32 result
(`torch.mm(..., out_dtype=torch.float32)`, where the installed torch has
it), each followed by K1.
"""

import contextlib
import sys

import torch

from ..ops import _build, cuda_topk, topk
from . import kprof

B, D, S, K = 16384, 1024, 16384, 32
SEED = 0
TILE = 128  # batch and d_sae come in multiples of the product's column tile
MAX_S = 256 * 64  # the exact route holds a row of h in the registers of one 256-thread CTA
H_REL = 1e-5
L1_REL = 1e-6


@contextlib.contextmanager
def _f32_matmul():
    """Full-f32 products on the card for the duration (TF32 off)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def encode_plain(x, w, b_enc):
    """h = bf16(x) @ W + b_enc in f32, TF32 off."""
    with _f32_matmul():
        return x.to(torch.bfloat16).float() @ w.float() + b_enc


def encode_stats_plain(x, w, b_enc, k):
    """(h (B, S) f32, TopKStats of h): the plain version of P1."""
    h = encode_plain(x, w, b_enc)
    return h, topk._topk_stats_plain(h, k)


def encode_stats(x, w, b_enc, k, fallback=None):
    """Kernel P1; same outputs as `encode_stats_plain`: x (B, D) f32, W
    (D, S) bf16, b_enc (S,) f32.

    `fallback`, a (1,) int32 tensor on x's device, gains the number of rows
    that took the exact route (a measurement)."""
    if x.device.type != "cuda":
        return encode_stats_plain(x, w, b_enc, k)
    dev = x.device
    b, d = x.shape
    s = w.shape[1]
    for name, t, dtype, shape in (("x", x, torch.float32, (b, d)), ("w", w, torch.bfloat16, (d, s)),
                                  ("b_enc", b_enc, torch.float32, (s,))):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"encode_stats: {name} must be a contiguous {shape} {dtype} tensor on {dev}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    k = min(k, s)
    if b % TILE or d % 32 or s % TILE or s > MAX_S or k < 1:
        raise ValueError(f"encode_stats: batch {b} and d_sae {s} must be multiples of {TILE}, d_model {d} "
                         f"of 32, d_sae at most {MAX_S}, k >= 1 (got k={k})")
    if fallback is not None and (fallback.dtype != torch.int32 or fallback.numel() != 1 or fallback.device != dev):
        raise ValueError(f"encode_stats wants a (1,) int32 fallback count on {dev}")
    xb = torch.empty((b, d), dtype=torch.bfloat16, device=dev)
    h = torch.empty((b, s), dtype=torch.float32, device=dev)
    kth = torch.empty((b, 1), dtype=torch.float32, device=dev)
    f = torch.empty((b, s), dtype=torch.bfloat16, device=dev)
    live = torch.zeros((s,), dtype=torch.int32, device=dev)
    l0 = torch.empty((b, 1), dtype=torch.float32, device=dev)
    l1 = torch.empty((b, 1), dtype=torch.float32, device=dev)
    code = _build.lib().saev_encode_stats(
        x.data_ptr(), w.data_ptr(), b_enc.data_ptr(), b, d, s, k, xb.data_ptr(), h.data_ptr(),
        kth.data_ptr(), f.data_ptr(), live.data_ptr(), l0.data_ptr(), l1.data_ptr(),
        None if fallback is None else fallback.data_ptr(), _build.stream_ptr(x),
    )
    _build.check(code, "encode_stats")
    encode_stats.launches += 1
    return h, topk.TopKStats(kth=kth, f=f, live=live != 0, l0=l0, l1=l1)


encode_stats.launches = 0


def inputs(device="cuda", seed: int = SEED) -> dict:
    """The JAX script's operands (scripts/proto_encode_stats.py:119-124),
    drawn on the device: W in f32 for the f32 encoder and in bf16."""
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn((D, S), generator=gen, device=device) / 32
    return {
        "x": torch.randn((B, D), generator=gen, device=device),
        "w": w,
        "wb": w.to(torch.bfloat16),
        "b_enc": torch.randn((S,), generator=gen, device=device) * 0.01,
    }


def _same_stats(got: topk.TopKStats, want: topk.TopKStats) -> list[str]:
    bad = [name for name in ("kth", "f", "live", "l0") if not torch.equal(getattr(got, name), getattr(want, name))]
    l1_rel = float(((got.l1 - want.l1).abs() / want.l1.abs().clamp_min(1e-30)).max())
    return bad + ([f"l1 (rel {l1_rel:.3g})"] if l1_rel > L1_REL else [])


def check(inp: dict, k: int = K) -> dict:
    """h against the plain version; kth, f, live and l0 bitwise equal, and l1
    within 1e-6, to K1 and to K1's plain version on P1's own h. Raises
    AssertionError on a failure; returns h's errors, the live count and the
    rows that took the exact route."""
    x, wb, b_enc = inp["x"], inp["wb"], inp["b_enc"]
    fallback = torch.zeros(1, dtype=torch.int32, device=x.device)
    h, st = encode_stats(x, wb, b_enc, k, fallback)
    ph = encode_plain(x, wb, b_enc)
    diff = (h - ph).double()
    rel = float(torch.linalg.vector_norm(diff) / torch.linalg.vector_norm(ph.double()))
    out = {"h_rel": rel, "h_max_abs": float(diff.abs().max())}
    del ph, diff
    if rel > H_REL:
        raise AssertionError(f"P1: h rel-norm {rel:.3g} > {H_REL}")
    for name, want in (("plain", topk._topk_stats_plain(h, k)), ("K1", cuda_topk.topk_stats_cuda(h, k))):
        bad = _same_stats(st, want)
        if bad:
            raise AssertionError(f"P1: statistics on its own h differ from {name}'s: {', '.join(bad)}")
    out["n_live"] = int(st.live.sum())
    out["exact_rows"] = int(fallback)
    return out


def ab(inp: dict, n: int = 10, warmup: int = 3) -> dict[str, list]:
    """Device-profiler rows of one call of the fused kernel and of each
    two-pass form (the bf16 one only where torch has the product)."""
    from ..nn import modeling

    x, w, wb, b_enc = inp["x"], inp["w"], inp["wb"], inp["b_enc"]
    cases = {
        "fused P1": lambda: encode_stats(x, wb, b_enc, K),
        "two-pass f32 encoder + K1": lambda: cuda_topk.topk_stats_cuda(modeling._linear_bias(x, w, b_enc, "highest"), K),
    }
    if modeling.has_bf16_mm_f32():
        cases["two-pass bf16 encoder + K1"] = lambda: cuda_topk.topk_stats_cuda(
            modeling._linear_bias(x, w, b_enc, "default"), K)
    with torch.no_grad(), _f32_matmul():
        return {name: kprof.device_profile(fn, n=n, warmup=warmup) for name, fn in cases.items()}


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    print(kprof.card())
    inp = inputs()
    if "--check" in argv:
        res = check(inp)
        print(f"numerics: h rel-norm {res['h_rel']:.3g} (max abs {res['h_max_abs']:.3g}) against the plain "
              f"version; kth, f, live ({res['n_live']} live), l0 bitwise equal to K1 and to its plain "
              f"version on P1's own h, l1 within {L1_REL}; {res['exact_rows']} rows took the exact route")
        return
    from ..nn import modeling

    if not modeling.has_bf16_mm_f32():
        print("two-pass bf16 encoder: not timed, this torch has no bf16 product with an f32 result")
    for name, rows in ab(inp).items():
        print(kprof.report(name, rows, top=4))


if __name__ == "__main__":
    main()
