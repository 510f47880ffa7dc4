"""P2, the group-outer Matryoshka forward error, and its bench (counterpart of
scripts/proto_gouter.py).

    python -m saev_tpu_torch.scripts.proto_gouter

K2 (`grouped_prefix_err`) gives every 128-row tile the whole K = S walk, so
each row tile streams all of W from L2. The TPU kernel walks the groups
outermost so that W is fetched once for many row tiles. P2 asks the same on
this card in its own terms (csrc/prefix_gouter.cu, `gouter_wgmma_kernel`):
K2's walk in one launch, on clusters of two row tiles of one d tile, each
loading half of every W stage and multicasting it to both, so W leaves L2
once for two row tiles. The accumulator starts at b_dec - x and stays in
registers, so the second output is the full f32 error err_full = xhat +
b_dec - x, not K2's xhat, and E matches K2 to f32 noise, not bitwise.

`main()` checks P2 against K2 with the JAX script's limits (E rel-norm
< 2e-3, err_full against K2's xhat + b_dec - x rel-norm < 1e-5, loss rel
< 1e-4) and against its plain version, then times both kernels with the
device profiler. The JAX script's `--bm` (Mosaic's row tile) has no
counterpart.
"""

import numpy as np
import torch

from ..ops import _build
from ..ops import cuda_matryoshka as cm
from . import kprof

B, S, D, G, J = 16384, 16384, 1024, 1024, 10
SEED = 0
# Against K2 (scripts/proto_gouter.py:222-223).
E_REL_K2, ERR_REL_K2, LOSS_REL_K2 = 2e-3, 1e-5, 1e-4
# Against the plain version: K2's own limits (chip_smoke.py parity phase).
E_REL, ERR_REL, LOSS_REL = 1e-2, 1e-4, 1e-5


def grouped_prefix_err_gouter_plain(f, w, x, b_dec, inv_upper, m, r, *, group_size=1024):
    """(e (J, B, D) bf16, err_full (B, D) f32, loss_sum () f32) with
    e[j] = bf16((b_dec - x) + f[:, :p_j] @ W[:p_j]),
    err_full = (b_dec - x) + f @ W and loss_sum = sum (f32(e) * inv_upper)^2."""
    ff, wf = f.float(), w.float()
    bx = b_dec - x
    cuts = (m * group_size + r).tolist()
    e = torch.stack([bx + ff[:, :p] @ wf[:p] for p in cuts]).to(torch.bfloat16)
    loss_sum = ((e.float() * inv_upper) ** 2).sum()
    return e, bx + ff @ wf, loss_sum


def grouped_prefix_err_gouter(f, w, x, b_dec, inv_upper, m, r, *, group_size=1024):
    """Kernel P2; same outputs as `grouped_prefix_err_gouter_plain`. One
    cluster launch, then a fixed-order sum of one loss partial a CTA: the
    same bits every run."""
    if f.device.type != "cuda":
        return grouped_prefix_err_gouter_plain(f, w, x, b_dec, inv_upper, m, r, group_size=group_size)
    dev = f.device
    b, s = f.shape
    d = w.shape[1]
    j = m.shape[0]
    cm._check_cuts(j, b, s, d, group_size)
    cm._check("f", f, torch.bfloat16, (b, s), dev)
    cm._check("w", w, torch.bfloat16, (s, d), dev)
    cm._check("x", x, torch.float32, (b, d), dev)
    cm._check("b_dec", b_dec, torch.float32, (d,), dev)
    cm._check("m", m, torch.int32, (j,), dev)
    cm._check("r", r, torch.int32, (j,), dev)
    iu = cm._scalar(inv_upper, dev)
    e = torch.empty((j, b, d), dtype=torch.bfloat16, device=dev)
    err = torch.empty((b, d), dtype=torch.float32, device=dev)
    n_partials = (b // cm.TILE) * (d // cm.TILE)
    partials = torch.empty((n_partials,), dtype=torch.float32, device=dev)
    loss_sum = torch.empty((1,), dtype=torch.float32, device=dev)
    code = _build.lib().saev_prefix_err_gouter(
        f.data_ptr(), w.data_ptr(), x.data_ptr(), b_dec.data_ptr(), iu.data_ptr(),
        m.data_ptr(), r.data_ptr(), j, b, s, d, group_size, e.data_ptr(),
        err.data_ptr(), partials.data_ptr(), loss_sum.data_ptr(), _build.stream_ptr(f),
    )
    _build.check(code, "grouped_prefix_err_gouter")
    grouped_prefix_err_gouter.launches += 1
    return e, err, loss_sum[0]


grouped_prefix_err_gouter.launches = 0


def inputs(device="cuda", seed: int = SEED) -> dict:
    """The JAX script's operands (scripts/proto_gouter.py:182-194), drawn on
    the device; the last cut is the full decode, p = S."""
    gen = torch.Generator(device=device).manual_seed(seed)
    f = torch.randn((B, S), generator=gen, device=device)
    f = f.masked_fill_(f < 1.5, 0.0).to(torch.bfloat16)
    prefixes = np.sort(np.random.default_rng(seed).choice(np.arange(1, S + 1), size=J, replace=False))
    prefixes[-1] = S
    return {
        "f": f,
        "w": (torch.randn((S, D), generator=gen, device=device) * 0.02).to(torch.bfloat16),
        "x": torch.randn((B, D), generator=gen, device=device),
        "b_dec": torch.randn((D,), generator=gen, device=device) * 0.01,
        "inv_upper": torch.tensor([0.41], device=device),
        "m": torch.from_numpy(prefixes // G).to(device=device, dtype=torch.int32),
        "r": torch.from_numpy(prefixes % G).to(device=device, dtype=torch.int32),
    }


def _rel_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))


def _args(inp: dict) -> tuple:
    return tuple(inp[k] for k in ("f", "w", "x", "b_dec", "inv_upper", "m", "r"))


def check(inp: dict, group_size: int = G) -> dict:
    """P2 against K2 and against its plain version on the same operands;
    raises AssertionError past a limit. Returns the measured errors."""
    args = _args(inp)
    e0, xhat0, loss0 = cm.grouped_prefix_err(*args, group_size=group_size)
    e1, err1, loss1 = grouped_prefix_err_gouter(*args, group_size=group_size)
    e2, err2, loss2 = grouped_prefix_err_gouter(*args, group_size=group_size)
    repeatable = torch.equal(e1, e2) and torch.equal(err1, err2) and torch.equal(loss1, loss2)
    err_want = xhat0 + (inp["b_dec"] - inp["x"])
    out = {
        "repeatable": repeatable,
        "e_mismatch_frac_k2": float((e0 != e1).float().mean()),
        "e_rel_k2": _rel_norm(e1, e0),
        "err_rel_k2": _rel_norm(err1, err_want),
        "loss_rel_k2": abs(float(loss1) - float(loss0)) / abs(float(loss0)),
    }
    del e0, xhat0, e2, err2, err_want
    pe, perr, ploss = grouped_prefix_err_gouter_plain(*args, group_size=group_size)
    out.update(
        e_rel=_rel_norm(e1, pe),
        err_rel=_rel_norm(err1, perr),
        loss_rel=abs(float(loss1) - float(ploss)) / abs(float(ploss)),
        max_abs=max(float((e1.float() - pe.float()).abs().max()), float((err1 - perr).abs().max())),
    )
    failed = [
        what for what, bad in (
            ("not bitwise repeatable", not repeatable),
            (f"E rel-norm against K2 {out['e_rel_k2']:.3g} >= {E_REL_K2}", out["e_rel_k2"] >= E_REL_K2),
            (f"err_full rel-norm against K2 {out['err_rel_k2']:.3g} >= {ERR_REL_K2}",
             out["err_rel_k2"] >= ERR_REL_K2),
            (f"loss rel against K2 {out['loss_rel_k2']:.3g} >= {LOSS_REL_K2}", out["loss_rel_k2"] >= LOSS_REL_K2),
            (f"E rel-norm against plain {out['e_rel']:.3g} > {E_REL}", out["e_rel"] > E_REL),
            (f"err_full rel-norm against plain {out['err_rel']:.3g} > {ERR_REL}", out["err_rel"] > ERR_REL),
            (f"loss rel against plain {out['loss_rel']:.3g} > {LOSS_REL}", out["loss_rel"] > LOSS_REL),
        ) if bad
    ]
    if failed:
        raise AssertionError("P2: " + "; ".join(failed))
    return out


def timing(inp: dict, n: int = 10, warmup: int = 3) -> dict[str, list]:
    """K2 and P2 under the device profiler: name -> rows of one call."""
    args = _args(inp)
    return {
        "K2 grouped_prefix_err": kprof.device_profile(
            lambda: cm.grouped_prefix_err(*args, group_size=G), n=n, warmup=warmup),
        "P2 grouped_prefix_err_gouter": kprof.device_profile(
            lambda: grouped_prefix_err_gouter(*args, group_size=G), n=n, warmup=warmup),
    }


def main() -> None:
    print(kprof.card())
    inp = inputs()
    res = check(inp)
    print(f"numerics: E mismatch frac {res['e_mismatch_frac_k2']:.2e}, rel-norm {res['e_rel_k2']:.2e}; "
          f"err_full rel-norm {res['err_rel_k2']:.2e}; loss rel {res['loss_rel_k2']:.2e} (against K2); "
          f"against plain: E {res['e_rel']:.2e}, err_full {res['err_rel']:.2e}, loss {res['loss_rel']:.2e}; "
          f"bitwise repeatable")
    for name, rows in timing(inp).items():
        print(kprof.report(name, rows))


if __name__ == "__main__":
    main()
