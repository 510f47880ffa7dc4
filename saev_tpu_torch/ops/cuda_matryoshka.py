"""Wrappers of kernels K2-K4 and K7, the grouped Matryoshka products (K2 and
K7 in csrc/prefix_fwd.cu, K3 in csrc/dgrad.cu, K4 in csrc/wgrad.cu), each
with its plain bf16-operand version beside it.

Counterparts of saev_tpu/ops/pallas_matryoshka.py `grouped_prefix_err`,
`grouped_matmul_dgrad`, `grouped_matmul_wgrad` and `grouped_prefix_base`. A CUDA tensor launches the
kernel; a CPU tensor takes the `*_plain` version, which has the same outputs
and dtypes: bf16 operands, f32 accumulation.

Prefix cuts are p_j = m_j * g + r_j, passed as (J,) int32 tensors m and r on
the operands' device (the kernels read them there; no host sync).
"""

import torch

from . import _build

# The kernels keep the sorted cuts in shared memory beside their ring, 8
# bytes a cut (csrc/hopper.cuh MAX_CUTS).
MAX_PREFIXES = 8192
TILE = 128  # rows and columns of the kernels' output tiles

_BF16 = torch.bfloat16
_F32 = torch.float32


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(what)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, dev) -> None:
    _require(t.device == dev, f"{name} is on {t.device}, expected {dev}")
    _require(t.dtype == dtype, f"{name} has dtype {t.dtype}, expected {dtype}")
    _require(tuple(t.shape) == tuple(shape), f"{name} has shape {tuple(t.shape)}, expected {shape}")
    _require(t.is_contiguous(), f"{name} must be contiguous")


def _check_cuts(j: int, b: int, s: int, d: int, g: int) -> None:
    _require(1 <= j <= MAX_PREFIXES, f"{j} prefixes; the kernels take 1..{MAX_PREFIXES}")
    _require(b % TILE == 0, f"batch {b} must be a multiple of {TILE}")
    _require(d % TILE == 0, f"d_model {d} must be a multiple of {TILE}")
    _require(g % TILE == 0 and s % g == 0, f"group {g} must be a multiple of {TILE} dividing d_sae {s}")


def _scalar(t: torch.Tensor, dev) -> torch.Tensor:
    return t.detach().reshape(1).to(device=dev, dtype=_F32).contiguous()


# --- K2 -------------------------------------------------------------------------


def grouped_prefix_err_plain(f, w, x, b_dec, inv_upper, m, r, *, group_size=1024):
    """(e (J, B, D) bf16, xhat_nobias (B, D) f32, loss_sum () f32) with
    e[j] = bf16(f[:, :p_j] @ W[:p_j] + (b_dec - x)) and
    loss_sum = sum (f32(e) * inv_upper)^2."""
    ff, wf = f.float(), w.float()
    bx = b_dec - x
    cuts = (m * group_size + r).tolist()
    e = torch.stack([ff[:, :p] @ wf[:p] + bx for p in cuts]).to(_BF16)
    loss_sum = ((e.float() * inv_upper) ** 2).sum()
    return e, ff @ wf, loss_sum


def grouped_prefix_err(f, w, x, b_dec, inv_upper, m, r, *, group_size=1024):
    """Kernel K2; same outputs as `grouped_prefix_err_plain`. One launch on
    wgmma with TMA-fed operands walks K = d_sae for each 128 x 128 tile and
    snapshots E_j at each cut (16-lane steps plus a correction of the lanes
    below the cut), then a fixed-order sum of the per-tile loss partials:
    the same bits every run."""
    if f.device.type != "cuda":
        return grouped_prefix_err_plain(f, w, x, b_dec, inv_upper, m, r, group_size=group_size)
    dev = f.device
    b, s = f.shape
    d = w.shape[1]
    j = m.shape[0]
    _check_cuts(j, b, s, d, group_size)
    _check("f", f, _BF16, (b, s), dev)
    _check("w", w, _BF16, (s, d), dev)
    _check("x", x, _F32, (b, d), dev)
    _check("b_dec", b_dec, _F32, (d,), dev)
    _check("m", m, torch.int32, (j,), dev)
    _check("r", r, torch.int32, (j,), dev)
    iu = _scalar(inv_upper, dev)
    e = torch.empty((j, b, d), dtype=_BF16, device=dev)
    xhat = torch.empty((b, d), dtype=_F32, device=dev)
    partials = torch.empty(((b // TILE) * (d // TILE),), dtype=_F32, device=dev)
    loss_sum = torch.empty((1,), dtype=_F32, device=dev)
    code = _build.lib().saev_prefix_err(
        f.data_ptr(), w.data_ptr(), x.data_ptr(), b_dec.data_ptr(), iu.data_ptr(),
        m.data_ptr(), r.data_ptr(), j, b, s, d, group_size, e.data_ptr(),
        xhat.data_ptr(), partials.data_ptr(), loss_sum.data_ptr(), _build.stream_ptr(f),
    )
    _build.check(code, "grouped_prefix_err")
    grouped_prefix_err.launches += 1
    return e, xhat, loss_sum[0]


grouped_prefix_err.launches = 0


# --- K7 -------------------------------------------------------------------------


def grouped_prefix_base_plain(f, w, m, r, *, group_size=1024, base_dtype=_F32):
    """(base (J, B, D) in base_dtype, xhat_nobias (B, D) f32) with
    base[j] = f[:, :p_j] @ W[:p_j] (the sub-group remainder included) and
    xhat_nobias = f @ W."""
    ff, wf = f.float(), w.float()
    cuts = (m * group_size + r).tolist()
    base = torch.stack([ff[:, :p] @ wf[:p] for p in cuts]).to(base_dtype)
    return base, ff @ wf


def grouped_prefix_base(f, w, m, r, *, group_size=1024, base_dtype=_F32):
    """Kernel K7; same outputs as `grouped_prefix_base_plain`. K2's walk
    with base_j in place of the error: its xhat is K2's bit for bit, and
    bf16(base[j] + (b_dec - x)) is K2's E[j]."""
    if f.device.type != "cuda":
        return grouped_prefix_base_plain(f, w, m, r, group_size=group_size, base_dtype=base_dtype)
    dev = f.device
    b, s = f.shape
    d = w.shape[1]
    j = m.shape[0]
    _check_cuts(j, b, s, d, group_size)
    _require(base_dtype in (_F32, _BF16), f"base dtype {base_dtype} is not float32 or bfloat16")
    _check("f", f, _BF16, (b, s), dev)
    _check("w", w, _BF16, (s, d), dev)
    _check("m", m, torch.int32, (j,), dev)
    _check("r", r, torch.int32, (j,), dev)
    base = torch.empty((j, b, d), dtype=base_dtype, device=dev)
    xhat = torch.empty((b, d), dtype=_F32, device=dev)
    code = _build.lib().saev_prefix_base(
        f.data_ptr(), w.data_ptr(), m.data_ptr(), r.data_ptr(), j, b, s, d, group_size,
        int(base_dtype == _BF16), base.data_ptr(), xhat.data_ptr(), _build.stream_ptr(f),
    )
    _build.check(code, "grouped_prefix_base")
    grouped_prefix_base.launches += 1
    return base, xhat


grouped_prefix_base.launches = 0


# --- K3 -------------------------------------------------------------------------


def grouped_matmul_dgrad_plain(w, e, m, r, scale, *, group_size=1024, df_dtype=_F32):
    """(df (B, S) in df_dtype, dA (B, n_groups, D) bf16) with
    dA_G = bf16(scale * sum_{j: m_j > G} E_j) and
    df[:, G] = dA_G @ W_G^T + scale * sum_{j: m_j = G} [col < r_j] E_j @ W_G^T."""
    n_j, b, d = e.shape
    s = w.shape[0]
    g = group_size
    n_groups = s // g
    ms, rs = m.tolist(), r.tolist()
    ef, wf = e.float(), w.float()
    sc = scale.reshape(()).float()
    da = torch.empty((b, n_groups, d), dtype=_BF16, device=e.device)
    run = torch.zeros((b, d), dtype=_F32, device=e.device)
    for gi in reversed(range(n_groups)):  # the summation order of the kernel
        for j in range(n_j):
            if ms[j] == gi + 1:
                run = run + ef[j]
        da[:, gi] = (run * sc).to(_BF16)
    df = torch.empty((b, s), dtype=_F32, device=e.device)
    for gi in range(n_groups):
        wg = wf[gi * g : (gi + 1) * g]
        out = da[:, gi].float() @ wg.T
        rem = torch.zeros_like(out)
        for j in range(n_j):
            if ms[j] == gi and rs[j] > 0:
                part = ef[j] @ wg.T
                part[:, rs[j]:] = 0.0
                rem = rem + part
        df[:, gi * g : (gi + 1) * g] = out + sc * rem
    return df.to(df_dtype), da


def grouped_matmul_dgrad(w, e, m, r, scale, *, group_size=1024, df_dtype=_F32):
    """Kernel K3; same outputs as `grouped_matmul_dgrad_plain`: dA bit for
    bit, df up to the order of its f32 sums. Two launches: the dA build, then
    the df product on wgmma with TMA-fed operands."""
    if e.device.type != "cuda":
        return grouped_matmul_dgrad_plain(
            w, e, m, r, scale, group_size=group_size, df_dtype=df_dtype
        )
    dev = e.device
    j, b, d = e.shape
    s = w.shape[0]
    _check_cuts(j, b, s, d, group_size)
    _require(df_dtype in (_F32, _BF16), f"df dtype {df_dtype} is not float32 or bfloat16")
    _check("w", w, _BF16, (s, d), dev)
    _check("e", e, _BF16, (j, b, d), dev)
    _check("m", m, torch.int32, (j,), dev)
    _check("r", r, torch.int32, (j,), dev)
    sc = _scalar(scale, dev)
    df = torch.empty((b, s), dtype=df_dtype, device=dev)
    da = torch.empty((b, s // group_size, d), dtype=_BF16, device=dev)
    code = _build.lib().saev_dgrad(
        w.data_ptr(), e.data_ptr(), m.data_ptr(), r.data_ptr(), sc.data_ptr(),
        j, b, s, d, group_size, int(df_dtype == _BF16), df.data_ptr(), da.data_ptr(),
        _build.stream_ptr(e),
    )
    _build.check(code, "grouped_matmul_dgrad")
    grouped_matmul_dgrad.launches += 1
    return df, da


grouped_matmul_dgrad.launches = 0


# --- K4 -------------------------------------------------------------------------


def grouped_matmul_wgrad_plain(f, da, e, m, r, scale, *, group_size=1024):
    """dW (S, D) f32 with dW_G = f_G^T @ dA_G
    + scale * sum_{j: m_j = G} ([lane < r_j] f_G)^T @ E_j."""
    n_j = e.shape[0]
    b, s = f.shape
    d = e.shape[2]
    g = group_size
    ms, rs = m.tolist(), r.tolist()
    ff, daf, ef = f.float(), da.float(), e.float()
    sc = scale.reshape(()).float()
    dw = torch.empty((s, d), dtype=_F32, device=f.device)
    for gi in range(s // g):
        fg = ff[:, gi * g : (gi + 1) * g]
        out = fg.T @ daf[:, gi]
        rem = torch.zeros_like(out)
        for j in range(n_j):
            if ms[j] == gi and rs[j] > 0:
                fm = fg.clone()
                fm[:, rs[j]:] = 0.0
                rem = rem + fm.T @ ef[j]
        dw[gi * g : (gi + 1) * g] = out + sc * rem
    return dw


def grouped_matmul_wgrad(f, da, e, m, r, scale, *, group_size=1024):
    """Kernel K4; same output as `grouped_matmul_wgrad_plain` up to the order
    of its f32 sums, the same bits every run. Two launches: the products on
    wgmma with TMA-fed operands, each CTA one 128 x 128 tile over the whole
    batch (a group's main term into dW, or one cut's remainder into a
    workspace of J x group x D floats), then the combine
    dW += scale * (sum of the remainders in ascending j)."""
    if f.device.type != "cuda":
        return grouped_matmul_wgrad_plain(f, da, e, m, r, scale, group_size=group_size)
    dev = f.device
    b, s = f.shape
    j, _, d = e.shape
    _check_cuts(j, b, s, d, group_size)
    _check("f", f, _BF16, (b, s), dev)
    _check("da", da, _BF16, (b, s // group_size, d), dev)
    _check("e", e, _BF16, (j, b, d), dev)
    _check("m", m, torch.int32, (j,), dev)
    _check("r", r, torch.int32, (j,), dev)
    sc = _scalar(scale, dev)
    dw = torch.empty((s, d), dtype=_F32, device=dev)
    ws = torch.empty((j, group_size, d), dtype=_F32, device=dev)
    code = _build.lib().saev_wgrad(
        f.data_ptr(), da.data_ptr(), e.data_ptr(), m.data_ptr(), r.data_ptr(),
        sc.data_ptr(), j, b, s, d, group_size, dw.data_ptr(), ws.data_ptr(),
        _build.stream_ptr(f),
    )
    _build.check(code, "grouped_matmul_wgrad")
    grouped_matmul_wgrad.launches += 1
    return dw


grouped_matmul_wgrad.launches = 0
