"""A plain torch model of P1's select (csrc/encode_stats.cu), step by step as
the kernel runs it, for the CPU tests (test_torch_encode_stats.py, against
the plain version and the JAX package) and the card tests
(test_torch_cuda_kernels.py, against the kernel: which rows take the exact
route, and L1's bits). Imports no JAX.

The model takes the kernel's own h (B, S) and follows the walk over column
tiles of hopper.cuh's TILE: in each tile a row's keys (order_key) in the
order the kernel appends them (lane q of the row's quad, then its pairs of
columns 8 i + 2 q + {0, 1}); the row's bound L and its buffer of kCap
(read from the source) keys and columns, in the kernel's order; the keys
>= L (and -0.0 beside an L of +0.0) counted; a warp's 16 consecutive rows
all pruned when one of them would pass the cap (the new L the k-th largest
of the buffer and the tile's keys with its bits below kPruneBit cleared, the
bisection's cut from the common prefix of L and the largest key, and no
lower than L, or all its bits where the keys at or above the cut bound
would pass the cap; the buffer compacted in index order to the keys >= L,
a row whose keys >= L still pass the cap flagged for the exact route); then
the appends. After the last tile, each held row's kth is
the k-th largest of its buffer, f the scatter of its kept entries, L1 each
lane's entries (j = 4 i + q) summed in index order, then the quad's xor
tree. Every row when k > kCap, and each flagged row, takes the exact route,
K1's row routine: kth, f, L0 and L1 of the plain version there.
"""

import functools
import pathlib
import re

import torch
from kth_select_model import key_float, order_key

CSRC = pathlib.Path(__file__).resolve().parent.parent / "saev_tpu_torch" / "csrc"
WARP_ROWS = 16  # rows of a warp: its 8 quads hold two rows each


@functools.cache
def _constant(source: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text())[1])


def cap() -> int:
    """Keys a row's candidate buffer holds (kCap)."""
    return _constant("encode_stats.cu", "kCap")


def prune_bit() -> int:
    """The lowest bit a prune's cut bound keeps (kPruneBit)."""
    return _constant("encode_stats.cu", "kPruneBit")


def tile() -> int:
    """Columns of a product tile (hopper.cuh TILE)."""
    return _constant("hopper.cuh", "TILE")


def append_order(width: int) -> torch.Tensor:
    """The tile's columns in the order the kernel appends a row's keys: lane
    q of the quad, then its pairs of the accumulator's fragment in order,
    columns 8 i + 2 q + {0, 1} for the tile's width / 8 groups i."""
    return torch.tensor([8 * i + 2 * q + c for q in range(4) for i in range(width // 8) for c in range(2)])


def _from_key(lower: torch.Tensor) -> torch.Tensor:
    """The least key a buffer holds beside a bound: -0.0's beside +0.0's."""
    return torch.where(lower == 0x80000000, 0x7FFFFFFF, lower)


def _kth_largest(keys: torch.Tensor, valid: torch.Tensor, k: int) -> torch.Tensor:
    return torch.where(valid, keys, -1).sort(dim=1, descending=True).values[:, k - 1]


def p1_model(h: torch.Tensor, k: int) -> dict:
    """P1's statistics of h (B, S) f32 as the kernel computes them: kth, f,
    live, l0, l1, and per row whether it took the exact route (`exact`),
    the prunes it took (`prunes`) and its buffer's final count (`n`)."""
    b, s = h.shape
    width, c = tile(), cap()
    assert b % WARP_ROWS == 0 and s % width == 0, (b, s)
    k = min(k, s)
    key = order_key(h)
    order = append_order(width)
    slots = torch.arange(c + width)
    lower = torch.zeros(b, dtype=torch.int64)
    n = torch.zeros(b, dtype=torch.int64)
    held = torch.full((b,), k <= c)
    buf = torch.zeros((b, c + width), dtype=torch.int64)  # past c: where the kernel stores nothing
    col = torch.zeros((b, c + width), dtype=torch.int64)
    prunes = torch.zeros(b, dtype=torch.int64)
    for j in range(s // width):
        cols = j * width + order
        tk = key[:, cols]
        keep = (tk >= _from_key(lower)[:, None]) & held[:, None]
        over = held & (n + keep.sum(1) > c)
        pruned = over.view(-1, WARP_ROWS).any(1).repeat_interleave(WARP_ROWS) & held
        if bool(pruned.any()):
            valid = torch.cat([slots[None, :] < n[:, None], torch.ones_like(tk, dtype=bool)], 1)
            union = torch.cat([buf, tk], 1)
            exact_kth = _kth_largest(union, valid, k)
            # The bisection from the common prefix of L and the largest key,
            # cut below kPruneBit, never below L; all 32 bits where the keys
            # at or above the cut bound would pass the cap.
            hi = torch.where(valid, union, 0).amax(1)
            top = torch.full_like(hi, -1)
            for bit in range(32):
                top = torch.where(((lower ^ hi) >> bit) != 0, bit, top)
            cut = torch.maximum(exact_kth & ~((1 << torch.clamp(top + 1, max=prune_bit())) - 1), lower)
            fits = (valid & (union >= torch.clamp(_from_key(cut), min=1)[:, None])).sum(1) <= c
            lower = torch.where(pruned, torch.where(fits, cut, exact_kth), lower)
            valid = valid[:, :buf.shape[1]]
            prunes += pruned
            kept = valid & (buf >= _from_key(lower)[:, None])
            # In index order: the kept entries first, stable.
            moved = torch.argsort((~kept).to(torch.int8), dim=1, stable=True)
            buf = torch.where(pruned[:, None], buf.gather(1, moved), buf)
            col = torch.where(pruned[:, None], col.gather(1, moved), col)
            n = torch.where(pruned, kept.sum(1), n)
            keep = (tk >= _from_key(lower)[:, None]) & held[:, None]
            held = held & ~(pruned & (n + keep.sum(1) > c))
            keep = keep & held[:, None]
        pos = torch.where(keep, n[:, None] + keep.cumsum(1) - 1, c + torch.arange(width)[None, :])
        buf = buf.scatter(1, pos, tk)
        col = col.scatter(1, pos, cols[None, :].expand(b, -1))
        n = n + keep.sum(1)

    valid = slots[None, :] < n[:, None]
    kth_key = _kth_largest(buf, valid, min(k, c))  # rows not held take the exact route below
    kth = key_float(kth_key)
    x = key_float(buf)
    kept = valid & (buf >= _from_key(kth_key)[:, None]) & (x >= kth[:, None]) & held[:, None]
    f = torch.zeros((b, s), dtype=torch.bfloat16)
    rows = torch.arange(b)[:, None].expand_as(buf)
    f[rows[kept], col[kept]] = x[kept].to(torch.bfloat16)
    l0 = (kept & (x != 0)).sum(1).float()
    lane_sums = []
    for q in range(4):  # each lane's entries j = 4 i + q in index order
        acc = torch.zeros(b, dtype=torch.float32)
        for j in range(q, c, 4):
            acc = acc + torch.where(kept[:, j], x[:, j].abs(), 0.0)
        lane_sums.append(acc)
    l1 = (lane_sums[0] + lane_sums[1]) + (lane_sums[2] + lane_sums[3])

    exact = ~held
    if bool(exact.any()):  # K1's row routine: the plain version's statistics
        he = h[exact]
        ke = _kth_largest(order_key(he), torch.ones_like(he, dtype=bool), k)
        kth = kth.clone()
        kth[exact] = key_float(ke)
        fe = torch.where(he >= kth[exact][:, None], he, 0.0)
        f[exact] = fe.to(torch.bfloat16)
        l0[exact] = ((he >= kth[exact][:, None]) & (he != 0)).sum(1).float()
        l1[exact] = fe.abs().sum(1)
    return {"kth": kth[:, None], "f": f, "live": (f != 0).any(0), "l0": l0[:, None], "l1": l1[:, None],
            "exact": exact, "prunes": prunes, "n": torch.where(held, n, 0)}
