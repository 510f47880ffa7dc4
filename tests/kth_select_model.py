"""Plain torch models of the selects of kernels K1 and K6 (csrc/topk_row.cuh)
and K5 (csrc/kth_masked.cu), and of P4's and P3's pass loops
(csrc/kth_ops.cu), step by step as the kernels run them, for the
CPU tests (test_torch_kth_select.py, against the JAX package) and the card
tests (test_torch_cuda_kernels.py, against the kernels: which rows take K1's
and K6's fallback, and K1's L1 in the kernel's order). Imports no JAX.

- K1 and K6 (`select_model`): the dispatch of topk_stats.cu or kth.cu (VPT
  keys a thread, T threads), runs of 4
  columns a thread, key 0 past the row's end, the per-thread maxima and their
  k-th largest cut to its bits down to kBoundBit, t0 (when k <= T', the
  threads that hold a column), the keys >= t0 counted against the candidate
  buffer's capacity (kCandCap; both constants read from the source), the
  k-th largest candidate (ranked up to T candidates, bisected past them),
  and the whole-row bisection where k > T' or the buffer overflows; each
  bisection from the common prefix of its bounds (`bisect`). Then K1's
  epilogue, L1 in the kernel's order.
- K5: the dispatch of kth_masked.cu (KPL keys a lane, W warps a CTA), the
  mask compacted by threads over contiguous runs of columns, -inf where
  fewer than k columns are unmasked, G warps a row and the lane layout of
  the gathered keys (each unmasked column held once), the bisection from
  the common prefix of the row's least and largest unmasked key.
- K1, K5 and K6 on rows wider than the narrow kernels hold (kth_wide.cu):
  K1's cluster route (`cluster_model`, `cluster_stats_model`): the
  slices, each CTA's bound from its threads' maxima, the candidates of
  each slice, the union and its kept keys, the cluster-wide bisection
  where a buffer overflows, and L1 summed slice by slice in rank order;
  K5's route chosen from n (`k5_wide_model`: the group route's KPL and G,
  or the walk); the walk (`wide_model`: K6, K5 past the group route, K1
  past the cluster route): the chunks, each chunk's k-th largest key, the
  running lower bound, the buffer, the rank, the bisections. The slice,
  chunk, capacities and threads default to the source's constants and are
  parameters, so a test can cut a small row into several slices or
  chunks.
- P4 and P3 (`kth_ops_model`, `count_loop_model`, csrc/kth_ops.cu): the
  dispatch (VPT keys a thread in runs of 4 columns, T threads; P4's and
  P3's tables must agree), each mode's key domain and pad past the row's
  end, a pass's count split over kAcc accumulators a thread and summed
  pairwise (f32 in f32red; kMxuAcc D fragments in mxu, with the bf16 A
  fragment's lane layout; both constants read from the source), the warp's
  and the block's sums, P3's sweep over its passes before one block sum,
  and the rows of each persistent CTA (`cta_rows`) over a grid smaller and
  larger than B.
"""

import functools
import pathlib
import re

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "saev_tpu_torch" / "csrc"


@functools.cache
def _source(name: str) -> str:
    return (CSRC / name).read_text()


def cand_cap() -> int:
    return int(re.search(r"constexpr int kCandCap = (\d+);", _source("topk_row.cuh"))[1])


def bound_bit() -> int:
    return int(re.search(r"constexpr int kBoundBit = (\d+);", _source("topk_row.cuh"))[1])


def _select_dispatch(name: str, s: int) -> tuple[int, int]:
    """(VPT, MAXT) of the table in csrc/`name` for a row of s."""
    for n_t, vpt, vpt_t, maxt in re.findall(r"S <= (\d+) \* (\d+)\) return launch<(\d+), (\d+)>",
                                            _source(name)):
        if s <= int(n_t) * int(vpt):
            return int(vpt_t), int(maxt)
    raise ValueError(s)


def k1_dispatch(s: int) -> tuple[int, int]:
    """(VPT, MAXT) of topk_stats.cu's table for a row of s."""
    return _select_dispatch("topk_stats.cu", s)


def k6_dispatch(s: int) -> tuple[int, int]:
    """(VPT, MAXT) of kth.cu's table for a row of s."""
    return _select_dispatch("kth.cu", s)


def k5_dispatch(s: int) -> tuple[int, int]:
    """(KPL, warps a CTA) of kth_masked.cu's table for a row of s."""
    for w, kpl, kpl_t, warps in re.findall(
            r"S <= (\d+) \* 32 \* (\d+)\) return launch<(\d+)>\(h, mask, B, S, k, out, (\d+), stream\)",
            _source("kth_masked.cu")):
        if s <= int(w) * 32 * int(kpl):
            return int(kpl_t), int(warps)
    raise ValueError(s)


# --- order keys (csrc/order_key.cuh) as int64 in [0, 2**32) ---


def order_key(h: torch.Tensor) -> torch.Tensor:
    u = h.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >> 31 == 1, u ^ 0xFFFFFFFF, u | 0x80000000)


def key_float(key: torch.Tensor) -> torch.Tensor:
    bits = torch.where(key >> 31 == 1, key & 0x7FFFFFFF, key ^ 0xFFFFFFFF)
    return torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32).view(torch.float32)


def bisect(lo: torch.Tensor, hi: torch.Tensor, k: int, count, lowest: int = 0) -> torch.Tensor:
    """topk_row.cuh `bisect`, row by row: from lo's and hi's common prefix,
    one step for each bit below it down to `lowest`; count(t) gives each
    row's count of keys >= t[row]."""
    diff = lo ^ hi
    top = torch.full_like(lo, -1)
    for b in range(32):
        top = torch.where((diff >> b) != 0, b, top)
    cur = lo & ~((torch.ones_like(lo) << (top + 1)) - 1)
    for b in range(31, -1, -1):
        cand = cur | (1 << b)
        cur = torch.where((b <= top) & (b >= lowest) & (count(cand) >= k), cand, cur)
    return cur


# --- K1 ---


def k1_layout(s: int, dispatch=k1_dispatch) -> tuple[torch.Tensor, int]:
    """(T, VPT) column of each thread's key slot (runs of 4: slot 4r + q of
    thread t is column 4(t + rT) + q), and T."""
    vpt, maxt = dispatch(s)
    nt = -(-(-(-s // vpt)) // 32) * 32
    assert nt <= maxt and nt * vpt >= s
    t = torch.arange(nt)[:, None]
    j = torch.arange(vpt)[None, :]
    return 4 * (t + (j // 4) * nt) + j % 4, nt


def select_model(h: torch.Tensor, k: int, dispatch=k1_dispatch) -> dict:
    """The select (`row_keys` and `select_kth_key`) of a (B, S) f32 batch
    under a kernel's dispatch: kth and, per row, whether the filter ran, its
    candidate count and whether the row fell back."""
    s = h.shape[1]
    k = min(k, s)
    cols, nt = k1_layout(s, dispatch)
    inside = cols < s
    key = torch.where(inside, order_key(h)[:, cols.clamp(max=s - 1)], 0)  # (B, T, VPT)
    mx = key.amax(-1)  # (B, T)
    t_live = min(nt, -(-s // 4))
    bounded = k <= t_live
    lo, hi = mx.amin(-1), mx.amax(-1)
    if bounded:
        t0 = bisect(lo, hi, k, lambda t: (mx >= t[:, None]).sum(-1), lowest=bound_bit())
    else:
        t0 = torch.zeros_like(hi)
    filt = bounded & (t0 > 0)
    n_cand = torch.where(filt, (key >= t0[:, None, None]).flatten(1).sum(-1), 0)
    by_cand = filt & (n_cand <= cand_cap())
    flat = key.flatten(1)
    cand_key = torch.where(flat >= t0[:, None], flat, 0)  # the buffer: the keys >= t0
    # Up to T candidates: the one with fewer than k above it and at least k
    # at or above it, the k-th of them in descending order; past T, a
    # bisection over them.
    ranked = torch.sort(cand_key, dim=-1, descending=True).values[:, k - 1]
    sel_cand = torch.where(n_cand <= nt, ranked, bisect(t0, hi, k, lambda t: (cand_key >= t[:, None]).sum(-1)))
    sel_full = bisect(t0, hi, k, lambda t: (flat >= t[:, None]).sum(-1))
    kth = key_float(torch.where(by_cand, sel_cand, sel_full))[:, None]
    return {"kth": kth, "filter": filt, "n_cand": n_cand, "fallback": ~by_cand}


def k6_model(h: torch.Tensor, k: int) -> dict:
    """K6 on a (B, S) f32 batch: `select_model` under kth.cu's dispatch."""
    return select_model(h, k, k6_dispatch)


def k1_model(h: torch.Tensor, k: int) -> dict:
    """K1 on a (B, S) f32 batch: kth, f, live, l0, l1 and, per row, whether
    the filter ran, its candidate count and whether the row fell back."""
    b, s = h.shape
    sel = select_model(h, k)
    kth = sel["kth"]
    cols, nt = k1_layout(s)
    inside = cols < s

    x = torch.where(inside, h[:, cols.clamp(max=s - 1)], 0.0)  # (B, T, VPT)
    keep = x >= kth[:, :, None]
    fv = torch.where(keep, x, 0.0)
    acc = torch.zeros((b, nt), dtype=torch.float32)
    for j in range(fv.shape[-1]):  # each thread's keys in turn
        acc = acc + torch.where(inside[:, j], fv[:, :, j].abs(), 0.0)
    acc = acc.view(b, nt // 32, 32)
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):  # the warp's xor tree
        acc = acc + acc[:, :, lane ^ o]
    l1 = torch.zeros(b, dtype=torch.float32)
    for w in range(nt // 32):  # the warps in turn
        l1 = l1 + acc[:, w, 0]
    f = torch.where(h >= kth, h, 0.0).to(torch.bfloat16)
    return sel | {
        "f": f, "live": (f != 0).any(0), "l0": ((h >= kth) & (h != 0)).sum(1, keepdim=True).float(),
        "l1": l1[:, None],
    }


def k5_model(h: torch.Tensor, mask: torch.Tensor, k: int) -> tuple[torch.Tensor, int, int]:
    """K5 on a (B, S) batch and a (S,) bool mask: (value (B, 1), n, G)."""
    b, s = h.shape
    k = min(k, s)
    kpl, warps = k5_dispatch(s)
    nt = 32 * warps
    per = -(-s // nt)
    assert per <= 64
    # Each thread's run of columns, its count, and its offset (a block scan).
    runs = [torch.arange(min(t * per, s), min((t + 1) * per, s)) for t in range(nt)]
    counts = torch.tensor([int(mask[r].sum()) for r in runs])
    offsets = torch.cumsum(counts, 0) - counts
    n = int(counts.sum())
    idx = torch.full((n,), -1, dtype=torch.int64)
    for r, o in zip(runs, offsets.tolist()):
        kept = r[mask[r]]
        idx[o : o + len(kept)] = kept
    assert torch.equal(idx, torch.nonzero(mask).flatten())  # ascending, each once
    if n < k:
        return torch.full((b, 1), float("-inf")), n, 0
    g_warps = 1
    while g_warps * 32 * kpl < n:
        g_warps *= 2
    assert g_warps <= warps
    i, g, lane = torch.meshgrid(torch.arange(kpl), torch.arange(g_warps), torch.arange(32), indexing="ij")
    j = ((i * g_warps + g) * 32 + lane).flatten()  # the compacted key each lane slot holds
    assert torch.equal(torch.sort(j[j < n]).values, torch.arange(n))
    key = torch.where(j < n, order_key(h)[:, idx[j.clamp(max=n - 1)]], 0)
    valid = (j < n)[None, :]
    lo = torch.where(valid, key, 2**32 - 1).amin(-1)
    hi = key.amax(-1)
    cur = bisect(lo, hi, k, lambda t: (key >= t[:, None]).sum(-1))
    return key_float(cur)[:, None], n, g_warps


# --- the wide route of K1, K5 and K6 (csrc/kth_wide.cu) ---


def wide_consts() -> dict[str, int]:
    """kth_wide.cu's constants: the walk's keys a thread, threads a CTA and
    candidate capacity; K1's cluster route's keys a thread, threads a CTA,
    most CTAs a cluster, a CTA's candidate buffer and the gathered union's
    capacity; K5's group route's warps a CTA and the most unmasked columns
    it takes (KPL 64 keys a lane)."""
    src = _source("kth_wide.cu")
    get = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src)[1])  # noqa: E731
    assert "constexpr int kGroupMaxN = kGroupWarps * 32 * 64;" in src
    return {"vpt": get("kWideVpt"), "threads": get("kWideThreads"), "cap": get("kWideCap"),
            "slice_vpt": get("kSliceVpt"), "slice_threads": get("kSliceThreads"),
            "max_cluster": get("kMaxCluster"), "slice_cap": get("kSliceCap"), "union_cap": get("kUnionCap"),
            "group_warps": get("kGroupWarps"), "group_max": get("kGroupWarps") * 32 * 64}


def wide_chunks(s: int, chunk: int) -> list[tuple[int, int]]:
    """(start, width) of each chunk of a row of s keys (the walk,
    `wide_row`): the fewest chunks of at most `chunk`, of one width rounded
    up to a multiple of 4, the last one the rest; none for no keys."""
    n = -(-s // chunk)
    if n == 0:
        return []
    cs = (-(-s // n) + 3) // 4 * 4
    return [(c * cs, min(cs, s - c * cs)) for c in range(n)]


def wide_model(h: torch.Tensor, k: int, mask: torch.Tensor | None = None, *, chunk: int | None = None,
               cap: int | None = None, threads: int | None = None) -> dict:
    """The walk of kth_wide.cu (`wide_row_kernel`: K6; K5 past the group
    route, with a (S,) bool mask, over the keys of its unmasked columns; K1
    past the cluster route) on a (B, S) f32 batch: kth (B, 1), -inf where
    K5's row has fewer than k unmasked columns, and per row the lower bound
    L (a key), the candidate count and which way the row took: `ranked`,
    `bisected` (the buffer) or `fallback` (the whole row). The chunks, each
    chunk's k-th largest key (0 for a chunk of fewer than k), the running L,
    each chunk's candidates (its keys at or above its own k-th key, L so far
    and 1) against the buffer's capacity, then the k-th largest candidate,
    ranked up to the CTA's threads and bisected from L past them, or the
    whole row bisected from L where the buffer overflows. The chunk width,
    capacity and threads default to the source's and are parameters, so a
    test can cut a small row into several chunks."""
    c = wide_consts()
    chunk = chunk or c["vpt"] * c["threads"]
    cap = cap or c["cap"]
    threads = threads or c["threads"]
    b, s = h.shape
    k = min(k, s)
    key = order_key(h)
    if mask is not None:
        key = key[:, mask]
        s = key.shape[1]
    lower = torch.zeros(b, dtype=torch.int64)
    n_cand = torch.zeros(b, dtype=torch.int64)
    cand = []
    for c0, n in wide_chunks(s, chunk):
        kc = key[:, c0 : c0 + n]
        t = torch.sort(kc, dim=1, descending=True).values[:, k - 1] if n >= k else torch.zeros_like(lower)
        theta = torch.maximum(torch.maximum(t, lower), torch.ones_like(t))
        kept = kc >= theta[:, None]
        n_cand += kept.sum(1)
        cand.append(torch.where(kept, kc, 0))
        lower = torch.maximum(lower, t)
    # Fewer than k keys (K5): the k-th largest candidate is key 0.
    cand = torch.cat(cand + [torch.zeros((b, max(0, k - s)), dtype=key.dtype)], 1)
    hi = key.amax(1) if s else torch.zeros_like(lower)
    # The k-th largest candidate (0 where there are fewer than k), a
    # bisection over the candidates from L, and one over the whole row.
    ranked = torch.sort(cand, dim=1, descending=True).values[:, k - 1]
    by_cand = bisect(lower, hi, k, lambda t: (cand >= t[:, None]).sum(-1))
    by_row = bisect(lower, hi, k, lambda t: (key >= t[:, None]).sum(-1))
    fallback = n_cand > cap
    rank = ~fallback & (n_cand <= threads)
    kth = torch.where(fallback, by_row, torch.where(rank, ranked, by_cand))
    assert bool((kth >= lower).all())
    value = key_float(kth)
    if mask is not None:
        value = torch.where(kth == 0, float("-inf"), value)
    return {"kth": value[:, None], "lower": lower, "n_cand": n_cand, "ranked": rank,
            "bisected": ~fallback & ~rank, "fallback": fallback}


def walk_stats_model(h: torch.Tensor, k: int, **kw) -> dict:
    """K1 on the walk: `wide_model`'s kth, then f, live, L0 and L1 with
    topk_row.cuh's per-element formulas (L1 summed in column order)."""
    sel = wide_model(h, k, **kw)
    kth = sel["kth"]
    keep = h >= kth
    f = torch.where(keep, h, 0.0).to(torch.bfloat16)
    return sel | {"f": f, "live": (f != 0).any(0), "l0": (keep & (h != 0)).sum(1, keepdim=True).float(),
                  "l1": torch.where(keep, h, 0.0).abs().sum(1, keepdim=True)}


def cluster_slices(s: int, slice_cols: int) -> list[tuple[int, int]]:
    """(start, width) of each CTA's slice of a row of s on K1's cluster
    route (`cluster_ctas_for`, `slice_width`): C = ceil(s / slice_cols)
    slices of one width, ceil(s / C) rounded up to a multiple of 4, the
    last the rest."""
    n = -(-s // slice_cols)
    sw = (-(-s // n) + 3) // 4 * 4
    return [(c * sw, min(sw, s - c * sw)) for c in range(n)]


def cluster_model(h: torch.Tensor, k: int, *, vpt: int | None = None, threads: int | None = None,
                  slice_cap: int | None = None, union_cap: int | None = None) -> dict:
    """K1's select on its cluster route (`wide_cluster_kernel`) on a (B, S)
    f32 batch: C CTAs a row, CTA c holding slice c in K1's layout (VPT keys
    a thread in runs of 4 columns, T threads, key 0 past the slice's end).
    Each CTA's bound L_c: where 2k <= T' (the threads that hold a column of
    the last, smallest slice; `own`) the k-th largest of its threads'
    maxima, else, where q = ceil(k / C) <= T', the least over the CTAs of
    their q-th largest maxima; each cut to its bits down to kBoundBit as
    `bisect` finds it; 0 where neither holds. Each CTA's keys >= L_c are its
    candidates (counted against slice_cap, their sum against union_cap);
    the union's keys >= the largest bound are kept, and the k-th largest
    kept key is the row's, ranked up to T kept keys and bisected past them;
    else (a buffer or the union overflows, no bound) the cluster bisects the
    row from the largest bound. Returns kth (B, 1), C, the slices and per
    row the bound, the candidate and kept counts and which way the row
    took: `ranked`, `bisected` or `fallback`."""
    c = wide_consts()
    vpt = vpt or c["slice_vpt"]
    threads = threads or c["slice_threads"]
    slice_cap = slice_cap or c["slice_cap"]
    union_cap = union_cap or c["union_cap"]
    b, s = h.shape
    k = min(k, s)
    key = order_key(h)
    slices = cluster_slices(s, vpt * threads)
    n_ctas = len(slices)
    t_live = min(threads, -(-slices[-1][1] // 4))
    q = -(-k // n_ctas)
    own, bounded = 2 * k <= t_live, q <= t_live
    t = torch.arange(threads)[:, None]
    j = torch.arange(vpt)[None, :]
    layout = 4 * (t + (j // 4) * threads) + j % 4  # (T, VPT) column of each slot within a slice
    held, lower, top = [], [], []
    for c0, n in slices:
        kc = torch.where(layout < n, key[:, c0 + layout.clamp(max=n - 1)], 0)  # (B, T, VPT)
        mx = kc.amax(-1)
        top.append(mx.amax(-1))
        if bounded:
            lower.append(bisect(mx.amin(-1), mx.amax(-1), k if own else q,
                                lambda v: (mx >= v[:, None]).sum(-1), lowest=bound_bit()))
        else:
            lower.append(torch.zeros(b, dtype=torch.int64))
        held.append(kc.flatten(1))
    lower = torch.stack(lower, 1)  # (B, C)
    if bounded and not own:
        lower = lower.amin(1, keepdim=True).expand(b, n_ctas)
    top = torch.stack(top, 1).amax(1)
    n_cand = torch.stack([(kc >= lc[:, None]).sum(1) if bounded else torch.zeros(b, dtype=torch.int64)
                          for kc, lc in zip(held, lower.unbind(1))], 1)
    least, most = lower.amin(1), lower.amax(1)
    n_union = n_cand.sum(1)
    fits = bounded & (least > 0) & (n_cand <= slice_cap).all(1) & (n_union <= union_cap)
    # The union: each slice's keys >= its own bound, of which those >= the
    # largest bound are kept.
    union = torch.cat([torch.where(kc >= lc[:, None], kc, 0) for kc, lc in zip(held, lower.unbind(1))], 1)
    kept = torch.where(union >= most[:, None], union, 0)
    n_kept = (kept > 0).sum(1)
    by_kept = torch.sort(kept, dim=1, descending=True).values[:, k - 1]
    row = torch.cat(held, 1)
    by_row = bisect(most, top, k, lambda v: (row >= v[:, None]).sum(-1))
    kth = torch.where(fits, by_kept, by_row)
    assert bool((kth >= most).all())
    rank = fits & (n_kept <= threads)
    return {"kth": key_float(kth)[:, None], "ctas": n_ctas, "slices": slices, "lower": most, "n_cand": n_union,
            "n_kept": n_kept, "own": own, "ranked": rank, "bisected": fits & ~rank, "fallback": ~fits}


def cluster_stats_model(h: torch.Tensor, k: int, **kw) -> dict:
    """K1 on its cluster route: `cluster_model`'s kth, then f, live, L0 and
    L1 with topk_row.cuh's per-element formulas, L1 in the kernel's order:
    each CTA's part as K1 sums a row (each thread's keys in turn, a warp's
    xor tree, the warps in turn), then the CTAs' parts in rank order."""
    sel = cluster_model(h, k, **kw)
    kth = sel["kth"]
    c = wide_consts()
    vpt = kw.get("vpt") or c["slice_vpt"]
    threads = kw.get("threads") or c["slice_threads"]
    b = h.shape[0]
    t = torch.arange(threads)[:, None]
    j = torch.arange(vpt)[None, :]
    layout = 4 * (t + (j // 4) * threads) + j % 4
    lane = torch.arange(32)
    l1 = torch.zeros(b, dtype=torch.float32)
    for c0, n in sel["slices"]:
        inside = layout < n
        x = torch.where(inside, h[:, c0 + layout.clamp(max=n - 1)], 0.0)  # (B, T, VPT)
        fv = torch.where(inside & (x >= kth[:, :, None]), x, 0.0)
        acc = torch.zeros((b, threads), dtype=torch.float32)
        for i in range(vpt):  # each thread's keys in turn
            acc = acc + fv[:, :, i].abs()
        acc = acc.view(b, threads // 32, 32)
        for o in (16, 8, 4, 2, 1):  # the warp's xor tree
            acc = acc + acc[:, :, lane ^ o]
        part = torch.zeros(b, dtype=torch.float32)
        for w in range(threads // 32):  # the warps in turn
            part = part + acc[:, w, 0]
        l1 = l1 + part  # the CTAs in rank order
    keep = h >= kth
    f = torch.where(keep, h, 0.0).to(torch.bfloat16)
    return sel | {"f": f, "live": (f != 0).any(0), "l0": (keep & (h != 0)).sum(1, keepdim=True).float(),
                  "l1": l1[:, None]}


def wide_stats_model(h: torch.Tensor, k: int, *, cluster: dict | None = None, walk: dict | None = None) -> dict:
    """K1 on rows wider than its narrow kernel holds, as `saev_topk_stats_wide`
    routes them: the cluster route up to kMaxCluster slices, the walk past
    it; `cluster` and `walk` are the two models' keyword parameters."""
    cluster, walk = cluster or {}, walk or {}
    c = wide_consts()
    slice_cols = (cluster.get("vpt") or c["slice_vpt"]) * (cluster.get("threads") or c["slice_threads"])
    if -(-h.shape[1] // slice_cols) <= c["max_cluster"]:
        return cluster_stats_model(h, k, **cluster) | {"route": "cluster"}
    return walk_stats_model(h, k, **walk) | {"route": "walk"}


def k5_wide_model(h: torch.Tensor, mask: torch.Tensor, k: int, *, warps: int | None = None,
                  walk: dict | None = None) -> dict:
    """K5 on rows wider than its narrow kernel holds (`saev_kth_masked_wide`):
    the list of the n unmasked columns, then, chosen on the card from n, the
    group route (`wide_masked_group_kernel`: KPL 32 keys a lane for n <=
    warps * 32 * 32, KPL 64 up to warps * 32 * 64; G warps a row, the
    fewest, a power of two, that hold n) or the walk past it (`wide_model`
    with `walk`'s parameters). -inf where fewer than k columns are unmasked.
    Returns value (B, 1), n, the route, KPL and G."""
    warps = warps or wide_consts()["group_warps"]
    k = min(k, h.shape[1])
    n = int(mask.sum())
    if n > warps * 32 * 64:
        return {"value": wide_model(h, k, mask, **(walk or {}))["kth"], "n": n, "route": "walk", "kpl": 0, "g": 0}
    kpl = 32 if n <= warps * 32 * 32 else 64
    if n < k:
        return {"value": torch.full((h.shape[0], 1), float("-inf")), "n": n, "route": "group", "kpl": kpl, "g": 0}
    g_warps = 1
    while g_warps * 32 * kpl < n:
        g_warps *= 2
    assert g_warps <= warps
    key = order_key(h)[:, mask]
    lo, hi = key.amin(1), key.amax(1)
    kth = bisect(lo, hi, k, lambda t: (key >= t[:, None]).sum(-1))
    return {"value": key_float(kth)[:, None], "n": n, "route": "group", "kpl": kpl, "g": g_warps}


# --- P4 and P3, the pass loops (csrc/kth_ops.cu) ---

PASS_MODES = ("prod", "i32key", "subsar", "f32red", "mxu")  # the kernel's MODE is the index


def pass_consts() -> dict[str, int]:
    """kth_ops.cu's accumulators of a thread's count in a pass (P4, kAcc)
    and over its passes (P3, kLoopAcc), and mxu's D fragments (kMxuAcc)."""
    src = _source("kth_ops.cu")
    get = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src)[1])  # noqa: E731
    return {"acc": get("kAcc"), "loop_acc": get("kLoopAcc"), "mxu_acc": get("kMxuAcc")}


def pass_dispatch(s: int) -> tuple[int, int]:
    """(VPT, MAXT) of kth_ops.cu's tables for a row of s: P4's (`dispatch`)
    and P3's (`saev_count_loop`), which must agree."""
    src = _source("kth_ops.cu")
    p4 = re.findall(r"S <= (\d+) \* (\d+)\) return launch<MODE, (\d+), (\d+)>", src)
    p3 = re.findall(r"S <= (\d+) \* (\d+)\) return launch_count<(\d+), (\d+)>", src)
    assert p4 and p4 == p3
    for n_t, vpt, vpt_t, maxt in p4:
        if s <= int(n_t) * int(vpt):
            return int(vpt_t), int(maxt)
    raise ValueError(s)


def streams(s: int, offset: int = 0) -> bool:
    """kth_ops.cu `streams`: the persistent stream route where S % 4 == 0
    and the batch is 16-byte aligned (its first element `offset` 4-byte
    elements into an aligned allocation); else one CTA a row."""
    return s % 4 == 0 and offset % 4 == 0


def cta_rows(b: int, ctas: int) -> list[list[int]]:
    """The rows each persistent CTA takes (row_stream.cuh `stream_rows`):
    the grid is min(B, the CTAs the card holds at once), and CTA g takes
    rows g, g + grid, ..."""
    grid = min(b, ctas)
    return [list(range(g, b, grid)) for g in range(grid)]


def _thread_keys(key: torch.Tensor, pad: int) -> tuple[torch.Tensor, int, int]:
    """(B, T, VPT) keys as the CTA's threads hold them (runs of 4 columns,
    K1's layout: `k1_layout` under kth_ops.cu's table), `pad` past the row's
    end; and T, VPT."""
    s = key.shape[1]
    cols, nt = k1_layout(s, pass_dispatch)
    vpt = cols.shape[1]
    held = torch.where(cols < s, key[:, cols.clamp(max=s - 1)], pad)
    return held, nt, vpt


def _tree(acc: torch.Tensor) -> torch.Tensor:
    """`warp_count`'s sum of a thread's accumulators (last dim): halves
    added pairwise, c[i] += c[i + s] for s = A/2, .., 1."""
    a = acc.shape[-1]
    s = a // 2
    while s > 0:
        acc = acc[..., :s] + acc[..., s : 2 * s]
        s //= 2
    return acc[..., 0]


def _accumulate(hit: torch.Tensor, a: int) -> torch.Tensor:
    """(.., T, VPT) values -> (.., T, A): accumulator j % A sums keys j, j +
    A, .. of each thread (keys past VPT add to none)."""
    vpt = hit.shape[-1]
    acc = torch.zeros(hit.shape[:-1] + (a,), dtype=hit.dtype)
    for j in range(vpt):
        acc[..., j % a] += hit[..., j]
    return acc


def _mxu_lane_counts(mask: torch.Tensor, frags: int) -> torch.Tensor:
    """mxu's count of one pass in each lane, from (B, T, VPT) 0/1 f32: each
    thread's keys 8m..8m+7 are product m's bf16 A fragment (a[q] = keys
    8m+2q, 8m+2q+1; a[0] and a[2] in row lane/4, a[1] and a[3] in row
    lane/4 + 8), D fragment m % frags adds A times ones, so column 0 of row
    r is the sum of row r of A over the four lanes that hold it; lanes with
    lane % 4 == 0 take d[0] + d[2] of every fragment, the others 0."""
    b, nt, vpt = mask.shape
    mmas = -(-vpt // 8)
    vals = torch.zeros((b, nt, mmas * 8), dtype=torch.float32)
    vals[..., :vpt] = mask
    vals = vals.view(b, nt // 32, 8, 4, mmas, 4, 2)  # (B, warp, g, t, m, q, lo/hi)
    row_lo = vals[..., 0, :] + vals[..., 2, :]  # a[0], a[2]: row g
    row_hi = vals[..., 1, :] + vals[..., 3, :]  # a[1], a[3]: row g + 8
    # D[r][0] of product m: the row's values over its four lanes (t).
    d_lo = row_lo.sum(-1).sum(3)  # (B, warp, g, m)
    d_hi = row_hi.sum(-1).sum(3)
    d = torch.zeros((b, nt // 32, 8, frags, 2), dtype=torch.float32)
    for m in range(mmas):
        d[..., m % frags, 0] += d_lo[..., m]
        d[..., m % frags, 1] += d_hi[..., m]
    c = torch.zeros((b, nt // 32, 8, 4), dtype=torch.float32)  # lane = 4 g + t
    for i in range(frags):
        c[..., 0] += d[..., i, 0] + d[..., i, 1]
    return c.view(b, nt)


def kth_ops_model(h: torch.Tensor, k: int, mode: str, ctas: int = 264) -> dict:
    """P4 on a (B, S) f32 batch, as kth_ops.cu runs it: kth (B, 1) and the
    rows each persistent CTA took. The keys in the mode's domain (int64:
    u32, signed, 31-bit) with its pad past S, VPT a thread over T threads,
    the count of each pass in A accumulators a thread (f32 in f32red; mxu's
    D fragments), the warp's sum, the block's sum of the warps', and the
    prefix step; also VPT, T, the pad and each pass's candidate (B,
    passes)."""
    b, s = h.shape
    consts = pass_consts()
    key = order_key(h)
    passes, cur = 32, torch.zeros(b, dtype=torch.int64)
    pad = 0
    if mode == "i32key":
        key, cur, pad = key - 2**31, cur - 2**31, -(2**31)  # key ^ sign read as int32
    elif mode == "subsar":
        key, passes, pad = key >> 1, 31, 2**31 - 1
    held, nt, vpt = _thread_keys(key, pad)
    rows = cta_rows(b, ctas)
    assert sorted(r for rs in rows for r in rs) == list(range(b))
    cands = []
    for p in range(passes):
        bit = 1 << (passes - 1 - p)
        if mode == "i32key":  # int32 arithmetic: bit 31 is INT32_MIN, the first step wraps to 0
            cand = cur + (bit - 2**32 if bit == 2**31 else bit)
            cand = torch.remainder(cand + 2**31, 2**32) - 2**31
        elif mode == "subsar":
            cand = cur + bit
        else:
            cand = cur | bit
        cands.append(cand)
        c = cand[:, None, None]
        if mode == "mxu":
            lane = _mxu_lane_counts((held >= c).float(), consts["mxu_acc"])
        elif mode == "f32red":
            lane = _tree(_accumulate((held >= c).float(), consts["acc"]))
        elif mode == "subsar":
            lane = _tree(_accumulate(((held - c) < 0).long() * -1, consts["acc"]))
        else:  # prod, i32key: compares in their own domain
            lane = _tree(_accumulate((held >= c).long(), consts["acc"]))
        warp = lane.view(b, nt // 32, 32).sum(-1)
        total = warp.sum(-1)
        if mode == "subsar":
            total = total + s
        cur = torch.where(total >= k, cand, cur)
    if mode == "i32key":
        cur = cur + 2**31
    elif mode == "subsar":
        cur = cur << 1
    return {"kth": key_float(cur)[:, None], "rows": rows, "vpt": vpt, "threads": nt, "pad": pad,
            "cands": torch.stack(cands, 1)}


def count_loop_model(key: torch.Tensor, n_passes: int, ctas: int = 264) -> dict:
    """P3 on a (B, S) int32 batch, as kth_ops.cu runs it: out (B, 1) int32
    and the rows each persistent CTA took. The keys, VPT a thread over T
    threads, INT_MIN past S; each thread sums compare results over the
    passes and its keys into kLoopAcc accumulators in one sweep (u32
    arithmetic),
    adds them, then one warp sum and one block sum a row."""
    b, s = key.shape
    held, nt, vpt = _thread_keys(key.to(torch.int64), -(2**31))
    rows = cta_rows(b, ctas)
    assert sorted(r for rs in rows for r in rs) == list(range(b))
    acc = torch.zeros((b, nt, pass_consts()["loop_acc"]), dtype=torch.int64)
    for p in range(n_passes):
        acc = (acc + _accumulate((held >= p).long(), acc.shape[-1])) % 2**32
    total = _tree(acc).view(b, nt // 32, 32).sum(-1).sum(-1) % 2**32
    out = torch.where(total >= 2**31, total - 2**32, total).to(torch.int32)
    return {"out": out[:, None], "rows": rows, "vpt": vpt, "threads": nt}
