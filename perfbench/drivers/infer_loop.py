"""Closed-loop inference of one trained dictionary over batches of tokens,
as the port's `framework.inference.worker_fn` loop drives a batch:
`infer_batch` (the encoder at "highest" with K6's TopK threshold, the
decode, the batch's sums), `compact_rows` and the distributions' slice on
the card, then the copies to the host, the float64 sums there and
`csr_block`. Every row is kept. Each CSR block is dropped once assembled;
the files' write is not part of the window.

The traffic file gives k, the ring's batches, the rows a batch whose CSR
rows are kept for the check (`sample_rows`, drawn from the seed), the share
of batches whose sums are kept (`sample_batches`), `n_dists`, the batches
the trace profiles, and `fault` for the correctness tests.

The check, after the window with the program's state freed (`compare`):
every row of each ring slot's latest batch and the sampled rows of every
other batch are judged by the reference's pre-activations and TopK
threshold, and each slot's latest sums and the sampled batches' by the
reference's sums.
"""

import time

import numpy as np
import torch

from perfbench.lib import data, result, trace as tracing, work
from perfbench.reference import sae as ref


def init_params(cfg, seed, device) -> dict:
    """One dictionary, datapoint-initialized from the seed (a trained one
    would need checkpoints the repository does not hold)."""
    stacked = data.datapoint_init(cfg, 1, seed + 101, device)
    return {k: v[0].contiguous() for k, v in stacked.items()}


def run(cell, seed: int, seconds: float, trace: bool, device: str, t0: float) -> result.Run:
    from saev_tpu_torch.framework import inference
    from saev_tpu_torch.nn import modeling

    cfg, tr = cell.config, cell.traffic
    b, s, d, k = tr["batch_size"], cfg["d_sae"], cfg["d_model"], tr["top_k"]
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    out = result.Run(cell=cell)
    fault = tr.get("fault")

    sae_cfg = modeling.SparseAutoencoderConfig(d_model=d, d_sae=s, activation=modeling.TopK(top_k=k))
    params = init_params(cfg, seed, dev)
    state = modeling.init_state(sae_cfg, dev)
    ring = data.batches(cfg["assumed"]["activations"], d, b, tr["ring"], seed, dev)
    mask = torch.ones(b, dtype=torch.bool, device=dev)
    n_dists = min(tr["n_dists"], s)
    rng = data.numpy_rng(seed, 2000)
    sums = {"n_tokens": 0, "sse_recon": 0.0, "sum_sq": 0.0,
            "sum_vec": np.zeros(d), "mean_values": np.zeros(s), "sparsity": np.zeros(s)}
    kept_rows: list[tuple[int, np.ndarray, list]] = []  # (slot, rows, [(columns, values)] a row)
    kept_stats: list[tuple[int, dict]] = []
    last: dict[int, tuple] = {}  # a ring slot's latest whole batch of CSR rows
    last_stats: dict[int, dict] = {}  # and its sums
    clock = {"host": 0.0}
    host_spans = tracing.Spans()
    events: list = []

    def one(i: int, keep: bool, timed: bool) -> None:
        slot = i % len(ring)
        x = ring[slot]
        if timed:
            e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            e[0].record()
        with host_spans.span("infer_batch"):
            f, stats = inference.infer_batch(sae_cfg, params, state, x, mask)
        if timed:
            e[1].record()
        with host_spans.span("compact"):
            counts, cols, vals = inference.compact_rows(f)
            dists = f[:, :n_dists]
        if timed:
            e[2].record()
            events.append(e)
        t = time.perf_counter()
        with host_spans.span("host"):
            st = {key: v.cpu().numpy() for key, v in stats.items()}
            counts_h, cols_h, vals_h = counts.cpu().numpy(), cols.cpu().numpy(), vals.cpu().numpy()
            dists.cpu().numpy()
            if fault == "altered":  # a planted fault: one answer altered where it is produced
                vals_h = vals_h.copy()
                vals_h[len(vals_h) // 2] += 1.0
            if fault == "half_batch":  # a planted fault: half the batch left out of the sums
                st = {key: v * 0.5 if key != "n_tokens" else v for key, v in st.items()}
            sums["n_tokens"] += int(st["n_tokens"])
            sums["sse_recon"] += float(st["sse_recon"])
            sums["sum_sq"] += float(st["sum_sq"])
            sums["sum_vec"] += st["sum_vec"].astype(np.float64)
            sums["mean_values"] += st["mean_values"].astype(np.float64)
            sums["sparsity"] += st["sparsity"].astype(np.float64)
            block = inference.csr_block(counts_h, cols_h, vals_h, s)
        if timed:
            clock["host"] += time.perf_counter() - t
        if keep:
            last[slot] = (counts_h, cols_h, vals_h)
            last_stats[slot] = st
            rows = np.sort(rng.choice(b, size=tr["sample_rows"], replace=False))
            ptr = block.indptr
            kept_rows.append((slot, rows, [(block.indices[ptr[r]:ptr[r + 1]].copy(), block.data[ptr[r]:ptr[r + 1]].copy())
                                           for r in rows]))
            if rng.random() < tr["sample_batches"]:
                kept_stats.append((slot, st))
        del block

    # Set-up: one batch of each ring slot warms every shape.
    for i in range(len(ring)):
        one(i, keep=False, timed=False)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    out.end_to_end["setup_s"] = time.perf_counter() - t0
    w0 = time.perf_counter()
    n = 0
    while True:
        one(n, keep=True, timed=trace and on_card)
        n += 1
        if time.perf_counter() - w0 >= seconds:
            break
    if on_card:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - w0
    out.attempted = n
    out.end_to_end["infer_tokens_per_s"] = n * b / window_s
    if on_card:
        out.memory_peak_bytes = torch.cuda.max_memory_allocated()
    out.end_to_end["peak_mem_gib"] = out.memory_peak_bytes / 2**30
    m = work.infer_batch_model_s(b, d, s, k)
    out.counts.update(batches=n, window_s=window_s, batch=b, d_sae=s, d_model=d, k=k)
    out.model_s.update(batch_model=m["model"], batch_select=m["select"])
    if trace:
        out.host_s["host_per_batch"] = clock["host"] / max(n, 1)
        if events:
            out.event_ms["compaction"] = sum(e[1].elapsed_time(e[2]) for e in events) / len(events)
        if on_card:
            n_prof = tr["profiled_batches"]

            def segment():
                for i in range(n_prof):
                    one(n + i, keep=False, timed=False)

            out.trace = tracing.profile(segment, host_spans)
            out.counts["profiled_batches"] = n_prof

    del params, ring, state, mask
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    kept_stats += list(last_stats.items())
    for name, value in compare(cfg, tr, seed, dev, kept_rows, kept_stats, last).items():
        out.check(name, value)
    return out


def _gaps(h: torch.Tensor, kth: torch.Tensor, cols: list, vals: list) -> tuple[float, float]:
    """(rank gap, value gap) of rows whose reference pre-activations are h
    and thresholds kth, judged against the program's CSR rows (columns and
    values a row): the widest gap by which a kept column lies below the
    threshold or a column left out lies above it, and the widest gap of a
    kept value from its pre-activation, each over the row's rms
    pre-activation."""
    n = h.shape[0]
    row = torch.repeat_interleave(torch.arange(n, device=h.device),
                                  torch.tensor([len(c) for c in cols], device=h.device))
    col = torch.from_numpy(np.concatenate(cols).astype(np.int64)).to(h.device)
    val = torch.from_numpy(np.concatenate(vals).astype(np.float32)).to(h.device)
    kept = torch.zeros_like(h, dtype=torch.bool)
    kept[row, col] = True
    rms = torch.sqrt(torch.mean(h.double() ** 2, dim=1, keepdim=True))
    gap = torch.where(kept, kth - h, h - kth).clamp(min=0).double() / rms
    value = (val.double() - h[row, col].double()).abs() / rms[row, 0]
    return float(gap.max()), float(value.max()) if value.numel() else 0.0


def compare(cfg, tr, seed, dev, kept_rows, kept_stats, last, mode="f32") -> dict[str, float]:
    """The numbers compared, the reference made again from the seed: over
    every row of each ring slot's latest batch in the window and the rows
    kept from every other batch, the widest gap by which a column the
    program kept lies below the reference's threshold, or one it left out
    lies above it, in the reference's pre-activations ("rank_gap"; a column
    at the threshold that rounding moves across reads near 0), and the
    widest gap of a kept value from the reference's pre-activation
    ("value_gap"), both over the row's rms pre-activation; over the kept
    batches, the worst relative gap of a sum ("stats_gap": the token count,
    the SSE, the sum of squares, and the sums of x, of each latent's values
    and of its positive counts by the L1 norm of their difference)."""
    params = init_params(cfg, seed, dev)
    ring = data.batches(cfg["assumed"]["activations"], cfg["d_model"], tr["batch_size"], tr["ring"], seed, dev)
    k = tr["top_k"]
    rank = value = 0.0
    for slot, (counts, cols, vals) in last.items():
        ptr = np.concatenate([[0], np.cumsum(counts)])
        block = 4096
        for start in range(0, len(counts), block):
            stop = min(start + block, len(counts))
            h, kth = ref.infer_rows(params, ring[slot][start:stop], k, mode)
            g = _gaps(h, kth, [cols[ptr[r]:ptr[r + 1]] for r in range(start, stop)],
                      [vals[ptr[r]:ptr[r + 1]] for r in range(start, stop)])
            rank, value = max(rank, g[0]), max(value, g[1])
            del h, kth
    for slot, rows, csr in kept_rows:
        h, kth = ref.infer_rows(params, ring[slot][torch.from_numpy(rows).to(dev)], k, mode)
        g = _gaps(h, kth, [c for c, _ in csr], [v for _, v in csr])
        rank, value = max(rank, g[0]), max(value, g[1])
    stats = 0.0
    cache: dict[int, dict] = {}
    for slot, st in kept_stats:
        if slot not in cache:
            cache[slot] = ref.infer_stats(params, ring[slot], k, mode)
        r = cache[slot]
        stats = max(stats, result.rel_gap(float(st["n_tokens"]), float(r["n_tokens"])),
                    result.rel_gap(float(st["sse_recon"]), r["sse_recon"]),
                    result.rel_gap(float(st["sum_sq"]), r["sum_sq"]))
        for key in ("sum_vec", "mean_values", "sparsity"):
            rv = r[key].cpu().numpy()
            stats = max(stats, float(np.sum(np.abs(st[key].astype(np.float64) - rv)) / np.sum(np.abs(rv))))
    return {"rank_gap": rank, "value_gap": value, "stats_gap": stats}
