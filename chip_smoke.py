"""Drive the PyTorch port's production SAE train step on one CUDA card.

    python3 chip_smoke.py

Phases, one output line or more each, in order; any failure raises and the
script exits non-zero:

1. device   -- a CUDA card must be present (no CPU fallback); prints its name
               and the `nvidia-smi` name and power limit.
2. build    -- compiles saev_tpu_torch/csrc/*.cu with nvcc (ops/_build.py).
3. parity   -- each kernel against its plain PyTorch version on the same
               CUDA tensors at the production shape (batch 16384, d_sae 16384,
               d_model 1024, k 32, 10 prefixes), plus edge cases.
4. reference -- the step on the card (kernel path) against the same step on
               the CPU (plain f32 path) at a small shape.
5. slice    -- the warm-up train step (TopK 32 + Matryoshka 10, Adam,
               aux_enabled=False) at full width: 5 steps of one SAE and 2 of a
               two-SAE sweep, counting kernel launches.
6. timing   -- each kernel's time against its plain version's.

The line before the last is {"kernels": [...]} with every number measured in
this run; the last line is {"ok": true, "device": {...}}.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

B, D_MODEL, D_SAE, TOP_K, N_PREFIXES, GROUP = 16384, 1024, 16384, 32, 10, 1024
SEED = 0

KERNELS = {
    "topk_stats": ("saev_tpu_torch/csrc/topk_stats.cu", "saev_tpu/ops/pallas_topk.py:136"),
    "grouped_prefix_err": ("saev_tpu_torch/csrc/matryoshka.cu", "saev_tpu/ops/pallas_matryoshka.py:161"),
    "grouped_matmul_dgrad": ("saev_tpu_torch/csrc/matryoshka.cu", "saev_tpu/ops/pallas_matryoshka.py:287"),
    "grouped_matmul_wgrad": ("saev_tpu_torch/csrc/matryoshka.cu", "saev_tpu/ops/pallas_matryoshka.py:424"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def wrappers() -> dict:
    from saev_tpu_torch.ops import cuda_matryoshka as cm
    from saev_tpu_torch.ops import cuda_topk

    return {
        "topk_stats": cuda_topk.topk_stats_cuda,
        "grouped_prefix_err": cm.grouped_prefix_err,
        "grouped_matmul_dgrad": cm.grouped_matmul_dgrad,
        "grouped_matmul_wgrad": cm.grouped_matmul_wgrad,
    }


def rel_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on a GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {name}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi)
    return name


def phase_build(verbose: bool = False) -> None:
    from saev_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build(verbose=verbose)
    _build.lib()
    log(f"build: {path.name} in {time.perf_counter() - t0:.1f} s")


def _gen(device="cuda") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(SEED)


def _k1_case(h: torch.Tensor, k: int, what: str) -> float:
    from saev_tpu_torch.ops import cuda_topk, topk

    got = cuda_topk.topk_stats_cuda(h, k)
    want = topk._topk_stats_plain(h, k)
    torch.cuda.synchronize()
    require(torch.equal(got.kth, want.kth), f"K1 {what}: kth differs")
    require(torch.equal(got.f, want.f), f"K1 {what}: f differs")
    require(torch.equal(got.live, want.live), f"K1 {what}: live differs")
    require(torch.equal(got.l0, want.l0), f"K1 {what}: l0 differs")
    l1_rel = float(((got.l1 - want.l1).abs() / want.l1.abs().clamp_min(1e-30)).max())
    require(l1_rel <= 1e-6, f"K1 {what}: l1 rel err {l1_rel:.3g} > 1e-6")
    err = max(max_abs(got.kth, want.kth), max_abs(got.f, want.f), max_abs(got.l1, want.l1))
    log(f"parity K1 {what}: kth/f/live/l0 equal, l1 max rel {l1_rel:.3g}")
    return err


def _k1_inputs() -> torch.Tensor:
    h = torch.randn((B, D_SAE), generator=_gen(), device="cuda")
    h[0] = 0.0  # all tied at zero
    h[1] = -h[1].abs()  # all negative
    h[2] = -h[2].abs()
    h[2, :5] = 1.0 + torch.arange(5, device="cuda")  # fewer than k positive
    h[3, :100] = 7.0  # ties across the boundary
    h[4, ::2] = -0.0  # signed zeros beside positives
    h[4, 1::2] = -h[4, 1::2].abs()
    h[4, 1:40:2] = 0.5
    return h


def _matryoshka_inputs():
    from saev_tpu_torch.nn import objectives

    g = _gen()
    f = (torch.randn((B, D_SAE), generator=g, device="cuda")
         * (torch.rand((B, D_SAE), generator=g, device="cuda") < 0.1)).to(torch.bfloat16)
    w = (torch.randn((D_SAE, D_MODEL), generator=g, device="cuda") / 32).to(torch.bfloat16)
    x = torch.randn((B, D_MODEL), generator=g, device="cuda")
    b_dec = torch.randn((D_MODEL,), generator=g, device="cuda") * 0.1
    rng = np.random.default_rng(SEED)
    sampled = objectives.sample_prefixes(D_SAE, N_PREFIXES, rng=rng)
    # m = 0 (p < g), two cuts in one group, r = 0 (p on a boundary), p = d_sae.
    hand = np.asarray([100, 700, 1024, 2048, 5000, 5001, 9000, 12288, 15000, D_SAE], np.int32)
    return f, w, x, b_dec, {"sampled": sampled, "hand-set": hand}


def _cuts(p: np.ndarray):
    pt = torch.from_numpy(p).to("cuda")
    m = torch.div(pt, GROUP, rounding_mode="floor").to(torch.int32).contiguous()
    return m, (pt - m * GROUP).to(torch.int32).contiguous()


def phase_parity() -> dict:
    from saev_tpu_torch.ops import cuda_matryoshka as cm

    errs = {name: 0.0 for name in KERNELS}
    h = _k1_inputs()
    errs["topk_stats"] = _k1_case(h, TOP_K, "production")
    errs["topk_stats"] = max(errs["topk_stats"], _k1_case(h[:256].contiguous(), D_SAE, "k = d_sae"))
    errs["topk_stats"] = max(errs["topk_stats"], _k1_case(h[:256, :1000].contiguous(), TOP_K, "ragged row 1000"))
    del h

    f, w, x, b_dec, cut_sets = _matryoshka_inputs()
    upper = x.abs().max().clamp_min(1e-12)
    iu = (1.0 / upper).reshape(1)
    for what, p in cut_sets.items():
        m, r = _cuts(p)
        j = len(p)
        e, xhat, loss = cm.grouped_prefix_err(f, w, x, b_dec, iu, m, r, group_size=GROUP)
        e2, _, loss2 = cm.grouped_prefix_err(f, w, x, b_dec, iu, m, r, group_size=GROUP)
        pe, pxhat, ploss = cm.grouped_prefix_err_plain(f, w, x, b_dec, iu, m, r, group_size=GROUP)
        torch.cuda.synchronize()
        require(torch.equal(loss, loss2) and torch.equal(e, e2), f"K2 {what}: not bitwise reproducible")
        loss_rel = abs(float(loss) - float(ploss)) / abs(float(ploss))
        require(loss_rel <= 1e-5, f"K2 {what}: loss rel err {loss_rel:.3g} > 1e-5")
        r_xhat, r_e = rel_norm(xhat, pxhat), rel_norm(e, pe)
        require(r_xhat <= 1e-4, f"K2 {what}: xhat rel-norm {r_xhat:.3g} > 1e-4")
        require(r_e <= 1e-2, f"K2 {what}: E rel-norm {r_e:.3g} > 1e-2")
        errs["grouped_prefix_err"] = max(errs["grouped_prefix_err"], max_abs(xhat, pxhat), max_abs(e, pe))
        log(f"parity K2 {what} cuts {p.tolist()}: loss rel {loss_rel:.3g} (bitwise repeatable), "
            f"xhat rel-norm {r_xhat:.3g}, E rel-norm {r_e:.3g}")
        del e2, pe, pxhat

        scale = torch.full((1,), 2.0 / (B * j * D_MODEL), device="cuda")
        df, da = cm.grouped_matmul_dgrad(w, e, m, r, scale, group_size=GROUP, df_dtype=torch.bfloat16)
        pdf, pda = cm.grouped_matmul_dgrad_plain(w, e, m, r, scale, group_size=GROUP, df_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        r_df, r_da = rel_norm(df, pdf), rel_norm(da, pda)
        require(r_df <= 1e-2 and r_da <= 1e-2, f"K3 {what}: df {r_df:.3g} / dA {r_da:.3g} rel-norm > 1e-2")
        errs["grouped_matmul_dgrad"] = max(errs["grouped_matmul_dgrad"], max_abs(df, pdf), max_abs(da, pda))
        log(f"parity K3 {what}: df rel-norm {r_df:.3g}, dA rel-norm {r_da:.3g}")
        del df, pdf, pda

        dw = cm.grouped_matmul_wgrad(f, da, e, m, r, scale, group_size=GROUP)
        pdw = cm.grouped_matmul_wgrad_plain(f, da, e, m, r, scale, group_size=GROUP)
        torch.cuda.synchronize()
        r_dw = rel_norm(dw, pdw)
        require(r_dw <= 1e-4, f"K4 {what}: dW rel-norm {r_dw:.3g} > 1e-4")
        errs["grouped_matmul_wgrad"] = max(errs["grouped_matmul_wgrad"], max_abs(dw, pdw))
        log(f"parity K4 {what}: dW rel-norm {r_dw:.3g}")
        del dw, pdw, da, e
    torch.cuda.empty_cache()
    return errs


def _hp(n_sae: int, device) -> dict:
    return {
        "lr": torch.full((n_sae,), 4e-4, device=device) * (1 + torch.arange(n_sae, device=device)),
        "n_lr_warmup": torch.full((n_sae,), 2.0, device=device),
        "grad_clip": torch.ones((n_sae,), device=device),
        "sparsity_coeff": torch.zeros((n_sae,), device=device),
    }


def phase_reference() -> None:
    """Kernel path on the card against the plain f32 path on the CPU, from
    one state and batch at a small shape (bf16 against f32: rel 1e-2)."""
    from saev_tpu_torch.framework import train
    from saev_tpu_torch.nn import modeling, objectives

    cfg = modeling.SparseAutoencoderConfig(d_model=128, d_sae=2048, activation=modeling.TopK(top_k=8))
    obj = objectives.Matryoshka(n_prefixes=4)
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.normal(size=(256, 128)).astype(np.float32))
    pf = torch.from_numpy(np.stack([objectives.sample_prefixes(2048, 4, rng=rng) for _ in range(2)]))
    ts_cpu = train.init_sweep_state(cfg, 2, torch.Generator().manual_seed(SEED))
    ts_gpu = train.SweepState(*(train._tree_map(lambda t: t.to("cuda"), v) for v in ts_cpu))
    step = train.make_train_step(cfg, obj, n_steps=100)
    for i in range(3):
        ts_cpu, s_cpu = step(ts_cpu, x, pf, _hp(2, "cpu"))
        ts_gpu, s_gpu = step(ts_gpu, x.cuda(), pf.cuda(), _hp(2, "cuda"))
        for key in ("mse", "l1", "loss", "grad_norm"):
            a, b = s_gpu[key].cpu(), s_cpu[key]
            rel = float(((a - b).abs() / b.abs()).max())
            require(rel <= 1e-2, f"reference step {i}: {key} rel err {rel:.3g} > 1e-2")
        require(torch.equal(s_gpu["l0"].cpu(), s_cpu["l0"]), f"reference step {i}: l0 differs")
    log(f"reference: 3 steps of a 2-SAE sweep (d_model 128, d_sae 2048, batch 256) "
        f"agree with the CPU plain path; last mse {s_gpu['mse'].tolist()}")


def phase_slice() -> dict:
    from saev_tpu_torch.framework import train
    from saev_tpu_torch.nn import modeling, objectives

    cfg = modeling.SparseAutoencoderConfig(
        d_model=D_MODEL, d_sae=D_SAE, activation=modeling.TopK(top_k=TOP_K)
    )
    obj = objectives.Matryoshka(n_prefixes=N_PREFIXES)
    step = train.make_train_step(cfg, obj, n_steps=6000, optim="adam", aux_enabled=False)
    rng = np.random.default_rng(SEED)
    xs = [torch.from_numpy(rng.normal(size=(B, D_MODEL)).astype(np.float32)).to("cuda") for _ in range(2)]
    fns = wrappers()
    results = {}
    for fn in fns.values():
        fn.launches = 0
    for n_sae, n_steps in ((1, 5), (2, 2)):
        ts = train.init_sweep_state(cfg, n_sae, _gen(), "cuda")
        prefixes = torch.from_numpy(
            np.stack([objectives.sample_prefixes(D_SAE, N_PREFIXES, rng=rng) for _ in range(n_sae)])
        ).to("cuda")
        hp = _hp(n_sae, "cuda")
        before = {k: fn.launches for k, fn in fns.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(n_steps):
            t0 = time.perf_counter()
            ts, stats = step(ts, xs[i % 2], prefixes, hp)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            for key, v in stats.items():
                require(bool(torch.isfinite(v.float()).all()), f"slice: stat {key} not finite: {v}")
            l0 = stats["l0"].tolist()
            # Threshold TopK keeps ties, so an exact f32 tie at a row's k-th
            # value adds 1/B to the mean; allow at most a few such rows.
            require(all(TOP_K <= v <= TOP_K + 4 / B for v in l0), f"slice: mean L0 {l0} is not {TOP_K}")
        for key, v in ts.params.items():
            require(bool(torch.isfinite(v).all()), f"slice: param {key} not finite")
        for k, fn in fns.items():
            rose = fn.launches - before[k]
            require(rose == n_sae * n_steps, f"slice: {k} launched {rose} times, expected {n_sae * n_steps}")
        ms = 1e3 * statistics.median(times[1:] if len(times) > 2 else times)
        peak = torch.cuda.max_memory_allocated() / 2**30
        results[n_sae] = {"ms": ms, "peak_gib": peak}
        log(f"slice n_sae={n_sae}: {n_steps} steps, median {ms:.2f} ms/step "
            f"({B / (ms / 1e3):.1f} patches/s), step times ms {[round(t * 1e3, 2) for t in times]}, "
            f"peak {peak:.2f} GiB, last mse {stats['mse'].tolist()}, l0 {stats['l0'].tolist()}, "
            f"launches {[fn.launches - before[k] for k, fn in fns.items()]}")
        del ts, stats
        torch.cuda.empty_cache()
    return {k: fn.launches for k, fn in fns.items()}, results


def _time(fn, n: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def phase_timing() -> dict:
    from saev_tpu_torch.ops import cuda_matryoshka as cm
    from saev_tpu_torch.ops import cuda_topk, topk

    out = {}
    h = torch.randn((B, D_SAE), generator=_gen(), device="cuda")
    out["topk_stats"] = (_time(lambda: cuda_topk.topk_stats_cuda(h, TOP_K), 10),
                         _time(lambda: topk._topk_stats_plain(h, TOP_K), 3))
    del h
    f, w, x, b_dec, cut_sets = _matryoshka_inputs()
    m, r = _cuts(cut_sets["sampled"])
    iu = (1.0 / x.abs().max()).reshape(1)
    scale = torch.full((1,), 2.0 / (B * N_PREFIXES * D_MODEL), device="cuda")
    e, _, _ = cm.grouped_prefix_err(f, w, x, b_dec, iu, m, r, group_size=GROUP)
    _, da = cm.grouped_matmul_dgrad(w, e, m, r, scale, group_size=GROUP, df_dtype=torch.bfloat16)
    out["grouped_prefix_err"] = (
        _time(lambda: cm.grouped_prefix_err(f, w, x, b_dec, iu, m, r, group_size=GROUP), 10),
        _time(lambda: cm.grouped_prefix_err_plain(f, w, x, b_dec, iu, m, r, group_size=GROUP), 2))
    out["grouped_matmul_dgrad"] = (
        _time(lambda: cm.grouped_matmul_dgrad(w, e, m, r, scale, group_size=GROUP,
                                              df_dtype=torch.bfloat16), 10),
        _time(lambda: cm.grouped_matmul_dgrad_plain(w, e, m, r, scale, group_size=GROUP,
                                                    df_dtype=torch.bfloat16), 2))
    out["grouped_matmul_wgrad"] = (
        _time(lambda: cm.grouped_matmul_wgrad(f, da, e, m, r, scale, group_size=GROUP), 10),
        _time(lambda: cm.grouped_matmul_wgrad_plain(f, da, e, m, r, scale, group_size=GROUP), 2))
    for k, (ms, plain_ms) in out.items():
        log(f"timing {k}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (cuts {cut_sets['sampled'].tolist()})")
    return out


def main() -> int:
    name = phase_device()
    phase_build()
    errs = phase_parity()
    phase_reference()
    launches, _ = phase_slice()
    times = phase_timing()
    kernels = [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], "max_abs_err": errs[k],
         "ms": times[k][0], "plain_ms": times[k][1]}
        for k, (src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
