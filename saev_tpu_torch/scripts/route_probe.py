"""Device time of K2, K7 and the wide route of K1, K5 and K6 in one tree of this repository,
with their outputs' sha256 and K2's and K7's registers and spills, to set two
trees side by side on one card.

    python saev_tpu_torch/scripts/route_probe.py [ROOT] [--step]

Imports `saev_tpu_torch` from ROOT (default: the checkout that holds this
file), builds its kernels and prints, by `kprof.device_profile`:
- K2 (`grouped_prefix_err`) and K7 (`grouped_prefix_base`, f32 base) on
  `proto_gouter.inputs()` (B = S = 16384, D = 1024), at the 10 cuts
  `sample_prefixes(16384, 10)` gives with seed 0 (five in the first 16
  lanes) and at the script's own 10 cuts;
- K1 (`topk_stats_cuda`) and K6 (`kth_value_cuda`) at k 32 and K5
  (`kth_value_masked_cuda`, k 512) at 16384 x 65536, where they take the
  wide route (csrc/kth_wide.cu), on Gaussian rows; K1 and K6 also at 16384
  x 131072; K5 under 5% of the columns unmasked, as a prefix and
  scattered, 40% and 60% scattered (the dense AuxK step at 40% and 60%
  dead) and none masked, and at x 131072 under 40% scattered, 40% as a
  prefix and none masked, each beside its bounds: the unmasked columns'
  bytes, and the 32-byte sectors that hold one (what a gather of them
  reads).
With --step it times instead the d_sae 131072 dense train step (d_model
1024, TopK 32, AuxK 512, Matryoshka 10, Adam) from a state with 30% of the
latents pinned dead as bench.py pins them, so its AuxK select (K5) takes
39321 unmasked columns, by chip_smoke.py's `time_huge_dense_step` (the
chip_smoke.py beside this script's package, whatever ROOT is): 3 steps at
batch 16384, the median of the last two (host clock, each step ending in a
synchronize), each step's launches checked.
Run it once with each tree's root in one call, in the order parent, change,
change, parent; equal sha256 mean equal bits (K1's also without L1, which
each route sums in its own fixed order).
"""

import pathlib
import sys

import numpy as np

TOP_K, K_AUX, WIDE_S = 32, 512, 65536
HBM_BYTES_S = 3.35e12  # the H100 SXM's memory rate at 700 W


def dense_step() -> None:
    """The d_sae 131072 dense step of the tree on sys.path, timed by
    `time_huge_dense_step` of the chip_smoke.py beside this script's
    package (see --step)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", pathlib.Path(__file__).resolve().parents[2]
                                                  / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.time_huge_dense_step()


def main(argv: list[str]) -> None:
    step = "--step" in argv
    argv = [a for a in argv if a != "--step"]
    root = pathlib.Path(argv[0] if argv else pathlib.Path(__file__).resolve().parents[2]).resolve()
    sys.path.insert(0, str(root))
    import torch

    import saev_tpu_torch
    from saev_tpu_torch.nn import objectives
    from saev_tpu_torch.ops import _build, cuda_kth, cuda_topk
    from saev_tpu_torch.ops import cuda_matryoshka as cm
    from saev_tpu_torch.scripts import digests, kprof, proto_gouter

    where = pathlib.Path(saev_tpu_torch.__file__).resolve()
    if root not in where.parents:
        raise SystemExit(f"saev_tpu_torch came from {where}, not from {root}")
    print(f"route_probe of {root}: {kprof.card()}")
    _build.lib()
    if step:
        dense_step()
        return
    for name, r in _build.ptxas_resources(_build.ptxas_log().read_text(), "prefix_wgmma_kernel").items():
        print(f"ptxas {name[-60:]}: {r}")

    g = proto_gouter.inputs()
    sampled = objectives.sample_prefixes(proto_gouter.S, proto_gouter.J, rng=np.random.default_rng(0))
    cut_sets = {"sampled": (torch.from_numpy(sampled // proto_gouter.G).to("cuda", torch.int32),
                            torch.from_numpy(sampled % proto_gouter.G).to("cuda", torch.int32)),
                "proto_gouter": (g["m"], g["r"])}
    for what, (m, r) in cut_sets.items():
        k2 = lambda: cm.grouped_prefix_err(g["f"], g["w"], g["x"], g["b_dec"], g["inv_upper"], m, r,  # noqa: E731
                                           group_size=proto_gouter.G)
        k7 = lambda: cm.grouped_prefix_base(g["f"], g["w"], m, r, group_size=proto_gouter.G)  # noqa: E731
        for name, fn in (("K2", k2), ("K7", k7)):
            rows = kprof.device_profile(fn, n=20, warmup=3, expect=("prefix_wgmma_kernel",))
            print(f"{name} {what} cuts: {kprof.total_device_ms(rows):.4f} ms device per call, "
                  f"sha256 {digests.output_digest(*fn())}")
    del g
    torch.cuda.empty_cache()

    # The tree's K1 kernel on the wide route: the cluster route's, or the
    # walk's in a tree from before it.
    wide_src = (root / "saev_tpu_torch" / "csrc" / "kth_wide.cu").read_text()
    k1_kernel = "wide_cluster_kernel" if "wide_cluster_kernel" in wide_src else "wide_row_kernel"
    gen = torch.Generator(device="cuda").manual_seed(0)

    def timed(what: str, fn, kernel: str, note: str = "") -> None:
        rows = kprof.device_profile(fn, n=20, warmup=3, expect=(kernel,))
        out = fn()
        line = f"{what}: {kprof.total_device_ms(rows):.4f} ms device per call, sha256 {digests.output_digest(*out)}"
        if len(out) == 5:  # K1: also without L1, whose order of summation a route sets
            line += f", without L1 {digests.output_digest(*out[:4])}"
        print(line + note, flush=True)

    def k5_masks(s: int, prefix: tuple, scattered: tuple) -> dict:
        cols = torch.arange(s, device="cuda")
        masks = {f"{int(s * frac)} unmasked, prefix": cols < int(s * frac) for frac in prefix}
        for frac in scattered:
            n = int(s * frac)
            masks[f"{n} unmasked, scattered"] = torch.zeros(s, dtype=torch.bool, device="cuda")
            masks[f"{n} unmasked, scattered"][torch.randperm(s, generator=gen, device="cuda")[:n]] = True
        masks["none masked"] = cols >= 0
        return masks

    def timed_k5(h: torch.Tensor, masks: dict) -> None:
        b, s = h.shape
        for what, mask in masks.items():
            sectors = int(torch.nn.functional.pad(mask, (0, -s % 8)).view(-1, 8).any(1).sum())
            bounds = (f"; bound {b * int(mask.sum()) * 4 / HBM_BYTES_S * 1e3:.3f} ms (unmasked bytes), "
                      f"{b * sectors * 32 / HBM_BYTES_S * 1e3:.3f} ms (sectors)")
            timed(f"K5 {b}x{s} k {K_AUX}, {what}", lambda: (cuda_kth.kth_value_masked_cuda(h, mask, K_AUX),),
                  "compact_mask_kernel", bounds)

    h = torch.randn((16384, WIDE_S), generator=gen, device="cuda")
    timed(f"K1 16384x{WIDE_S} k {TOP_K}", lambda: cuda_topk.topk_stats_cuda(h, TOP_K), k1_kernel)
    timed(f"K6 16384x{WIDE_S} k {TOP_K}", lambda: (cuda_kth.kth_value_cuda(h, TOP_K),), "wide_")
    timed_k5(h, k5_masks(WIDE_S, (0.05,), (0.05, 0.4, 0.6)))
    del h
    torch.cuda.empty_cache()
    h = torch.randn((16384, 2 * WIDE_S), generator=gen, device="cuda")
    timed(f"K1 16384x{2 * WIDE_S} k {TOP_K}", lambda: cuda_topk.topk_stats_cuda(h, TOP_K), k1_kernel)
    timed(f"K6 16384x{2 * WIDE_S} k {TOP_K}", lambda: (cuda_kth.kth_value_cuda(h, TOP_K),), "wide_")
    timed_k5(h, k5_masks(2 * WIDE_S, (0.4,), (0.4,)))


if __name__ == "__main__":
    main(sys.argv[1:])
