"""Device time of K2, K7 and K5's wide route in one tree of this repository,
with their outputs' sha256 and K2's and K7's registers and spills, to set two
trees side by side on one card.

    python saev_tpu_torch/scripts/route_probe.py [ROOT]

Imports `saev_tpu_torch` from ROOT (default: the checkout that holds this
file), builds its kernels and prints, by `kprof.device_profile`:
- K2 (`grouped_prefix_err`) and K7 (`grouped_prefix_base`, f32 base) on
  `proto_gouter.inputs()` (B = S = 16384, D = 1024), at the 10 cuts
  `sample_prefixes(16384, 10)` gives with seed 0 (five in the first 16
  lanes) and at the script's own 10 cuts;
- K1 (`topk_stats_cuda`) and K6 (`kth_value_cuda`) at k 32 and K5
  (`kth_value_masked_cuda`, k 512) at 16384 x 65536, where they take the
  wide route, on Gaussian rows; K5 under 5% of the columns unmasked, as a
  prefix and scattered.
Run it once with each tree's root in one call, in the order parent, change,
change, parent; equal sha256 mean equal bits.
"""

import pathlib
import sys

import numpy as np

TOP_K, K_AUX, WIDE_S = 32, 512, 65536


def main(argv: list[str]) -> None:
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

    gen = torch.Generator(device="cuda").manual_seed(0)
    h = torch.randn((16384, WIDE_S), generator=gen, device="cuda")
    for name, fn in (("K1", lambda: cuda_topk.topk_stats_cuda(h, TOP_K)),
                     ("K6", lambda: (cuda_kth.kth_value_cuda(h, TOP_K),))):
        rows = kprof.device_profile(fn, n=20, warmup=3, expect=("wide_row_kernel",))
        print(f"{name} 16384x{WIDE_S} k {TOP_K}: {kprof.total_device_ms(rows):.4f} ms device per call, "
              f"sha256 {digests.output_digest(*fn())}")
    n_live = int(WIDE_S * 0.05)
    masks = {"prefix": torch.arange(WIDE_S, device="cuda") < n_live,
             "scattered": torch.zeros(WIDE_S, dtype=torch.bool, device="cuda")}
    masks["scattered"][torch.randperm(WIDE_S, generator=gen, device="cuda")[:n_live]] = True
    for what, mask in masks.items():
        fn = lambda: cuda_kth.kth_value_masked_cuda(h, mask, K_AUX)  # noqa: E731
        rows = kprof.device_profile(fn, n=20, warmup=3, expect=("wide_row_kernel",))
        print(f"K5 16384x{WIDE_S} k {K_AUX}, {n_live} unmasked ({what}): {kprof.total_device_ms(rows):.4f} ms "
              f"device per call, sha256 {digests.output_digest(fn())}")


if __name__ == "__main__":
    main(sys.argv[1:])
