"""The readings that a cell's correctness limits are set from, on the card at
the cell's own size (not run by the benchmark's runs):

    python3 perfbench/calibrate.py --workload NAME --seeds 12 --control-seeds 3 [--out FILE]

- lower: the program's numbers on each of `--seeds` seeds, through the
  cell's driver with a short window (the checks compare what its set-up and
  window produced);
- control: the reference put in the program's place at the precision below
  the configuration's (fp8 for the train step's bf16 "default", TF32 for
  inference's f32 "highest"), against the f32 reference, on
  `--control-seeds` seeds;
- faults: the program with a fault planted under the window's call (train:
  half the batch left out; inference: half the batch left out of the sums,
  one answer altered a batch), on the same seeds. A state returned unchanged
  reads 1 by the gradient's and the change's measure and needs no run.

Prints one JSON object of every reading; `--out` writes it to a file too.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import run as bench  # noqa: E402
from perfbench.lib import data, spec  # noqa: E402

FAULTS = {"train_loop": ("half_batch",), "infer_loop": ("half_batch", "altered")}


def program(cell, seed: int, device: str, seconds: float, fault=None) -> dict:
    if fault:
        cell = dataclasses.replace(cell, traffic={**cell.traffic, "fault": fault})
    line, _ = bench.execute(cell, seed, seconds, False, device, time.perf_counter())
    return {name: c["value"] for name, c in line["checks"].items()}


def control(cell, seed: int, device: str) -> dict:
    import torch

    drv = spec.driver(cell.traffic["driver"])
    dev = torch.device(device)
    cfg, tr = cell.config, cell.traffic
    if cell.traffic["driver"] == "train_loop":
        f32 = drv.reference_readings(cfg, tr, seed, dev, "f32")
        low = drv.reference_readings(cfg, tr, seed, dev, "fp8")
        return drv.compare(low, f32)
    return drv.compare(cfg, tr, seed, dev, *control_outputs(drv, cfg, tr, seed, dev, "tf32"))


def control_outputs(drv, cfg, tr, seed, dev, mode):
    """What the reference at `mode` gives in the program's place: for each
    ring slot its whole batch of CSR rows, the rows the window would keep,
    and the batch's sums."""
    import numpy as np
    import torch

    from perfbench.reference import sae as ref

    params = drv.init_params(cfg, seed, dev)
    ring = data.batches(cfg["assumed"]["activations"], cfg["d_model"], tr["batch_size"], tr["ring"], seed, dev)
    rng = data.numpy_rng(seed, 2000)
    k = tr["top_k"]
    last, kept_rows, kept_stats = {}, [], []
    for slot, x in enumerate(ring):
        counts, cols, vals = [], [], []
        for start in range(0, x.shape[0], 4096):
            h, kth = ref.infer_rows(params, x[start:start + 4096], k, mode)
            keep = h >= kth
            counts.append(keep.sum(1).cpu().numpy())
            idx = torch.nonzero(keep)
            cols.append(idx[:, 1].to(torch.int32).cpu().numpy())
            vals.append(h[keep].cpu().numpy())
        counts, cols, vals = np.concatenate(counts), np.concatenate(cols), np.concatenate(vals)
        last[slot] = (counts, cols, vals)
        ptr = np.concatenate([[0], np.cumsum(counts)])
        rows = np.sort(rng.choice(x.shape[0], size=tr["sample_rows"], replace=False))
        kept_rows.append((slot, rows, [(cols[ptr[r]:ptr[r + 1]], vals[ptr[r]:ptr[r + 1]]) for r in rows]))
        st = ref.infer_stats(params, x, k, mode)
        kept_stats.append((slot, {key: (v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v))
                                  for key, v in st.items()}))
    return kept_rows, kept_stats, last


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--first-seed", type=int, default=3_000_000_000)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    args = p.parse_args()
    cell = spec.load_cell(args.workload)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    out = {"cell": cell.name, "seeds": seeds, "lower": [], "control": [], "faults": {}}
    for seed in seeds:
        out["lower"].append(program(cell, seed, args.device, args.seconds))
        print(json.dumps({"seed": seed, "lower": out["lower"][-1]}), file=sys.stderr, flush=True)
    for seed in seeds[:args.control_seeds]:
        out["control"].append(control(cell, seed, args.device))
        print(json.dumps({"seed": seed, "control": out["control"][-1]}), file=sys.stderr, flush=True)
        for fault in FAULTS[cell.traffic["driver"]]:
            out["faults"].setdefault(fault, []).append(program(cell, seed, args.device, args.seconds, fault))
            print(json.dumps({"seed": seed, fault: out["faults"][fault][-1]}), file=sys.stderr, flush=True)
    names = out["lower"][0].keys()
    out["summary"] = {n: {"lower": max(r[n] for r in out["lower"]),
                          "control": min(r[n] for r in out["control"]) if out["control"] else None,
                          **{f: min(r[n] for r in rs) for f, rs in out["faults"].items()}} for n in names}
    out["seconds"] = time.perf_counter() - T0
    text = json.dumps(out)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
