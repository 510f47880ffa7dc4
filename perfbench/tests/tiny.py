"""Cells of the benchmark cut to a size a CPU test holds: the same files, the
same drivers and reference, widths and batch shrunk."""

import dataclasses

from perfbench.lib import spec

TINY = dict(d_model=32, d_sae=256, k_aux=16, batch_size=64, n_prefixes=4, dead_threshold_tokens=640,
            log_every=2, n_train=64 * 100)


def cell(name: str, fault: str | None = None) -> spec.Cell:
    c = spec.load_cell(name)
    cfg = dict(c.config, **TINY)
    cfg["assumed"] = dict(cfg["assumed"], activations={"rank": 64, "active": 4, "signal": 1.0, "noise": 0.1})
    tr = dict(c.traffic)
    if tr["driver"] == "train_loop":
        # aux_from_step at batch 64 and 640 dead tokens: ceil(640 / 64) - 1.
        tr.update(start_step=9, top_ks=[min(k, 16) for k in tr["top_ks"]])
    else:
        tr.update(top_k=8, batch_size=64, profiled_batches=2)
    if fault:
        tr["fault"] = fault
    return dataclasses.replace(c, config=cfg, traffic=tr)
