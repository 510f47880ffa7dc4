"""The selects' share of their roofline: K1's TopK over h and K5's AuxK
threshold over the dead columns for every SAE and traced step, and K6's
threshold in the log step (lib/work.py), over the device time of the port's
selection kernels. Silent where none ran."""

from perfbench.lib import layers


def read(run):
    n = layers.per_unit(run)
    if run.trace is None or not n:
        return None
    spent = layers.layer_s(run, "select")
    least = n * run.model_s["step_select"] + run.counts["profiled_logs"] * run.model_s["log_select"]
    return 100.0 * least / spent if spent else None
