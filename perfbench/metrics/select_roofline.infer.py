"""K6's share of its roofline: the TopK threshold over each batch's h (read
once) over the device time of the port's selection kernels in the traced
batches. Silent where none ran."""

from perfbench.lib import layers


def read(run):
    n = layers.per_unit(run)
    if run.trace is None or not n:
        return None
    spent = layers.layer_s(run, "select")
    return 100.0 * n * run.model_s["batch_select"] / spent if spent else None
