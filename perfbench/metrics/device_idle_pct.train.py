"""The share of the traced window in which no operation ran on the device
(torch.profiler: the union of kernels, copies and fills)."""

from perfbench.lib import layers


def read(run):
    return layers.idle_pct(run)
