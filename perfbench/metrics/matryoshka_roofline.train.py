"""K2-K4's share of their roofline: the Matryoshka reconstructions' and
their gradient's least time for every SAE and traced step (lib/work.py,
from the configuration's shapes) over the device time of the port's
kernels of `prefix_fwd.cu`, `dgrad.cu`, `wgrad.cu` and `matryoshka.cu`.
Silent where none ran."""

from perfbench.lib import layers


def read(run):
    n = layers.per_unit(run)
    if run.trace is None or not n:
        return None
    spent = layers.layer_s(run, "matryoshka")
    return 100.0 * n * run.model_s["step_matryoshka"] / spent if spent else None
