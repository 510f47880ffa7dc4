"""Device ms a step in kernels that are neither the port's CUDA kernels nor
launched by a matmul call: the objective's, AuxK's and the optimizer's
elementwise passes, casts and reductions (torch.profiler, the traced steps,
log steps included)."""

from perfbench.lib import layers


def read(run):
    n = layers.per_unit(run)
    if run.trace is None or not n:
        return None
    return 1e3 * layers.elementwise_s(run) / n
