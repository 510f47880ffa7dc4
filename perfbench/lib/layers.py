"""Readings shared by the per-layer metrics' readers: device time by layer
from the trace, and the least times of the window's work."""

from . import trace as tracing, work


def per_unit(run) -> int | None:
    """Steps (train) or batches (inference) in the traced window."""
    return run.counts.get("profiled_steps") or run.counts.get("profiled_batches")


def layer_s(run, layer: str) -> float:
    ports = tracing.port_kernels()
    return run.trace.kernel_s(lambda name: tracing.kernel_layer(name, ports) == layer)


def elementwise_s(run) -> float:
    """Device seconds in kernels that are neither the port's nor launched by
    a matmul call."""
    ports = tracing.port_kernels()
    gemm = run.trace.matmul_kernels
    return run.trace.kernel_s(lambda name: tracing.kernel_layer(name, ports) is None and name not in gemm)


def gemm_share_pct(run) -> float | None:
    """The matmul calls' least time over their kernels' device time, in %."""
    if run.trace is None:
        return None
    c = run.counts
    bound = spent = 0.0
    for name, shapes, dtypes, seconds, t, kernels in run.trace.matmuls:
        span = run.trace.enclosing(t, "perfbench.cohort")
        k = c["k_by_span"][span] if span in c.get("k_by_span", {}) else c["k"]
        density = work.latent_density(c["d_sae"], c["d_model"], k, c.get("k_aux"))
        least = work.product_bound_s(name, shapes, dtypes, c["batch"], density, kernels)
        if least is None or seconds <= 0:
            continue
        bound += least
        spent += seconds
    return 100.0 * bound / spent if spent else None


def idle_pct(run) -> float | None:
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
