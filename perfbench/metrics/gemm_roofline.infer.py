"""The products' share of their roofline in the traced batches: each
recorded matmul call's least time (its shapes and precision, the decode's
latents counted by their nonzeros) over its kernels' device time, summed
(f32 at "highest" against 67 TFLOP/s)."""

from perfbench.lib import layers


def read(run):
    return layers.gemm_share_pct(run)
