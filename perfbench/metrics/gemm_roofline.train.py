"""The products' share of their roofline in the traced steps: each recorded
matmul call's least time (its shapes and precision, sparse operands counted
by their nonzeros) over its kernels' device time, summed (bf16 against 989
TFLOP/s, the log step's f32 against 67)."""

from perfbench.lib import layers


def read(run):
    return layers.gemm_share_pct(run)
