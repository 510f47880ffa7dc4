"""Kernel-level bench entry points of the port, each run as
`python -m saev_tpu_torch.scripts.<name>` on a CUDA card: `kprof`,
`proto_gouter`, `proto_encode_stats` and `microbench_kth`."""
