"""Kernel-level bench entry points of the port, each run as
`python -m saev_tpu_torch.scripts.<name>` on a CUDA card: `kprof`,
`proto_gouter`, `proto_encode_stats` and `microbench_kth`; and `vit_route`,
the extraction engine's bf16 route against its float32 forward. Also
`gradcam`, `export_demo` and `activations`, the TOML sweep launcher for
extraction."""
