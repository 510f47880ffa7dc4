"""The ViT model zoo on torch (the counterpart of saev_tpu/models).

Each family module defines (a) a `vit.Spec` describing the architecture, (b) a
weight converter from that family's torch checkpoint layout into the shared
params tree, and (c) a `data.models.Transformer` wrapper registered in the
family registry. The compute engine is `saev_tpu_torch.models.vit`: one
forward with residual-stream taps (the reference uses torch forward hooks,
reference src/saev/data/shards.py:189-301).
"""
