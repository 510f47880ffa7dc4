"""The birdsong study on PyTorch tensors (counterpart of contrib/birdsong/src/
birdsong and contrib/birdsong/scripts): the channel trace of Bird-MAE's
residual stream (`trace`, on the card where the model's params are), and the
host-side analysis of a Bird-MAE run: activation statistics and the d_bad
hunt (`stats`), per-latent spectrograms and filtered clips (`visuals`), the
clip-gallery page (`make_html`) and its discovery over runs roots
(`browse`).

    python -m saev_tpu_torch.birdsong {visuals,make_html} ...
"""
