"""Mimicry discrimination: which SAE latents tell co-mimic subspecies pairs
apart (counterpart of contrib/mimics/src/mimics and contrib/mimics/launch.py).
Per-latent AUROC over max-pooled image features (`scoring`), cross-run
feature consistency (`consistency`), pair-task definitions over
subspecies_view labels (`tasks`), classifier-checkpoint discovery and
feature pooling (`checkpoints`), the width-sweep study (`analysis`),
top-activation strips per feature (`render`) and self-contained HTML
browsers (`viewer`).

    python -m saev_tpu_torch.mimics {score,render,consistency,viewer,scores} ...

Host-only numpy on a run's inference artifacts (`token_acts.npz`), as in
contrib; pandas, matplotlib and Pillow are imported where used.
"""
