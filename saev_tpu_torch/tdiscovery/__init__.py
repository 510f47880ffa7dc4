"""Trait discovery on PyTorch tensors (counterpart of contrib/trait_discovery/
src/tdiscovery): sparse 1-D logistic probes for every (latent, class) pair
(`probe1d`), dictionary baselines (`baselines`: k-means, semi-NMF, PCA,
random directions), the SAE scorer (`saes`), average precision and purity
(`metrics`) and the FishVista evaluation (`fishvista`); and the host-side
analysis of a run's inference artifacts: image-level heads and their
grounding audit (`classification`), the Heliconius metadata dataset
(`datasets`), the probe-results and audit frames (`analysis`,
`audit_analysis`), top-image galleries and their browser (`visuals`,
`browse`) and the classification-results view (`clsview`); and the study
modules over many runs: run tables and pareto fronts (`runs`), FishVista
result tables (`results`), probe telemetry (`logparse`), FishBase trait x
body-part scores (`fishbase`), mimic-pair harvests (`mimicry`), the paper's
figure and table battery (`figplots`) and variant ablations (`ablations`),
with the data-prep scripts under `scripts/`.

    python -m saev_tpu_torch.tdiscovery {probe1d,baseline::train,baseline::inference,metrics,cls::train,cls::eval,cls::audit,visuals} ...

The device work (the probe's Levenberg-Marquardt iterations over CSR events,
the k-means step, the semi-NMF encode, the SAE forward with kernel K6) runs
on the card unless the caller passes `device="cpu"` (`--device cpu`). The
analysis modules are numpy on the host, as in contrib; scikit-learn,
matplotlib, pandas and Pillow are imported where used, and a missing one
raises an ImportError that names it."""

import torch


def device_of(name: str) -> torch.device:
    """`name` as a torch device; raises where it names the card and torch
    sees none, so nothing falls back to the CPU unasked."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f'trait discovery runs on device "{name}" and torch sees no CUDA device; '
            'pass device="cpu" (--device cpu) to run it on the CPU'
        )
    return device
