"""Interactive interpretability on PyTorch tensors (counterpart of
contrib/interactive_interp): linear patch-segmentation probes and latent
interventions (`semseg`), latents scored as binary concept detectors
(`semprobe`), the [CLS] probe grid (`classification`) and the paper's figure
assets (`scripts.make_figures`).

    python -m saev_tpu_torch.interactive_interp.semseg {train,visuals,validate,quantify,interactive} ...
    python -m saev_tpu_torch.interactive_interp.semprobe.scoring {score,negatives} ...
    python -m saev_tpu_torch.interactive_interp.classification {train,flowers,cub,caltech101} ...

The device work (the probes' AdamW steps, the SAE encodes with kernel K6,
the one-hot count products, the intervention counts) runs on the card unless
the caller passes `device="cpu"` (`--device cpu`)."""

import torch


def device_of(name: str) -> torch.device:
    """`name` as a torch device; raises where it names the card and torch
    sees none, so nothing falls back to the CPU unasked."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f'interactive_interp runs on device "{name}" and torch sees no CUDA device; '
            'pass device="cpu" (--device cpu) to run it on the CPU'
        )
    return device
