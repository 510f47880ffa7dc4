"""Learning-rate schedule of the train step (counterpart of
saev_tpu/utils/scheduling.py `warmup_cosine`)."""

import math

import torch


def warmup_cosine(step, init, n_warmup, peak, n_steps, final) -> torch.Tensor:
    """WarmupCosine as a tensor function of the step counter.

    `warmup_cosine(t, ...)` is the learning rate after t scheduler steps, so
    t = 0 gives `init` (lr = 0 at the first step when init is 0). `n_warmup`,
    `peak` and the other knobs may be per-SAE tensors; the result broadcasts
    over them. Computed in float32.
    """
    tensors = [v for v in (step, init, n_warmup, peak, n_steps, final)
               if isinstance(v, torch.Tensor)]
    device = tensors[0].device if tensors else None

    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32, device=device)

    step, n_warmup, n_steps = f32(step), f32(n_warmup), f32(n_steps)
    init, peak, final = f32(init), f32(peak), f32(final)
    warm = init + (peak - init) * (step / torch.clamp(n_warmup, min=1.0))
    progress = (step - n_warmup) / torch.clamp(n_steps - n_warmup, min=1.0)
    cosine = final + (peak - final) * (1 + torch.cos(math.pi * progress)) / 2
    return torch.where(step < n_warmup, warm, torch.where(step < n_steps, cosine, final))
