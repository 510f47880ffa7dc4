"""Inputs made from the seed: synthetic activations, datapoint-initialized
weights, the dead latents a cell pins, and the Matryoshka prefix cuts.

The activations copy the generator of `chip_smoke.py`'s job phase
(`_job_shards`): each row is a Gaussian combination of `active` of `rank`
random directions (`signal`, its rms a coordinate) plus isotropic Gaussian
noise (`noise`). They are made on the device in a few large calls. The same
seed gives the same bits, so the reference regenerates what the program was
handed instead of keeping a copy.
"""

import numpy as np
import torch


def generator(seed: int, device, salt: int = 0) -> torch.Generator:
    """A torch.Generator for one purpose of a run: seeds up to 2**63 and a
    salt apart per purpose."""
    return torch.Generator(device).manual_seed((int(seed) * 1_000_003 + salt) % (1 << 63))


def numpy_rng(seed: int, salt: int = 0) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), salt])


class Activations:
    """Rows of d_model f32 activations, `rows(n)` at a time, from one
    generator: a basis of `rank` directions, each row `active` of them with
    Gaussian codes, plus noise."""

    def __init__(self, spec: dict, d_model: int, seed: int, device):
        self.spec, self.d_model, self.device = spec, d_model, torch.device(device)
        self.gen = generator(seed, self.device, salt=1)
        self.basis = torch.randn((spec["rank"], d_model), generator=self.gen, device=self.device) * (
            spec["signal"] / spec["active"] ** 0.5)

    def rows(self, n: int, chunk: int = 16384) -> torch.Tensor:
        out = torch.empty((n, self.d_model), dtype=torch.float32, device=self.device)
        for start in range(0, n, chunk):
            m = min(chunk, n - start)
            codes = torch.randn((m, self.spec["active"]), generator=self.gen, device=self.device)
            idx = torch.randint(self.spec["rank"], (m, self.spec["active"]), generator=self.gen,
                                device=self.device)
            x = torch.einsum("na,nad->nd", codes, self.basis[idx])
            x += self.spec["noise"] * torch.randn((m, self.d_model), generator=self.gen, device=self.device)
            out[start:start + m] = x
        return out


def batches(spec: dict, d_model: int, batch: int, n: int, seed: int, device) -> list[torch.Tensor]:
    """`n` distinct batches of `batch` rows: the ring a cell cycles through."""
    acts = Activations(spec, d_model, seed, device)
    return [acts.rows(batch) for _ in range(n)]


def datapoint_init(cfg: dict, n_sae: int, seed: int, device, dead_share: float = 0.0,
                   dead_bias: float = 0.0) -> dict[str, torch.Tensor]:
    """Stacked (n_sae, ...) f32 params initialized as the configuration
    states (`reinit_blend`, `reinit_enc_dec_tranpose`, `normalize_w_dec`),
    as the port's `make_saes` does on the host, here on the device from the
    seed: W_dec's rows blend zero-centered activation rows (drawn apart from
    the cell's batches) with Kaiming-uniform noise, in a permutation of their
    own a SAE; rows normalized; W_enc = W_dec^T; zero biases. The first
    `dead_share` of each SAE's latents get b_enc = `dead_bias`: far enough
    below every live pre-activation that they never fire."""
    d_model, d_sae, blend = cfg["d_model"], cfg["d_sae"], cfg["reinit_blend"]
    device = torch.device(device)
    gen = generator(seed, device, salt=2)
    acts = Activations(cfg["assumed"]["activations"], d_model, seed + 7919, device).rows(d_sae)
    zero_centered = acts - acts.mean(dim=0, keepdim=True)
    bound = (6.0 / d_model) ** 0.5
    kaiming = torch.empty((d_sae, d_model), device=device).uniform_(-bound, bound, generator=gen)
    mixed = blend * zero_centered + (1 - blend) * kaiming
    del acts, zero_centered, kaiming
    w_dec = torch.empty((n_sae, d_sae, d_model), device=device)
    for i in range(n_sae):
        w_dec[i] = mixed[torch.randperm(d_sae, generator=gen, device=device)]
    del mixed
    if cfg["normalize_w_dec"]:
        w_dec /= torch.linalg.norm(w_dec, dim=-1, keepdim=True)
    b_enc = torch.zeros((n_sae, d_sae), device=device)
    b_enc[:, :n_dead(d_sae, dead_share)] = dead_bias
    return {
        "W_enc": w_dec.transpose(1, 2).contiguous(),
        "b_enc": b_enc,
        "W_dec": w_dec,
        "b_dec": torch.zeros((n_sae, d_model), device=device),
    }


def n_dead(d_sae: int, share: float) -> int:
    return int(d_sae * share)


def dead_counters(d_sae: int, n_sae: int, share: float, device) -> torch.Tensor:
    """(n_sae, d_sae) int32 tokens-since-active: the pinned dead latents at
    2**30 (the port's cap), every other at 0."""
    toks = torch.zeros((n_sae, d_sae), dtype=torch.int32, device=device)
    toks[:, :n_dead(d_sae, share)] = 1 << 30
    return toks


def sample_prefixes(d_sae: int, n_prefixes: int, rng: np.random.Generator, min_prefix_length: int = 1,
                    pareto_power: float = 0.5) -> np.ndarray:
    """Ascending Matryoshka prefix lengths ending in d_sae, favoring short
    prefixes (a copy of saev's `sample_prefixes`; the port's
    `objectives.sample_prefixes` draws the same for the same generator)."""
    if n_prefixes <= 1:
        return np.array([d_sae], dtype=np.int32)
    lengths = np.arange(1, d_sae)
    pareto_cdf = 1.0 - (min_prefix_length / lengths.astype(np.float64)) ** pareto_power
    pareto_pdf = np.concatenate([pareto_cdf[:1], np.diff(pareto_cdf)])
    p = pareto_pdf / pareto_pdf.sum()
    sampled = rng.choice(lengths.shape[0], size=n_prefixes - 1, replace=False, p=p)
    prefixes = np.concatenate([lengths[sampled], [d_sae]])
    prefixes.sort()
    return prefixes.astype(np.int32)
