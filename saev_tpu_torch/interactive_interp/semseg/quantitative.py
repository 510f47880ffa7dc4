"""Quantitative latent-intervention evaluation for semantic segmentation.

Counterpart of contrib/interactive_interp/semseg/quantitative.py (reference
main :26, Report :83, eval_{rand_vec,rand_feat,auto_feat} :159-396,
get_latent_lookup :399): for each segmentation class, pick its most-associated
SAE latent (best F1 across activation thresholds), set that latent to a scaled
value, re-run the linear segmentation probe, and count how many target-class
patches change prediction vs how many OTHER patches change — the specificity
measure of the latent's causal role. Controls: a random latent per class, and
a random direction of matched magnitude.

As in the JAX package, activations stream from labeled shards and the probe
is per-patch linear, so interventions are evaluated one class at a time on
every patch (see `_count_fn`) and each class's modified logits are a rank-1
update of the original ones. On the card: the SAE encode at "highest" (TopK's
threshold by kernel K6), the one-hot count products, and the intervention
counts over chunks of classes at once. The JAX package encodes each batch
once a method; here each batch is encoded once and all methods count from
that encode (the counts do not change: the encode is the same).
"""

import csv
import dataclasses
import logging
import pathlib
import typing as tp

import numpy as np
import torch

from ... import helpers, nn
from ...data import OrderedConfig, OrderedDataLoader
from ...nn import modeling
from .. import device_of
from . import training

logger = logging.getLogger("semseg.quantitative")

THRESHOLDS = (0.0, 0.1, 0.3, 1.0)
# Elements of the (classes, batch, n_classes) logit update one chunk of
# classes holds: 2^26 f32 values, 256 MiB.
CHUNK_ELEMENTS = 1 << 26


@dataclasses.dataclass(frozen=True)
class Config:
    """Intervention-evaluation configuration (reference quantitative.py
    config): the JAX package's fields and defaults but for `device`."""

    sae_ckpt: pathlib.Path = pathlib.Path("./checkpoint/sae.pt")
    probe_ckpt: pathlib.Path = pathlib.Path("./checkpoints/semseg")
    acts: OrderedConfig = dataclasses.field(default_factory=OrderedConfig)
    """Labeled validation shards."""
    probe_i: int = 0
    """Which probe in the checkpoint grid to evaluate against."""
    n_classes: int = 151
    scale: float = -1.0
    """Intervention value = scale * latent's observed max (negative
    suppresses)."""
    methods: tuple[str, ...] = ("auto-feat", "rand-feat", "rand-vec")
    seed: int = 42
    dump_to: pathlib.Path = pathlib.Path("./results")
    device: tp.Literal["cuda", "cpu"] = "cuda"
    """Where the encodes and counts run: the card unless "cpu" is asked for."""


@dataclasses.dataclass(frozen=True)
class ClassResults:
    """Per-class intervention outcome (reference quantitative.py:56-79)."""

    class_id: int
    n_orig_patches: int
    n_changed_patches: int
    n_other_patches: int
    n_other_changed: int


@dataclasses.dataclass(frozen=True)
class Report:
    """One method's results (reference quantitative.py:83-136)."""

    method: str
    class_results: list[ClassResults]
    intervention_scale: float

    @property
    def mean_target_change(self) -> float:
        total = sum(r.n_orig_patches for r in self.class_results)
        changed = sum(r.n_changed_patches for r in self.class_results)
        return changed / total if total else 0.0

    @property
    def mean_other_change(self) -> float:
        total = sum(r.n_other_patches for r in self.class_results)
        changed = sum(r.n_other_changed for r in self.class_results)
        return changed / total if total else 0.0

    @property
    def target_change_std(self) -> float:
        """Std of the per-class target-change fraction — separates a method
        that disrupts every class a little from one that nukes a few
        (reference quantitative.py:110-125)."""
        per_class = np.array([
            r.n_changed_patches / r.n_orig_patches if r.n_orig_patches else 0.0
            for r in self.class_results
        ])
        return float(np.std(per_class))

    @property
    def other_change_std(self) -> float:
        per_class = np.array([
            r.n_other_changed / r.n_other_patches if r.n_other_patches else 0.0
            for r in self.class_results
        ])
        return float(np.std(per_class))

    def to_csv_row(self) -> dict[str, float | str]:
        return {
            "method": self.method,
            "target_change": self.mean_target_change,
            "other_change": self.mean_other_change,
            "target_std": self.target_change_std,
            "other_std": self.other_change_std,
            "scale": self.intervention_scale,
        }


def encode_f(sae_cfg, params, state, x: torch.Tensor) -> torch.Tensor:
    """f_x of the eval-mode forward at "highest" (f32, TF32 off; TopK's
    threshold by kernel K6 on the card)."""
    return modeling.encode(sae_cfg, params, state, x, training=False, precision="highest")[0].f_x


def batch_acts(batch, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(batch["act"], np.float32)).to(device)


@torch.no_grad()
def latent_class_stats(
    sae_cfg, params, state, acts_cfg: OrderedConfig, *, n_classes: int,
    thresholds: tuple[float, ...] = THRESHOLDS,
) -> tuple[np.ndarray, np.ndarray]:
    """(f1 (C, T, S), top_values (S,)): per-class/threshold latent F1 and the
    per-latent max activation, in one ordered pass (reference
    get_latent_lookup :399-540, without the live ViT), on the device of
    `params`.

    Each threshold's firing mask is built alone (bf16 0/1 values) and summed
    a class by a one-hot product with f32 results: exact below 2^24 patches a
    batch. The counts add up across batches as int64, so f1 is the JAX
    package's wherever its f32 sums are exact."""
    device = params["W_enc"].device
    d_sae = sae_cfg.d_sae
    t = len(thresholds)
    tp_cts = torch.zeros((n_classes, t, d_sae), dtype=torch.int64, device=device)
    fired_cts = torch.zeros((t, d_sae), dtype=torch.int64, device=device)
    class_cts = torch.zeros((n_classes,), dtype=torch.int64, device=device)
    top = torch.zeros((d_sae,), dtype=torch.float32, device=device)
    dl = OrderedDataLoader(acts_cfg)
    try:
        for batch in helpers.progress(dl, desc="latent lookup"):
            assert "token_labels" in batch, (
                f"{acts_cfg.shards} has no labels.bin; quantitative eval needs "
                "per-patch labels."
            )
            f_x = encode_f(sae_cfg, params, state, batch_acts(batch, device))
            labels = torch.from_numpy(batch["token_labels"].astype(np.int64)).to(device)
            # (B, C); a label past n_classes gets a row of zeros, as jax.nn.one_hot gives it.
            onehot = (labels[:, None] == torch.arange(n_classes, device=device)).to(torch.bfloat16)
            for ti, thr in enumerate(thresholds):
                fired = f_x > thr  # (B, S)
                tp_cts[:, ti] += modeling._mm_bf16(onehot.T, fired.to(torch.bfloat16)).to(torch.int64)
                fired_cts[ti] += fired.sum(dim=0)
                del fired  # the next threshold's mask is made before this one would be freed
            class_cts += torch.bincount(labels, minlength=n_classes)[:n_classes]
            top = torch.maximum(top, f_x.max(dim=0).values)
    finally:
        dl.shutdown()
    tp_np = tp_cts.cpu().numpy()
    fp_np = fired_cts.cpu().numpy()[None] - tp_np
    fn_np = class_cts.cpu().numpy()[:, None, None] - tp_np
    tp_cts, fp_cts, fn_cts = (a.astype(np.float32) for a in (tp_np, fp_np, fn_np))
    f1 = 2 * tp_cts / np.maximum(2 * tp_cts + fp_cts + fn_cts, 1.0)
    return f1, top.cpu().numpy()


def get_latent_lookup(f1_cts: np.ndarray) -> np.ndarray:
    """Best latent per class: max F1 over thresholds (background class 0 maps
    to latent -1, never intervened)."""
    best = f1_cts.max(axis=1).argmax(axis=1)  # (C,)
    best[0] = -1
    return best.astype(np.int64)


class _Encoded(tp.NamedTuple):
    f: torch.Tensor  # (B, S)
    orig_logits: torch.Tensor  # (B, K)
    orig_pred: torch.Tensor  # (B,)


class _Counter:
    """Per-class intervention counts for one probe (see `_count_fn`):
    `encode(x)` once a batch, then `counts(enc, lookup, top_values,
    rand_dir)` for each method; calling it does both."""

    def __init__(self, sae_cfg, params, state, probe_w, probe_b, scale, n_classes):
        self.sae_cfg, self.params, self.state = sae_cfg, params, state
        self.device = params["W_enc"].device
        self.w = torch.as_tensor(np.asarray(probe_w, np.float32)).to(self.device)  # (D, K)
        self.b = torch.as_tensor(np.asarray(probe_b, np.float32)).to(self.device)  # (K,)
        self.w_dec = params["W_dec"]
        self.scale = scale
        self.n_classes = n_classes

    @torch.no_grad()
    def encode(self, x: np.ndarray) -> _Encoded:
        x = torch.from_numpy(np.asarray(x, np.float32)).to(self.device)
        f = encode_f(self.sae_cfg, self.params, self.state, x)
        with modeling._f32_products():
            orig_logits = x @ self.w + self.b
        return _Encoded(f, orig_logits, torch.argmax(orig_logits, dim=-1))

    @torch.no_grad()
    def counts(self, enc: _Encoded, lookup, top_values, rand_dir) -> tuple[np.ndarray, ...]:
        """(n_orig, n_changed, n_other, n_other_changed), each (n_classes,)
        int64: the JAX package's `lax.map` over classes, a chunk of classes
        at once as a (classes, B, K) logit update."""
        dev = self.device
        f, orig_logits, orig_pred = enc
        lookup = torch.as_tensor(np.asarray(lookup, np.int64)).to(dev)
        top_values = torch.as_tensor(np.asarray(top_values, np.float32)).to(dev)
        n, k = orig_logits.shape
        rand_coef = None
        if rand_dir is not None:
            rand = torch.as_tensor(np.asarray(rand_dir, np.float32)).to(dev)
            with modeling._f32_products():
                rand_coef = rand @ self.w  # (K,)
        chunk = max(1, CHUNK_ELEMENTS // max(n * k, 1))
        out = torch.zeros((4, self.n_classes), dtype=torch.int64, device=dev)
        for c0 in range(0, self.n_classes, chunk):
            cs = torch.arange(c0, min(c0 + chunk, self.n_classes), device=dev)
            lat = lookup[cs]
            valid = lat >= 0
            lat_safe = lat.clamp_min(0)
            value = self.scale * top_values[lat_safe]  # (Cc,)
            dscalar = value[:, None] - f[:, lat_safe].T  # (Cc, B) per-patch latent shift
            wdec = self.w_dec[lat_safe]  # (Cc, D)
            if rand_coef is None:
                with modeling._f32_products():
                    coef = wdec @ self.w  # (Cc, K)
                delta = dscalar[:, :, None] * coef[:, None, :]
            else:
                # Random-direction control: the same per-patch shift MAGNITUDE
                # along a fixed random unit vector.
                mag = dscalar.abs() * torch.linalg.vector_norm(wdec, dim=1)[:, None]
                delta = mag[:, :, None] * rand_coef[None, None, :]
            mod_pred = torch.argmax(orig_logits[None] + delta, dim=-1)  # (Cc, B)
            del delta
            mod_pred = torch.where(valid[:, None], mod_pred, orig_pred[None])
            orig_mask = orig_pred[None] == cs[:, None]
            changed = mod_pred != orig_pred[None]
            out[0, cs] = orig_mask.sum(dim=1)
            out[1, cs] = (changed & orig_mask).sum(dim=1)
            out[2, cs] = (~orig_mask).sum(dim=1)
            out[3, cs] = (changed & ~orig_mask).sum(dim=1)
        return tuple(out.cpu().numpy())

    def __call__(self, x, lookup, top_values, rand_dir):
        return self.counts(self.encode(x), lookup, top_values, rand_dir)


def _count_fn(sae_cfg, params, state, probe_w, probe_b, scale, n_classes) -> _Counter:
    """Per-class intervention counts for all three methods on one batch.

    Interventions are evaluated ONE CLASS AT A TIME — class c's latent is set
    to `scale * top_value` on EVERY patch, and we count how many class-c
    patches vs how many OTHER patches flip prediction. With a per-patch
    linear probe, modifying only class-c patches could never change any other
    patch (the reference's cross-patch effects come from hooking a mid-ViT
    layer, quantitative.py:337-367), so the all-patch per-class form is what
    makes other_change a real specificity measure here. Class masks use the
    ORIGINAL PREDICTIONS, matching the reference's accounting
    (compute_class_results, quantitative.py:592-630). The probe is linear, so
    each class's modified logits are orig + (v_c - f_lc) * (W_dec[l_c] @ W_p)
    — no re-encode per class."""
    return _Counter(sae_cfg, params, state, probe_w, probe_b, scale, n_classes)


def worker_fn(cfg: Config) -> list[Report]:
    """Run every configured intervention method and dump the summary CSV
    (reference main :26-52). All methods share ONE ordered pass and one
    encode a batch — the probe logits and SAE codes per batch are
    method-independent."""
    device = device_of(cfg.device)
    sae_cfg, params, state = nn.load(cfg.sae_ckpt, device=device)
    probe = training.load(cfg.probe_ckpt)
    probe_w = np.asarray(probe["w"][cfg.probe_i])
    probe_b = np.asarray(probe["b"][cfg.probe_i])

    f1, top_values = latent_class_stats(
        sae_cfg, params, state, cfg.acts, n_classes=cfg.n_classes
    )
    auto_lookup = get_latent_lookup(f1)
    rng = np.random.default_rng(cfg.seed)
    rand_lookup = np.where(
        auto_lookup >= 0, rng.integers(0, sae_cfg.d_sae, size=cfg.n_classes), -1
    )
    rand_dir = rng.normal(size=(sae_cfg.d_model,)).astype(np.float32)
    rand_dir /= np.linalg.norm(rand_dir)

    run = _count_fn(
        sae_cfg, params, state, probe_w, probe_b, cfg.scale, cfg.n_classes
    )
    method_args: dict[str, tuple] = {
        "auto-feat": (auto_lookup, None),
        "rand-feat": (rand_lookup, None),
        "rand-vec": (auto_lookup, rand_dir),
    }
    methods = [m for m in cfg.methods if m in method_args]
    totals = {m: np.zeros((cfg.n_classes, 4), np.int64) for m in methods}

    dl = OrderedDataLoader(cfg.acts)
    try:
        for batch in helpers.progress(dl, desc="interventions"):
            if not methods:
                continue
            enc = run.encode(batch["act"])
            for method in methods:
                lookup, direction = method_args[method]
                counts = run.counts(enc, lookup, top_values, direction)
                totals[method] += np.stack(
                    [np.asarray(c, np.int64) for c in counts], axis=1
                )
    finally:
        dl.shutdown()

    reports = []
    for method in methods:
        lookup = method_args[method][0]
        class_results = [
            ClassResults(
                class_id=c,
                n_orig_patches=int(totals[method][c, 0]),
                n_changed_patches=int(totals[method][c, 1]),
                n_other_patches=int(totals[method][c, 2]),
                n_other_changed=int(totals[method][c, 3]),
            )
            for c in range(1, cfg.n_classes)
            if lookup[c] >= 0 and totals[method][c, 0] > 0
        ]
        reports.append(Report(
            method=method,
            class_results=class_results,
            intervention_scale=cfg.scale,
        ))
        logger.info(
            "%s: target change %.3f, other change %.3f", method,
            reports[-1].mean_target_change, reports[-1].mean_other_change,
        )

    fpath = pathlib.Path(cfg.dump_to) / "results.csv"
    fpath.parent.mkdir(parents=True, exist_ok=True)
    with open(fpath, "w", newline="") as fd:
        writer = csv.DictWriter(
            fd,
            fieldnames=[
                "method", "target_change", "other_change",
                "target_std", "other_std", "scale",
            ],
        )
        writer.writeheader()
        for report in reports:
            writer.writerow(report.to_csv_row())
    return reports


def cli(cfg: Config) -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s",
    )
    worker_fn(cfg)
