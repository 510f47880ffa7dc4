"""Dictionary-learning baselines: mini-batch k-means, streaming PCA, semi-NMF
and random directions (counterpart of contrib/trait_discovery/src/tdiscovery/
baselines.py; reference MiniBatchKMeans :58, MiniBatchPCA :183,
MiniBatchSemiNMF :284, dump/load :588-677): sklearn-style
`partial_fit`/`transform` estimators over activation batches.

The k-means step (distances, assignment, counts and sums), the collapsed-centre
test and the semi-NMF encode run on the device, the card unless the caller
passes `device="cpu"`; their products are float32 with TF32 off. The
generator draws (initial centres, resurrection) stay numpy on the host, with
the JAX package's draws. PCA stays float64 numpy on the host, as there.
Checkpoints keep the reference layout (`checkpoint/baseline.pt`, a JSON header
line then `torch.save` of float32 tensors), so either package loads the
other's.
"""

import dataclasses
import io
import json
import logging
import pathlib
import secrets
import typing as tp

import numpy as np
import scipy.sparse
import torch

from .. import disk, helpers
from ..data import Metadata, OrderedConfig, OrderedDataLoader, ShuffledConfig, ShuffledDataLoader
from ..framework.inference import Filepaths, _torch_save
from ..metrics import Metrics
from ..nn import modeling
from ..utils import scheduling
from . import device_of

logger = logging.getLogger("baselines")

BaselineMethod = tp.Literal["kmeans", "pca", "semi-nmf"]
BASELINE_SCHEMA_VERSION = 1


def baseline_ckpt(run: disk.Run) -> pathlib.Path:
    """Baseline weights live beside sae.pt as checkpoint/baseline.pt
    (reference baselines.py:38-45)."""
    return run.ckpt.parent / "baseline.pt"


def _pos_part(x):
    return (abs(x) + x) * 0.5


def _neg_part(x):
    return (abs(x) - x) * 0.5


def sq_distances(batch: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(B, k) squared distances |x|^2 - 2 x c^T + |c|^2, the product in
    float32 with TF32 off."""
    with modeling._f32_products():
        prod = batch @ centers.T
    return (batch**2).sum(1, keepdim=True) - 2.0 * prod + (centers**2).sum(1)[None, :]


def kmeans_step(centers: torch.Tensor, batch: torch.Tensor):
    """One mini-batch k-means assignment (reference baselines.py:58-75):
    (assign (B,), counts (k,), sums (k, d), inertia ()), on the tensors'
    device. Counts and sums are `index_add_`s, whose float atomics may add in
    another order on each call on the card."""
    d2 = sq_distances(batch, centers)
    assign = d2.argmin(1)
    counts = torch.zeros(centers.shape[0], dtype=batch.dtype, device=batch.device)
    counts.index_add_(0, assign, torch.ones_like(assign, dtype=batch.dtype))
    sums = torch.zeros_like(centers).index_add_(0, assign, batch)
    inertia = d2.gather(1, assign[:, None]).mean().clamp_min(0.0)
    return assign, counts, sums, inertia


class MiniBatchKMeans:
    """Mini-batch k-means with empty-cluster resurrection and collapsed-center
    splitting (reference baselines.py:58-180). The centres and counts stay on
    the device; `cluster_centers_` and `cluster_counts_` read them back."""

    method = "kmeans"

    def __init__(self, k: int, collapse_tol: float = 0.5, seed: int = 0, device: str = "cuda"):
        self.k = k
        self.collapse_tol = collapse_tol
        self.device = device_of(device)
        self._centers: torch.Tensor | None = None
        self._counts: torch.Tensor | None = None
        self.n_steps_ = 0
        self.n_features_in_: int | None = None
        self.last_batch_inertia_: float | None = None
        self._rng = np.random.default_rng(seed)

    @property
    def cluster_centers_(self) -> np.ndarray | None:
        return None if self._centers is None else self._centers.cpu().numpy()

    @property
    def cluster_counts_(self) -> np.ndarray | None:
        return None if self._counts is None else self._counts.cpu().numpy()

    @torch.no_grad()
    def partial_fit(self, batch: np.ndarray) -> "MiniBatchKMeans":
        batch = np.asarray(batch, dtype=np.float32)
        assert batch.ndim == 2, f"batch must be 2D, got {batch.shape}"
        if self.n_features_in_ is None:
            self.n_features_in_ = batch.shape[1]
        assert batch.shape[1] == self.n_features_in_

        if self._centers is None:
            n = batch.shape[0]
            if n >= self.k:
                idx = self._rng.permutation(n)[: self.k]
                centers = batch[idx]
            else:
                reps = -(-self.k // n)
                centers = np.tile(batch, (reps, 1))[: self.k]
            self._centers = torch.from_numpy(np.ascontiguousarray(centers)).to(self.device)
            self._counts = torch.zeros(self.k, dtype=torch.float32, device=self.device)

        xb = torch.from_numpy(batch).to(self.device)
        _, counts_batch, sums_batch, inertia = kmeans_step(self._centers, xb)
        prev_counts = self._counts

        # Resurrect clusters that have never seen data.
        empty = (prev_counts == 0) & (counts_batch == 0)
        n_empty = int(empty.sum())
        if n_empty:
            repl = batch[self._rng.integers(0, batch.shape[0], size=n_empty)]
            counts_batch[empty] = 1.0
            sums_batch[empty] = torch.from_numpy(repl).to(self.device)

        self._counts = prev_counts + counts_batch
        mask = (counts_batch > 0)[:, None]
        moved = (self._centers * prev_counts[:, None] + sums_batch) / self._counts[:, None]
        self._centers = torch.where(mask, moved, self._centers)
        self.last_batch_inertia_ = float(inertia)

        self._split_collapsed_centers(xb)
        self.n_steps_ += 1
        return self

    def _split_collapsed_centers(self, batch: torch.Tensor) -> None:
        """Replace near-duplicate centers with far-away batch points
        (reference baselines.py:146-172). The pairwise distances are the
        product form of `sq_distances`, on the device: the JAX package's
        (k, k, d) broadcast of differences does not fit in memory at
        k = 4096, d = 1024."""
        if self.k < 2:
            return
        c = self._centers
        pairwise = sq_distances(c, c).clamp_min(0.0).sqrt()
        close = torch.triu(pairwise < self.collapse_tol, diagonal=1)
        if not bool(close.any()):
            return
        pairs = close.nonzero()
        cnt_i = self._counts[pairs[:, 0]]
        cnt_j = self._counts[pairs[:, 1]]
        losers = torch.where(cnt_i <= cnt_j, pairs[:, 0], pairs[:, 1])
        loser_mask = torch.zeros(self.k, dtype=torch.bool, device=c.device)
        loser_mask[losers] = True
        n_needed = int(loser_mask.sum())
        cand = batch
        if cand.shape[0] < n_needed:
            cand = cand.repeat(-(-n_needed // cand.shape[0]), 1)
        cand_dist = sq_distances(cand, c).clamp_min(0.0).sqrt()
        order = torch.argsort(-cand_dist.max(dim=1).values, stable=True)[:n_needed]
        self._centers[loser_mask] = cand[order]
        self._counts[loser_mask] = 0.0

    @torch.no_grad()
    def transform(self, batch: np.ndarray) -> np.ndarray:
        """Negative distances to the centers (higher = closer), matching the
        reference's score convention (baselines.py:174-180)."""
        assert self._centers is not None, "not fitted"
        xb = torch.from_numpy(np.asarray(batch, dtype=np.float32)).to(self.device)
        return (-sq_distances(xb, self._centers).clamp_min(0.0).sqrt()).cpu().numpy()

    @torch.no_grad()
    def assign(self, batch: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(nearest centre, its squared distance clamped at 0) for each row,
        computed on the device."""
        xb = torch.from_numpy(np.asarray(batch, dtype=np.float32)).to(self.device)
        d2 = sq_distances(xb, self._centers)
        min_d2, idx = d2.min(dim=1)
        return idx.cpu().numpy(), min_d2.clamp_min(0.0).cpu().numpy()

    def state_dict(self) -> dict[str, np.ndarray]:
        return {
            "cluster_centers_": self.cluster_centers_,
            "cluster_counts_": self.cluster_counts_,
        }

    def load_state_dict(self, sd):
        self._centers = torch.tensor(np.asarray(sd["cluster_centers_"]), dtype=torch.float32, device=self.device)
        self._counts = torch.tensor(np.asarray(sd["cluster_counts_"]), dtype=torch.float32, device=self.device)
        self.n_features_in_ = self._centers.shape[1]


class MiniBatchPCA:
    """Streaming PCA via online mean/scatter accumulation + eigh
    (reference baselines.py:183-282). Float64 numpy on the host."""

    method = "pca"

    def __init__(self, n_components: int):
        self.n_components = n_components
        self.components_: np.ndarray | None = None
        self.explained_variance_: np.ndarray | None = None
        self.mean_: np.ndarray | None = None
        self.scatter_: np.ndarray | None = None
        self.n_samples_seen_ = 0
        self.n_steps_ = 0
        self.n_features_in_: int | None = None
        self.total_variance_: float | None = None
        self.last_batch_recon_error_: float | None = None
        self.last_batch_var_ratio_: float | None = None

    def partial_fit(self, batch: np.ndarray) -> "MiniBatchPCA":
        batch = np.asarray(batch, dtype=np.float64)
        if batch.shape[0] == 0:
            return self
        n_batch, n_features = batch.shape
        if self.n_features_in_ is None:
            self.n_features_in_ = n_features
        assert n_features == self.n_features_in_
        assert self.n_components <= n_features

        batch_mean = batch.mean(axis=0)
        centered = batch - batch_mean
        scatter_update = centered.T @ centered

        if self.n_samples_seen_ == 0:
            self.mean_ = batch_mean
            self.scatter_ = scatter_update
            self.n_samples_seen_ = n_batch
        else:
            n_prev = self.n_samples_seen_
            n_total = n_prev + n_batch
            delta = batch_mean - self.mean_
            correction = np.outer(delta, delta) * (n_prev * n_batch / n_total)
            self.scatter_ = self.scatter_ + scatter_update + correction
            self.mean_ = self.mean_ + delta * (n_batch / n_total)
            self.n_samples_seen_ = n_total

        cov = self.scatter_ / max(self.n_samples_seen_ - 1, 1)
        cov = 0.5 * (cov + cov.T)
        eigvals, eigvecs = np.linalg.eigh(cov)
        order = np.argsort(eigvals)[::-1][: self.n_components]
        self.explained_variance_ = eigvals[order]
        self.components_ = eigvecs[:, order].T.copy()
        total_var = float(eigvals.sum())
        self.total_variance_ = total_var if np.isfinite(total_var) else None
        self.last_batch_var_ratio_ = float(
            self.explained_variance_.sum() / max(total_var, 1e-12)
        )

        scores = (batch - self.mean_) @ self.components_.T
        recon = scores @ self.components_ + self.mean_
        self.last_batch_recon_error_ = float(((batch - recon) ** 2).mean())
        self.n_steps_ += 1
        return self

    def transform(self, batch: np.ndarray) -> np.ndarray:
        assert self.components_ is not None, "not fitted"
        return (np.asarray(batch, np.float64) - self.mean_) @ self.components_.T

    def state_dict(self):
        return {
            "components_": self.components_,
            "mean_": self.mean_,
            "explained_variance_": self.explained_variance_,
        }

    def load_state_dict(self, sd):
        self.components_ = np.asarray(sd["components_"])
        self.mean_ = np.asarray(sd["mean_"])
        self.explained_variance_ = np.asarray(sd["explained_variance_"])
        self.n_features_in_ = self.components_.shape[1]


@torch.no_grad()
def semi_nmf_encode(D: torch.Tensor, acts: torch.Tensor, n_iters: int, eps: float) -> torch.Tensor:
    """Non-negative codes z (B, k) of `acts` on the dictionary D (k, d)
    (reference baselines.py:307-336): the ridge least-squares start, then
    `n_iters` multiplicative updates, in float32 with TF32 off."""
    eye = torch.eye(D.shape[0], dtype=D.dtype, device=D.device)
    with modeling._f32_products():
        ddt = D @ D.T
        ddt_reg_inv = torch.linalg.solve(ddt + eps * eye, eye)
        atd = acts @ D.T
        z = (atd @ ddt_reg_inv).clamp_min(eps)
        if n_iters == 0:
            return z
        atd_pos, atd_neg = _pos_part(atd), _neg_part(atd)
        ddt_pos, ddt_neg = _pos_part(ddt), _neg_part(ddt)
        for _ in range(n_iters):
            num = atd_pos + z @ ddt_neg
            den = atd_neg + z @ ddt_pos + eps
            z = z * torch.sqrt(num / den)
    return z


class MiniBatchSemiNMF:
    """Mini-batch semi-NMF: non-negative codes, unconstrained dictionary
    (reference baselines.py:284-463). The encode runs on the device; the
    dictionary's accumulators and its ridge solve stay numpy on the host."""

    method = "semi-nmf"

    def __init__(
        self,
        n_concepts: int,
        *,
        z_iters: int = 10,
        encode_iters: int = 300,
        ridge: float = 1e-6,
        eps: float = 1e-8,
        forget_factor: float = 0.7,
        d_update_every: int = 10,
        seed: int = 0,
        device: str = "cuda",
    ):
        assert 0.0 <= forget_factor < 1.0
        self.n_concepts = n_concepts
        self.z_iters = z_iters
        self.encode_iters = encode_iters
        self.ridge = float(ridge)
        self.eps = float(eps)
        self.forget_factor = float(forget_factor)
        self.d_update_every = d_update_every
        self.device = device_of(device)
        self._rng = np.random.default_rng(seed)

        self.D_: np.ndarray | None = None
        self.n_features_in_: int | None = None
        self.n_samples_seen_ = 0
        self.n_steps_ = 0
        self.ZtZ_acc_: np.ndarray | None = None
        self.ZtA_acc_: np.ndarray | None = None
        self.last_batch_recon_mse_: float | None = None
        self.last_batch_nmse_: float | None = None

    def _encode(self, acts: np.ndarray, n_iters: int) -> np.ndarray:
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(self.device)  # noqa: E731
        return semi_nmf_encode(to(self.D_), to(acts), n_iters, self.eps).cpu().numpy()

    def partial_fit(self, batch: np.ndarray) -> "MiniBatchSemiNMF":
        acts = np.asarray(batch, dtype=np.float32)
        if acts.shape[0] == 0:
            return self
        n_batch, n_features = acts.shape
        if self.n_features_in_ is None:
            self.D_ = self._rng.normal(size=(self.n_concepts, n_features)).astype(
                np.float32
            )
            self.n_features_in_ = n_features
            self.ZtZ_acc_ = np.zeros((self.n_concepts, self.n_concepts), np.float32)
            self.ZtA_acc_ = np.zeros((self.n_concepts, n_features), np.float32)
        assert n_features == self.n_features_in_

        z = self._encode(acts, self.z_iters)
        self._update_last_batch_metrics(acts, z)

        ztz = z.T @ z
        zta = z.T @ acts
        f = self.forget_factor
        self.ZtZ_acc_ = f * self.ZtZ_acc_ + (1.0 - f) * ztz
        self.ZtA_acc_ = f * self.ZtA_acc_ + (1.0 - f) * zta
        self.n_samples_seen_ += n_batch
        self.n_steps_ += 1
        if self.n_steps_ % self.d_update_every == 0:
            reg = self.ZtZ_acc_ + self.ridge * np.eye(self.n_concepts, dtype=np.float32)
            self.D_ = np.linalg.solve(reg, self.ZtA_acc_)
        return self

    def transform(self, batch: np.ndarray, *, n_iters: int | None = None) -> np.ndarray:
        assert self.D_ is not None, "not fitted"
        return self._encode(np.asarray(batch, np.float32), self.encode_iters if n_iters is None else n_iters)

    def _update_last_batch_metrics(self, acts: np.ndarray, z: np.ndarray) -> None:
        recon = z @ self.D_
        diff = (acts - recon).astype(np.float64)
        recon_sse = float((diff**2).sum())
        n_batch = acts.shape[0]
        self.last_batch_recon_mse_ = recon_sse / n_batch
        a64 = acts.astype(np.float64)
        sse_baseline = float((a64 * a64).sum()) - float(
            a64.sum(0) @ a64.sum(0)
        ) / n_batch
        assert sse_baseline > 0.0, (
            f"Baseline variance is non-positive (sse_baseline={sse_baseline:.6e})."
        )
        self.last_batch_nmse_ = recon_sse / sse_baseline

    def state_dict(self):
        return {"D_": self.D_, "ZtZ_acc_": self.ZtZ_acc_, "ZtA_acc_": self.ZtA_acc_}

    def load_state_dict(self, sd):
        self.D_ = np.asarray(sd["D_"])
        self.ZtZ_acc_ = np.asarray(sd["ZtZ_acc_"])
        self.ZtA_acc_ = np.asarray(sd["ZtA_acc_"])
        self.n_features_in_ = self.D_.shape[1]


class RandomVectors:
    """Random unit-gaussian prototype directions — the no-learning control
    baseline (reference fishvista/evaluation.py method='random'). `fit` is a
    no-op; scores are plain dot products."""

    method = "random"

    def __init__(self, k: int, d: int | None = None, seed: int = 0):
        self.k = k
        self.n_features_in_ = d
        self._rng = np.random.default_rng(seed)
        self.vectors_: np.ndarray | None = None
        if d is not None:
            self._init(d)

    def _init(self, d: int):
        v = self._rng.normal(size=(self.k, d)).astype(np.float32)
        self.vectors_ = v / np.linalg.norm(v, axis=1, keepdims=True)
        self.n_features_in_ = d

    def partial_fit(self, batch: np.ndarray) -> "RandomVectors":
        if self.vectors_ is None:
            self._init(np.asarray(batch).shape[1])
        return self

    def transform(self, batch: np.ndarray) -> np.ndarray:
        if self.vectors_ is None:
            self._init(np.asarray(batch).shape[1])
        return np.asarray(batch, np.float32) @ self.vectors_.T

    def state_dict(self) -> dict[str, np.ndarray]:
        assert self.vectors_ is not None, "not fitted"
        return {"vectors_": self.vectors_}

    def load_state_dict(self, sd):
        self.vectors_ = np.asarray(sd["vectors_"])
        self.n_features_in_ = self.vectors_.shape[1]


# ---------------------------------------------------------------------------
# Checkpointing (reference baselines.py:588-677)
# ---------------------------------------------------------------------------

_METHODS = {
    "kmeans": MiniBatchKMeans,
    "pca": MiniBatchPCA,
    "semi-nmf": MiniBatchSemiNMF,
    "random": RandomVectors,
}


def dump(run: disk.Run, method: str, model, extra: dict | None = None) -> pathlib.Path:
    fpath = baseline_ckpt(run)
    header = {
        "schema": BASELINE_SCHEMA_VERSION,
        "method": method,
        **(extra or {}),
    }
    sd = {
        k: torch.from_numpy(np.ascontiguousarray(np.asarray(v, dtype=np.float32)))
        for k, v in model.state_dict().items()
    }
    with open(fpath, "wb") as fd:
        fd.write(json.dumps(header).encode() + b"\n")
        torch.save(sd, fd)
    return fpath


def load(run: disk.Run, *, device: str = "cuda", **kwargs):
    """The baseline in run's checkpoint; k-means and semi-NMF on `device`."""
    fpath = baseline_ckpt(run)
    with open(fpath, "rb") as fd:
        header = json.loads(fd.readline())
        sd = torch.load(io.BytesIO(fd.read()), weights_only=True, map_location="cpu")
    sd = {k: v.numpy() for k, v in sd.items()}
    method = header["method"]
    cls = _METHODS[method]
    if method == "kmeans":
        model = cls(k=sd["cluster_centers_"].shape[0], device=device, **kwargs)
    elif method == "pca":
        model = cls(n_components=sd["components_"].shape[0], **kwargs)
    elif method == "random":
        model = cls(k=sd["vectors_"].shape[0], **kwargs)
    else:
        model = cls(n_concepts=sd["D_"].shape[0], device=device, **kwargs)
    model.load_state_dict(sd)
    return model


# ---------------------------------------------------------------------------
# Training pipeline (reference baselines.py:465-494 TrainConfig, :851-949
# train_worker_fn, :701-849 per-method eval)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Baseline dictionary training over shard streams: the JAX package's
    fields and defaults but for `device`, and `train_data` a loader config
    by default (the command line sets its fields)."""

    method: BaselineMethod = "kmeans"
    train_data: ShuffledConfig = dataclasses.field(default_factory=ShuffledConfig)
    """Shuffled loader config of the train stream."""
    val_data: ShuffledConfig | None = None
    """Shuffled loader config for eval (None or n_val<=0 skips eval; on the
    command line `val-data:config` selects one)."""
    n_train: int = 100_000_000
    n_val: int = 10_000_000
    k: int = 1024 * 16
    """Dictionary size (clusters / components / concepts)."""
    collapse_tol: float = 0.5
    z_iters: int = 10
    encode_iters: int = 300
    ridge: float = 1e-6
    eps: float = 1e-8
    forget_factor: float = 0.7
    d_update_every: int = 10
    seed: int = 42
    runs_root: pathlib.Path = pathlib.Path("./tdiscovery/runs")
    log_every: int = 50
    debug: bool = False
    device: tp.Literal["cuda", "cpu"] = "cuda"
    """Where the device work runs: the card unless "cpu" is asked for."""


def make_model(cfg: TrainConfig):
    if cfg.method == "kmeans":
        return MiniBatchKMeans(k=cfg.k, collapse_tol=cfg.collapse_tol, seed=cfg.seed, device=cfg.device)
    if cfg.method == "pca":
        return MiniBatchPCA(n_components=cfg.k)
    if cfg.method == "semi-nmf":
        return MiniBatchSemiNMF(
            n_concepts=cfg.k, z_iters=cfg.z_iters, encode_iters=cfg.encode_iters,
            ridge=cfg.ridge, eps=cfg.eps, forget_factor=cfg.forget_factor,
            d_update_every=cfg.d_update_every, seed=cfg.seed, device=cfg.device,
        )
    raise ValueError(f"Unknown method {cfg.method!r}")


def _val_batches(cfg: TrainConfig):
    if cfg.val_data is None or cfg.n_val <= 0:
        return None
    dl = ShuffledDataLoader(cfg.val_data)
    return scheduling.BatchLimiter(dl, min(cfg.n_val, dl.n_samples))


def eval_kmeans(cfg: TrainConfig, model: MiniBatchKMeans) -> dict[str, float]:
    """Inertia + center utilization/population stats (reference :702-745)."""
    limiter = _val_batches(cfg)
    if limiter is None:
        return {}
    hits = np.zeros(model.k, dtype=np.float64)
    sum_sq_dist, n = 0.0, 0
    for batch in limiter:
        acts = np.asarray(batch["act"])
        assign, min_d2 = model.assign(acts)
        sum_sq_dist += float(min_d2.sum())
        np.add.at(hits, assign, 1.0)
        n += acts.shape[0]
    if n == 0:
        return {}
    return {
        "eval/inertia": sum_sq_dist / n,
        "eval/utilization": float((hits > 0).mean()),
        "eval/mean_pop": float(hits.mean()),
        "eval/max_pop": float(hits.max()),
    }


def _eval_nmse(limiter, recon_fn) -> dict[str, float]:
    """Normalized MSE of recon_fn over the val stream (reference :747-849)."""
    sse, sum_sq, n = 0.0, 0.0, 0
    sum_vec = None
    for batch in limiter:
        acts = np.asarray(batch["act"], dtype=np.float64)
        recon = np.asarray(recon_fn(acts.astype(np.float32)), dtype=np.float64)
        sse += float(((acts - recon) ** 2).sum())
        sum_sq += float((acts * acts).sum())
        sum_vec = acts.sum(0) if sum_vec is None else sum_vec + acts.sum(0)
        n += acts.shape[0]
    if n == 0:
        return {}
    sse_baseline = sum_sq - float(sum_vec @ sum_vec) / n
    return {
        "eval/mse": sse / n,
        "eval/normalized_mse": sse / max(sse_baseline, 1e-18),
    }


def eval_pca(cfg: TrainConfig, model: MiniBatchPCA) -> dict[str, float]:
    limiter = _val_batches(cfg)
    if limiter is None:
        return {}
    return _eval_nmse(
        limiter, lambda a: model.transform(a) @ model.components_ + model.mean_
    )


def eval_semi_nmf(cfg: TrainConfig, model: MiniBatchSemiNMF) -> dict[str, float]:
    limiter = _val_batches(cfg)
    if limiter is None:
        return {}
    return _eval_nmse(limiter, lambda a: model.transform(a) @ model.D_)


def get_training_metrics(model, n_samples: int) -> dict[str, float]:
    """Final train-side metrics recorded into the checkpoint header
    (reference :679-699)."""
    out: dict[str, float] = {"train/n_samples": float(n_samples)}
    for attr, key in (
        ("last_batch_recon_mse_", "train/last_batch_recon_mse"),
        ("last_batch_nmse_", "train/last_batch_nmse"),
        ("n_steps_", "train/n_steps"),
    ):
        v = getattr(model, attr, None)
        if v is not None:
            out[key] = float(v)
    return out


def train_worker_fn(cfg: TrainConfig) -> str:
    """Stream the shuffled loader, fit the dictionary, eval, dump to a Run
    (reference train_worker_fn :851-949). Returns the run id."""
    dl = ShuffledDataLoader(cfg.train_data)
    limiter = scheduling.BatchLimiter(dl, min(cfg.n_train, dl.n_samples))
    model = make_model(cfg)

    n_samples = 0
    for batch in helpers.progress(limiter, desc="fit", every=cfg.log_every):
        acts = np.asarray(batch["act"], dtype=np.float32)
        model.partial_fit(acts)
        n_samples += acts.shape[0]

    evals = {
        "kmeans": eval_kmeans, "pca": eval_pca, "semi-nmf": eval_semi_nmf
    }[cfg.method](cfg, model)
    metrics = {**get_training_metrics(model, n_samples), **evals}
    logger.info("Trained %s on %d samples: %s", cfg.method, n_samples, metrics)

    run_id = secrets.token_hex(4)
    shards = pathlib.Path(cfg.train_data.shards)
    val_shards = pathlib.Path(cfg.val_data.shards) if cfg.val_data else shards
    run = disk.Run.new(
        run_id, train_shards_dir=shards, val_shards_dir=val_shards,
        runs_root=pathlib.Path(cfg.runs_root),
    )
    dump(run, cfg.method, model, extra={"metrics": metrics, "k": cfg.k})
    with open(run.run_dir / "metrics.json", "w") as fd:
        json.dump(metrics, fd, indent=2)
    return run_id


# ---------------------------------------------------------------------------
# Inference pipeline: the same 5 artifacts as SAE inference so baselines slot
# into visuals/probe1d/metrics (reference :951-1378)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class InferenceConfig:
    """The JAX package's fields and defaults but for `device`, and `data` an
    ordered loader config by default (the command line sets its fields)."""

    run: pathlib.Path = pathlib.Path("./tdiscovery/runs/example")
    data: OrderedConfig = dataclasses.field(default_factory=OrderedConfig)
    """Ordered loader config of the shards to score."""
    n_dists: int = 25
    n_iters: int = 300
    """Semi-NMF multiplicative update iterations at inference."""
    save: bool = True
    force: bool = False
    device: tp.Literal["cuda", "cpu"] = "cuda"
    """Where the device work runs: the card unless "cpu" is asked for."""


def inference_worker_fn(cfg: InferenceConfig) -> None:
    """Ordered pass writing token_acts.npz / sparsity.pt / mean_values.pt /
    distributions.pt / metrics.json for the baseline dictionary
    (reference inference_worker_fn :1362-1378 dispatching :1001-1360)."""
    run = disk.Run(cfg.run)
    model = load(run, device=cfg.device)
    method = type(model).method
    if method == "random":
        raise ValueError(
            "Baseline inference artifacts are reconstruction-based; the "
            "'random' control has no reconstruction semantics. Use it via "
            "the fishvista evaluation pipeline (prototype scoring) instead."
        )
    md = Metadata.load(cfg.data.shards)
    fpaths = Filepaths.from_run(run, md)
    required = list(fpaths) if cfg.save else [fpaths.metrics]
    if not cfg.force and all(f.exists() for f in required):
        logger.info("All artifacts exist for %s; skipping.", cfg.run)
        return

    batch_size = max(
        cfg.data.batch_size
        // md.content_tokens_per_example
        * md.content_tokens_per_example,
        md.content_tokens_per_example,
    )
    dl = OrderedDataLoader(dataclasses.replace(cfg.data, batch_size=batch_size))
    n_samples = dl.n_samples
    k = {
        "kmeans": lambda: model.k,
        "pca": lambda: model.components_.shape[0],
        "semi-nmf": lambda: model.D_.shape[0],
    }[method]()
    d_model = md.d_model

    mean_values = np.zeros((k,), dtype=np.float64)
    sparsity = np.zeros((k,), dtype=np.float64)
    n_dists = min(cfg.n_dists, k)
    if cfg.save:
        distributions = np.zeros((n_samples, n_dists), dtype=np.float32)
        blocks: list[scipy.sparse.csr_matrix] = []
    sse_recon, sum_sq, n_tokens = 0.0, 0.0, 0
    sum_vec = np.zeros((d_model,), dtype=np.float64)
    prev_i = -1

    for batch in helpers.progress(dl, desc=f"{method}-inference"):
        acts = np.asarray(batch["act"], dtype=np.float32)
        if method == "kmeans":
            assign, min_d2 = model.assign(acts)
            # Sparse one-hot codes valued 1/(1+dist) (reference :1036).
            scores_sparse = (assign, 1.0 / (1.0 + np.sqrt(min_d2)))
            sse_recon += float(min_d2.astype(np.float64).sum())
            codes = None
        elif method == "pca":
            codes = model.transform(acts)
            recon = codes @ model.components_ + model.mean_
            sse_recon += float(((acts - recon).astype(np.float64) ** 2).sum())
            scores_sparse = None
        else:
            codes = model.transform(acts, n_iters=cfg.n_iters)
            recon = codes @ model.D_
            sse_recon += float(((acts - recon).astype(np.float64) ** 2).sum())
            scores_sparse = None

        a64 = acts.astype(np.float64)
        sum_sq += float((a64 * a64).sum())
        sum_vec += a64.sum(0)
        n_tokens += acts.shape[0]

        if not cfg.save:
            continue
        batch_idx = (
            np.asarray(batch["example_idx"]) * md.content_tokens_per_example
            + np.asarray(batch["token_idx"])
        )
        assert int(batch_idx[0]) == prev_i + 1
        assert (np.sort(batch_idx) == batch_idx).all()
        prev_i = int(batch_idx[-1])

        if scores_sparse is not None:
            assign, vals = scores_sparse
            np.add.at(sparsity, assign, 1.0)
            np.add.at(mean_values, assign, vals)
            blocks.append(
                scipy.sparse.csr_matrix(
                    (vals, (np.arange(len(assign)), assign)),
                    shape=(len(assign), k),
                )
            )
            sel = assign < n_dists
            distributions[batch_idx[sel], assign[sel]] = vals[sel]
        else:
            codes = codes.astype(np.float32)
            sparsity += (codes != 0).sum(0)
            mean_values += codes.sum(0, dtype=np.float64)
            blocks.append(scipy.sparse.csr_matrix(codes))
            distributions[batch_idx] = codes[:, :n_dists]

    if cfg.save:
        with np.errstate(divide="ignore", invalid="ignore"):
            mean_values = mean_values / sparsity
        sparsity = sparsity / n_samples
        token_acts = scipy.sparse.vstack(blocks, format="csr")
        scipy.sparse.save_npz(fpaths.token_acts, token_acts)
        _torch_save(mean_values.astype(np.float32), fpaths.mean_values)
        _torch_save(sparsity.astype(np.float32), fpaths.sparsity)
        _torch_save(distributions, fpaths.distributions)

    assert n_tokens > 0
    sse_baseline = sum_sq - float(sum_vec @ sum_vec) / n_tokens
    assert sse_baseline > 0.0, f"Non-positive baseline variance {sse_baseline:.3e}"
    metrics = Metrics.from_accumulators(
        sse_recon=sse_recon, sse_baseline=sse_baseline,
        n_tokens=n_tokens, d_model=d_model,
    )
    with open(fpaths.metrics, "wb") as fd:
        helpers.jdump(metrics.to_dict(), fd, indent=2)
    logger.info("Wrote %s baseline inference artifacts under %s.", method, fpaths.metrics.parent)


def train_cli(cfg: TrainConfig) -> None:
    logging.basicConfig(level=logging.INFO)
    train_worker_fn(cfg)


def inference_cli(cfg: InferenceConfig) -> None:
    logging.basicConfig(level=logging.INFO)
    inference_worker_fn(cfg)
