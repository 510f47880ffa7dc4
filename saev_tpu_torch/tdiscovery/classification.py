"""Task-driven feature selection and concept audit on SAE features
(counterpart of contrib/trait_discovery/src/tdiscovery/classification.py;
reference PatchAgg :59, LabelGrouping :68, classifiers :120-141,
load_image_labels :176, apply_grouping :220, aggregate_to_images :270,
train_worker_fn :310, tie-aware AP :650, batched AP :739, audit
eval_worker_fn :819, sweep CLIs :497/:1042). The protocol:

1. aggregate patch-level SAE activations to image features (mean/max),
2. group dataset labels into a task and train a sparse-linear (L1 logistic)
   or decision-tree head,
3. AUDIT the head's most important latents against segmentation masks:
   per-latent best-class Average Precision over the union of each
   classifier's top-`max_budget` features, then Yield@B (fraction of the top
   B whose best AP >= tau) and its average AUC_B.

The token activations are the `token_acts.npz` that `framework.inference`
writes. Artifacts are contrib's: `cls_{task}_{agg}_{cls}.pkl` (JSON header
line + pickle) under the test inference dir, plus `audit_ap_s.npy`,
`audit_best_class_s.npy`, `audit_results.json` and
`classification_{task}.json`. Host-only numpy; `cls::train` fits
scikit-learn's heads and raises ImportError where scikit-learn is missing,
and reading a checkpoint unpickles them.
"""

import dataclasses
import enum
import json
import logging
import pathlib
import pickle
import typing as tp

import numpy as np
import scipy.sparse

from .. import configs, disk, helpers
from ..data import Metadata, datasets

logger = logging.getLogger("td.classification")


class PatchAgg(enum.Enum):
    """How to aggregate patch-level features to image-level."""

    MEAN = "mean"
    MAX = "max"


@dataclasses.dataclass(frozen=True)
class LabelGrouping:
    """Defines a classification task by grouping labels (reference
    classification.py:68-117). Empty groups = use original labels directly."""

    name: str = "class"
    source_col: str = "class"
    groups: dict[str, list[str]] = dataclasses.field(default_factory=dict)

    def apply(
        self, labels: list[str], class_names: list[str] | None = None
    ) -> tuple[np.ndarray, list[str]]:
        """Map raw string labels to group indices; returns (y, class_names).
        Ungrouped labels are dropped (marked -1) when groups are given.

        `class_names` pins the index space (e.g. the names saved in a trained
        checkpoint): without it, the mapping is re-derived from THIS split's
        label set, and a test split missing the alphabetically-first train
        class would silently shift every index."""
        if not self.groups:
            names = class_names if class_names is not None else sorted(set(labels))
            index = {name: i for i, name in enumerate(names)}
            return np.array([index.get(label, -1) for label in labels]), list(names)
        seen: dict[str, str] = {}
        for name, raws in self.groups.items():
            for raw in raws:
                assert raw not in seen, (
                    f"Label '{raw}' appears in groups '{seen[raw]}' and '{name}'."
                )
                seen[raw] = name
        names = class_names if class_names is not None else sorted(self.groups)
        order = {name: i for i, name in enumerate(names)}
        lookup = {
            raw: order[name]
            for name in self.groups
            if name in order
            for raw in self.groups[name]
        }
        return np.array([lookup.get(label, -1) for label in labels]), list(names)


@dataclasses.dataclass(frozen=True)
class DecisionTree:
    """sklearn DecisionTreeClassifier head."""

    key: tp.Literal["decision-tree"] = "decision-tree"
    max_depth: int = -1
    """Maximum depth; negative = unlimited."""


@dataclasses.dataclass(frozen=True)
class SparseLinear:
    """L1-penalized logistic regression head."""

    key: tp.Literal["sparse-linear"] = "sparse-linear"
    C: float = 0.01
    """Inverse regularization strength; lower = sparser."""
    max_iter: int = 90


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    run: pathlib.Path = pathlib.Path("./runs/abcdefg")
    """Run directory."""
    train_shards: pathlib.Path = pathlib.Path("./shards/01234567")
    test_shards: pathlib.Path = pathlib.Path("./shards/abcdef01")
    task: LabelGrouping = dataclasses.field(default_factory=LabelGrouping)
    patch_agg: PatchAgg = PatchAgg.MAX
    cls: DecisionTree | SparseLinear = SparseLinear()
    debug: bool = False


def aggregate_to_images(
    token_acts: scipy.sparse.csr_matrix, tokens_per_example: int, agg: PatchAgg
) -> np.ndarray:
    """(n_tokens, d_sae) CSR -> (n_images, d_sae) dense image features
    (reference classification.py:270-308, which loops images and densifies
    each; here one sparse pooling product / one np.maximum.at scatter)."""
    n_tokens, d_sae = token_acts.shape
    assert n_tokens % tokens_per_example == 0
    n_images = n_tokens // tokens_per_example
    if agg is PatchAgg.MEAN:
        rows = np.repeat(np.arange(n_images), tokens_per_example)
        pool = scipy.sparse.csr_matrix(
            (
                np.full(n_tokens, 1.0 / tokens_per_example, np.float32),
                (rows, np.arange(n_tokens)),
            ),
            shape=(n_images, n_tokens),
        )
        return np.asarray((pool @ token_acts).todense())
    # Per-image max over the CSR nonzeros: np.maximum.at on
    # (row // tokens_per_example, col). Activations are >= 0, so absent
    # entries correctly leave the zero default.
    coo = token_acts.tocoo()
    out = np.zeros((n_images, d_sae), dtype=np.float32)
    np.maximum.at(out, (coo.row // tokens_per_example, coo.col), coo.data)
    return out


def load_image_labels(shards: pathlib.Path) -> tuple[list[str], dict[str, list[str]]]:
    """Per-image string labels from the shard metadata's dataset config
    (reference load_image_labels, classification.py:176-218).

    Returns (label_cols, {col: labels}). ImgSegFolder datasets expose every
    CSV column; everything else exposes a single 'class' column.
    """
    md = Metadata.load(shards)
    data_cfg = md.make_data_cfg()
    ds = datasets.get_dataset(data_cfg)

    cols = getattr(ds, "label_cols", None)
    if cols:
        stems = getattr(ds, "img_fpaths", None)
        labels: dict[str, list[str]] = {col: [] for col in cols}
        for fpath in stems:
            per_sample = ds.sample_labels.get(fpath.stem, {})
            for col in cols:
                labels[col].append(per_sample.get(col, ""))
        return list(cols), labels

    out = []
    for i in range(len(ds)):
        sample = ds[i]
        value = sample.get("label", sample.get("target"))
        out.append(str(value))
    return ["class"], {"class": out}


def _cls_str(cls: DecisionTree | SparseLinear) -> str:
    return f"C{cls.C}" if isinstance(cls, SparseLinear) else f"depth{cls.max_depth}"


def ckpt_fpath(run: disk.Run, cfg: TrainConfig) -> pathlib.Path:
    """Contrib's artifact name: cls_{task}_{agg}_{cls}.pkl under the TEST
    inference dir (reference classification.py:464-470)."""
    return (
        run.inference
        / cfg.test_shards.name
        / f"cls_{cfg.task.name}_{cfg.patch_agg.value}_{_cls_str(cfg.cls)}.pkl"
    )


def _image_features(run: disk.Run, shards: pathlib.Path, agg: PatchAgg) -> np.ndarray:
    md = Metadata.load(shards)
    acts = scipy.sparse.load_npz(
        run.inference / shards.name / "token_acts.npz"
    ).tocsr()
    expected = md.n_examples * md.content_tokens_per_example
    assert acts.shape[0] == expected, (acts.shape, expected)
    return aggregate_to_images(acts, md.content_tokens_per_example, agg)


def train_worker_fn(cfg: TrainConfig) -> int:
    """Train the head on train-shard features, evaluate on test, save the
    header+pickle checkpoint (reference train_worker_fn :310-494)."""
    sklearn_linear = helpers.optional_import("sklearn.linear_model", "cls::train")
    sklearn_tree = helpers.optional_import("sklearn.tree", "cls::train")

    run = disk.Run(cfg.run)

    def split(shards: pathlib.Path, class_names=None):
        x_all = _image_features(run, shards, cfg.patch_agg)
        cols, labels = load_image_labels(shards)
        assert cfg.task.source_col in labels, (
            f"Source column '{cfg.task.source_col}' not in {cols}"
        )
        y, names = cfg.task.apply(labels[cfg.task.source_col], class_names=class_names)
        keep = y >= 0
        return x_all[keep], y[keep], names

    train_x, train_y, class_names = split(cfg.train_shards)
    test_x, test_y, _ = split(cfg.test_shards, class_names=class_names)
    assert len(np.unique(train_y)) >= 2, "Need at least two classes after grouping."
    logger.info(
        "Task '%s': %d classes; train %d, test %d images.",
        cfg.task.name, len(class_names), len(train_y), len(test_y),
    )

    if isinstance(cfg.cls, SparseLinear):
        clf = sklearn_linear.LogisticRegression(
            penalty="l1", C=cfg.cls.C, solver="liblinear", max_iter=cfg.cls.max_iter,
        )
    else:
        depth = None if cfg.cls.max_depth < 0 else cfg.cls.max_depth
        clf = sklearn_tree.DecisionTreeClassifier(max_depth=depth, random_state=0)
    clf.fit(train_x, train_y)

    test_pred = clf.predict(test_x)
    test_acc = float((test_pred == test_y).mean()) if len(test_y) else float("nan")
    _, importance = extract_feature_ranking(clf)
    n_used = int((importance > 0).sum())
    logger.info(
        "Trained %s: train acc %.3f, test acc %.3f, %d features used.",
        cfg.cls.key, float(clf.score(train_x, train_y)), test_acc, n_used,
    )

    out = ckpt_fpath(run, cfg)
    out.parent.mkdir(parents=True, exist_ok=True)
    header = {
        "cfg": dataclasses.asdict(cfg),
        "test_acc": test_acc,
        "n_classes": len(class_names),
        "class_names": class_names,
    }
    with open(out, "wb") as fd:
        fd.write((json.dumps(header, default=str) + "\n").encode())
        pickle.dump(
            {"classifier": clf, "test_pred": test_pred, "test_y": test_y}, fd
        )
    logger.info("Saved checkpoint to %s", out)
    return 0


def load_classifier_checkpoint(fpath: pathlib.Path):
    """(header, payload) from a header+pickle checkpoint."""
    with open(fpath, "rb") as fd:
        header = json.loads(fd.readline())
        payload = pickle.load(fd)
    return header, payload


def extract_feature_ranking(clf) -> tuple[np.ndarray, np.ndarray]:
    """(ranked latent ids desc, importance per latent): sum |coef| across
    classes for linear heads, tree feature_importances_ otherwise (reference
    classification.py:622-648)."""
    if hasattr(clf, "coef_"):
        importance = np.abs(np.asarray(clf.coef_)).sum(axis=0)
    else:
        importance = np.asarray(clf.feature_importances_)
    return np.argsort(-importance, kind="stable"), importance


def latent_class_matrix(clf, n_classes: int) -> np.ndarray:
    """(n_classes, d_sae) signed coefficient matrix of a linear head, rows
    aligned to the class-name index space: clf.coef_ rows follow
    clf.classes_, which may cover only the classes PRESENT in the train
    split (absent classes stay all-zero), and a binary fit has ONE row
    scoring classes_[1] (expanded into -w/+w)."""
    raw = np.asarray(clf.coef_)
    fitted = np.asarray(clf.classes_, dtype=int)
    if raw.shape[0] == 1 and len(fitted) == 2:
        raw = np.vstack([-raw[0], raw[0]])
    out = np.zeros((n_classes, raw.shape[1]), dtype=np.float64)
    for row, cls_idx in zip(raw, fitted):
        if 0 <= cls_idx < n_classes:
            out[cls_idx] = row
    return out


# ---------------------------------------------------------------------------
# Audit stage: per-latent grounding AP against segmentation masks
# ---------------------------------------------------------------------------


def tie_aware_ap(
    acts_n: np.ndarray, labels_onehot_nc: np.ndarray, n_pos_c: np.ndarray
) -> np.ndarray:
    """Exact expected AP over all permutations of tied scores for ONE latent
    (McSherry & Najork 2008; reference compute_ap_for_latent :650-736).

    The reference walks tie groups in a Python double loop; here the
    per-group sums collapse analytically: for a group of size n starting at
    0-indexed t with r positives (per class) and R cumulative positives
    before it,

        contribution = (r/n) [ (R+1) H + (r-1)/(n-1) (n - (t+1) H) ],
        H = sum_{j=t+1}^{t+n} 1/j,

    (the second term vanishes when n == 1), so the whole computation is
    np.add.reduceat over groups + a harmonic-number lookup. O(n log n) for
    the sort, O(groups * classes) after.
    """
    n = acts_n.shape[0]
    order = np.argsort(-acts_n, kind="stable")
    scores = acts_n[order]
    labels = labels_onehot_nc[order].astype(np.float64)

    starts = np.flatnonzero(np.concatenate([[True], scores[:-1] != scores[1:]]))
    sizes = np.diff(np.concatenate([starts, [n]])).astype(np.float64)

    r_gc = np.add.reduceat(labels, starts, axis=0)  # positives per group
    before_gc = np.cumsum(r_gc, axis=0) - r_gc  # exclusive cumulative

    harmonic = np.concatenate([[0.0], np.cumsum(1.0 / np.arange(1, n + 1))])
    h_g = harmonic[(starts + sizes.astype(int))] - harmonic[starts]

    t1 = starts + 1.0  # (t+1), 1-indexed group start
    tie_term = np.divide(
        r_gc - 1.0, (sizes - 1.0)[:, None],
        out=np.zeros_like(r_gc), where=(sizes > 1.0)[:, None],
    ) * (sizes - t1 * h_g)[:, None]
    contrib = (r_gc / sizes[:, None]) * ((before_gc + 1.0) * h_g[:, None] + tie_term)

    ap = contrib.sum(axis=0) / np.clip(n_pos_c, 1.0, None)
    return np.where(n_pos_c > 0, ap, 0.0).astype(np.float32)


def ap_batched(
    acts_nb: np.ndarray, labels_onehot_nc: np.ndarray, n_pos_c: np.ndarray
) -> np.ndarray:
    """Standard (non-tie-aware) AP for a batch of latents vs all seg classes
    (reference compute_ap_batched :739-798). Returns (batch, n_seg_classes)."""
    n, b = acts_nb.shape
    ranks = np.arange(1, n + 1, dtype=np.float64)[:, None]
    n_pos_safe = np.clip(n_pos_c, 1.0, None)
    out = np.zeros((b, labels_onehot_nc.shape[1]), dtype=np.float32)
    order_nb = np.argsort(-acts_nb, axis=0, kind="stable")
    for j in range(b):
        labels = labels_onehot_nc[order_nb[:, j]].astype(np.float64)
        tp = labels.cumsum(axis=0)
        out[j] = ((tp / ranks) * labels).sum(axis=0) / n_pos_safe
    out[:, n_pos_c <= 0] = 0.0
    return out


@dataclasses.dataclass(frozen=True)
class AuditConfig:
    """Audit stage config (reference EvalConfig, classification.py:582-620):
    best-class AP for the union of each checkpoint's top-`max_budget` latents,
    then Yield@B per budget."""

    run: pathlib.Path = pathlib.Path("./runs/abcdefg")
    test_shards: pathlib.Path = pathlib.Path("./shards/abcdef01")
    cls_checkpoints: tuple[pathlib.Path, ...] = ()
    max_budget: int = 1000
    tau: float = 0.3
    """Grounding threshold: a latent is grounded if best-class AP >= tau."""
    budgets: tuple[int, ...] = (3, 10, 30, 100, 300, 1000)
    ignore_label_ids: tuple[int, ...] = (0,)
    batch_size: int = 64
    debug: bool = False


def audit_worker_fn(cfg: AuditConfig) -> dict[str, object]:
    """Reference eval_worker_fn (classification.py:819-1040): amortizes the
    per-latent AP over the union of all checkpoints' top features, then scores
    each checkpoint's ranking with Yield@B and AUC_B."""
    assert cfg.cls_checkpoints, "No classifier checkpoints provided."
    for b in cfg.budgets:
        assert b <= cfg.max_budget, f"Budget {b} exceeds max_budget={cfg.max_budget}."

    run = disk.Run(cfg.run)
    art_dir = run.inference / cfg.test_shards.name

    rankings = []
    for fpath in cfg.cls_checkpoints:
        header, payload = load_classifier_checkpoint(pathlib.Path(fpath))
        ranked_i, importance = extract_feature_ranking(payload["classifier"])
        rankings.append((pathlib.Path(fpath), header, ranked_i, importance))

    d_sae = len(rankings[0][2])
    union = sorted({
        int(s) for _, _, ranked_i, _ in rankings for s in ranked_i[: cfg.max_budget]
    })
    logger.info(
        "Union of top-%d latents over %d checkpoints: %d/%d.",
        cfg.max_budget, len(rankings), len(union), d_sae,
    )

    md = Metadata.load(cfg.test_shards)
    n_patches = md.n_examples * md.content_tokens_per_example
    labels_flat = np.asarray(
        np.memmap(
            cfg.test_shards / "labels.bin", mode="r", dtype=np.uint8,
            shape=(md.n_examples, md.content_tokens_per_example),
        )
    ).reshape(-1)
    seg_classes = [
        int(c) for c in np.unique(labels_flat) if c not in cfg.ignore_label_ids
    ]
    assert seg_classes, "No segmentation classes left after ignore_label_ids."
    onehot = np.zeros((n_patches, len(seg_classes)), dtype=np.float32)
    for i, c in enumerate(seg_classes):
        onehot[:, i] = labels_flat == c
    n_pos = onehot.sum(axis=0)

    acts_csc = scipy.sparse.load_npz(art_dir / "token_acts.npz").tocsc()
    assert acts_csc.shape == (n_patches, d_sae), (acts_csc.shape, n_patches, d_sae)

    best_ap = np.full(d_sae, np.nan, dtype=np.float32)
    best_class = np.full(d_sae, -1, dtype=np.int32)
    for start, end in helpers.batched_idx(len(union), cfg.batch_size):
        cols = union[start:end]
        acts_nb = np.asarray(acts_csc[:, cols].todense(), dtype=np.float32)
        # Tie-aware AP, NOT the standard formula: SAE activations are ~99%
        # exact zeros, so every latent has one giant tie group and standard
        # AP would depend on arbitrary dataset patch order (the reference
        # uses compute_ap_batched here and accepts that bias,
        # classification.py:739-755 "ties are rare", false for SAE codes).
        ap_bc = np.stack(
            [tie_aware_ap(acts_nb[:, j], onehot, n_pos) for j in range(len(cols))]
        )
        best = np.argmax(ap_bc, axis=1)
        best_ap[cols] = ap_bc[np.arange(len(cols)), best]
        best_class[cols] = np.asarray(seg_classes)[best]

    np.save(art_dir / "audit_ap_s.npy", best_ap)
    np.save(art_dir / "audit_best_class_s.npy", best_class)

    per_ckpt = []
    for fpath, header, ranked_i, importance in rankings:
        yield_at_b = {}
        for b in cfg.budgets:
            top_ap = best_ap[ranked_i[:b]]
            yield_at_b[str(b)] = float(np.nansum(top_ap >= cfg.tau) / b)
        auc_b = float(sum(yield_at_b.values()) / len(yield_at_b))
        per_ckpt.append({
            "cls_checkpoint": str(fpath),
            "cls_type": header["cfg"]["cls"]["key"],
            "test_acc": header.get("test_acc"),
            "n_nonzero_importance": int((importance > 0).sum()),
            "tau": cfg.tau,
            "budgets": list(cfg.budgets),
            "yield_at_b": yield_at_b,
            "auc_b": auc_b,
        })
        logger.info("%s: AUC_B=%.4f", fpath.name, auc_b)

    results = {
        "run": str(cfg.run),
        "test_shards": str(cfg.test_shards),
        "max_budget": cfg.max_budget,
        "n_features_evaluated": len(union),
        "n_seg_classes": len(seg_classes),
        "ignore_label_ids": list(cfg.ignore_label_ids),
        "d_sae": d_sae,
        "classifiers": per_ckpt,
    }
    out_fpath = art_dir / "audit_results.json"
    out_fpath.write_text(json.dumps(results, indent=2))
    logger.info("Saved %d classifier audits to %s", len(per_ckpt), out_fpath)
    return results


# ---------------------------------------------------------------------------
# Image-level classification eval (AP on the head's own task)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    run: pathlib.Path = pathlib.Path("./runs/abcdefg")
    test_shards: pathlib.Path = pathlib.Path("./shards/abcdef01")
    task: LabelGrouping = dataclasses.field(default_factory=LabelGrouping)
    patch_agg: PatchAgg = PatchAgg.MAX
    cls: DecisionTree | SparseLinear = SparseLinear()
    top_features: int = 20
    """How many most-important features to report per class."""


def eval_worker_fn(cfg: EvalConfig) -> dict[str, object]:
    """Image-level accuracy/AP of a trained head on the test shards."""
    from . import metrics as td_metrics

    run = disk.Run(cfg.run)
    train_like = TrainConfig(
        run=cfg.run, test_shards=cfg.test_shards, task=cfg.task,
        patch_agg=cfg.patch_agg, cls=cfg.cls,
    )
    header, payload = load_classifier_checkpoint(ckpt_fpath(run, train_like))
    clf = payload["classifier"]
    class_names = header["class_names"]

    x = _image_features(run, cfg.test_shards, cfg.patch_agg)
    _, labels = load_image_labels(cfg.test_shards)
    y, _ = cfg.task.apply(
        labels[cfg.task.source_col], class_names=list(class_names)
    )
    keep = y >= 0
    x, y = x[keep], y[keep]

    n_classes = len(class_names)
    onehot = np.zeros((len(y), n_classes), dtype=np.float32)
    onehot[np.arange(len(y)), y] = 1.0
    if hasattr(clf, "predict_proba"):
        raw_scores = np.asarray(clf.predict_proba(x))
        scores = np.zeros((len(y), n_classes), dtype=np.float64)
        scores[:, np.asarray(clf.classes_, dtype=int)] = raw_scores
    else:
        scores = onehot * 0.0

    ap = td_metrics.average_precision(scores, onehot)
    ranked_i, _ = extract_feature_ranking(clf)
    top_per_class = [ranked_i[: cfg.top_features].tolist()] * n_classes
    if hasattr(clf, "coef_"):
        # Absent classes keep the global-ranking fallback (their aligned row
        # is all-zero, which carries no per-class signal).
        aligned = latent_class_matrix(clf, n_classes)
        # The binary expansion assigns rows to BOTH classes_[0] and
        # classes_[1], so classes_ is exactly the covered set.
        fitted = set(np.asarray(clf.classes_, dtype=int).tolist())
        for cls_idx in range(n_classes):
            if cls_idx in fitted:
                top_per_class[cls_idx] = (
                    np.argsort(-np.abs(aligned[cls_idx]))[: cfg.top_features]
                    .tolist()
                )
    results = {
        "accuracy": float((clf.predict(x) == y).mean()),
        "mean_ap": float(np.nanmean(ap)),
        "ap_per_class": ap.tolist(),
        "class_names": class_names,
        "top_features_per_class": top_per_class,
        "n_test": int(len(y)),
    }
    out_fpath = (
        run.inference / cfg.test_shards.name / f"classification_{cfg.task.name}.json"
    )
    out_fpath.write_text(json.dumps(results, indent=2))
    logger.info("Eval acc %.3f, mAP %.3f; wrote %s", results["accuracy"], results["mean_ap"], out_fpath)
    return results


# ---------------------------------------------------------------------------
# CLIs (sweep-capable, reference train_cli :497 / eval_cli :1042)
# ---------------------------------------------------------------------------


def _expand(cfg, default, sweep: pathlib.Path | None):
    if sweep is None:
        return [cfg]
    sweep_dcts = configs.load_sweep(sweep)
    cfgs, errs = configs.load_cfgs(cfg, default=default, sweep_dcts=sweep_dcts)
    for err in errs:
        logger.warning("Error in config: %s", err)
    return cfgs


def train_cli(cfg: TrainConfig, sweep: pathlib.Path | None = None) -> None:
    logging.basicConfig(level=logging.INFO)
    for i, c in enumerate(_expand(cfg, TrainConfig(), sweep), start=1):
        logger.info("Running train config %d.", i)
        train_worker_fn(c)


def eval_cli(cfg: EvalConfig, sweep: pathlib.Path | None = None) -> None:
    logging.basicConfig(level=logging.INFO)
    for i, c in enumerate(_expand(cfg, EvalConfig(), sweep), start=1):
        logger.info("Running eval config %d.", i)
        eval_worker_fn(c)


def audit_cli(cfg: AuditConfig) -> None:
    logging.basicConfig(level=logging.INFO)
    audit_worker_fn(cfg)
