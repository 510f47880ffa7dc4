"""Research-analysis layer: runs root -> validated tidy DataFrame
(counterpart of contrib/trait_discovery/src/tdiscovery/analysis.py; reference
probe-results notebook `contrib/trait_discovery/notebooks/metrics.py:55-340`):
discover every run with 1-D probe metrics, pair its train/val splits, join
the tracker record, and derive the research metrics (probe R, grounding
coverage, purity, weight-sign fractions) into ONE schema-validated pandas
DataFrame that the figure battery consumes.

As in contrib, run config and summary come from the offline tracker
(`utils.wandb`'s local layout: config.json + summary.json per run id) with
the run dir's config.json as fallback, and the schema check is a small
hand-rolled table (`SCHEMA` + `validate_df`): a column with the wrong dtype
or an out-of-range value raises with a named column. The dataset config
that a shard directory embeds is read with the shard protocol's restricted
unpickler. Host-only; pandas is imported where a frame is built.
"""

import dataclasses
import json
import logging
import pathlib

import numpy as np

from .. import disk, helpers
from ..data import Metadata, datasets, shards

logger = logging.getLogger("td.analysis")

TAUS = (0.3, 0.5, 0.7)
PURITY_K = 16


# ---------------------------------------------------------------------------
# Shard-level helpers
# ---------------------------------------------------------------------------


def baseline_ce(shards_dir: pathlib.Path) -> np.ndarray:
    """Per-class binary cross entropy of the label prevalence (the
    no-information probe floor; reference notebooks/metrics.py:1412-1429)."""
    md = Metadata.load(shards_dir)
    labels = np.memmap(
        shards_dir / "labels.bin",
        mode="r",
        dtype=np.uint8,
        shape=(md.n_examples, md.content_tokens_per_example),
    )
    flat = np.asarray(labels).reshape(-1)
    n_classes = int(flat.max()) + 1
    prob = np.bincount(flat, minlength=n_classes) / flat.size
    with np.errstate(divide="ignore", invalid="ignore"):
        ce = -(prob * np.log(prob) + (1 - prob) * np.log(1 - prob))
    return np.nan_to_num(ce, nan=0.0, posinf=0.0)


def _load_pt_array(fpath: pathlib.Path) -> np.ndarray:
    """A 1-D float array from an inference .pt artifact (the torch.save
    format of framework.inference._torch_save)."""
    import torch

    return (
        torch.load(fpath, weights_only=True, map_location="cpu").numpy().reshape(-1)
    )


def load_freqs(run: "disk.Run", shards_name: str) -> np.ndarray:
    """Per-latent firing frequency from a run's inference sparsity.pt
    (reference notebooks/008_pe.py load_freqs :665-681)."""
    return _load_pt_array(run.inference / shards_name / "sparsity.pt")


def load_mean_values(run: "disk.Run", shards_name: str) -> np.ndarray:
    """Per-latent mean activation value from mean_values.pt (reference
    notebooks/008_pe.py load_mean_values :682-699)."""
    return _load_pt_array(run.inference / shards_name / "mean_values.pt")


def purity_at(
    top_labels_dk: np.ndarray,
    best_i: np.ndarray,
    *,
    k: int,
    nnz_per_latent: np.ndarray | None = None,
) -> float:
    """Mean purity of the best latents' top-k activating patch labels: for
    each class's best latent, the modal-label fraction among its k strongest
    patches (reference notebooks/008_pe.py get_mean_purity :461-471).

    A latent with fewer than k nonzero activations gets arbitrary zero-valued
    tokens in its "top" (csr_topk contract) — typically consecutive
    same-label patches — inflating purity to ~1.0, so when `nnz_per_latent`
    is given, classes whose best latent fires < k times are excluded (NaN if
    none remain). Pass it whenever the metrics artifact carries it
    (`tdiscovery.metrics` writes `nnz_per_latent`)."""
    assert top_labels_dk.ndim == 2
    assert top_labels_dk.shape[1] >= k, (top_labels_dk.shape, k)
    best_i = np.asarray(best_i)
    if nnz_per_latent is not None:
        valid = np.asarray(nnz_per_latent)[best_i] >= k
        if not valid.any():
            return float("nan")
        best_i = best_i[valid]
    labels_ck = top_labels_dk[best_i, :k]
    _, counts = mode(labels_ck, axis=1)
    return float((counts / k).mean())


def probe_split_label(shards_dir: pathlib.Path) -> str | None:
    """"train"/"val" from the dataset config a shard dump embeds, or None."""
    try:
        md = Metadata.load(shards_dir)
        data_cfg = md.make_data_cfg()
    except Exception as err:
        logger.debug("No metadata split for %s: %s", shards_dir, err)
        return None
    split = str(getattr(data_cfg, "split", "")).lower()
    if split in {"train", "training"}:
        return "train"
    if split in {"val", "validation"}:
        return "val"
    return None


def get_model_key(metadata: dict) -> str:
    """Human-readable backbone name from shard metadata (reference
    notebooks/metrics.py:1525-1558; the table covers the package's model families)."""
    family = next(
        (metadata[k] for k in ("vit_family", "model_family", "family") if k in metadata),
        "?",
    )
    ckpt = str(
        next((metadata[k] for k in ("vit_ckpt", "model_ckpt", "ckpt") if k in metadata), "?")
    )
    named = {
        ("dinov2", "dinov2_vitb14_reg"): "DINOv2 ViT-B/14 (reg)",
        ("dinov2", "dinov2_vitl14_reg"): "DINOv2 ViT-L/14 (reg)",
        ("clip", "ViT-B-16/openai"): "CLIP ViT-B/16",
        ("clip", "hf-hub:imageomics/bioclip"): "BioCLIP ViT-B/16",
        ("clip", "hf-hub:imageomics/bioclip-2"): "BioCLIP 2 ViT-L/14",
        ("siglip", "hf-hub:timm/ViT-L-16-SigLIP2-256"): "SigLIP2 ViT-L/16",
    }
    if (family, ckpt) in named:
        return named[(family, ckpt)]
    if family == "dinov3":
        for size in ("l", "b", "s"):
            if f"vit{size}" in ckpt:
                return f"DINOv3 ViT-{size.upper()}/16"
    if family == "fake-clip":
        return "Fake CLIP (test)"
    logger.info("Unknown model: %s", (family, ckpt))
    return ckpt


def get_data_key(metadata: dict) -> str | None:
    """Human-readable dataset name from the pickled dataset config embedded
    in shard metadata (reference notebooks/metrics.py:1561-1578)."""
    try:
        data_cfg = shards.decode_dataset_cfg(str(metadata["data"]))
    except Exception:
        return None
    root = str(getattr(data_cfg, "root", ""))
    split = getattr(data_cfg, "split", None)
    if isinstance(data_cfg, datasets.ImgSegFolder) and "ADE" in root:
        return f"ADE20K/{split}"
    if isinstance(data_cfg, datasets.Imagenet):
        return f"IN1K/{split}"
    if isinstance(data_cfg, datasets.ImgFolder) and "fish-vista" in root:
        return "FishVista (Img)"
    if isinstance(data_cfg, (datasets.FakeImg, datasets.FakeImgSeg)):
        return "Fake (test)"
    logger.info("Unknown data: %r", data_cfg)
    return None


def mode(a: np.ndarray, axis: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(modal value, count) along `axis` — scipy.stats.mode-alike over small
    integer labels (reference notebooks/metrics.py:1902-1920)."""
    a = np.asarray(a)
    a = np.moveaxis(a, axis, -1)
    flat = a.reshape(-1, a.shape[-1]).astype(np.int64)
    n_bins = int(flat.max()) + 1 if flat.size else 1
    counts = np.stack([np.bincount(row, minlength=n_bins) for row in flat])
    vals = counts.argmax(axis=1)
    return vals.reshape(a.shape[:-1]), counts.max(axis=1).reshape(a.shape[:-1])


# ---------------------------------------------------------------------------
# Tracker / config flattening
# ---------------------------------------------------------------------------


def _flatten(prefix: str, obj, out: dict) -> None:
    if isinstance(obj, dict):
        for key, value in obj.items():
            _flatten(f"{prefix}/{key}" if prefix else str(key), value, out)
    elif isinstance(obj, (str, int, float, bool)) or obj is None:
        out[prefix] = obj


def tracker_record(run_id: str, tracker_root: pathlib.Path | None) -> dict:
    """Flattened `summary/...` + tag keys from the offline JSONL tracker
    (the offline counterpart of the reference's `get_wandb_run`,
    notebooks/metrics.py:1468-1520)."""
    row: dict[str, object] = {}
    if tracker_root is None:
        return row
    for project_dir in sorted(p for p in tracker_root.glob("*") if p.is_dir()):
        run_dir = project_dir / run_id
        summary_fpath = run_dir / "summary.json"
        if not summary_fpath.exists():
            continue
        try:
            summary = json.loads(summary_fpath.read_text())
        except json.JSONDecodeError:
            continue
        _flatten("summary", summary, row)
        cfg_fpath = run_dir / "config.json"
        if cfg_fpath.exists():
            try:
                row["tags"] = tuple(json.loads(cfg_fpath.read_text()).get("tags", []))
            except json.JSONDecodeError:
                pass
        break
    return row


def run_record(run: "disk.Run", tracker_root: pathlib.Path | None) -> dict:
    """One flattened record per run: `config/...` from the run dir's own
    config.json, `summary/...` from the tracker, plus model/data keys."""
    row: dict[str, object] = {"run_id": run.run_id}
    cfg = run.config
    _flatten("config", cfg, row)
    row.update(tracker_record(run.run_id, tracker_root))

    try:
        md = dataclasses.asdict(Metadata.load(run.train_shards))
    except Exception:
        md = {}
    md = {k: (str(v) if isinstance(v, pathlib.Path) else v) for k, v in md.items()}
    row["model_key"] = get_model_key(md) if md else "?"
    row["data_key"] = get_data_key(md) if md else None
    objective = cfg.get("objective", {})
    row["objective"] = (
        "matryoshka"
        if isinstance(objective, dict) and objective.get("n_prefixes", 1) > 1
        else "vanilla"
    )
    return row


# ---------------------------------------------------------------------------
# Probe-results DataFrame (the notebook's core artifact)
# ---------------------------------------------------------------------------

SCHEMA: dict[str, tuple[str, tuple[float, float] | None]] = {
    # column: (dtype kind, optional inclusive [lo, hi] range)
    "run_id": ("str", None),
    "model": ("str", None),
    "layer": ("int", (0, float("inf"))),
    "objective": ("str", None),
    "train_nmse": ("float", None),
    "val_nmse": ("float", None),
    "frac_w_neg": ("float", (0, 1)),
    "frac_best_w_neg": ("float", (0, 1)),
    "train_probe_shards": ("str", None),
    "train_probe_ce": ("float", (0, float("inf"))),
    "train_baseline_ce": ("float", (0, float("inf"))),
    "train_probe_r": ("float", None),
    "val_probe_shards": ("str", None),
    "val_probe_ce": ("float", (0, float("inf"))),
    "val_baseline_ce": ("float", (0, float("inf"))),
    "val_probe_r": ("float", None),
    "val_mean_ap": ("float", (0, 1)),
    "val_mean_prec": ("float", (0, 1)),
    "val_mean_recall": ("float", (0, 1)),
    "val_mean_f1": ("float", (0, 1)),
    f"val_mean_purity_{PURITY_K}": ("float", (0, 1)),
    "cov_at_0_3": ("float", (0, 1)),
    "cov_at_0_5": ("float", (0, 1)),
    "cov_at_0_7": ("float", (0, 1)),
}

_KINDS = {"str": "OU", "int": "iu", "float": "f"}


def validate_df(df, schema: dict = SCHEMA) -> None:
    """Pandera-style structural check: every schema column present, dtype of
    the right kind, values within range. Raises ValueError naming the first
    offending column."""
    for col, (kind, rng) in schema.items():
        if col not in df.columns:
            raise ValueError(f"schema: missing column {col!r}")
        if len(df) == 0:
            continue
        if df[col].dtype.kind not in _KINDS[kind]:
            raise ValueError(
                f"schema: column {col!r} has dtype {df[col].dtype}, wanted {kind}"
            )
        if rng is not None:
            lo, hi = rng
            vals = df[col].to_numpy()
            bad = (vals < lo) | (vals > hi)
            if bad.any():
                raise ValueError(
                    f"schema: column {col!r} out of [{lo}, {hi}]: "
                    f"{vals[bad][:5].tolist()}"
                )


def _probe_metric_fpaths(run_dir: pathlib.Path) -> list[pathlib.Path]:
    inference = run_dir / "inference"
    if not inference.is_dir():
        return []
    return sorted(
        fp
        for shard_dir in inference.iterdir()
        if shard_dir.is_dir()
        for fp in [shard_dir / "probe1d_metrics.npz"]
        if fp.is_file()
    )


def _make_baseline_ce_cache():
    cache: dict[str, np.ndarray] = {}

    def cached(shards_dir: pathlib.Path) -> np.ndarray:
        key = shards_dir.name
        if key not in cache:
            cache[key] = baseline_ce(shards_dir)
        return cache[key]

    return cached


def _probe_split_map(
    run: "disk.Run", fpaths: list[pathlib.Path],
    shards_root: pathlib.Path,
) -> dict[str, tuple[pathlib.Path, str]] | None:
    """{'train'/'val': (metrics_fpath, shard_id)}, or None when the run does
    not have exactly one probe-metrics artifact per split."""
    split_map: dict[str, tuple[pathlib.Path, str]] = {}
    for fpath in fpaths:
        shard_id = fpath.parent.name
        shards_dir = shards_root / shard_id
        if not shards_dir.exists():
            logger.info("Skipping %s: shards %s missing.", run.run_id, shard_id)
            continue
        split = probe_split_label(shards_dir)
        if split is None:
            continue
        if split in split_map:
            logger.info("Skipping %s: duplicate %s probes.", run.run_id, split)
            return None
        split_map[split] = (fpath, shard_id)
    if {"train", "val"} - set(split_map):
        logger.info(
            "Skipping %s: need train+val probes, have %s.",
            run.run_id,
            sorted(split_map),
        )
        return None
    return split_map


def _downstream_cols(
    run: "disk.Run",
    split_map: dict[str, tuple[pathlib.Path, str]],
    shards_root: pathlib.Path,
    cached_baseline,
) -> dict[str, object]:
    """The shared downstream-quality columns of one probe-results row: pick
    the best latent per class by TRAIN probe loss, probe CE / probe R on both
    splits, reconstruction NMSE from metrics.json, AP/precision/recall/F1/
    coverage, and purity@16."""
    train_fpath, train_shard = split_map["train"]
    val_fpath, val_shard = split_map["val"]

    with np.load(train_fpath) as fd:
        train_loss = fd["loss"]
        w = fd["weights"]
    with np.load(val_fpath) as fd:
        val_loss = fd["loss"]
    assert train_loss.ndim == 2 and train_loss.shape == val_loss.shape

    n_latents, n_classes = train_loss.shape
    best_i = np.argmin(train_loss, axis=0)
    cols = np.arange(n_classes)
    train_ce = float(train_loss[best_i, cols].mean())
    val_ce = float(val_loss[best_i, cols].mean())
    train_base = float(cached_baseline(shards_root / train_shard).mean())
    val_base = float(cached_baseline(shards_root / val_shard).mean())

    def nmse(shard_id: str) -> float:
        fpath = run.inference / shard_id / "metrics.json"
        if fpath.is_file():
            return float(json.loads(fpath.read_text())["normalized_mse"])
        # Missing reconstruction metrics are MISSING, not "NMSE exactly 1.0"
        # — a fabricated 1.0 is indistinguishable from a terrible SAE in
        # every downstream figure; NaN drops out of dropna/nanmean.
        return float("nan")

    mean_ap = mean_prec = mean_recall = mean_f1 = purity = 0.0
    n_pos = None
    cov = {f"cov_at_{tau}".replace(".", "_"): 0.0 for tau in TAUS}
    ap_fpath = run.inference / val_shard / (
        f"probe1d_metrics__train-{train_shard}.npz"
    )
    if ap_fpath.is_file():
        with np.load(ap_fpath) as fd:
            ap_c = fd["ap"]
            mean_prec = float(fd["precision"].mean())
            mean_recall = float(fd["recall"].mean())
            mean_f1 = float(fd["f1"].mean())
            top_labels = fd["top_labels"] if "top_labels" in fd else None
            nnz = fd["nnz_per_latent"] if "nnz_per_latent" in fd else None
            n_pos = fd["n_pos_per_class"] if "n_pos_per_class" in fd else None
        # Classes with no val positives are stored as 0 in the npz
        # (nan_to_num); exclude them from the means like trait_metrics.json's
        # nanmean does, so the run's two artifacts agree.
        present = (
            np.asarray(n_pos) > 0 if n_pos is not None
            else np.ones(ap_c.shape, dtype=bool)
        )
        ap_present = ap_c[present]
        mean_ap = float(ap_present.mean()) if ap_present.size else 0.0
        cov = {
            f"cov_at_{tau}".replace(".", "_"): (
                float((ap_present > tau).mean()) if ap_present.size else 0.0
            )
            for tau in TAUS
        }
        if top_labels is not None and top_labels.shape[1] >= PURITY_K:
            # NaN = unmeasurable (no best latent fires >= k times); do NOT
            # conflate with worst-possible purity 0.0.
            purity = purity_at(
                top_labels, best_i, k=PURITY_K, nnz_per_latent=nnz
            )

    return {
        "train_nmse": nmse(train_shard),
        "val_nmse": nmse(val_shard),
        "frac_w_neg": float((w < 0).mean()),
        "frac_best_w_neg": float((w[best_i, cols] < 0).mean()),
        "train_probe_shards": train_shard,
        "train_probe_ce": train_ce,
        "train_baseline_ce": train_base,
        "train_probe_r": 1 - train_ce / train_base,
        "val_probe_shards": val_shard,
        "val_probe_ce": val_ce,
        "val_baseline_ce": val_base,
        "val_probe_r": 1 - val_ce / val_base,
        "val_mean_ap": mean_ap,
        "val_mean_prec": mean_prec,
        "val_mean_recall": mean_recall,
        "val_mean_f1": mean_f1,
        f"val_mean_purity_{PURITY_K}": purity,
        **cov,
    }


def load_probe_results_df(
    runs_root: pathlib.Path,
    shards_root: pathlib.Path,
    *,
    tracker_root: pathlib.Path | None = None,
    validate: bool = True,
):
    """One row per run that has BOTH train- and val-split probe metrics
    (reference load_probe_results_df, notebooks/metrics.py:163-340).

    Per run: pick the best latent per class by TRAIN probe loss, score both
    splits with it (probe CE), normalize against the prevalence baseline
    (probe R = 1 - CE/CE_baseline), read reconstruction NMSE from
    metrics.json, AP/precision/recall/F1/coverage from the
    probe1d_metrics__train-*.npz artifact, and purity@16 of the best
    latents' top-activating patch labels.
    """
    pd = helpers.optional_import("pandas", "tdiscovery.analysis")

    runs_root = pathlib.Path(runs_root)
    shards_root = pathlib.Path(shards_root)
    rows = []
    cached_baseline = _make_baseline_ce_cache()

    for run_dir in sorted(p for p in runs_root.iterdir() if p.is_dir()):
        fpaths = _probe_metric_fpaths(run_dir)
        if not fpaths:
            continue
        try:
            run = disk.Run(run_dir)
        except (ValueError, FileNotFoundError) as err:
            logger.info("Skipping %s: %s", run_dir.name, err)
            continue

        split_map = _probe_split_map(run, fpaths, shards_root)
        if split_map is None:
            continue

        try:
            record = run_record(run, tracker_root)
        except FileNotFoundError as err:
            # Baseline runs (checkpoint/baseline.pt, no config.json) share the
            # runs root; they belong to load_baseline_probe_results_df.
            logger.info("Skipping %s: %s", run.run_id, err)
            continue

        raw_layer = record.get("config/val_data/layer", 0) or 0
        try:
            layer = int(raw_layer)
        except (TypeError, ValueError):
            # layer='all' (ShuffledConfig supports it) has no single-layer
            # row semantics; skip the run instead of killing the whole frame.
            logger.info("Skipping %s: non-integer layer %r.", run.run_id, raw_layer)
            continue
        rows.append({
            "run_id": run.run_id,
            "model": record["model_key"],
            "layer": layer,
            "objective": record["objective"],
            "sae_data": record.get("data_key"),
            "sae_val_mse": record.get("summary/eval/mse"),
            "sae_val_l0": record.get("summary/eval/l0"),
            "sae_val_l1": record.get("summary/eval/l1"),
            **_downstream_cols(run, split_map, shards_root, cached_baseline),
        })

    df = pd.DataFrame(rows)
    if validate and len(df):
        validate_df(df)
    logger.info("Assembled probe-results df: %d runs.", len(df))
    return df


# Reference method-name normalization (notebooks/baselines.py:276-289).
_BASELINE_METHOD_NAMES = {"kmeans": "k-means", "pca": "pca", "semi-nmf": "semi-nmf"}


def load_baseline_probe_results_df(
    runs_root: pathlib.Path,
    shards_root: pathlib.Path,
    *,
    validate: bool = True,
):
    """The probe-results frame for BASELINE dictionary runs (k-means / PCA /
    semi-NMF; reference notebooks/baselines.py:139-328): the same downstream
    probe columns as `load_probe_results_df`, plus the method identity and its
    fit-side metrics — `fit_val_mse` (inertia for k-means, reconstruction MSE
    otherwise) and `fit_val_l0` (1 for k-means's one-hot codes, else the
    dictionary size k). Runs are recognized by their `checkpoint/baseline.pt`
    header instead of a wandb config."""
    pd = helpers.optional_import("pandas", "tdiscovery.analysis")

    runs_root = pathlib.Path(runs_root)
    shards_root = pathlib.Path(shards_root)
    rows = []
    cached_baseline = _make_baseline_ce_cache()

    for run_dir in sorted(p for p in runs_root.iterdir() if p.is_dir()):
        fpaths = _probe_metric_fpaths(run_dir)
        ckpt_fpath = run_dir / "checkpoint" / "baseline.pt"
        if not fpaths or not ckpt_fpath.is_file():
            continue
        try:
            run = disk.Run(run_dir)
        except (ValueError, FileNotFoundError) as err:
            logger.info("Skipping %s: %s", run_dir.name, err)
            continue

        split_map = _probe_split_map(run, fpaths, shards_root)
        if split_map is None:
            continue

        with open(ckpt_fpath, "rb") as fd:
            header = json.loads(fd.readline())
        raw_method = header.get("method", "?")
        method = _BASELINE_METHOD_NAMES.get(raw_method)
        if method is None:
            logger.info("Skipping %s: unknown method %r.", run.run_id, raw_method)
            continue
        metrics = header.get("metrics", {})
        if method == "k-means":
            fit_val_mse = metrics.get("eval/inertia")
            fit_val_l0 = 1.0
        else:
            fit_val_mse = metrics.get("eval/mse")
            fit_val_l0 = float(header.get("k", 0))

        try:
            md = dataclasses.asdict(Metadata.load(run.train_shards))
        except Exception:
            md = {}
        md = {k: (str(v) if isinstance(v, pathlib.Path) else v)
              for k, v in md.items()}

        rows.append({
            "run_id": run.run_id,
            "model": get_model_key(md) if md else "?",
            "layer": int(split_layer_of(run)),
            "method": method,
            "fit_data": get_data_key(md) if md else None,
            "fit_val_mse": fit_val_mse,
            "fit_val_l0": fit_val_l0,
            **_downstream_cols(run, split_map, shards_root, cached_baseline),
        })

    df = pd.DataFrame(rows)
    if validate and len(df):
        schema = dict(SCHEMA)
        schema.pop("objective", None)
        schema["method"] = ("str", None)
        validate_df(df, schema=schema)
    logger.info("Assembled baseline probe-results df: %d runs.", len(df))
    return df


def split_layer_of(run: "disk.Run") -> int:
    """The recorded layer of a run's train shards (single-layer dumps), or 0.
    Baseline runs carry no config.json, so the layer comes from metadata."""
    try:
        layers = Metadata.load(run.train_shards).layers
        return int(layers[0]) if layers else 0
    except Exception:
        return 0
