"""The port's host-side analysis of a run against contrib's originals, on the
CPU: trait discovery's `datasets`, `classification` (cls::train, cls::eval,
cls::audit), `analysis`, `audit_analysis`, `visuals`, `browse` and `clsview`
(saev_tpu_torch.tdiscovery against contrib/trait_discovery/src/tdiscovery),
and the mimics project (saev_tpu_torch.mimics against contrib/mimics/src/
mimics, scripts/viewer.py and launch.py).

One tree is made from a numpy seed (`_build_tree`): two labelled
ImgSegFolder datasets of 8 x 8 PNGs (fake-clip's 16 patches an image) with
their shards at d_model 32; two runs of a TopK SAE at d_sae 128 whose first
latents read the classes' centres, the second run's latents a permutation
of the first's, and the port's `framework.inference` (on the CPU) writes both
runs' token activations on both splits; probe metrics, tracker records,
audit and classification results, classifier checkpoints and a baseline
run are written from the seed for the frames. Each group of modules gets
its own copy of the tree on each side. Every group's pipeline (`PIPELINES`)
is the same code on both sides, handed the modules of one package:
contrib's run in one subprocess with contrib's src on sys.path and JAX on
the CPU, because contrib's import loads JAX through `saev_tpu.data`; the
port's in this process. Integer, label, string and byte outputs must be
equal, floats within rtol FLOAT_RTOL; images are compared as decoded pixels
and paths relative to each side's copy.

Also: `python -m saev_tpu_torch.tdiscovery cls::train` writes the head that
`train_worker_fn` writes, and what needs scikit-learn or matplotlib raises an
ImportError naming it where it cannot be imported.
"""

import dataclasses
import importlib
import importlib.abc
import json
import os
import pathlib
import pickle
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import scipy.sparse

REPO = pathlib.Path(__file__).resolve().parent.parent

FLOAT_RTOL = 1e-6
N_CLASSES, TOKENS, D_MODEL, D_SAE, TOP_K = 3, 16, 32, 128, 4
N_IMAGES = {"train": 24, "test": 24}
SPLITS = {"train": "training", "test": "validation"}
CLASS_NAMES = ("a", "b", "c")
SUBSPECIES = ("lativitta_dorsal", "malleti_dorsal", "cyrbia_dorsal")
PAIRS = (("lativitta_dorsal", "malleti_dorsal"), ("lativitta_dorsal", "cyrbia_dorsal"),
         ("malleti_dorsal", "cyrbia_dorsal"))
TASK = "lativitta_dorsal_vs_malleti_dorsal"
GROUPS = ("classification", "analysis", "visuals", "mimics")


# ---------------------------------------------------------------------------
# The tree (built with the port, read by both packages)
# ---------------------------------------------------------------------------


def _seg_dataset(root: pathlib.Path, rng) -> dict[str, np.ndarray]:
    """root/images/<split>/*.png, root/annotations/<split>/*.png and
    labels.csv (stem, class, subspecies_view); each image's class is its
    index mod N_CLASSES, its object patches a random half. Returns each
    split's per-patch labels (0 background, class + 1 object)."""
    from PIL import Image

    rows, patch_labels = [], {}
    for split, folder in SPLITS.items():
        (root / "images" / folder).mkdir(parents=True)
        (root / "annotations" / folder).mkdir(parents=True)
        labels = np.zeros((N_IMAGES[split], TOKENS), np.uint8)
        for i in range(N_IMAGES[split]):
            stem, c = f"{split}{i:03d}", i % N_CLASSES
            obj = rng.random(TOKENS) < 0.5
            labels[i] = np.where(obj, c + 1, 0)
            pixels = np.kron(labels[i].reshape(4, 4), np.ones((2, 2), np.uint8))
            Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).save(root / "images" / folder / f"{stem}.png")
            Image.fromarray(pixels).save(root / "annotations" / folder / f"{stem}.png")
            rows.append(f"{stem},{CLASS_NAMES[c]},{SUBSPECIES[c]}")
        patch_labels[split] = labels
    (root / "labels.csv").write_text("stem,class,subspecies_view\n" + "\n".join(rows) + "\n")
    return patch_labels


def _butterflies(root: pathlib.Path, rng) -> None:
    """A Heliconius-style folder: 6 images and a master sheet with dead
    columns, in shuffled order, with one row that names no image."""
    from PIL import Image

    (root / "images" / "training").mkdir(parents=True)
    (root / "annotations" / "training").mkdir(parents=True)
    rows = []
    for i in range(6):
        name = f"CAM{i:04d}.png"
        Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).save(root / "images" / "training" / name)
        Image.fromarray(np.full((8, 8), i % 3, np.uint8)).save(root / "annotations" / "training" / name)
        rows.append(f"{name},{SUBSPECIES[i % 3].split('_')[0]},{'dorsal' if i % 2 else 'ventral'},http://x/{i},2020-01-0{i + 1}")
    rows.append("CAM9999.png,erato,dorsal,http://x/9,2020-02-01")
    order = rng.permutation(len(rows))
    (root / "Heliconius_img_master.csv").write_text(
        "Image_name,subspecies,view,file_url,Date\n" + "\n".join(rows[i] for i in order) + "\n")


def _shards(shards_root: pathlib.Path, seg_root: pathlib.Path, split: str, labels: np.ndarray,
            centers: np.ndarray, rng) -> pathlib.Path:
    """fake-clip shards of one split: an object patch its class's centre plus
    noise, a background patch noise."""
    from saev_tpu_torch.data import datasets, fake_vit, shards

    n = N_IMAGES[split]
    md = shards.Metadata(
        family="fake-clip", ckpt=fake_vit.CKPT, layers=(0,), content_tokens_per_example=TOKENS, cls_token=False,
        d_model=D_MODEL, n_examples=n, max_tokens_per_shard=TOKENS * 10,
        data=shards.encode_dataset_cfg(datasets.ImgSegFolder(root=seg_root, split=SPLITS[split])),
        dataset=seg_root,
    )
    md.dump(shards_root)
    acts = 0.3 * rng.standard_normal((n, TOKENS, D_MODEL)).astype(np.float32)
    obj = labels > 0
    acts[obj] += centers[labels[obj] - 1]
    with shards.ShardWriter(shards_root, md) as writer:
        for start in range(0, n, 8):
            writer.write_batch(acts[start : start + 8, None], start, labels[start : start + 8])
    return shards_root / md.hash


def _run(runs_root: pathlib.Path, run_id: str, shards: dict, config: dict) -> pathlib.Path:
    """A run dir whose links are relative, so a copied tree stays whole."""
    from saev_tpu_torch import disk

    rel = pathlib.Path("..", "..", "..", "shards")
    run = disk.Run.new(run_id, train_shards_dir=rel / shards["train"].name, val_shards_dir=rel / shards["test"].name,
                       runs_root=runs_root)
    (run.run_dir / "checkpoint" / "config.json").write_text(json.dumps(config))
    return run.run_dir


def _sae_runs(runs_root: pathlib.Path, shards: dict, centers: np.ndarray, rng) -> None:
    """r1: a TopK SAE whose first N_CLASSES latents read and write the
    classes' centres; r2: r1's latents permuted. The port's inference (CPU)
    on both splits of both."""
    import torch

    from saev_tpu_torch.data import OrderedConfig
    from saev_tpu_torch.framework import inference
    from saev_tpu_torch.nn import modeling, serialize

    cfg = modeling.SparseAutoencoderConfig(d_model=D_MODEL, d_sae=D_SAE, activation=modeling.TopK(top_k=TOP_K))
    params, state = modeling.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    unit = torch.from_numpy(centers / np.linalg.norm(centers, axis=1, keepdims=True))
    params["W_enc"][:, :N_CLASSES] = 2 * unit.T
    params["W_dec"][:N_CLASSES] = unit
    perm = torch.from_numpy(rng.permutation(D_SAE))
    permuted = {"W_enc": params["W_enc"][:, perm].contiguous(), "b_enc": params["b_enc"][perm],
                "W_dec": params["W_dec"][perm].contiguous(), "b_dec": params["b_dec"]}
    for run_id, p, layer in (("r1", params, 0), ("r2", permuted, 1)):
        config = {"sae": {"d_sae": D_SAE, "activation": {"key": "top-k", "top_k": TOP_K}},
                  "val_data": {"layer": layer}, "objective": {"n_prefixes": 1}, "lr": 1e-3, "tags": ["mimic"]}
        run_dir = _run(runs_root, run_id, shards, config)
        serialize.dump(run_dir / "checkpoint" / "sae.pt", cfg, p, state)
        for split in shards.values():
            inference.worker_fn(inference.Config(
                run=run_dir, data=OrderedConfig(shards=split, layer=0, batch_size=128), device="cpu"))


def _probe_artifacts(art_train: pathlib.Path, art_test: pathlib.Path, train_name: str, n_latents: int, rng) -> None:
    """probe1d_metrics.npz on both splits and the val split's
    probe1d_metrics__train-<train>.npz, from the seed."""
    n_cls = N_CLASSES + 1
    np.savez(art_train / "probe1d_metrics.npz", loss=rng.random((n_latents, n_cls)).astype(np.float32),
             weights=rng.standard_normal((n_latents, n_cls)).astype(np.float32))
    np.savez(art_test / "probe1d_metrics.npz", loss=rng.random((n_latents, n_cls)).astype(np.float32))
    np.savez(art_test / f"probe1d_metrics__train-{train_name}.npz", ap=rng.random(n_cls).astype(np.float32),
             precision=rng.random(n_cls).astype(np.float32), recall=rng.random(n_cls).astype(np.float32),
             f1=rng.random(n_cls).astype(np.float32), top_labels=rng.integers(0, n_cls, (n_latents, 20)),
             nnz_per_latent=rng.integers(0, 40, n_latents), n_pos_per_class=np.array([5, 0, 7, 3]))


def _heads(rng) -> dict:
    """A fitted L1 logistic head and a decision tree on seeded features."""
    import sklearn.linear_model
    import sklearn.tree

    x = rng.random((30, D_SAE)).astype(np.float32)
    y = np.arange(30) % 2
    x[np.arange(30), y] += 2.0
    linear = sklearn.linear_model.LogisticRegression(penalty="l1", C=1.0, solver="liblinear", random_state=0)
    return {"linear": linear.fit(x, y), "tree": sklearn.tree.DecisionTreeClassifier(max_depth=3, random_state=0).fit(x, y)}


def _analysis_artifacts(tree: pathlib.Path, shards: dict, rng) -> None:
    """The tracker, probe metrics, audit results, classification results,
    classifier checkpoints and a baseline run that the frames read."""
    runs_root = tree / "saev" / "runs"
    r3 = _run(runs_root, "r3", shards, {"sae": {"d_sae": 2 * D_SAE, "activation": {"key": "top-k", "top_k": 8}},
                                        "val_data": {"layer": 1}, "objective": {"n_prefixes": 4}, "tags": ["wide"]})
    for i, run_id in enumerate(("r1", "r2", "r3")):
        for project in ("other", "saev"):
            (tree / "tracker" / project).mkdir(parents=True, exist_ok=True)
        rec = tree / "tracker" / "saev" / run_id
        rec.mkdir()
        nmse = float(rng.random())
        (rec / "summary.json").write_text(json.dumps({"eval": {
            "l0": float(4 + 8 * rng.random()), "l1": float(rng.random()), "mse": float(rng.random()),
            "normalized_mse": nmse, "nmse": nmse}}))
        (rec / "config.json").write_text(json.dumps({"tags": ["mimic", f"t{i}"]}))
    (tree / "tracker" / "other" / "r9").mkdir()
    (tree / "tracker" / "other" / "r9" / "summary.json").write_text("{}")

    heads = _heads(rng)
    with open(tree / "heads.pkl", "wb") as fd:
        pickle.dump(heads, fd)
    for run_dir in (runs_root / "r1", runs_root / "r2", r3):
        art = run_dir / "inference" / shards["test"].name
        art.mkdir(parents=True, exist_ok=True)
        classifiers = []
        for j, (key, c, depth) in enumerate((("sparse-linear", 0.1, None), ("sparse-linear", 1.0, None),
                                             ("decision-tree", None, 3), ("decision-tree", None, -1))):
            ckpt = art / f"cls_syn_{j}.pkl"
            ckpt.write_text(json.dumps({"cfg": {"cls": {"key": key, "C": c, "max_depth": depth},
                                                "patch_agg": "PatchAgg.MAX"}}) + "\n")
            yields = np.sort(rng.random(4))[::-1]
            classifiers.append({
                "cls_checkpoint": str(ckpt), "cls_type": key, "test_acc": float(rng.random()),
                "n_nonzero_importance": int(rng.integers(1, 200)), "tau": 0.3, "budgets": [3, 10, 30, 100],
                "yield_at_b": {b: float(v) for b, v in zip(("3", "10", "30", "100"), yields)},
                "auc_b": float(yields.mean())})
        (art / "audit_results.json").write_text(json.dumps({"classifiers": classifiers}))
        top = [rng.permutation(D_SAE)[:6].tolist() for _ in CLASS_NAMES]
        top[1][:2] = top[0][:2]
        (art / "classification_habitat.json").write_text(json.dumps({
            "accuracy": float(rng.random()), "mean_ap": float(rng.random()),
            "ap_per_class": rng.random(N_CLASSES).tolist(), "class_names": list(CLASS_NAMES),
            "top_features_per_class": top, "n_test": 24}))
        if run_dir.name == "r3":
            continue
        _probe_artifacts(run_dir / "inference" / shards["train"].name, art, shards["train"].name, D_SAE, rng)
        for name, head, hdr in (("C1.0", heads["linear"], {"key": "sparse-linear", "C": 1.0}),
                                ("depth3", heads["tree"], {"key": "decision-tree", "max_depth": 3})):
            with open(art / f"cls_{TASK}_max_{name}.pkl", "wb") as fd:
                header = {"cfg": {"cls": hdr}, "test_acc": float(rng.random()), "n_classes": 2,
                          "class_names": ["erato", "melpomene"]}
                fd.write((json.dumps(header) + "\n").encode())
                pickle.dump({"classifier": head}, fd)
        (art / f"cls_{TASK}_max_C0.5.pkl").write_bytes(b"not a checkpoint\n")
    # A k-means baseline run: checkpoint/baseline.pt's header, no config.json.
    b1 = runs_root / "b1"
    for sub in ("checkpoint", "links", "inference"):
        (b1 / sub).mkdir(parents=True)
    for name, split in (("train-shards", "train"), ("val-shards", "test")):
        (b1 / "links" / name).symlink_to(pathlib.Path("..", "..", "..", "shards") / shards[split].name)
    (b1 / "checkpoint" / "baseline.pt").write_bytes(
        (json.dumps({"method": "kmeans", "k": 8, "metrics": {"eval/inertia": 1.5}}) + "\n").encode() + b"\0")
    for split in shards.values():
        (b1 / "inference" / split.name).mkdir()
    _probe_artifacts(b1 / "inference" / shards["train"].name, b1 / "inference" / shards["test"].name,
                     shards["train"].name, 8, rng)


def _build_tree(tree: pathlib.Path) -> None:
    rng = np.random.default_rng(0)
    seg_root = tree / "data" / "ADE20K"
    labels = _seg_dataset(seg_root, rng)
    _butterflies(tree / "butterflies", rng)
    centers = (2 * rng.standard_normal((N_CLASSES, D_MODEL))).astype(np.float32)
    shards_root = tree / "saev" / "shards"
    shards_root.mkdir(parents=True)
    shards = {split: _shards(shards_root, seg_root, split, labels[split], centers, rng) for split in SPLITS}
    runs_root = tree / "saev" / "runs"
    runs_root.mkdir(parents=True)
    _sae_runs(runs_root, shards, centers, rng)
    _analysis_artifacts(tree, shards, rng)


def _shard_dirs(tree: pathlib.Path) -> dict[str, pathlib.Path]:
    from_run = tree / "saev" / "runs" / "r1" / "links"
    return {"train": tree / "saev" / "shards" / os.readlink(from_run / "train-shards").split("/")[-1],
            "test": tree / "saev" / "shards" / os.readlink(from_run / "val-shards").split("/")[-1]}


# ---------------------------------------------------------------------------
# Plain values: what both sides return, compared by `assert_same`
# ---------------------------------------------------------------------------


def plain(obj, tree: pathlib.Path):
    """`obj` as builtins and numpy arrays: frames as their columns, dtypes
    and values; images as pixels; dataclasses as dicts; the tree's path as
    "<tree>" in every string."""
    root = str(tree)
    if isinstance(obj, dict):
        return {plain(k, tree): plain(v, tree) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [plain(v, tree) for v in obj]
    if isinstance(obj, (str, pathlib.PurePath)):
        return str(obj).replace(root, "<tree>")
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return plain({f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}, tree)
    if isinstance(obj, np.ndarray):
        return plain(obj.tolist(), tree) if obj.dtype.kind in "OUS" else obj
    if isinstance(obj, (np.generic, bool, int, float)) or obj is None:
        return obj.item() if isinstance(obj, np.generic) else obj
    if type(obj).__name__ == "DataFrame":
        return {"columns": plain(list(obj.columns), tree), "dtypes": [str(t) for t in obj.dtypes],
                "values": {str(c): plain(_column(obj[c]), tree) for c in obj.columns}}
    if type(obj).__module__.startswith("PIL."):
        return np.asarray(obj)
    if hasattr(obj, "value") and type(obj).__class__.__name__ == "EnumType":
        return obj.value
    raise TypeError(f"no plain form for {type(obj)}")


def _column(col):
    values = col.to_list()
    if col.dtype.kind in "fiub":
        return np.asarray(values, dtype=col.dtype)
    return values


def _pixels(root: pathlib.Path) -> dict:
    """Every PNG under `root`, decoded."""
    from PIL import Image

    return {str(p.relative_to(root)): np.asarray(Image.open(p)) for p in sorted(root.rglob("*.png"))}


def assert_same(got, want, where: str = "") -> None:
    """Equal structure; floats within FLOAT_RTOL; everything else equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got, key=str) == sorted(want, key=str), (where, got, want)
        for k in want:
            assert_same(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (where, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.shape == want.shape and got.dtype == want.dtype, (
            where, getattr(got, "dtype", type(got)), want.dtype, getattr(got, "shape", None), want.shape)
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=FLOAT_RTOL, atol=0, err_msg=where)
        else:
            np.testing.assert_array_equal(got, want, err_msg=where)
    elif isinstance(want, float):
        assert isinstance(got, float), (where, got, want)
        assert (np.isnan(got) and np.isnan(want)) or got == pytest.approx(want, rel=FLOAT_RTOL, abs=0), (
            where, got, want)
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


# ---------------------------------------------------------------------------
# The pipelines: the same calls on each package's modules
# ---------------------------------------------------------------------------


def _classification(m, tree: pathlib.Path) -> dict:
    sh, run1 = _shard_dirs(tree), tree / "saev" / "runs" / "r1"
    out = {}
    ds = m.datasets.get_dataset(m.datasets.Butterflies(root=tree / "butterflies", split="training"))
    out["butterflies"] = {"len": len(ds), "meta": [ds.get_metadata(i) for i in range(len(ds))], "sample": ds[1]}
    acts = scipy.sparse.load_npz(run1 / "inference" / sh["train"].name / "token_acts.npz").tocsr()
    out["aggregate"] = {agg.value: m.classification.aggregate_to_images(acts, TOKENS, agg)
                        for agg in m.classification.PatchAgg}
    out["labels"] = {s: m.classification.load_image_labels(d) for s, d in sh.items()}
    labels = out["labels"]["train"][1]
    pair = m.classification.LabelGrouping(name="pair", source_col="subspecies_view",
                                          groups={"erato": [SUBSPECIES[0]], "melpomene": [SUBSPECIES[1]]})
    out["grouping"] = [pair.apply(labels["subspecies_view"]),
                       pair.apply(labels["subspecies_view"], class_names=["melpomene", "x", "erato"]),
                       m.classification.LabelGrouping().apply(labels["class"]),
                       m.classification.LabelGrouping().apply(labels["class"], class_names=["c", "a"])]
    # liblinear fits two classes only (scikit-learn 1.8 on), so the L1 head
    # takes the pair task and the tree the three classes.
    ckpts, heads = {}, {"sparse-linear": (m.classification.SparseLinear(C=1.0), pair),
                        "decision-tree": (m.classification.DecisionTree(max_depth=3), m.classification.LabelGrouping())}
    for name, (head, task) in heads.items():
        cfg = m.classification.TrainConfig(run=run1, train_shards=sh["train"], test_shards=sh["test"], cls=head,
                                           task=task)
        np.random.seed(0)  # liblinear's shuffle draws from numpy's global state
        m.classification.train_cli(cfg)
        fpath = m.classification.ckpt_fpath(m.disk.Run(run1), cfg)
        header, payload = m.classification.load_classifier_checkpoint(fpath)
        clf = payload["classifier"]
        fitted = ({"coef": clf.coef_, "intercept": clf.intercept_} if name == "sparse-linear" else
                  {"feature": clf.tree_.feature, "threshold": clf.tree_.threshold, "value": clf.tree_.value})
        out[f"train {name}"] = {"name": fpath.name, "header": header, "classes": clf.classes_,
                                "test_pred": payload["test_pred"], "test_y": payload["test_y"],
                                "ranking": m.classification.extract_feature_ranking(clf), **fitted}
        if name == "sparse-linear":
            out["latent class matrix"] = m.classification.latent_class_matrix(clf, N_CLASSES + 1)
        out[f"eval {name}"] = m.classification.eval_worker_fn(m.classification.EvalConfig(
            run=run1, test_shards=sh["test"], cls=head, task=task, top_features=5))
        ckpts[name] = fpath
    art = run1 / "inference" / sh["test"].name
    out["audit"] = {"results": m.classification.audit_worker_fn(m.classification.AuditConfig(
        run=run1, test_shards=sh["test"], cls_checkpoints=tuple(ckpts.values()), max_budget=64,
        budgets=(3, 10, 30, 64), batch_size=16)),
        "file": json.loads((art / "audit_results.json").read_text()),
        "ap": np.load(art / "audit_ap_s.npy"), "best_class": np.load(art / "audit_best_class_s.npy")}
    rng = np.random.default_rng(7)
    onehot = (rng.random((200, 4)) < 0.3).astype(np.float32)
    onehot[:, 3] = 0
    n_pos = onehot.sum(axis=0)
    tied = rng.integers(0, 4, 200).astype(np.float32)
    out["tie-aware ap"] = [m.classification.tie_aware_ap(tied, onehot, n_pos),
                           m.classification.tie_aware_ap(rng.random(200).astype(np.float32), onehot, n_pos)]
    out["ap batched"] = m.classification.ap_batched(rng.random((200, 5)).astype(np.float32), onehot, n_pos)
    return out


def _analysis(m, tree: pathlib.Path) -> dict:
    sh, runs, tracker = _shard_dirs(tree), tree / "saev" / "runs", tree / "tracker"
    a, aa = m.analysis, m.audit_analysis
    run1 = m.disk.Run(runs / "r1")
    rng = np.random.default_rng(11)
    top_labels, best = rng.integers(0, 4, (D_SAE, 20)), rng.integers(0, D_SAE, 4)
    md_train = json.loads((sh["train"] / "metadata.json").read_text())
    mds = [{"vit_family": "dinov2", "vit_ckpt": "dinov2_vitl14_reg"}, {"family": "clip", "ckpt": "hf-hub:imageomics/bioclip"},
           {"model_family": "dinov3", "model_ckpt": "dinov3_vitb16"}, {"family": "fake-clip"}, {"family": "x", "ckpt": "y"}]
    labels = rng.integers(0, 5, (6, 9))
    out = {
        "baseline ce": {s: a.baseline_ce(d) for s, d in sh.items()},
        "freqs": [a.load_freqs(run1, sh["test"].name), a.load_mean_values(run1, sh["test"].name)],
        "purity": [a.purity_at(top_labels, best, k=16), a.purity_at(top_labels, best, k=4, nnz_per_latent=rng.integers(0, 9, D_SAE)),
                   a.purity_at(top_labels, best, k=4, nnz_per_latent=np.zeros(D_SAE))],
        "split label": [a.probe_split_label(d) for d in (*sh.values(), tree / "saev" / "shards" / "missing")],
        "keys": [a.get_model_key(md) for md in (*mds, md_train)]
        + [a.get_data_key(md_train), a.get_data_key({"data": "e30="}), a.get_data_key({})],
        "mode": [a.mode(labels, axis=0), a.mode(labels, axis=1)],
        "tracker": [a.tracker_record("r1", tracker), a.tracker_record("r1", None), a.run_record(run1, tracker)],
        "probe results": a.load_probe_results_df(runs, tree / "saev" / "shards", tracker_root=tracker),
        "baseline probe results": a.load_baseline_probe_results_df(runs, tree / "saev" / "shards"),
    }
    frame = a.load_probe_results_df(runs, tree / "saev" / "shards", tracker_root=tracker, validate=False)
    frame["val_mean_ap"] = 1.5
    try:
        a.validate_df(frame)
    except ValueError as err:
        out["validate"] = str(err)
    run_dirs = [runs / "r1", runs / "r2", runs / "r3", runs / "missing"]
    sae_df, clf_df = aa.load_audit_frames(run_dirs, tracker)
    adf = aa.analysis_frame(clf_df)
    out["audit frames"] = [sae_df, clf_df, adf, aa.jitter(5, data_width=0.1)]
    out["figures"] = [aa.fig_pareto_frontiers(sae_df)[1], aa.fig_pareto_frontiers(sae_df, filters={"nope": 1})[1],
                      aa.fig_sparsity_accuracy(clf_df)[1], aa.hyp_best_configs(adf, n=5)]
    out["battery"] = [aa.run_battery(run_dirs, tree / "battery", tracker),
                      sorted(p.name for p in (tree / "battery").iterdir())]
    return out


def _visuals(m, tree: pathlib.Path) -> dict:
    sh, runs = _shard_dirs(tree), tree / "saev" / "runs"
    art = runs / "r1" / "inference" / sh["test"].name
    m.visuals.worker_fn(m.visuals.Config(run=runs / "r1", shards=sh["test"], img_scale=4.0, n_latents=3, top_k=3,
                                         latents=(0, 1), n_distributions=4, log_value_range=(-6.0, 6.0)))
    out = {"var": m.pd.read_parquet(art / "var.parquet"), "images": _pixels(art)}
    out["discover"] = [m.browse.discover_runs([runs, tree / "missing"]), m.browse.shards_with_images(runs / "r1"),
                       m.browse.shards_with_images(runs / "r2")]
    out["browsers"] = {p.name: p.read_text() for p in m.browse.build_browsers([runs], tree / "browser", n_features=4)}
    cv = m.clsview
    run_dirs = [runs / "r1", runs / "r2", runs / "missing"]
    results = json.loads((art / "classification_habitat.json").read_text())
    with open(tree / "heads.pkl", "rb") as fd:
        heads = pickle.load(fd)
    out["clsview"] = [cv.load_cls_results_df(run_dirs, tracker_root=tree / "tracker"),
                      cv.load_cls_results_df(run_dirs, per_class=True), cv.cls_results_fpaths(runs / "r1"),
                      cv.tree_rules(heads["tree"], list(CLASS_NAMES)), cv.tree_rules(heads["tree"], list(CLASS_NAMES), max_depth=1),
                      cv.top_latents_table(results, k=3), cv.shared_latents(results, k=3),
                      cv.latent_class_matrix(heads["linear"], N_CLASSES + 1)]
    return out


def _mimics(m, tree: pathlib.Path) -> dict:
    sh, runs, tracker = _shard_dirs(tree), tree / "saev" / "runs", tree / "tracker"
    out = {}
    cfg = m.tasks.DecideTaskSpecsConfig(shards=sh["test"], pair_specs=("lativitta:malleti", "lativitta:cyrbia",
                                                                     "notabilis:plesseni"), min_samples_per_class=6)
    specs, summary = m.tasks.decide_task_specs(cfg)
    m.tasks.dump_summary_csv(summary, tree / "tasks" / "summary.csv")
    out["tasks"] = [specs, summary, (tree / "tasks" / "summary.csv").read_text(),
                    m.tasks.decide_task_specs(dataclasses.replace(cfg, include_filtered=True, min_samples_per_class=9),
                                              labels=["a_dorsal", "b_dorsal"] * 5),
                    m.tasks.make_candidate_task_names(dataclasses.replace(cfg, task_names=("x_v_vs_y_v", "x_v_vs_y_v"))),
                    m.tasks.parse_task_name(TASK), m.tasks.make_label_grouping(TASK)]
    labels = tuple(m.classification.load_image_labels(sh["test"])[1]["subspecies_view"])
    out["scores"] = {r: m.scoring.score_run(m.scoring.Config(run=runs / r, shards=sh["test"], labels=labels, pairs=PAIRS,
                                                             min_samples=4, feature_chunk=50)) for r in ("r1", "r2")}
    rng = np.random.default_rng(5)
    scores = rng.integers(0, 3, (30, 70)).astype(np.float32)
    acts = scipy.sparse.load_npz(runs / "r1" / "inference" / sh["test"].name / "token_acts.npz")
    out["auroc"] = [m.scoring.auroc_per_latent(scores, (np.arange(30) % 3 == 0).astype(np.int8), chunk=16),
                    m.scoring.build_task_specs(list(labels), pairs=list(PAIRS), min_samples=9),
                    m.scoring.max_pool_csr(acts, N_IMAGES["test"], TOKENS)]
    out["consistency"] = m.consistency.worker_fn(m.consistency.Config(runs=(runs / "r1", runs / "r2"), shards=sh["test"],
                                                                      top_k=5))
    dc = m.checkpoints.DiscoverCheckpointsConfig(run_root_dpath=runs, shard_id=sh["test"].name, task_name=TASK)
    rows = m.checkpoints.discover_checkpoints(dc)
    sel = m.checkpoints.select_checkpoints(rows, n_features_range=(1, 200), top_k=3)
    pooled = m.checkpoints.pool_features(sel, per_ckpt=5)
    out["checkpoints"] = [rows, sel, pooled, m.checkpoints.discover_checkpoints(dataclasses.replace(dc, c_values=(1.0,))),
                          m.checkpoints.build_render_plan(list(labels), pooled, groups={
                              "erato": [SUBSPECIES[0]], "melpomene": [SUBSPECIES[1]], "none": ["zzz"]},
                              n_per_class=3, seed=1)]
    ma = m.mimics_analysis
    df = ma.join_scores(ma.mark_pareto(ma.load_runs_df(runs, tracker_root=tracker)), runs, sh["test"].name)
    ma.plot_frontier(df, tree / "frontier" / "frontier.png")
    out["analysis"] = [df, ma.load_runs_df(runs, tags=("wide",)), ma.mark_pareto(df, group_col=None),
                       ma.width_study(df), _pixels(tree / "frontier")]
    art = runs / "r1" / "inference" / sh["test"].name
    out["render"] = [m.render.worker_fn(m.render.Config(run=runs / "r1", shards=sh["test"], labels=labels,
                                                        n_features=2, n_per_class=2, img_scale=2.0)),
                     _pixels(art / "mimics")]
    out["viewer"] = [m.viewer.build(m.viewer.Config(runs=(runs / "r1", runs / "r2"), shards=sh["test"],
                                                    out=tree / "viewer.html")).read_text(),
                     m.viewer.build_scores(m.viewer.ScoresConfig(runs=(runs / "r1", runs / "r2"), shards=sh["test"],
                                                                 out=tree / "scores.html")).read_text()]
    (tree / "sweep.toml").write_text("min_samples = [4, 5]\nfeature_chunk = [32]\nforce_recompute = [true]\n")
    m.launch_score(m.scoring.Config(run=runs / "r2", shards=sh["test"], labels=labels, pairs=PAIRS[:1]),
                   tree / "sweep.toml")
    out["launch score"] = json.loads((runs / "r2" / "inference" / sh["test"].name / "mimic_scores.json").read_text())
    return out


PIPELINES = {"classification": _classification, "analysis": _analysis, "visuals": _visuals, "mimics": _mimics}


def port_modules() -> types.SimpleNamespace:
    import pandas as pd

    from saev_tpu_torch import disk
    from saev_tpu_torch.mimics import __main__ as launch
    from saev_tpu_torch.mimics import analysis as mimics_analysis
    from saev_tpu_torch.mimics import checkpoints, consistency, render, scoring, tasks, viewer
    from saev_tpu_torch.tdiscovery import (analysis, audit_analysis, browse, classification, clsview, datasets,
                                           visuals)

    return types.SimpleNamespace(
        disk=disk, pd=pd, datasets=datasets, classification=classification, analysis=analysis,
        audit_analysis=audit_analysis, visuals=visuals, browse=browse, clsview=clsview, tasks=tasks,
        scoring=scoring, consistency=consistency, checkpoints=checkpoints, mimics_analysis=mimics_analysis,
        render=render, viewer=viewer, launch_score=launch.score)


def contrib_modules() -> types.SimpleNamespace:
    """contrib's modules; contrib's src dirs must be on sys.path."""
    import importlib.util

    import pandas as pd
    import viewer
    from mimics import analysis as mimics_analysis
    from mimics import checkpoints, consistency, render, scoring, tasks
    from tdiscovery import analysis, audit_analysis, browse, classification, clsview, datasets, visuals

    import saev_tpu.disk

    # contrib/mimics/launch.py, by its path: the repo's own launch.py shares its name.
    spec = importlib.util.spec_from_file_location("mimics_launch", REPO / "contrib" / "mimics" / "launch.py")
    launch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(launch)
    return types.SimpleNamespace(
        disk=saev_tpu.disk, pd=pd, datasets=datasets, classification=classification, analysis=analysis,
        audit_analysis=audit_analysis, visuals=visuals, browse=browse, clsview=clsview, tasks=tasks,
        scoring=scoring, consistency=consistency, checkpoints=checkpoints, mimics_analysis=mimics_analysis,
        render=render, viewer=viewer, launch_score=launch.score)


CONTRIB_SCRIPT = r"""
import json, os, pathlib, pickle, sys
spec = json.loads(sys.argv[1])
repo = pathlib.Path(spec["repo"])
sys.path[:0] = [str(repo / "tests"), str(repo), str(repo / "contrib" / "trait_discovery" / "src"),
                str(repo / "contrib" / "mimics" / "src"), str(repo / "contrib" / "mimics" / "scripts")]
import jax
jax.config.update("jax_platforms", "cpu")
import test_torch_contrib_host as t
m = t.contrib_modules()
out = {group: t.plain(t.PIPELINES[group](m, pathlib.Path(tree)), pathlib.Path(tree))
       for group, tree in spec["trees"].items()}
leaked = sorted(n for n in sys.modules if n.startswith("saev_tpu_torch"))
with open(spec["out"], "wb") as fd:
    pickle.dump({"out": out, "port_modules_loaded": leaked}, fd)
"""


# ---------------------------------------------------------------------------
# Fixtures and tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("contrib_host")
    _build_tree(base / "base")
    for side in ("contrib", "port"):
        for group in GROUPS:
            shutil.copytree(base / "base", base / side / group, symlinks=True)
    return base


@pytest.fixture(scope="module")
def outs(trees):
    """(contrib's plain results, the port's): contrib's subprocess runs while
    the port's pipelines run here."""
    spec = {"repo": str(REPO), "trees": {g: str(trees / "contrib" / g) for g in GROUPS},
            "out": str(trees / "contrib.pkl")}
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO)}
    log = trees / "contrib.log"
    with open(log, "w") as fd:
        proc = subprocess.Popen([sys.executable, "-c", CONTRIB_SCRIPT, json.dumps(spec)], cwd=trees, env=env,
                                stdout=fd, stderr=subprocess.STDOUT)
        try:
            m = port_modules()
            port = {g: plain(PIPELINES[g](m, trees / "port" / g), trees / "port" / g) for g in GROUPS}
            proc.wait(timeout=300)
        finally:
            proc.kill()
    assert proc.returncode == 0, log.read_text()[-6000:]
    with open(spec["out"], "rb") as fd:
        got = pickle.load(fd)
    # contrib computed its results without the port's modules.
    assert [n for n in got["port_modules_loaded"] if n != "saev_tpu_torch"] == [], got["port_modules_loaded"]
    return got["out"], port


@pytest.fixture(scope="module")
def contrib_out(outs):
    return outs[0]


@pytest.fixture(scope="module")
def port_out(outs):
    return outs[1]


CASES = {
    "classification": ("butterflies", "aggregate", "labels", "grouping", "train sparse-linear", "train decision-tree",
                       "latent class matrix", "eval sparse-linear", "eval decision-tree", "audit", "tie-aware ap",
                       "ap batched"),
    "analysis": ("baseline ce", "freqs", "purity", "split label", "keys", "mode", "tracker", "probe results",
                 "baseline probe results", "validate", "audit frames", "figures", "battery"),
    "visuals": ("var", "images", "discover", "browsers", "clsview"),
    "mimics": ("tasks", "scores", "auroc", "consistency", "checkpoints", "analysis", "render", "viewer",
               "launch score"),
}


def test_pipelines_cover_every_case(contrib_out, port_out):
    for group, cases in CASES.items():
        assert sorted(contrib_out[group]) == sorted(port_out[group]) == sorted(cases), group


@pytest.mark.parametrize("case", CASES["classification"])
def test_classification_matches_contrib(contrib_out, port_out, case):
    """datasets and classification: cls::train's checkpoints (liblinear and
    the tree fit the same heads), cls::eval's results, cls::audit's APs and
    yields."""
    assert_same(port_out["classification"][case], contrib_out["classification"][case], case)


@pytest.mark.parametrize("case", CASES["analysis"])
def test_analysis_matches_contrib(contrib_out, port_out, case):
    """analysis' probe-results frames and audit_analysis' frames and battery."""
    assert_same(port_out["analysis"][case], contrib_out["analysis"][case], case)


@pytest.mark.parametrize("case", CASES["visuals"])
def test_visuals_browse_clsview_match_contrib(contrib_out, port_out, case):
    """visuals' var.parquet and images, browse's pages, clsview's frames,
    rules and tables."""
    assert_same(port_out["visuals"][case], contrib_out["visuals"][case], case)


@pytest.mark.parametrize("case", CASES["mimics"])
def test_mimics_matches_contrib(contrib_out, port_out, case):
    """mimics' tasks, scores, consistency, checkpoints, width study, render,
    viewers and the launcher's sweep."""
    assert_same(port_out["mimics"][case], contrib_out["mimics"][case], case)


def test_planted_latents_are_found(port_out):
    """The tree's structure shows through the port's results: the heads
    read the planted latents, the audit grounds them in their classes, the
    consistency of the two runs' permuted latents is 1."""
    cls = port_out["classification"]
    assert cls["eval sparse-linear"]["accuracy"] == 1.0
    assert set(cls["train sparse-linear"]["ranking"][0][:N_CLASSES].tolist()) == set(range(N_CLASSES))
    best = cls["audit"]["best_class"][:N_CLASSES]
    assert best.tolist() == [1, 2, 3] and (cls["audit"]["ap"][:N_CLASSES] > 0.9).all()
    for run, tasks in port_out["mimics"]["consistency"].items():
        for entries in tasks.values():
            assert entries[0]["consistency"] == pytest.approx(1.0, abs=1e-6), (run, entries[0])


def test_tdiscovery_launcher_trains_the_same_head(trees, port_out):
    """`python -m saev_tpu_torch.tdiscovery cls::train` (in-process) writes
    the checkpoint that `train_worker_fn` wrote for the same config."""
    from saev_tpu_torch.tdiscovery import __main__ as td
    from saev_tpu_torch.tdiscovery import classification

    tree = trees / "port" / "classification"
    sh, run = _shard_dirs(tree), tree / "saev" / "runs" / "r1"
    cfg = classification.TrainConfig(run=run, train_shards=sh["train"], test_shards=sh["test"],
                                     cls=classification.DecisionTree(max_depth=3))
    fpath = classification.ckpt_fpath(classification.disk.Run(run), cfg)
    want = fpath.read_bytes()
    fpath.unlink()
    td.main(["cls::train", "--run", str(run), "--train-shards", str(sh["train"]), "--test-shards", str(sh["test"]),
             "cls:decision-tree", "--cls.max-depth", "3"])
    assert fpath.read_bytes() == want


class _Blocked(importlib.abc.MetaPathFinder):
    def __init__(self, names):
        self.names = names

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in self.names:
            raise ModuleNotFoundError(f"No module named {name!r}")
        return None


@pytest.fixture
def without(monkeypatch):
    """Make the named packages unimportable for the test."""

    def block(*names):
        for mod in list(sys.modules):
            if mod.split(".")[0] in names:
                monkeypatch.delitem(sys.modules, mod)
        monkeypatch.setattr(sys, "meta_path", [_Blocked(names), *sys.meta_path])

    return block


NEEDS = {
    "cls::train": ("sklearn", lambda tree: importlib.import_module("saev_tpu_torch.tdiscovery.classification")
                   .train_worker_fn(importlib.import_module("saev_tpu_torch.tdiscovery.classification").TrainConfig(
                       run=tree / "saev" / "runs" / "r1"))),
    "clsview.tree_rules": ("sklearn", lambda tree: importlib.import_module("saev_tpu_torch.tdiscovery.clsview")
                           .tree_rules(None, [])),
    "audit battery": ("matplotlib", lambda tree: importlib.import_module("saev_tpu_torch.tdiscovery.audit_analysis")
                      .hyp_corr_heatmap(None)),
    "visuals figure": ("matplotlib", lambda tree: importlib.import_module("saev_tpu_torch.tdiscovery.visuals")
                       .plot_activation_distributions(None, None)),
    "mimics frontier": ("matplotlib", lambda tree: importlib.import_module("saev_tpu_torch.mimics.analysis")
                        .plot_frontier(None, tree / "f.png")),
}


@pytest.mark.parametrize("what", sorted(NEEDS))
def test_missing_package_raises_import_error(without, tmp_path, what):
    """Where scikit-learn or matplotlib cannot be imported, what needs it
    raises an ImportError that names it, before any other work."""
    package, call = NEEDS[what]
    without(package)
    with pytest.raises(ImportError, match=f"needs {package} .pip install"):
        call(tmp_path)
