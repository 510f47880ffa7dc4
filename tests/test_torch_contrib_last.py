"""The last of contrib's code in the port against contrib's originals, on the
CPU: birdsong's `stats`, `visuals`, `browse` and `scripts/make_html.py`
(saev_tpu_torch.birdsong); trait discovery's study modules `runs`,
`results`, `logparse`, `fishbase`, `mimicry`, `figplots` and `ablations`
(saev_tpu_torch.tdiscovery); the freshwater-fish tools `extract_tol` and
`make_gallery` (saev_tpu_torch.freshwater_fish); and trait discovery's
data-prep scripts `format_ade20k`, `format_fishvista`,
`download_butterflies`, `scrape_fishbase` and `push_dinov3`
(saev_tpu_torch.tdiscovery.scripts).

One tree is made from a numpy seed (`_build_tree`): BirdCLEF-layout clips,
two of them with a 10 kHz tone in time patches 10-12, their Bird-MAE-family
shards at d_model 32 (channel BAD planted, the tone's patches shifted along
one direction) and a TopK SAE whose latent 0 reads that direction, with the
port's inference (CPU) over them; test_torch_contrib_host's labelled image
shards; study runs, FishVista Result JSONs, a probe1d
telemetry log from a port fit, mimic-pair classifier checkpoints; a
TreeOfLife store (parquet and HDF5); ADE20K and FishVista downloads, stored
FishBase pages and SAE checkpoints to push. Each group of modules gets its
own copy of the tree on each side, and each group's pipeline (`PIPELINES`)
is the same code on both sides, handed the modules of one package: contrib's
in one subprocess with contrib's src dirs on sys.path and JAX on the CPU,
the port's in this process. Integers, strings, labels and bytes must be
equal, floats within FLOAT_RTOL; images are compared as decoded pixels,
clips as decoded samples, figures by their plotted data, HTML and every
other string with the tree's path replaced on each side.

Also: the launchers (`python -m saev_tpu_torch.birdsong`, the fish tools,
the data-prep scripts) write what their functions write, and what needs an
optional package raises an ImportError that names it where it cannot be
imported.
"""

import csv
import dataclasses
import datetime
import importlib
import io
import json
import os
import pathlib
import pickle
import shutil
import subprocess
import sys
import types
import wave

import numpy as np
import pytest

from test_torch_contrib_host import _pixels, _seg_dataset, _shards, plain, without  # noqa: F401
from test_torch_contrib_host import assert_same as _assert_same

REPO = pathlib.Path(__file__).resolve().parent.parent

GROUPS = ("birdsong", "study", "fish", "dataprep")
BIRD_D, BIRD_SAE, BIRD_K, CLIPS, BAD = 32, 64, 4, 8, 5
PLANTED = (1, 4)  # the clips with the tone
TONE_T = (10, 11, 12)  # its time patches
TONE_HZ = 10_000.0
SR = 32_000
BIRD_TAXONOMY = {"abethr1": "Aves", "barswa": "Aves", "22333": "Aves", "41663": "Insecta"}


# ---------------------------------------------------------------------------
# The tree (built with the port, read by both packages)
# ---------------------------------------------------------------------------


def _birdclef(root: pathlib.Path, rng) -> list[np.ndarray]:
    """A BirdCLEF-2025-layout root (taxonomy.csv, train.csv,
    train_audio/<label>/XC<n>.wav, 5 s at 32 kHz, int16): CLIPS bird clips of
    quiet noise, the PLANTED ones with a tone over TONE_T, and one insect
    clip for the Aves filter to drop. Returns the bird clips' samples."""
    import scipy.io.wavfile

    from saev_tpu_torch.models import bird_mae

    root.mkdir(parents=True)
    labels = [k for k, v in BIRD_TAXONOMY.items() if v == "Aves"]
    with open(root / "taxonomy.csv", "w") as fd:
        fd.write("primary_label,inat_taxon_id,scientific_name,common_name,class_name\n")
        for i, (label, cls) in enumerate(BIRD_TAXONOMY.items()):
            fd.write(f"{label},{100 + i},Genus species{i},Name {i},{cls}\n")
    rows, clips = [], []
    t = np.arange(SR * 5) / SR
    lo, hi = TONE_T[0] * bird_mae.SAMPLES_PER_TIME_PATCH, (TONE_T[-1] + 1) * bird_mae.SAMPLES_PER_TIME_PATCH
    for n in range(CLIPS + 1):
        label = labels[n % len(labels)] if n < CLIPS else "41663"
        x = 0.02 * rng.standard_normal(t.size)
        if n in PLANTED:
            x[lo:hi] += 0.5 * np.sin(2 * np.pi * TONE_HZ * t[lo:hi])
        pcm = np.clip(x * 32000, -32768, 32767).astype(np.int16)
        (root / "train_audio" / label).mkdir(parents=True, exist_ok=True)
        scipy.io.wavfile.write(root / "train_audio" / label / f"XC{n}.wav", SR, pcm)
        rows.append(f"{label},[],['call'],{label}/XC{n}.wav,XC,4.0")
        if n < CLIPS:
            clips.append(pcm)
    (root / "train.csv").write_text("primary_label,secondary_labels,type,filename,collection,rating\n"
                                    + "\n".join(rows) + "\n")
    return clips


def _bird_shards(shards_root: pathlib.Path, audio_root: pathlib.Path, rng) -> tuple[pathlib.Path, np.ndarray]:
    """Bird-MAE-family shards of the clips at d_model BIRD_D: noise, channel
    BAD raised by 40, and the tone's patches (time TONE_T, mel patch 6)
    shifted along a unit direction that has no BAD component."""
    from saev_tpu_torch.data import datasets, shards

    md = shards.Metadata(
        family="bird-mae", ckpt="Bird-MAE-Base", layers=(0,), content_tokens_per_example=256, cls_token=False,
        d_model=BIRD_D, n_examples=CLIPS, max_tokens_per_shard=256 * 4,
        data=shards.encode_dataset_cfg(datasets.BirdClef2025(root=audio_root)), dataset=audio_root)
    md.dump(shards_root)
    direction = rng.standard_normal(BIRD_D)
    direction[BAD] = 0.0
    direction /= np.linalg.norm(direction)
    acts = 0.3 * rng.standard_normal((CLIPS, 256, BIRD_D)).astype(np.float32)
    acts[:, :, BAD] += 40.0
    tone = [t * 8 + 6 for t in TONE_T]
    for c in PLANTED:
        acts[c, tone] += 3.0 * direction.astype(np.float32)
    with shards.ShardWriter(shards_root, md) as writer:
        writer.write_batch(acts[:, None], 0)
    return shards_root / md.hash, direction


def _bird_run(runs_root: pathlib.Path, shards_dir: pathlib.Path, direction: np.ndarray,
              d_sae: int = BIRD_SAE) -> pathlib.Path:
    """b1: a TopK SAE of `d_sae` latents whose latent 0 reads the tone's
    direction (bias -6, so it fires on the tone's patches only) and whose
    latents read nothing of channel BAD; the port's inference (CPU) over the
    clips."""
    import torch

    from saev_tpu_torch import disk
    from saev_tpu_torch.data import OrderedConfig
    from saev_tpu_torch.framework import inference
    from saev_tpu_torch.nn import modeling, serialize

    cfg = modeling.SparseAutoencoderConfig(d_model=BIRD_D, d_sae=d_sae, activation=modeling.TopK(top_k=BIRD_K))
    params, state = modeling.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    params["W_enc"][BAD] = 0.0
    params["W_enc"][:, 0] = 4.0 * torch.from_numpy(direction).float()
    params["b_enc"][0] = -6.0
    params["W_dec"][0] = torch.from_numpy(direction).float()
    rel = pathlib.Path("..", "..", "..", "shards", shards_dir.name)
    run = disk.Run.new("b1", train_shards_dir=rel, val_shards_dir=rel, runs_root=runs_root)
    serialize.dump(run.run_dir / "checkpoint" / "sae.pt", cfg, params, state)
    inference.worker_fn(inference.Config(run=run.run_dir, data=OrderedConfig(shards=shards_dir, layer=0,
                                                                             batch_size=512), device="cpu"))
    return run.run_dir


def _study_runs(study: pathlib.Path, shard_names: dict, rng) -> None:
    """runs.load_df's inputs: three run dirs (config.json; per shard
    metrics.json, nested trait_metrics.json, classification_<task>.json,
    audit_results.json, probe1d_metrics.npz), one without inference; and the
    probe files fig_latent_vs_purity reads."""
    for i, (run_id, act) in enumerate((("s1", "top-k"), ("s2", "relu"), ("s3", "top-k"))):
        ckpt = study / "runs" / run_id / "checkpoint"
        ckpt.mkdir(parents=True)
        (ckpt / "config.json").write_text(json.dumps({
            "sae": {"d_sae": 64 * (i + 1), "activation": {"key": act, "top_k": 8 if act == "top-k" else None}},
            "lr": 1e-3 * (i + 1), "optim": "adam", "seed": i}))
        if run_id == "s3":
            continue
        for split, shard in shard_names.items():
            art = study / "runs" / run_id / "inference" / shard
            art.mkdir(parents=True)
            (art / "metrics.json").write_text(json.dumps({"mse": float(rng.random()), "l0": float(8 + rng.random()),
                                                          "normalized_mse": float(rng.random()), "note": "x"}))
            (art / "trait_metrics.json").write_text(json.dumps({
                "mean_ap": float(rng.random()), "purity_16": {"mean": float(rng.random()), "min": 0.0},
                "n": 4, "ok": True, "skip": [1, 2]}))
            (art / "classification_habitat.json").write_text(json.dumps({"accuracy": float(rng.random()), "n": 3}))
            (art / "audit_results.json").write_text(json.dumps({"classifiers": [
                {"auc_b": float(rng.random())}, {"auc_b": None}, {"auc_b": float(rng.random())}]}))
            np.savez(art / "probe1d_metrics.npz", loss=rng.random((16, 5)).astype(np.float32),
                     weights=rng.standard_normal((16, 5)).astype(np.float32))
            if split == "test":
                np.savez(art / f"probe1d_metrics__train-{shard_names['train']}.npz",
                         top_labels=rng.integers(0, 5, (16, 20)))


def _results(study: pathlib.Path, rng) -> None:
    """FishVista Result JSONs (the dump of fishvista.utils.Result), one a
    list, one broken, one of another prefix; CUB's attributes.txt."""
    res = study / "results"
    res.mkdir()
    specs = (("sae", 64, {"layer": 5, "vit_family": "fake-clip"}), ("random", 64, {"layer": 5}),
             ("pca", 32, {"layer": 5, "n_train": 300}), ("sae", 32, None))
    for i, (method, n_protos, extra) in enumerate(specs):
        n = 12 if i else 11  # one result past FISHVISTA_CLASS_NAMES' ten classes
        test_ap = rng.random(n).round(6).tolist()
        result = {"method": method, "n_prototypes": n_protos, "best_prototype_per_class": rng.integers(0, 64, n).tolist(),
                  "train_ap_per_class": rng.random(n).tolist(), "test_ap_per_class": test_ap,
                  "mean_ap": float(np.mean(test_ap)), "n_train_patches": 1000 + i, "n_test_patches": 500, "seed": i,
                  "extra": extra}
        payload = [result, {**result, "seed": 9}] if i == 3 else result
        (res / f"fishvista_{method}_{n_protos}_{i}.json").write_text(json.dumps(payload))
    (res / "fishvista_broken.json").write_text("{not json")
    (res / "other_sae.json").write_text((res / "fishvista_sae_64_0.json").read_text())
    (study / "attributes.txt").write_text("1 has_bill_shape::curved\n2 has_wing_color::blue\n\n10 has_size::small (5 - 9 in)\n")


def _telemetry(study: pathlib.Path) -> None:
    """A probe1d.stats log: the port's probe fit (CPU) with the stats logger
    at DEBUG under logging's usual prefix, then CSR-load events, a malformed
    event and lines that are not events."""
    import logging

    import scipy.sparse

    from saev_tpu_torch.tdiscovery import probe1d

    fpath = study / "probe1d.log"
    handler = logging.FileHandler(fpath)
    handler.setFormatter(logging.Formatter("[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s"))
    stats = logging.getLogger("probe1d.stats")
    old = stats.level
    stats.setLevel(logging.DEBUG)
    stats.addHandler(handler)
    try:
        rng = np.random.default_rng(1)
        x = np.where(rng.uniform(size=(128, 4)) < 0.4, 1.0, 0.0).astype(np.float32)
        y = (rng.uniform(size=(128, 3)) < 0.3).astype(np.float32)
        probe1d.Sparse1DProbe(n_latents=4, n_classes=3, class_slab_size=2, max_iter=5, device="cpu").fit(
            scipy.sparse.csr_matrix(x), y)
    finally:
        stats.removeHandler(handler)
        stats.setLevel(old)
        handler.close()
    with open(fpath, "a") as fd:
        ts = "2026-01-02T03:04:05+00:00"
        fd.write(json.dumps({"event": "load_csr_start", "timestamp": ts, "split": "train", "fpath": "/x/a.npz"}) + "\n")
        fd.write("[t] [INFO] [x] " + json.dumps({"event": "load_csr_end", "timestamp": ts, "split": "train", "nnz": 12,
                                                   "rss_gb": 1.5}) + "\n")
        fd.write(json.dumps({"event": "probe_iteration", "timestamp": ts, "slab": [0], "iter": 0}) + "\n")
        fd.write("no event here {not json\n[1, 2]\n" + json.dumps({"event": "other"}) + "\n")


def _mimic_ckpt(runs_root: pathlib.Path, run_id: str, shard_id: str, task: str, *, C=0.1, seed=0, separable=True,
                patch_agg="max", key="sparse-linear") -> None:
    """A cls_*.pkl checkpoint in train_worker_fn's format with a scikit-learn
    L1 head fit on seeded features, as tests/test_td_fishbase_mimicry.py
    writes them."""
    import sklearn.linear_model

    rng = np.random.default_rng(seed)
    n, d = 40, 12
    y = np.arange(n) % 2
    x = rng.random((n, d)) * 0.1
    if separable:
        x[:, 3] = y * 2.0
    clf = sklearn.linear_model.LogisticRegression(penalty="l1", C=C, solver="liblinear", max_iter=50).fit(x, y)
    pred = clf.predict(x)
    if not separable:
        pred[:3] = 1 - pred[:3]
    header = {"cfg": {"task": {"name": task, "source_col": "subspecies_view"}, "patch_agg": patch_agg,
                      "cls": {"key": key, "C": C}},
              "test_acc": float((pred == y).mean()), "n_classes": 2, "class_names": ["erato", "melpomene"]}
    out = runs_root / run_id / "inference" / shard_id
    out.mkdir(parents=True, exist_ok=True)
    with open(out / f"cls_{task}_{patch_agg}_C{C}_{key}.pkl", "wb") as fd:
        fd.write((json.dumps(header) + "\n").encode())
        pickle.dump({"classifier": clf, "test_pred": pred, "test_y": y}, fd)


def _mimic_runs(root: pathlib.Path) -> None:
    easy, hard = "notabilis_dorsal_vs_plesseni_dorsal", "cyrbia_dorsal_vs_cythera_dorsal"
    _mimic_ckpt(root, "runA", "sh1", easy, C=0.1)
    _mimic_ckpt(root, "runA", "sh1", hard, C=0.1, separable=False, seed=1)
    _mimic_ckpt(root, "runB", "sh1", easy, C=1.0, seed=2)
    _mimic_ckpt(root, "runB", "sh1", hard, C=0.01, separable=False, seed=3)
    _mimic_ckpt(root, "runA", "sh1", easy, C=7.0)  # C not allowed
    _mimic_ckpt(root, "runA", "sh1", easy, patch_agg="mean")
    _mimic_ckpt(root, "runA", "sh1", "unknown_task")
    _mimic_ckpt(root, "runB", "sh1", hard, key="decision-tree")
    (root / "runB" / "inference" / "sh1" / "cls_broken.pkl").write_bytes(b"not a checkpoint\n")


def _png_bytes(color) -> np.ndarray:
    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGB", (16, 16), color).save(buf, format="PNG")
    return np.frombuffer(buf.getvalue(), dtype=np.uint8)


def _tol_store(root: pathlib.Path) -> None:
    """A TreeOfLife-200M layout (as tests/test_freshwater_fish.py lays it out):
    resolved-taxa parquet partitions, a uuid -> h5_file lookup, HDF5 images,
    and taxa files in CSV and parquet."""
    import h5py
    import pyarrow as pa
    import pyarrow.parquet as pq

    taxa = root / "resolved_taxa" / "source=gbif"
    taxa.mkdir(parents=True)
    pq.write_table(pa.table({
        "uuid": ["u1", "u2", "u3", "u4", "u5"],
        "class": ["Actinopterygii", "Actinopterygii", "Insecta", "Actinopterygii", "Actinopterygii"],
        "order": ["Cypriniformes", "Perciformes", "Coleoptera", "Cypriniformes", "Perciformes"],
        "family": ["Cyprinidae", "Percidae", "Carabidae", "Cyprinidae", "Percidae"],
        "species": ["Danio rerio", "Perca fluviatilis", "Carabus auratus", None, "Perca flavescens"],
    }), taxa / "part0.parquet")
    (root / "resolved_taxa" / "source=eol").mkdir()
    lookup = root / "lookup_tables"
    lookup.mkdir()
    h5 = root / "images0.h5"
    pq.write_table(pa.table({"uuid": ["u1", "u2", "u3", "u5"], "h5_file": [str(h5)] * 3 + [str(root / "missing.h5")]}),
                   lookup / "lookup0.parquet")
    with h5py.File(h5, "w") as fd:
        g = fd.create_group("images")
        for uuid, color in (("u1", (255, 0, 0)), ("u2", (0, 255, 0)), ("u3", (0, 0, 255))):
            g.create_dataset(uuid, data=_png_bytes(color))
        g.create_dataset("bad", data=np.frombuffer(b"not an image", dtype=np.uint8))
    (root / "taxa.csv").write_text("Family,other\nCyprinidae,1\nPercidae,2\n")
    pq.write_table(pa.table({"species": ["Perca fluviatilis", None]}), root / "taxa.parquet")
    (root / "bad_taxa.csv").write_text("kingdom\nAnimalia\n")


def _fish_gallery(root: pathlib.Path, rng) -> None:
    """make_gallery's inputs: a dataset's images/validation (with a non-image
    file and a subfolder) and labels.csv, a run's per-latent `{j}_sae_img.png`
    and var.parquet."""
    import pandas as pd
    from PIL import Image

    img_dir = root / "fishdata" / "images" / "validation"
    (img_dir / "sub").mkdir(parents=True)
    stems = [f"fish{i:02d}" for i in range(6)]
    for i, stem in enumerate(stems):
        Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).save(
            (img_dir / "sub" if i == 5 else img_dir) / f"{stem}.png")
    (img_dir / "notes.txt").write_text("not an image")
    (root / "fishdata" / "labels.csv").write_text(
        "stem,species\n" + "".join(f"{s},Species {i % 3}\n" for i, s in enumerate(stems[:5])))
    art = root / "fishrun" / "inference" / "fsh"
    for f in (0, 2, 5):
        (art / "images" / str(f)).mkdir(parents=True)
        for j in range(2 if f != 5 else 0):
            Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).save(art / "images" / str(f) / f"{j}_sae_img.png")
    (art / "images" / "notalatent").mkdir()
    pd.DataFrame({"feature": np.arange(8), "log10_freq": -rng.random(8) * 3, "log10_value": rng.standard_normal(8),
                  "topk_example_idx": [rng.integers(0, 6, 4).tolist() for _ in range(8)]}).to_parquet(art / "var.parquet")


def _ade_download(root: pathlib.Path, stems: dict[str, str]) -> None:
    """An ADE20K download (tests/test_td_dataprep.py's tree)."""
    from PIL import Image

    for i, stem in enumerate(stems):
        split = "training" if i % 2 == 0 else "validation"
        (root / "images" / split).mkdir(parents=True, exist_ok=True)
        (root / "annotations" / split).mkdir(parents=True, exist_ok=True)
        Image.new("RGB", (4, 4), (i, 0, 0)).save(root / "images" / split / f"{stem}.jpg")
        Image.new("L", (4, 4), i).save(root / "annotations" / split / f"{stem}.png")
    (root / "sceneCategories.txt").write_text("".join(f"{stem} {label}\n" for stem, label in stems.items()))


FV_SPECIES = (("fish_a.jpg", "Thunnus albacares"), ("fish_b.jpg", "Amphiprion ocellaris"),
              ("fish_c.jpg", "Nomatchus nada"), ("fish_d.jpg", "Thunnus albacares x"), ("fish_e.png", "Solo"))


def _fishvista(root: pathlib.Path) -> None:
    """A FishVista download (as tests/test_td_dataprep.py lays it out): Images/,
    segmentation masks and the per-split manifests."""
    from PIL import Image

    (root / "Images").mkdir(parents=True)
    (root / "segmentation_masks" / "images").mkdir(parents=True)
    splits = {"train": [], "val": [], "test": []}
    for i, (fname, sp) in enumerate(FV_SPECIES):
        if i != 3:
            Image.new("RGB", (8, 8), (i, i, i)).save(root / "Images" / fname)
        Image.new("L", (8, 8), i).save(root / "segmentation_masks" / "images" / f"{pathlib.Path(fname).stem}.png")
        splits[["train", "val", "test"][i % 3]].append((fname, sp))
    for split, rows in splits.items():
        for kind in ("segmentation", "classification"):
            with open(root / f"{kind}_{split}.csv", "w", newline="") as fd:
                writer = csv.writer(fd)
                writer.writerow(["filename", "family", "standardized_species"])
                writer.writerows([fname, "Testidae", sp] for fname, sp in rows)


def _fishbase_traits(fpath: pathlib.Path) -> None:
    from saev_tpu_torch.tdiscovery.scripts import format_fishvista as fv

    cols = ["genus", "species", *fv.HABITAT_COLS, *fv.MIGRATION_COLS, *fv.ENV_COLS]
    rows = [{"genus": "thunnus", "species": "albacares", "pelagic-oceanic": "1.0", "pelagic": "1", "oceanodromous": "1.0",
             "marine": "1.0"},
            {"genus": "amphiprion", "species": "ocellaris", "reef-associated": "1.0", "non-migratory": "?",
             "marine": "1.0", "brackish": "x"}]
    with open(fpath, "w", newline="") as fd:
        writer = csv.DictWriter(fd, fieldnames=cols)
        writer.writeheader()
        writer.writerows({c: row.get(c, "") for c in cols} for row in rows)


FISHBASE_PAGES = {
    "full": """<html><head><script>var x = "pelagic nonsense";</script><style>.demersal{}</style></head><body>
<h1>Thunnus albacares</h1><div>Environment: milieu / climate zone / depth range / distribution range
Marine; brackish; pelagic-oceanic; oceanodromous; depth range 1 - 250 m, usually 1 - 100 m.
pH range: 6.5 - 8.0; dH range: 5 - 19. Reef associated; non migratory.</div></body></html>""",
    "unknown": "<html><body>Freshwater; benthopelagic; depth range ? - 40 m, usually ? - 5 m.</body></html>",
    "private": "<html><body>This species is not in the public version of FishBase.</body></html>",
}


def _push_runs(root: pathlib.Path, rng) -> None:
    """push_dinov3's inputs: eight runs with schema-5 SAE files, their eval
    metrics in the offline tracker (flat and nested keys) or in the run's
    metrics.json, a run with neither, a run file over two layers."""
    import torch

    from saev_tpu_torch.nn import modeling, serialize

    cfg = modeling.SparseAutoencoderConfig(d_model=8, d_sae=16, activation=modeling.TopK(top_k=2))
    l0s = (2.0, 4.0, 4.0, 8.0, 16.0, 32.0, 64.0, 3.0)
    mses = (0.9, 0.5, 0.6, 0.4, 0.3, 0.2, 0.1, 0.95)
    (root / "tracker" / "saev").mkdir(parents=True)
    (root / "tracker" / "aaa").mkdir()
    for i, (l0, mse) in enumerate(zip(l0s, mses)):
        run_id = f"p{i}"
        params, state = modeling.init(cfg, torch.Generator().manual_seed(i), device="cpu")
        (root / "runs" / run_id / "checkpoint").mkdir(parents=True)
        serialize.dump(root / "runs" / run_id / "checkpoint" / "sae.pt", cfg, params, state)
        if i % 3 == 0:
            (root / "runs" / run_id / "metrics.json").write_text(json.dumps({"l0": l0, "mse": mse}))
        else:
            rec = root / "tracker" / "saev" / run_id
            rec.mkdir()
            summary = {"eval/l0": l0, "eval/mse": mse} if i % 3 == 1 else {"eval": {"l0": l0, "mse": mse}}
            (rec / "summary.json").write_text(json.dumps(summary))
    (root / "tracker" / "aaa" / "p1").mkdir()
    (root / "tracker" / "aaa" / "p1" / "summary.json").write_text("{broken")
    (root / "runs" / "p9" / "checkpoint").mkdir(parents=True)
    (root / "runs" / "p9" / "checkpoint" / "sae.pt").write_bytes(
        (root / "runs" / "p0" / "checkpoint" / "sae.pt").read_bytes())
    (root / "run_ids.json").write_text(json.dumps({"13": ["p0", "p1", "p2", "p3", "p4", "p5", "p6", "p7", "p9"],
                                                   "23": ["p3", "p4"]}))


def _build_tree(tree: pathlib.Path) -> None:
    rng = np.random.default_rng(0)
    shards_root = tree / "saev" / "shards"
    shards_root.mkdir(parents=True)
    _birdclef(tree / "birdclef", rng)
    bird, direction = _bird_shards(shards_root, tree / "birdclef", rng)
    runs_root = tree / "saev" / "runs"
    runs_root.mkdir(parents=True)
    _bird_run(runs_root, bird, direction)

    seg_root = tree / "data" / "ADE20K"
    labels = _seg_dataset(seg_root, rng)
    centers = (2 * rng.standard_normal((3, 32))).astype(np.float32)
    img = {split: _shards(shards_root, seg_root, split, labels[split], centers, rng) for split in ("train", "test")}
    (tree / "shard_names.json").write_text(json.dumps({"bird": bird.name, **{s: d.name for s, d in img.items()}}))
    study = tree / "study"
    _study_runs(study, {s: d.name for s, d in img.items()}, rng)
    _results(study, rng)
    _telemetry(study)
    (study / "traits.csv").write_text("genus,species,habitat,depth\nThunnus,Albacares, Pelagic-Oceanic ,x\n"
                                      "amphiprion,ocellaris,reef-associated,y\ndanio,rerio,Demersal,z\n")
    _mimic_runs(tree / "mimic_runs")
    _tol_store(tree / "tol")
    _fish_gallery(tree, rng)
    _ade_download(tree / "ade", {"ADE_train_1": "kitchen", "ADE_val_2": "beach", "ADE_train_3": "kitchen",
                                 "ADE_val_4": "street"})
    (tree / "ade_csv" / "images" / "training").mkdir(parents=True)
    _ade_download(tree / "ade_csv", {"s1": "wrong", "s 2": "wrong"})
    (tree / "ade_csv" / "labels.csv").write_text("stem,scene\ns1,right\ns 2,two words\n")
    _ade_download(tree / "ade_bad", {"only_img": "x"})
    (tree / "ade_bad" / "sceneCategories.txt").write_text("other_stem x\n")
    _fishvista(tree / "fv")
    _fishbase_traits(tree / "fv_traits.csv")
    (tree / "fv_pages").mkdir()
    for name, page in FISHBASE_PAGES.items():
        (tree / "fv_pages" / f"{name}.html").write_text(page)
    (tree / "fishbase_done.csv").write_text("family,genus,species\nScombridae,thunnus,albacares\n")
    _push_runs(tree / "push", rng)


def _shard_names(tree: pathlib.Path) -> dict[str, str]:
    return json.loads((tree / "shard_names.json").read_text())


# ---------------------------------------------------------------------------
# Plain forms of what plain() does not know
# ---------------------------------------------------------------------------


def _fig(fig) -> list:
    """A matplotlib figure as what it plots: each axes' title, labels,
    scales, lines' and collections' data and texts; the suptitle."""
    import matplotlib.pyplot as plt

    out = []
    for ax in fig.axes:
        out.append({"title": ax.get_title(), "xlabel": ax.get_xlabel(), "ylabel": ax.get_ylabel(),
                    "xscale": ax.get_xscale(), "yscale": ax.get_yscale(),
                    "lines": [np.asarray(line.get_xydata(), np.float64) for line in ax.lines],
                    "points": [np.asarray(c.get_offsets(), np.float64) for c in ax.collections],
                    "texts": [t.get_text() for t in ax.texts],
                    "legend": [t.get_text() for t in ax.get_legend().get_texts()] if ax.get_legend() else None})
    out.append(fig._suptitle.get_text() if fig._suptitle is not None else None)
    out.append([t.get_text() for lg in fig.legends for t in lg.get_texts()])
    plt.close(fig)
    return out


def _clips(root: pathlib.Path, vorbis) -> dict:
    """Every clip under `root`, decoded: WAV to its int16 samples, Ogg to its
    float samples (the package's own Vorbis reader)."""
    out = {}
    for p in sorted(root.rglob("*")):
        if p.suffix == ".wav":
            with wave.open(str(p)) as w:
                out[str(p.relative_to(root))] = (w.getframerate(), np.frombuffer(w.readframes(w.getnframes()), "<i2"))
        elif p.suffix == ".ogg":
            samples, sr = vorbis.read_ogg(p)
            out[str(p.relative_to(root))] = (sr, np.asarray(samples))
    return out


def _events(events) -> list:
    return [(type(e).__name__, {k: v.isoformat() if isinstance(v, datetime.datetime) else v
                                for k, v in dataclasses.asdict(e).items()}) for e in events]


def _tree_files(root: pathlib.Path) -> dict:
    """Every file under `root`: its path, and its bytes for text files,
    decoded pixels for images, the target for symlinks."""
    from PIL import Image

    out = {}
    for p in sorted(root.rglob("*")):
        rel = str(p.relative_to(root))
        if p.is_symlink():
            out[rel] = ("link", os.readlink(p))
        elif p.suffix in (".png", ".jpg"):
            out[rel] = np.asarray(Image.open(p))
        elif p.is_file():
            out[rel] = p.read_text()
    return out


def assert_same(got, want, where: str = "") -> None:
    """test_torch_contrib_host's `assert_same`, but two strings that differ
    fail with the first differing offset and its context: an assertion's
    diff of two pages with inline images would take minutes."""
    if isinstance(want, str) and isinstance(got, str):
        if got != want:
            i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), min(len(got), len(want)))
            pytest.fail(f"{where}: strings differ at {i} of {len(got)} / {len(want)}: "
                        f"{got[max(i - 80, 0):i + 80]!r} != {want[max(i - 80, 0):i + 80]!r}")
    elif isinstance(want, dict) and isinstance(got, dict) and sorted(got, key=str) == sorted(want, key=str):
        for key in want:
            assert_same(got[key], want[key], f"{where}/{key}")
    elif isinstance(want, list) and isinstance(got, list) and len(got) == len(want):
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    else:
        _assert_same(got, want, where)


def _error(fn) -> str:
    try:
        fn()
    except (AssertionError, ValueError) as err:
        return f"{type(err).__name__}: {err}"
    return "no error"


# ---------------------------------------------------------------------------
# The pipelines: the same calls on each package's modules
# ---------------------------------------------------------------------------


def _birdsong(m, tree: pathlib.Path) -> dict:
    names, runs = _shard_names(tree), tree / "saev" / "runs"
    bird = tree / "saev" / "shards" / names["bird"]
    art = runs / "b1" / "inference" / names["bird"]
    out = {}
    m.visuals.worker_fn(m.visuals.Config(run=runs / "b1", shards=bird, latents=(0,), n_latents=2, top_k=4, n_clips=3))
    out["visuals"] = {"var": m.pd.read_parquet(art / "var.parquet"), "images": _pixels(art / "clips"),
                      "clips": _clips(art / "clips", m.vorbis)}
    rng = np.random.default_rng(3)
    fb, acts = rng.standard_normal((512, 128)).astype(np.float32), np.zeros(256, np.float32)
    acts[5 * 8 + 2], acts[7] = 3.0, 1.0
    (tree / "drawn").mkdir()
    m.visuals.write_wav(tree / "drawn" / "tone.wav", 0.5 * np.sin(np.arange(3200) / 7.0), SR)
    m.visuals.write_clip(tree / "drawn" / "clip", rng.uniform(-1.2, 1.2, 4000), SR)
    out["drawing"] = {"spectrogram": [np.asarray(m.visuals.spectrogram_image(fb)), np.asarray(m.visuals.spectrogram_image(fb, scale=2))],
                      "sae": [np.asarray(m.visuals.sae_spectrogram_image(fb, acts)),
                              np.asarray(m.visuals.sae_spectrogram_image(fb, np.zeros(256), scale=2))],
                      "clips": _clips(tree / "drawn", m.vorbis)}
    (tree / "notes.json").write_text(json.dumps({"0": "a <tone> at 10 kHz", "9": "absent"}))
    pages = [m.make_html.make(m.make_html.Config(run=runs / "b1", shards=bird, embed=True, notes=tree / "notes.json",
                                                 out=tree / "embed.html")),
             m.make_html.make(m.make_html.Config(run=runs / "b1", shards=bird, latents=(0, 63), out=tree / "page.html")),
             m.make_html.make(m.make_html.Config(run=runs / "b1", shards=bird))]
    out["make_html"] = [(p, p.read_text()) for p in pages]
    (runs / "nolayout" / "inference" / "x" / "clips").mkdir(parents=True)
    roots = [runs, tree / "missing"]
    found = m.browse.discover_runs(roots)
    out["browse"] = {"discover": found, "with_clips": [m.browse.shards_with_clips(runs / r) for r in ("b1", "nolayout", "zzz")],
                     "pages": {p.name: p.read_text() for p in m.browse.build_browsers(roots, tree / "site")},
                     "relative": {p.name: p.read_text() for p in m.browse.build_browsers(
                         roots, tree / "site2", embed=False, runs=found)}}
    img = tree / "saev" / "shards" / names["test"]
    report = m.stats.report({"bird": (bird, 0), "image": (img, 0)}, n=600, seed=1, out=tree / "report.json")
    planted = rng.standard_normal((500, 24))
    planted[:, 17] *= 80.0
    s = m.stats.compute_stats(planted)
    out["stats"] = {"report": report, "file": (tree / "report.json").read_text(),
                    "sample": [m.stats.sample_acts(bird, layer=0, n=50, seed=2), m.stats.sample_acts(img, layer=0, n=10)],
                    "planted": [s, m.stats.outlier_dims(s), m.stats.outlier_dims(s, z=3.0), m.stats.norm_histogram(s, bins=7),
                                m.stats.compare(s, m.stats.compute_stats(rng.standard_normal((40, 24))), names=("a", "b"))]}
    return out


def _study_frame(rng):
    """A probe-results frame with the columns figplots reads: two models,
    three layers, six runs each."""
    import pandas as pd

    rows = []
    for m_i, model in enumerate(("DINOv2 ViT-L/14", "CLIP ViT-B/16")):
        for layer in (5, 11, 23):
            for r in range(6):
                rows.append({"run_id": f"{m_i}{layer}{r}", "model": model, "layer": layer,
                             "objective": ("vanilla", "matryoshka")[r % 2],
                             "sae_val_l0": float(2 ** (r + 2)), "val_nmse": float(rng.random()),
                             "val_probe_r": float(rng.random()), "train_probe_r": float(rng.random()),
                             "val_mean_ap": float(rng.random()) if r != 3 else np.nan,
                             "val_mean_purity_16": float(rng.random()), "cov_at_0_5": float(rng.random()),
                             "train_probe_ce": float(rng.random()), "val_probe_ce": float(rng.random()),
                             "train_baseline_ce": 0.5 + 0.1 * m_i, "val_baseline_ce": 0.6 + 0.1 * m_i})
    return pd.DataFrame(rows)


def _ablation_frame():
    """tests/test_td_ablations.py's frame: 2 variants x 2 layers x 3 L0
    points, with a second data key and one run lacking its metrics."""
    import pandas as pd

    rows, rid = [], 0
    for aux in ("auxk", "no-aux"):
        for layer in (13, 23):
            for k, l0 in enumerate((16.0, 64.0, 256.0)):
                nmse = 1.0 / (1 + l0 / 64) + (0.0 if aux == "auxk" else 0.05)
                rows.append({"run_id": f"r{rid}", "data_key": "FakeData" if rid % 5 else "Other",
                             "config/val_data/layer": layer, "config/sae/activation/aux/key": aux,
                             "config/sae/d_sae": 1000, "summary/eval/l0": l0,
                             "summary/eval/normalized_mse": nmse if rid != 7 else np.nan,
                             "summary/loss/n_dead": 50 if aux == "auxk" else 400,
                             "summary/eval/n_dead": 80 if aux == "auxk" else 500 + rid,
                             "train_probe_r": 0.1 + 0.01 * k + (0.2 if aux == "auxk" else 0),
                             "val_probe_r": 0.05 * k, "is_pareto": bool(k % 2)})
                rid += 1
    return pd.DataFrame(rows)


def _study(m, tree: pathlib.Path) -> dict:
    names, study = _shard_names(tree), tree / "study"
    rng = np.random.default_rng(4)
    out = {}
    specs = [m.runs.RunSpec(run=study / "runs" / r, method=meth, note=f"n{r}")
             for r, meth in (("s1", "sae"), ("s2", "pca"), ("s3", "sae"), ("gone", "sae"))]
    df, skipped = m.runs.load_df(specs)
    xs, ys = np.array([4.0, 4.0, 2.0, 8.0, 8.0, 1.0, 16.0]), np.array([0.5, 0.4, 0.6, 0.3, 0.3, 0.9, 0.35])
    out["runs"] = [df, skipped, m.runs.shard_columns(df, names["test"]), m.runs.shard_columns(df, names["train"], suffix="_b"),
                   m.runs.pareto_front(xs, ys), m.runs.load_df([])[0]]

    rdf = m.results.load_results_df(study / "results", prefix="fishvista")
    out["results"] = [rdf, m.results.load_results_df(study / "results"), m.results.map_table(rdf),
                      m.results.map_table(rdf, ["method", "layer", "nope"]), m.results.best_latents(rdf),
                      m.results.best_latents(rdf, method="sae", min_train_patches=1003),
                      m.results.best_latents(rdf, method="absent"), m.results.method_vs_random(rdf),
                      m.results.method_vs_random(rdf, n_prototypes=32), m.results.load_cub_attributes(study / "attributes.txt")]

    events = m.logparse.load_events(study / "probe1d.log")
    idf = m.logparse.iters_df(events)
    lines = [m.logparse.parse_line(line) for line in (study / "probe1d.log").read_text().splitlines()[:3]]
    out["logparse"] = [_events(events), _events([e for e in lines if e is not None]),
                       idf.assign(timestamp=idf["timestamp"].astype(str)), m.logparse.summarize(events),
                       m.logparse.summarize([]), m.logparse.iters_df([])]
    out["logparse figures"] = [_fig(f(idf)) for f in (m.logparse.fig_loss, m.logparse.fig_grad, m.logparse.fig_memory,
                                                      m.logparse.fig_trust_region)]

    fb = m.fishbase
    n_ex, tokens, d_sae = 60, 4, 16
    trait_idx = rng.integers(0, 3, n_ex).astype(np.int32)
    trait_idx[:5] = -1
    part_labels = rng.integers(0, 5, n_ex * tokens)
    acts = rng.random((n_ex * tokens, d_sae)) * 0.1
    acts[(part_labels == 3) & (np.repeat(trait_idx, tokens) == 1), 7] = 5.0
    acts[:, 9] = 0.0
    labels = rng.random(n_ex * tokens) < 0.3
    table = fb.load_trait_table(study / "traits.csv")
    vocab = fb.HABITATS[:3]
    scored = {s: fb.score_part_by_trait(acts, part_labels, trait_idx, tokens, vocab=vocab, parts=fb.PART_NAMES[:5],
                                        scorer=s) for s in ("pearson", "auc", "log_odds")}
    comp = fb.score_part_by_comparison(acts, part_labels, trait_idx, tokens, comparisons=(
        {"early": (vocab[0],), "late": (vocab[1], vocab[2])},), vocab=vocab, parts=fb.PART_NAMES[:5])
    out["fishbase"] = [fb.fast_auc(acts, labels), fb.fast_pearson(acts, labels), fb.activation_freq_ratio(acts, labels),
                       fb.activation_freq_ratio(acts, labels, threshold=0.05),
                       [fb.parse_species(s) for s in ("Scombridae_Thunnus_albacares", "Cyprinidae_Danio", "x", " a_b_c_d ")],
                       {"|".join(k): v for k, v in table.items()},
                       fb.example_traits(["Scombridae_Thunnus_albacares", "Pomacentridae_Amphiprion_ocellaris",
                                          "Cyprinidae_Danio_rerio", "Nope_Nope"], table, "habitat"),
                       {s: [r.scores, r.parts, r.targets, sorted(r.best_latents()), r.table()] for s, r in scored.items()},
                       [comp.scores, comp.targets, comp.table()], fb.score_part_by_comparison(
                           acts, np.where(part_labels > 2, 0, part_labels), np.clip(trait_idx, 0, 2), tokens).table(),
                       fb.trait_coverage(trait_idx, vocab), fb.trait_coverage(np.array([0, 10, 10, -1]))]

    mi = m.mimicry
    shards = tree / "saev" / "shards" / names["test"]
    pairs = [("lativitta", "malleti"), ("lativitta", "cyrbia"), ("notabilis", "plesseni")]
    easy, hard = mi.task_name("notabilis", "plesseni", "dorsal"), mi.task_name("cyrbia", "cythera", "dorsal")
    harvested = mi.harvest_results(tree / "mimic_runs", filt=mi.HarvestFilter(tasks=frozenset({easy, hard})))
    out["mimicry"] = [mi.pair_counts(shards, pairs, min_samples_per_class=6),
                      mi.pair_counts(shards, pairs[:1], views=("dorsal",), min_samples_per_class=2), harvested,
                      mi.harvest_results(tree / "mimic_runs", filt=mi.HarvestFilter(tasks=frozenset({easy}), c_values=frozenset({1.0})),
                                         run_to_layer={"runB": 13}),
                      mi.difficulty_table(harvested), mi.sparsity_tradeoff(harvested),
                      [mi.rank_features(r, top_k=3) for r in harvested], mi.pretty_task_name(easy),
                      mi.pair_task("a", "b", "ventral"), mi.run_id_from_ckpt_fpath(pathlib.Path("runs/x/inference/s/c.pkl")),
                      mi.balanced_accuracy(np.array([0, 0, 1, 1, 2]), np.array([0, 1, 1, 1, 0]))]

    fp, sdf = m.figplots, _study_frame(rng)
    kw = {"model": "DINOv2 ViT-L/14", "layers": [5, 11, 23], "n_layers": 24}
    grids = [fp.fig_layerwise_explained_variance, fp.fig_layerwise_log_l0, fp.fig_layerwise_map, fp.fig_layerwise_probe_r,
             fp.fig_layerwise_purity, fp.fig_layerwise_cov]
    figures = {}
    for f in grids:
        fig, plotted = f(sdf, **kw)
        figures[f.__name__] = [_fig(fig), plotted]
    fig, sub = fp.fig_overfitting(sdf, model="CLIP ViT-B/16")
    figures["overfitting"] = [_fig(fig), sub]
    fig, fronts = fp.fig_tradeoff(sdf)
    figures["tradeoff"] = [_fig(fig), fronts]
    fig, fronts = fp.fig_tradeoff(sdf, y="val_mean_ap", group="objective", annotate_pareto=False)
    figures["tradeoff ap"] = [_fig(fig), fronts]
    fig, data = fp.fig_prevalence_vs_ap(shards, np.linspace(0, 1, 6))
    figures["prevalence"] = [_fig(fig), data]
    fig, data = fp.fig_latent_vs_purity(study / "runs" / "s1", names["train"], names["test"], k=8)
    figures["latent purity"] = [_fig(fig), data]
    figures["no model"] = _error(lambda: fp.fig_overfitting(sdf, model="nope"))
    tables = {"sae vs baselines": fp.table_sae_vs_baselines(sdf), "vit size": fp.table_vit_size(sdf),
              "vit family": fp.table_vit_family(sdf), "variants": fp.table_sae_variants(sdf),
              "custom": fp.comparison_table(sdf, [("best", {"layer": 11}), ("none", {"model": "absent"}),
                                                  ("no ap", {"layer": 5, "run_id": "053"})], pick="val_mean_ap")}
    fig, _ = fp.fig_tradeoff(sdf)
    written = fp.save_battery({"tradeoff": fig}, {"variants": tables["variants"]}, tree / "battery")
    out["figplots"] = [figures, tables, [p.name for p in written],
                       {p.name: p.read_text() for p in sorted((tree / "battery").iterdir()) if p.suffix != ".pdf"}]

    ab, adf = m.ablations, _ablation_frame()
    fig, pareto_ids = ab.fig_variant_grid(adf)
    fig_all, all_ids = ab.fig_variant_grid(adf, pareto_only=False)
    out["ablations"] = [ab.completeness(adf, expected=3), ab.completeness(adf.iloc[:-1], expected=3),
                        ab.completeness(adf.iloc[:0], expected=1), _error(lambda: ab.completeness(adf[["run_id"]], expected=1)),
                        ab.dead_units(adf), ab.dead_units(adf, pareto_only=False),
                        ab.dead_units(adf.drop(columns=["summary/loss/n_dead"])),
                        ab.best_by(adf, "train_probe_r"), ab.best_by(adf, "val_probe_r", pareto_only=False, display=("run_id",)),
                        ab.source_vs_downstream(adf, layer=13), ab.source_vs_downstream(adf.drop(columns=["is_pareto"]), layer=23),
                        [_fig(fig), {str(k): v for k, v in pareto_ids.items()}],
                        [_fig(fig_all), {str(k): v for k, v in all_ids.items()}],
                        ab.variant_effect(adf, baseline="no-aux"), ab.variant_effect(adf, metric="train_probe_r", baseline="auxk")]
    return out


def _fish(m, tree: pathlib.Path) -> dict:
    et, mg, tol = m.extract_tol, m.make_gallery, tree / "tol"
    base = et.Config(resolved_taxa_dpath=tol / "resolved_taxa", lookup_tables_dpath=tol / "lookup_tables",
                     output_dpath=tree / "fish_out", n_workers=2, sources=("gbif", "eol", "inat"))
    cfgs = {"orders": dataclasses.replace(base, order_filter=("Cypriniformes", "Perciformes")),
            "class": dataclasses.replace(base, class_filter="Insecta", label_column="family"),
            "taxa csv": dataclasses.replace(base, taxa_file=tol / "taxa.csv"),
            "taxa parquet": dataclasses.replace(base, taxa_file=tol / "taxa.parquet"), "all": base}
    out = {"pairs": {k: et.collect_pairs(c) for k, c in cfgs.items()},
           "taxa": [[(col, sorted(values)) for col, values in (et.load_taxa_filter(tol / "taxa.csv"),
                                                                 et.load_taxa_filter(tol / "taxa.parquet"))],
                    _error(lambda: et.load_taxa_filter(tol / "bad_taxa.csv"))],
           "lookup": [et.load_lookup(tol / "lookup_tables", {"u1", "u3", "u5", "u9"}), et.load_lookup(tol / "lookup_tables", {"u9"})]}
    out["extract"] = [et.extract_h5_file(tol / "images0.h5", [("u1", tree / "h5" / "a.jpg"), ("bad", tree / "h5" / "b.jpg"),
                                                              ("zzz", tree / "h5" / "c.jpg")], 90),
                      et.extract_h5_file(tol / "missing.h5", [("u1", tree / "h5" / "d.jpg")], 90),
                      et.worker_fn(cfgs["orders"]), et.worker_fn(cfgs["orders"]), et.worker_fn(cfgs["class"]),
                      et.worker_fn(dataclasses.replace(base, order_filter=("Nothing",))),
                      _tree_files(tree / "fish_out"), _tree_files(tree / "h5")]
    cfg = mg.Config(run=tree / "fishrun", shards=pathlib.Path("x/fsh"), dataset=tree / "fishdata", out=tree / "gallery.html")
    species = mg.load_species(cfg)
    var_df = m.pd.read_parquet(tree / "fishrun" / "inference" / "fsh" / "var.parquet")
    out["gallery"] = [species, mg.load_species(dataclasses.replace(cfg, dataset=None)),
                      mg.load_species(dataclasses.replace(cfg, stem_labels=tree / "fishdata" / "none.csv")),
                      mg.build_features(tree / "fishrun" / "inference" / "fsh" / "images", var_df, species, 70),
                      mg.build_features(tree / "fishrun" / "inference" / "fsh" / "images", var_df, None, 70),
                      mg.png_to_jpeg_b64(tree / "fishrun" / "inference" / "fsh" / "images" / "0" / "0_sae_img.png", 50),
                      mg.gallery(cfg).read_text(),
                      mg.gallery(dataclasses.replace(cfg, title="Fish", dataset=None, out=tree / "gallery2.html")).read_text()]
    return out


def _dataprep(m, tree: pathlib.Path) -> dict:
    from PIL import Image

    ade, fv, bf, sf, pd3 = m.format_ade20k, m.format_fishvista, m.download_butterflies, m.scrape_fishbase, m.push_dinov3
    out = {}
    shutil.copytree(tree / "ade", tree / "ade_linked")
    out["ade20k"] = [ade.read_labels(ade.Config(src_root=tree / "ade")), ade.read_labels(ade.Config(src_root=tree / "ade_csv")),
                     ade.format_ade20k(ade.Config(src_root=tree / "ade")),
                     ade.format_ade20k(ade.Config(src_root=tree / "ade", dump_to=tree / "ade_copy", link_mode="copy", n_threads=2,
                                                  job_size=3)),
                     ade.format_ade20k(ade.Config(src_root=tree / "ade_linked", dump_to=tree / "ade_sym", n_threads=2)),
                     ade.format_ade20k(ade.Config(src_root=tree / "ade", dump_to=tree / "ade_hard", link_mode="hardlink")),
                     _tree_files(tree / "ade"), _tree_files(tree / "ade_copy"), _tree_files(tree / "ade_sym"),
                     _tree_files(tree / "ade_hard"),
                     ade.format_ade20k(ade.Config(src_root=tree / "ade_csv")), _tree_files(tree / "ade_csv"),
                     _error(lambda: ade.format_ade20k(ade.Config(src_root=tree / "ade_bad")))]
    out["fishvista"] = [fv.collapse_fishbase_row({"pelagic": "1", "demersal": "1.0", "anadromous": "?", "marine": "1",
                                                  "freshwater": "0"}),
                        {"|".join(k): v for k, v in fv.load_fishbase(tree / "fv_traits.csv").items()},
                        fv.segfolder(fv.Config(fv_root=tree / "fv", dump_to=tree / "seg", fishbase_csv=tree / "fv_traits.csv",
                                               n_threads=2, job_size=1)),
                        fv.segfolder(fv.Config(fv_root=tree / "fv", dump_to=tree / "seg_plain", n_threads=2)),
                        fv.imgfolder(fv.Config(fv_root=tree / "fv", dump_to=tree / "imgf", n_threads=2)),
                        _tree_files(tree / "seg"), _tree_files(tree / "seg_plain"), _tree_files(tree / "imgf"),
                        _error(lambda: fv.write_labels_csv(fv.Config(fv_root=tree / "fv", dump_to=tree / "gate",
                                                                     fishbase_csv=tree / "fv" / "segmentation_val.csv")))]
    rng = np.random.default_rng(6)

    def rows(n):
        for i in range(n):
            img = Image.fromarray(rng.integers(0, 256, (6, 6, 3), dtype=np.uint8))
            mask = Image.fromarray(rng.integers(0, 4, (6, 6), dtype=np.uint8))
            buf = io.BytesIO()
            img.save(buf, format="PNG")
            yield {"stem": f"dir/img_{i % 4}.jpg", "subspecies": ("lativitta", "malleti")[i % 2],
                   "view": ("dorsal", "ventral")[i // 2 % 2], "photo": {"bytes": buf.getvalue()} if i % 3 else img,
                   "mask": mask}

    cfg = bf.Config(out=tree / "bfly")
    out["butterflies"] = [bf.materialize(cfg, list(rows(5))), bf.materialize(cfg, list(rows(5))),
                          bf.materialize(dataclasses.replace(cfg, target_split="validation", stem_col=None), list(rows(3))),
                          bf.materialize(dataclasses.replace(cfg, label_cols=("subspecies",)), list(rows(2))),
                          _tree_files(tree / "bfly"), bf.find_column({"img", "x"}, "image", bf.IMAGE_COL_ALIASES),
                          _error(lambda: bf.find_column({"a", "b"}, "image", bf.IMAGE_COL_ALIASES)),
                          _error(lambda: bf.extract_pil_image(3.0))]
    out["fishbase scrape"] = [{k: sf.parse_environment((tree / "fv_pages" / f"{k}.html").read_text()) for k in FISHBASE_PAGES},
                              sf.page_text(FISHBASE_PAGES["full"]), sf.load_species(tree / "fv"),
                              sorted(sf.load_existing(tree / "fishbase_done.csv")), sorted(sf.load_existing(tree / "none.csv")),
                              sf.MirrorWorker("org.au", 10, 30, 3).url_for("THUNNUS", "Albacares")]
    cfg = pd3.Config(runs_root=tree / "push" / "runs", run_ids=tree / "push" / "run_ids.json",
                     tracker_root=tree / "push" / "tracker", staging=tree / "staging", max_n=4, **m.push_kw)
    run_ids = {13: ["p0", "p1", "p2", "p3", "p4", "p5", "p6", "p7", "p9"], 23: ["p3", "p4"]}
    metrics = pd3.fetch_metrics(run_ids, cfg)
    selected = pd3.select_pareto(metrics, max_n=4)
    pd3.preflight(selected, cfg.runs_root, **m.push_kw)
    staged = pd3.push(cfg)
    out["push"] = [metrics, selected, pd3.select_pareto(metrics), pd3.select_pareto(metrics, max_n=2), staged,
                   pd3.make_readme(cfg, staged).replace("saev_tpu_torch.nn", "saev_tpu.nn"),
                   (tree / "staging" / "manifest.json").read_text(),
                   (tree / "staging" / "README.md").read_text().replace("saev_tpu_torch.nn", "saev_tpu.nn"),
                   sorted(str(p.relative_to(tree / "staging")) for p in (tree / "staging").rglob("*.pt")),
                   pd3.push(dataclasses.replace(cfg, run_ids=None, staging=tree / "staging2", tracker_root=None)),
                   pd3.sha256_file(tree / "push" / "run_ids.json"),
                   _error(lambda: pd3.preflight([pd3.RunMetrics("nope", 0, 1.0, 1.0)], cfg.runs_root, **m.push_kw))]
    return out


PIPELINES = {"birdsong": _birdsong, "study": _study, "fish": _fish, "dataprep": _dataprep}


def port_modules() -> types.SimpleNamespace:
    import pandas as pd

    from saev_tpu_torch.birdsong import browse, make_html, stats, visuals
    from saev_tpu_torch.freshwater_fish import extract_tol, make_gallery
    from saev_tpu_torch.tdiscovery import ablations, figplots, fishbase, logparse, mimicry, results, runs
    from saev_tpu_torch.tdiscovery.scripts import (download_butterflies, format_ade20k, format_fishvista, push_dinov3,
                                                   scrape_fishbase)
    from saev_tpu_torch.utils import vorbis

    return types.SimpleNamespace(
        pd=pd, vorbis=vorbis, stats=stats, visuals=visuals, make_html=make_html, browse=browse, runs=runs,
        results=results, logparse=logparse, fishbase=fishbase, mimicry=mimicry, figplots=figplots, ablations=ablations,
        extract_tol=extract_tol, make_gallery=make_gallery, format_ade20k=format_ade20k,
        format_fishvista=format_fishvista, download_butterflies=download_butterflies, scrape_fishbase=scrape_fishbase,
        push_dinov3=push_dinov3, push_kw={"device": "cpu"})


def contrib_modules() -> types.SimpleNamespace:
    """contrib's modules; contrib's src dirs must be on sys.path."""
    import importlib.util

    import pandas as pd
    from birdsong import browse, stats, visuals
    from tdiscovery import ablations, figplots, fishbase, logparse, mimicry, results, runs

    from saev_tpu.utils import vorbis

    def load(name, path):
        spec = importlib.util.spec_from_file_location(name, REPO / path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    scripts = "contrib/trait_discovery/scripts"
    return types.SimpleNamespace(
        pd=pd, vorbis=vorbis, stats=stats, visuals=visuals, browse=browse, runs=runs, results=results,
        logparse=logparse, fishbase=fishbase, mimicry=mimicry, figplots=figplots, ablations=ablations,
        make_html=load("birdsong_make_html", "contrib/birdsong/scripts/make_html.py"),
        extract_tol=load("fish_extract_tol", "contrib/freshwater_fish/scripts/extract_tol.py"),
        make_gallery=load("fish_make_gallery", "contrib/freshwater_fish/scripts/make_gallery.py"),
        format_ade20k=load("format_ade20k", f"{scripts}/format_ade20k.py"),
        format_fishvista=load("format_fishvista", f"{scripts}/format_fishvista.py"),
        download_butterflies=load("download_butterflies", f"{scripts}/download_butterflies.py"),
        scrape_fishbase=load("scrape_fishbase", f"{scripts}/scrape_fishbase.py"),
        push_dinov3=load("push_dinov3", f"{scripts}/push_dinov3.py"), push_kw={})


CONTRIB_SCRIPT = r"""
import json, pathlib, pickle, sys
spec = json.loads(sys.argv[1])
repo = pathlib.Path(spec["repo"])
sys.path[:0] = [str(repo / "tests"), str(repo), str(repo / "contrib" / "trait_discovery" / "src"),
                str(repo / "contrib" / "birdsong" / "src")]
import jax
jax.config.update("jax_platforms", "cpu")
import test_torch_contrib_last as t
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
    base = tmp_path_factory.mktemp("contrib_last")
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
    assert [n for n in got["port_modules_loaded"] if n != "saev_tpu_torch"] == [], got["port_modules_loaded"]
    return got["out"], port


@pytest.fixture(scope="module")
def contrib_out(outs):
    return outs[0]


@pytest.fixture(scope="module")
def port_out(outs):
    return outs[1]


CASES = {
    "birdsong": ("visuals", "drawing", "make_html", "browse", "stats"),
    "study": ("runs", "results", "logparse", "logparse figures", "fishbase", "mimicry", "figplots", "ablations"),
    "fish": ("pairs", "taxa", "lookup", "extract", "gallery"),
    "dataprep": ("ade20k", "fishvista", "butterflies", "fishbase scrape", "push"),
}


def test_pipelines_cover_every_case(contrib_out, port_out):
    for group, cases in CASES.items():
        assert sorted(contrib_out[group]) == sorted(port_out[group]) == sorted(cases), group


@pytest.mark.parametrize("case", CASES["birdsong"])
def test_birdsong_matches_contrib(contrib_out, port_out, case):
    """visuals' var.parquet, spectrograms (pixels) and clips (samples),
    make_html's pages, browse's discovery and site, stats' report."""
    assert_same(port_out["birdsong"][case], contrib_out["birdsong"][case], case)


@pytest.mark.parametrize("case", CASES["study"])
def test_study_modules_match_contrib(contrib_out, port_out, case):
    """runs' frame and pareto front, results' tables, logparse's events,
    frames and figures, fishbase's scores, mimicry's harvest and tables,
    figplots' figures and tables, ablations' tables and grids."""
    assert_same(port_out["study"][case], contrib_out["study"][case], case)


@pytest.mark.parametrize("case", CASES["fish"])
def test_freshwater_fish_matches_contrib(contrib_out, port_out, case):
    """extract_tol's filters, lookup and extracted JPEGs (pixels),
    make_gallery's species, cards and page."""
    assert_same(port_out["fish"][case], contrib_out["fish"][case], case)


@pytest.mark.parametrize("case", CASES["dataprep"])
def test_dataprep_matches_contrib(contrib_out, port_out, case):
    """format_ade20k's and format_fishvista's trees, materialize's files,
    parse_environment's traits, push_dinov3's selection, staging and card."""
    assert_same(port_out["dataprep"][case], contrib_out["dataprep"][case], case)


def test_planted_structure_is_found(port_out):
    """The tree's structure shows through the port's results: latent 0's top
    clips are the tone's and its time clip is the tone's window, channel BAD
    is the outlier that stats reports, fishbase finds the planted latent,
    mimicry the separable pair."""
    vis = port_out["birdsong"]["visuals"]
    var = vis["var"]["values"]
    assert set(var["topk_example_idx"][0]) <= set(PLANTED)
    from saev_tpu_torch.models import bird_mae

    (sr, time_clip), = [v for k, v in vis["clips"].items() if k.startswith("0/0_time_clip")]
    assert sr == SR and len(time_clip) == len(TONE_T) * bird_mae.SAMPLES_PER_TIME_PATCH
    report = port_out["birdsong"]["stats"]["report"]
    assert report["per_set"]["bird"]["outlier_dims"][0]["dim"] == BAD
    assert BAD not in [d["dim"] for d in report["per_set"]["image"]["outlier_dims"]]
    pearson = port_out["study"]["fishbase"][7]["pearson"]
    assert 7 in pearson[3]
    difficulty = port_out["study"]["mimicry"][4]
    assert difficulty[-1]["task"] == "notabilis_dorsal_vs_plesseni_dorsal" and difficulty[-1]["best_balanced_acc"] == 1.0


def test_push_readme_names_the_port(trees, port_out):
    """The port's model card loads its files with the port's `nn.load`."""
    readme = (trees / "port" / "dataprep" / "staging" / "README.md").read_text()
    assert "import saev_tpu_torch.nn" in readme and "saev_tpu_torch.nn.load(" in readme


def test_birdsong_launcher_writes_the_same_page(trees, port_out):
    """`python -m saev_tpu_torch.birdsong make_html` (in-process) writes the
    page that make_html.make wrote for the same config."""
    from saev_tpu_torch.birdsong import __main__ as launcher

    tree = trees / "port" / "birdsong"
    names = _shard_names(tree)
    launcher.main(["make_html", "--run", str(tree / "saev" / "runs" / "b1"), "--shards",
                   str(tree / "saev" / "shards" / names["bird"]), "--embed", "--notes", str(tree / "notes.json"),
                   "--out", str(tree / "launched.html")])
    assert (tree / "launched.html").read_text() == (tree / "embed.html").read_text()


def test_dataprep_launchers_match_their_functions(trees, port_out, tmp_path):
    """The data-prep scripts' and fish tools' `main` (in-process) do what
    their functions do."""
    from saev_tpu_torch.freshwater_fish import extract_tol, make_gallery
    from saev_tpu_torch.tdiscovery.scripts import format_ade20k, format_fishvista, push_dinov3

    tree = trees / "port" / "dataprep"
    shutil.copytree(tree / "ade", tmp_path / "ade")
    format_ade20k.main(["format", "--src-root", str(tmp_path / "ade")])
    assert (tmp_path / "ade" / "image_labels.txt").read_text() == (tree / "ade" / "image_labels.txt").read_text()
    format_fishvista.main(["imgfolder", "--fv-root", str(tree / "fv"), "--dump-to", str(tmp_path / "imgf")])
    assert _tree_files(tmp_path / "imgf").keys() == _tree_files(tree / "imgf").keys()
    push_dinov3.main(["push", "--runs-root", str(tree / "push" / "runs"), "--run-ids", str(tree / "push" / "run_ids.json"),
                      "--tracker-root", str(tree / "push" / "tracker"), "--staging", str(tmp_path / "staging"),
                      "--max-n", "4", "--device", "cpu"])
    assert (tmp_path / "staging" / "manifest.json").read_text() == (tree / "staging" / "manifest.json").read_text()
    fish = trees / "port" / "fish"
    tol = fish / "tol"
    extract_tol.main(["extract", "--order-filter", "Cypriniformes,Perciformes",
                      "--resolved-taxa-dpath", str(tol / "resolved_taxa"), "--lookup-tables-dpath",
                      str(tol / "lookup_tables"), "--output-dpath", str(tmp_path / "fish"), "--n-workers", "2"])
    assert _tree_files(tmp_path / "fish").keys() == _tree_files(fish / "fish_out").keys() - {"Carabidae/u3.jpg"}
    make_gallery.main(["gallery", "--run", str(fish / "fishrun"), "--shards", "x/fsh", "--dataset",
                       str(fish / "fishdata"), "--out", str(tmp_path / "g.html")])
    assert (tmp_path / "g.html").read_text() == (fish / "gallery.html").read_text()


NEEDS = {
    "birdsong.visuals spectrogram": ("PIL", lambda t: importlib.import_module("saev_tpu_torch.birdsong.visuals")
                                     .spectrogram_image(np.zeros((4, 4)))),
    "tdiscovery.runs.load_df": ("pandas", lambda t: importlib.import_module("saev_tpu_torch.tdiscovery.runs").load_df([])),
    "tdiscovery.figplots figures": ("matplotlib", lambda t: importlib.import_module("saev_tpu_torch.tdiscovery.figplots")
                                    .fig_tradeoff(None)),
    "tdiscovery.figplots tables": ("tabulate", lambda t: importlib.import_module("saev_tpu_torch.tdiscovery.figplots")
                                   .save_battery({}, {"x": None}, t)),
    "tdiscovery.logparse figures": ("matplotlib", lambda t: importlib.import_module("saev_tpu_torch.tdiscovery.logparse")
                                    .fig_loss(None)),
    "tdiscovery.ablations grid": ("matplotlib", lambda t: importlib.import_module("saev_tpu_torch.tdiscovery.ablations")
                                  .fig_variant_grid(None)),
    "extract_tol h5": ("h5py", lambda t: importlib.import_module("saev_tpu_torch.freshwater_fish.extract_tol")
                       .extract_h5_file(t / "x.h5", [], 90)),
    "extract_tol parquet": ("pyarrow", lambda t: importlib.import_module("saev_tpu_torch.freshwater_fish.extract_tol")
                            .collect_pairs(importlib.import_module("saev_tpu_torch.freshwater_fish.extract_tol").Config())),
    "make_gallery": ("pandas", lambda t: importlib.import_module("saev_tpu_torch.freshwater_fish.make_gallery")
                     .gallery(importlib.import_module("saev_tpu_torch.freshwater_fish.make_gallery").Config(run=t, shards=t))),
    "push_dinov3.upload": ("huggingface_hub", lambda t: importlib.import_module("saev_tpu_torch.tdiscovery.scripts.push_dinov3")
                           .upload(None)),
    "download_butterflies.fetch": ("datasets", lambda t: importlib.import_module(
        "saev_tpu_torch.tdiscovery.scripts.download_butterflies").fetch(None)),
}


@pytest.mark.parametrize("what", sorted(NEEDS))
def test_missing_package_raises_import_error(without, tmp_path, what):
    """Where an optional package cannot be imported, what needs it raises an
    ImportError that names it, before any other work."""
    package, call = NEEDS[what]
    without(package)
    with pytest.raises(ImportError, match=f"needs {package} .pip install"):
        call(tmp_path)


def test_birdsong_visuals_skip_the_table_without_pandas(without, trees, tmp_path):
    """As contrib: without pandas, visuals write every clip and no
    var.parquet."""
    from saev_tpu_torch.birdsong import visuals

    tree = tmp_path / "t"
    shutil.copytree(trees / "port" / "birdsong", tree, symlinks=True)
    names = _shard_names(tree)
    art = tree / "saev" / "runs" / "b1" / "inference" / names["bird"]
    shutil.rmtree(art / "clips")
    (art / "var.parquet").unlink()
    without("pandas")
    visuals.worker_fn(visuals.Config(run=tree / "saev" / "runs" / "b1", shards=tree / "saev" / "shards" / names["bird"],
                                     latents=(0,), n_latents=0, top_k=4, n_clips=3))
    assert not (art / "var.parquet").exists()
    assert sorted(p.name for p in (art / "clips" / "0").iterdir()) == sorted(
        p.name for p in (trees / "port" / "birdsong" / "saev" / "runs" / "b1" / "inference" / names["bird"] / "clips" / "0").iterdir())
