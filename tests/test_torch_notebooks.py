"""The port's copies of contrib's notebook drivers against contrib's
originals, on the CPU: the 21 percent-format scripts that reach the JAX
package (birdsong's `birdset`, `clips`, `explore`; trait discovery's
`001_actfn` ... `visuals`; mimics' `exps/001-heliconius/exploration`), each
copy at `saev_tpu_torch/<package>/...` under contrib's file name.

One tree is made from a numpy seed (`_build_tree`), once for the module:
test_torch_contrib_host's tree (labelled image shards at d_model 32, two runs
of a TopK SAE with the port's inference on both splits, probe metrics, audit
and classification results, classifier checkpoints, a baseline run and a
summary tracker), with a species and a two-valued column added to its
labels, study runs (optimizer and AuxK variants at two layers) and their
summaries, tdiscovery.visuals' galleries of r1; a JSONL tracker of a sweep;
test_torch_contrib_last's Bird-MAE-family shards at d_model 32 with channel
BAD planted and a TopK SAE run over them (the port's inference), and its
mimic-pair classifier checkpoints; a FishBase trait table, mimic labels,
and a segmentation folder of several aspect ratios. Each side gets its own
copy. Contrib's 21 run in one subprocess with JAX on the CPU and the port's
21 in another with every `*_DEVICE=cpu`, each driver through
`runpy.run_path` with its own environment, in its own working directory,
after `np.random.seed(0)` (liblinear draws from numpy's global state).
BIRDSET_TRACE stays unset: `trace_report` is held to contrib by
tests/test_torch_birdsong.py.

Each driver's stdout must be equal on both sides, with the tree's path
replaced; so must its exit (0, or the same SystemExit code). Every file a
driver writes or changes must be equal: JSON, CSV and `.npz` as values,
floats within test_torch_contrib_host.FLOAT_RTOL; matplotlib figures by
their plotted data (recorded at `savefig`); other images as pixels; clips as
decoded samples; classifier checkpoints by their header and fitted arrays;
text with the tree's path replaced.
"""

import csv
import io
import json
import os
import pathlib
import pickle
import shutil
import subprocess
import sys
import wave

import numpy as np
import pytest

import test_torch_contrib_host as ch
from test_torch_contrib_host import plain
from test_torch_contrib_last import assert_same

REPO = pathlib.Path(__file__).resolve().parent.parent
SIDES = ("contrib", "port")
SPECIES = ("Scombridae_Thunnus_albacares", "Pomacentridae_Amphiprion_ocellaris", "Cyprinidae_Danio_rerio")
BIRD_SAE = 8  # the Bird-MAE-family run's latents: explore renders clips of each
WATER = ("open", "open", "reef")  # a two-valued column, for liblinear's two-class heads
# The study runs: (run id, optimizer, AuxK, layer, d_sae).
STUDY = (("s1", "adam", "auxk", 0, 128), ("s2", "muon", "auxk", 0, 128), ("s3", "adam", "no-aux", 0, 256),
         ("s4", "muon", "no-aux", 0, 256), ("s5", "adam", "auxk", 1, 128), ("s6", "muon", "auxk", 1, 256))


# name: (contrib's file, the port's copy), in the order the drivers run:
# explore writes the clip galleries that clips browses.
NOTEBOOKS = {
    "birdset": ("contrib/birdsong/notebooks/birdset.py", "saev_tpu_torch/birdsong/notebooks/birdset.py"),
    "explore": ("contrib/birdsong/notebooks/explore.py", "saev_tpu_torch/birdsong/notebooks/explore.py"),
    "clips": ("contrib/birdsong/notebooks/clips.py", "saev_tpu_torch/birdsong/notebooks/clips.py"),
    **{name: (f"contrib/trait_discovery/notebooks/{name}.py", f"saev_tpu_torch/tdiscovery/notebooks/{name}.py")
       for name in ("001_actfn", "002_ablations", "002_optim", "003_auxk", "005_butterflies", "009_pe_core",
                    "007_cambridge_sae", "008_pe", "metrics", "baselines", "visuals", "007_cambridge_mimicry",
                    "004_fishbase",
                    "004_fishbase_cls", "006_proposal_audit")},
    "exploration": ("contrib/mimics/exps/001-heliconius/exploration.py",
                    "saev_tpu_torch/mimics/exps/001-heliconius/exploration.py"),
    **{name: (f"contrib/trait_discovery/notebooks/{name}.py", f"saev_tpu_torch/tdiscovery/notebooks/{name}.py")
       for name in ("butterflies", "fishvista")},
}


# ---------------------------------------------------------------------------
# The tree (built with the port, read by both packages)
# ---------------------------------------------------------------------------


def _relabel(seg_root: pathlib.Path) -> None:
    """labels.csv with a FishVista species column first (004_fishbase joins
    the first column to the trait table) and a two-valued `water` column."""
    rows = list(csv.DictReader(open(seg_root / "labels.csv")))
    with open(seg_root / "labels.csv", "w", newline="") as fd:
        writer = csv.writer(fd)
        writer.writerow(["stem", "species", "class", "subspecies_view", "water"])
        for row in rows:
            c = ch.CLASS_NAMES.index(row["class"])
            writer.writerow([row["stem"], SPECIES[c], row["class"], row["subspecies_view"], WATER[c]])


def _study(tree: pathlib.Path, rng) -> None:
    """The study runs root, study/saev/runs: r1-r3 (links to saev/runs, each
    given an optimizer and an AuxK key) and s1-s6 (config and shard links
    only: optimizer and AuxK variants at two layers); every run gets a
    summary with L0, NMSE and dead latents, r1 on the frontier."""
    from saev_tpu_torch import disk

    study, tracker = tree / "study" / "saev" / "runs", tree / "tracker" / "saev"
    study.mkdir(parents=True)
    shard_dirs = ch._shard_dirs(tree)
    for run_id, optim, aux in (("r1", "adam", "auxk"), ("r2", "muon", "auxk"), ("r3", "adam", "no-aux")):
        fpath = tree / "saev" / "runs" / run_id / "checkpoint" / "config.json"
        cfg = json.loads(fpath.read_text())
        cfg["optim"] = optim
        cfg["sae"]["activation"]["aux"] = {"key": aux, "k_aux": 64, "alpha": 0.03125} if aux == "auxk" else {"key": aux}
        fpath.write_text(json.dumps(cfg))
        (study / run_id).symlink_to(pathlib.Path("..", "..", "..", "saev", "runs", run_id))
    rel = pathlib.Path("..", "..", "..", "..", "..", "saev", "shards")
    for run_id, optim, aux, layer, d_sae in STUDY:
        run = disk.Run.new(run_id, train_shards_dir=rel / shard_dirs["train"].name,
                           val_shards_dir=rel / shard_dirs["test"].name, runs_root=study)
        (run.run_dir / "checkpoint" / "config.json").write_text(json.dumps({
            "sae": {"d_sae": d_sae, "activation": {
                "key": "top-k", "top_k": 4,
                "aux": {"key": aux, "k_aux": 64, "alpha": 0.03125} if aux == "auxk" else {"key": aux}}},
            "val_data": {"layer": layer}, "objective": {"n_prefixes": 1}, "lr": 1e-3, "optim": optim,
            "tags": ["study"]}))
        (tracker / run_id).mkdir(parents=True)
        (tracker / run_id / "config.json").write_text(json.dumps({"tags": ["study"]}))
    for run_dir in sorted(study.iterdir()):
        summary_f = tracker / run_dir.name / "summary.json"
        summary = json.loads(summary_f.read_text()) if summary_f.exists() else {}
        d_sae = json.loads((run_dir / "checkpoint" / "config.json").read_text())["sae"]["d_sae"]
        l0, nmse = (2.0, 0.05) if run_dir.name == "r1" else (float(2 + 10 * rng.random()), float(0.1 + rng.random()))
        summary.setdefault("eval", {}).update({"l0": l0, "normalized_mse": nmse,
                                               "n_dead": int(rng.integers(0, d_sae // 4))})
        summary["loss"] = {"n_dead": int(rng.integers(0, d_sae // 4))}
        summary_f.write_text(json.dumps(summary))


def _jsonl_tracker(root: pathlib.Path, rng) -> None:
    """A sweep in the JSONL tracker's layout (<project>/<id>/config.json with
    the run's config and tags, metrics.jsonl with its history): TopK and Relu
    runs, Adam and Muon, with and without AuxK, at layers 11 and 13."""
    for i in range(8):
        run = root / "saev" / f"t{i}"
        run.mkdir(parents=True)
        act = {"key": "top-k", "top_k": 16 * (1 + i % 2)} if i % 4 != 3 else {"key": "relu"}
        if i % 3:
            act["aux"] = {"key": "auxk", "k_aux": 512, "alpha": 0.03125}
        config = {"sae": {"d_sae": 1024, "activation": act}, "optim": "muon" if i % 2 else "adam",
                  "lr": 1e-3 * (1 + i % 3), "val_data": {"layer": 11 + 2 * (i % 2)}}
        (run / "config.json").write_text(json.dumps({"config": config, "tags": ["sweep"] if i != 7 else ["other"]}))
        with open(run / "metrics.jsonl", "w") as fd:
            mse = 1.0 + rng.random()
            for step in range(0, 50, 10):
                mse *= 0.7 + 0.2 * rng.random()
                row = {"step": step, "_step": step, "loss/mse": mse, "loss/l0": float(10 + 40 * rng.random()),
                       "metrics/normalized_mse": mse / 2, "loss/n_dead": int(rng.integers(0, 100))}
                fd.write(json.dumps(row) + "\n")
    (root / "saev" / "empty").mkdir()


def _aspect_folder(root: pathlib.Path, rng) -> None:
    """An ImgSegFolder of 5 images of several aspect ratios and their masks."""
    from PIL import Image

    for kind in ("images", "annotations"):
        (root / kind / "training").mkdir(parents=True)
    for i, (w, h) in enumerate(((32, 16), (16, 32), (24, 24), (40, 12), (12, 20))):
        name = f"i{i}.png"
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(root / "images" / "training" / name)
        Image.fromarray(rng.integers(0, 4, (h, w), dtype=np.uint8)).save(root / "annotations" / "training" / name)


def _build_tree(tree: pathlib.Path) -> None:
    from test_torch_contrib_last import _bird_run, _bird_shards, _birdclef, _mimic_runs

    from saev_tpu_torch.tdiscovery import visuals

    ch._build_tree(tree)
    rng = np.random.default_rng(27)
    _relabel(tree / "data" / "ADE20K")
    _study(tree, rng)
    shard_dirs = ch._shard_dirs(tree)
    visuals.worker_fn(visuals.Config(run=tree / "saev" / "runs" / "r1", shards=shard_dirs["test"], img_scale=2.0,
                                     n_latents=3, top_k=3, latents=(0, 1), n_distributions=4,
                                     log_value_range=(-6.0, 6.0)))
    _jsonl_tracker(tree / "wandb", rng)
    bird = tree / "bird"
    (bird / "saev" / "shards").mkdir(parents=True)
    (bird / "saev" / "runs").mkdir(parents=True)
    _birdclef(bird / "birdclef", rng)
    bird_shards, direction = _bird_shards(bird / "saev" / "shards", bird / "birdclef", rng)
    _bird_run(bird / "saev" / "runs", bird_shards, direction, d_sae=BIRD_SAE)
    (tree / "traits.csv").write_text("genus,species,habitat\nThunnus,albacares,Pelagic-oceanic\n"
                                     "amphiprion,ocellaris,reef-associated\ndanio,rerio,Demersal\n")
    labels = [row["subspecies_view"] for row in csv.DictReader(open(tree / "data" / "ADE20K" / "labels.csv"))
              if row["stem"].startswith("test")]
    (tree / "mimic_labels.json").write_text(json.dumps(labels))
    _aspect_folder(tree / "aspect", rng)
    _mimic_runs(tree / "mimic_runs")


def _env(name: str, tree: pathlib.Path) -> dict:
    """The driver's environment over `tree` (every `*_DEVICE` is set by the
    port's side)."""
    runs, shards, tracker = tree / "saev" / "runs", tree / "saev" / "shards", tree / "tracker"
    sh = ch._shard_dirs(tree)
    bird = tree / "bird" / "saev"
    (bird_shards,) = [p for p in (bird / "shards").iterdir() if p.is_dir()]
    out, study_root = tree / "out" / name, tree / "study" / "saev" / "runs"
    study = {"TD_RUNS_ROOT": str(study_root), "TD_TRACKER": str(tracker), "TD_OUT": str(out)}
    return {
        "birdset": {"BIRDSET_AUDIO_SHARDS": str(bird_shards), "BIRDSET_IMG_SHARDS": str(sh["test"]),
                    "BIRDSET_N": "1024", "BIRDSET_OUT": str(tree / "birdset_report.json")},
        "explore": {"BIRDSONG_RUN": str(bird / "runs" / "b1"), "BIRDSONG_SHARDS": str(bird_shards),
                    "BIRDSONG_TRACKER": str(tree / "wandb" / "saev")},
        "clips": {"BS_RUNS_ROOTS": f"{bird / 'runs'},{tree / 'missing'}", "BS_OUT": str(out)},
        "001_actfn": {"SAEV_TRACKER": str(tree / "wandb" / "saev")},
        "002_ablations": {"SAEV_TRACKER": str(tree / "wandb" / "saev"), "SAEV_TAG": "sweep"},
        "002_optim": {"OPTIM_RUNS": str(study_root), "OPTIM_TRACKER": str(tracker), "OPTIM_EXPECTED": "2"},
        "003_auxk": {"AUXK_RUNS": str(study_root), "AUXK_TRACKER": str(tracker), "AUXK_EXPECTED": "2"},
        "005_butterflies": study,
        "009_pe_core": study,
        "007_cambridge_sae": study,
        "008_pe": {**study, "TD_SHARDS_ROOT": str(shards)},
        "metrics": {**study, "TD_SHARDS_ROOT": str(shards)},
        "baselines": {"TD_RUNS": str(runs), "TD_SHARDS": str(shards), "TD_TRACKER": str(tracker)},
        "visuals": {"TD_RUNS_ROOTS": str(runs), "TD_OUT": str(out), "TD_N_FEATURES": "4"},
        "007_cambridge_mimicry": {"MIMICRY_RUNS": str(tree / "mimic_runs"), "MIMICRY_SHARDS": str(sh["test"])},
        "004_fishbase": {"FISHBASE_SHARDS": str(sh["test"]), "FISHBASE_RUN": str(runs / "r1"),
                         "FISHBASE_TRAITS": str(tree / "traits.csv")},
        "004_fishbase_cls": {"TD_RUNS_ROOT": str(runs), "TD_TRACKER": str(tracker), "TD_TASK": "habitat"},
        "006_proposal_audit": {"TD_RUN": str(runs / "r1"), "TD_TRAIN_SHARDS": str(sh["train"]),
                               "TD_TEST_SHARDS": str(sh["test"]), "TD_SOURCE_COL": "water", "TD_OUT": str(out),
                               "TD_RUNS": str(runs / "r2")},
        "exploration": {"MIMICS_RUNS": str(runs), "MIMICS_SHARD": sh["test"].name, "MIMICS_TASK": ch.TASK,
                        "MIMICS_LABELS": str(tree / "mimic_labels.json"), "MIMICS_OUT": str(out)},
        "butterflies": {"BF_ROOT": str(tree / "data" / "ADE20K"), "BF_N": "4", "BF_OUT": str(out)},
        "fishvista": {"FV_ROOT": str(tree / "aspect"), "FV_N": "5", "FV_BUDGET": "12", "FV_PATCH": "4",
                      "FV_OUT": str(out)},
    }[name]


DEVICES = {"birdset": "BIRDSET_DEVICE"}  # the drivers that do device work, and their switch


# ---------------------------------------------------------------------------
# The runner: one process a side, each driver through runpy.run_path
# ---------------------------------------------------------------------------


def _figure_data(fig) -> list:
    """A matplotlib figure as what it plots: each axes' title, labels,
    scales, lines' and collections' data, patches' extents and texts; the
    suptitle and the figure legends' texts."""
    out = []
    for ax in fig.axes:
        out.append({"title": ax.get_title(), "xlabel": ax.get_xlabel(), "ylabel": ax.get_ylabel(),
                    "xscale": ax.get_xscale(), "yscale": ax.get_yscale(),
                    "lines": [np.asarray(line.get_xydata(), np.float64) for line in ax.lines],
                    "points": [np.asarray(c.get_offsets(), np.float64) for c in ax.collections],
                    "bars": np.asarray([p.get_bbox().bounds for p in ax.patches], np.float64).reshape(-1, 4),
                    "texts": [t.get_text() for t in ax.texts],
                    "ticks": [t.get_text() for t in ax.get_xticklabels() + ax.get_yticklabels()],
                    "legend": [t.get_text() for t in ax.get_legend().get_texts()] if ax.get_legend() else None})
    out.append(fig._suptitle.get_text() if fig._suptitle is not None else None)
    out.append([t.get_text() for lg in fig.legends for t in lg.get_texts()])
    return out


def _stats(tree: pathlib.Path) -> dict:
    """{path in the tree: (size, mtime)} of every file, links not followed."""
    out = {}
    for dirpath, _, names in os.walk(tree):
        for n in names:
            st = os.lstat(os.path.join(dirpath, n))
            out[os.path.relpath(os.path.join(dirpath, n), tree)] = (st.st_size, st.st_mtime_ns)
    return out


def run_driver(name: str, path: str, env: dict, tree: pathlib.Path) -> dict:
    """Run one driver as `python <path>` would, in tree/cwd/<name> with `env`
    added to the environment: its stdout, its exit (0, a SystemExit's code,
    or the exception that ended it), the files it wrote or changed and the
    data of every figure it saved (by their paths in the tree), and its
    seconds."""
    import contextlib
    import random
    import runpy
    import time
    import traceback

    cwd = tree / "cwd" / name
    cwd.mkdir(parents=True, exist_ok=True)
    before = _stats(tree)
    saved = (dict(os.environ), list(sys.path), list(sys.argv), os.getcwd())
    figures = {}
    try:
        import matplotlib.figure

        real_savefig = matplotlib.figure.Figure.savefig

        def savefig(fig, fname, *args, **kwargs):
            figures[os.path.relpath(os.path.abspath(fname), tree)] = _figure_data(fig)
            return real_savefig(fig, fname, *args, **kwargs)

        matplotlib.figure.Figure.savefig = savefig
    except ImportError:
        matplotlib = None
    os.environ.update(env)
    sys.argv = [path]
    os.chdir(cwd)
    np.random.seed(0)
    random.seed(0)
    stdout, status = io.StringIO(), {"exit": 0, "error": None}
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(stdout):
            runpy.run_path(path, run_name="__main__")
    except SystemExit as err:
        status["exit"] = 0 if err.code is None else err.code
    except Exception as err:  # noqa: BLE001 - the driver's error is its result
        status["exit"] = 1
        status["error"] = f"{type(err).__name__}: {err}"
        status["traceback"] = traceback.format_exc()[-3000:]
    finally:
        seconds = time.perf_counter() - t0
        os.environ.clear()
        os.environ.update(saved[0])
        sys.path[:], sys.argv[:] = saved[1], saved[2]
        os.chdir(saved[3])
        if matplotlib is not None:
            import matplotlib.pyplot as plt

            matplotlib.figure.Figure.savefig = real_savefig
            plt.close("all")
    after = _stats(tree)
    files = sorted(p for p, st in after.items() if before.get(p) != st)
    return {"stdout": stdout.getvalue(), **status, "files": files, "figures": figures, "seconds": seconds}


RUNNER = r"""
import json, os, pathlib, pickle, sys
spec = json.loads(sys.argv[1])
repo = pathlib.Path(spec["repo"])
sys.path[:0] = [str(repo / "tests"), str(repo)]
if spec["side"] == "contrib":
    import jax
    jax.config.update("jax_platforms", "cpu")
import test_torch_notebooks as t
tree = pathlib.Path(spec["tree"])
out = {"drivers": {name: t.run_driver(name, path, env, tree) for name, path, env in spec["drivers"]}}
out["modules"] = sorted({n.split(".")[0] for n in sys.modules} & {"saev_tpu", "saev_tpu_torch", "jax"})
with open(spec["out"], "wb") as fd:
    pickle.dump(out, fd)
"""


def drivers(side: str, tree: pathlib.Path, notebooks: dict = NOTEBOOKS) -> list:
    """[name, file, environment] of each driver of `side` over `tree`."""
    rows = []
    for name, files in notebooks.items():
        env = _env(name, tree)
        if side == "port" and name in DEVICES:
            env[DEVICES[name]] = "cpu"
        rows.append([name, str(REPO / files[SIDES.index(side)]), env])
    return rows


def start(side: str, tree: pathlib.Path, out: pathlib.Path, notebooks: dict = NOTEBOOKS) -> subprocess.Popen:
    """One process that runs `side`'s drivers over `tree` and pickles their
    results to `out`; its log beside `out`."""
    spec = {"repo": str(REPO), "side": side, "tree": str(tree), "out": str(out),
            "drivers": drivers(side, tree, notebooks)}
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO), "MPLBACKEND": "Agg",
           "OMP_NUM_THREADS": "1"}
    with open(out.with_suffix(".log"), "w") as log:
        return subprocess.Popen([sys.executable, "-c", RUNNER, json.dumps(spec)], cwd=tree, env=env, stdout=log,
                                stderr=subprocess.STDOUT)


# ---------------------------------------------------------------------------
# What a driver wrote, in plain form
# ---------------------------------------------------------------------------


def _cell(text: str):
    for kind in (int, float):
        try:
            return kind(text)
        except ValueError:
            pass
    return text


def _state(obj):
    """A pickled head as builtins and arrays: a scikit-learn estimator as its
    class name and attributes (a tree's nodes through __getstate__)."""
    if isinstance(obj, dict):
        return {str(k): _state(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_state(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj
    if isinstance(obj, np.generic):
        return obj.item()
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    fields = vars(obj) if hasattr(obj, "__dict__") else obj.__getstate__()
    return {"class": type(obj).__qualname__, **_state(fields)}


def artifact(tree: pathlib.Path, rel: str, figures: dict):
    """The file at `rel` in `tree`, in plain form: a saved figure as its
    plotted data; JSON, CSV, .npz/.npy and parquet as values; images as
    pixels; clips as decoded samples; a classifier checkpoint as its header
    and its head's state; other files as text (the tree's path replaced) or
    bytes."""
    fpath, root = tree / rel, str(tree)
    if rel in figures:
        return {"figure": plain(figures[rel], tree)}
    suffix = fpath.suffix
    if suffix == ".pdf":
        raise AssertionError(f"{rel}: a PDF that no figure's savefig wrote")
    if suffix == ".json":
        return plain(json.loads(fpath.read_text()), tree)
    if suffix == ".csv":
        return [[_cell(c.replace(root, "<tree>")) for c in row] for row in csv.reader(open(fpath, newline=""))]
    if suffix == ".npy":
        return np.load(fpath, allow_pickle=False)
    if suffix == ".npz":
        with np.load(fpath, allow_pickle=False) as fd:
            return {k: fd[k] for k in fd.files}
    if suffix == ".parquet":
        import pandas as pd

        return plain(pd.read_parquet(fpath), tree)
    if suffix in (".png", ".jpg"):
        from PIL import Image

        return np.asarray(Image.open(fpath))
    if suffix == ".wav":
        with wave.open(str(fpath)) as w:
            return [w.getframerate(), np.frombuffer(w.readframes(w.getnframes()), "<i2")]
    if suffix == ".ogg":
        from saev_tpu_torch.utils import vorbis

        samples, sr = vorbis.read_ogg(fpath)
        return [sr, np.asarray(samples)]
    if suffix == ".pkl":
        with open(fpath, "rb") as fd:
            header = json.loads(fd.readline())
            return {"header": plain(header, tree), "payload": _state(pickle.load(fd))}
    data = fpath.read_bytes()
    try:
        return data.decode().replace(root, "<tree>")
    except UnicodeDecodeError:
        return data


def compare(got: dict, want: dict, got_tree: pathlib.Path, want_tree: pathlib.Path, name: str) -> None:
    """One driver's run against contrib's: exit, stdout (each tree's path
    replaced), the files it wrote and each file's plain form."""
    assert (got["exit"], got["error"]) == (want["exit"], want["error"]), (
        name, got.get("traceback"), want.get("traceback"))
    assert_same(got["stdout"].replace(str(got_tree), "<tree>"), want["stdout"].replace(str(want_tree), "<tree>"),
                f"{name} stdout")
    assert got["files"] == want["files"], (name, got["files"], want["files"])
    for rel in want["files"]:
        assert_same(artifact(got_tree, rel, got["figures"]), artifact(want_tree, rel, want["figures"]), f"{name}/{rel}")


# ---------------------------------------------------------------------------
# Fixtures and tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("notebooks")
    _build_tree(base / "base")
    for side in SIDES:
        shutil.copytree(base / "base", base / side, symlinks=True)
    return base


@pytest.fixture(scope="module")
def outs(trees):
    """{side: its drivers' results}: both sides' processes run together."""
    procs = {side: start(side, trees / side, trees / f"{side}.pkl") for side in SIDES}
    try:
        for proc in procs.values():
            proc.wait(timeout=300)
    finally:
        for proc in procs.values():
            proc.kill()
    out = {}
    for side, proc in procs.items():
        assert proc.returncode == 0, (trees / f"{side}.log").read_text()[-6000:]
        with open(trees / f"{side}.pkl", "rb") as fd:
            out[side] = pickle.load(fd)
    return out


def test_each_side_ran_every_driver_on_its_own_package(outs):
    """Both sides ran the 21 drivers to their end (exit 0), contrib's without
    loading the port and the port's without loading JAX or the JAX package."""
    assert outs["contrib"]["modules"] == ["jax", "saev_tpu"], outs["contrib"]["modules"]
    assert outs["port"]["modules"] == ["saev_tpu_torch"], outs["port"]["modules"]
    for side, out in outs.items():
        assert list(out["drivers"]) == list(NOTEBOOKS)
        for name, res in out["drivers"].items():
            assert (res["exit"], res["error"]) == (0, None), (side, name, res.get("traceback"))


@pytest.mark.parametrize("name", NOTEBOOKS)
def test_driver_matches_contrib(trees, outs, name):
    compare(outs["port"]["drivers"][name], outs["contrib"]["drivers"][name], trees / "port", trees / "contrib", name)


# (driver, text in the port's copy, what the planted fault puts there)
FAULTS = {
    "printed count": ("001_actfn", 'print(f"{len(runs)} runs loaded', 'print(f"{len(runs) + 1} runs loaded'),
    "table count": ("004_fishbase", "{row['n_examples']}", "{row['n_examples'] + 1}"),
    "written plan": ("exploration", "json.dumps(plan, indent=2)", "json.dumps(plan[::-1], indent=2)"),
}


@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_fault_fails_the_comparison(trees, outs, tmp_path, monkeypatch, fault):
    """A scratch copy of one port driver with one planted fault (an
    off-by-one in a printed count, or a written artifact reordered), run
    here over a fresh copy of the tree: the comparison with contrib's run
    fails, and an unchanged scratch copy passes it."""
    name, old, new = FAULTS[fault]
    source = (REPO / NOTEBOOKS[name][1]).read_text()
    assert source.count(old) == 1, (name, old)
    monkeypatch.syspath_prepend(str(REPO))  # the copy's own path arithmetic names the scratch dir
    contrib = outs["contrib"]["drivers"][name]
    for label, text in (("planted", source.replace(old, new)), ("unchanged", source)):
        tree = tmp_path / label / "tree"
        shutil.copytree(trees / "base", tree, symlinks=True)
        copy = tmp_path / label / NOTEBOOKS[name][1]
        copy.parent.mkdir(parents=True)
        copy.write_text(text)
        got = run_driver(name, str(copy), drivers("port", tree, {name: NOTEBOOKS[name]})[0][2], tree)
        if label == "planted":
            with pytest.raises((AssertionError, pytest.fail.Exception)):
                compare(got, contrib, tree, trees / "contrib", name)
        else:
            compare(got, contrib, tree, trees / "contrib", name)
