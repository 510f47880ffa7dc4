"""saev_tpu_torch and chip_smoke.py import with jax, jaxlib, orbax, PIL,
pandas, scikit-learn, matplotlib, h5py, the JAX package (saev_tpu) and
contrib (`contrib`, and its `tdiscovery`, `mimics`, `birdsong` and
`freshwater_fish` packages) blocked: the machine with the card has no JAX
(and maybe no Pillow, pandas, scikit-learn, matplotlib or h5py). The library surface that reads a run (the `nn` names,
`IndexedDataset`, `csr_topk`, `PercentileEstimator`, the schedulers), Muon's
and "high"'s code, the interpretation layer's colormap, trait discovery's
probe fit and memory plan, the semseg probes' AdamW step, the audit's
tie-aware AP and the mimic scores' AUROC run there too, as do birdsong's
statistics, the study modules' numpy (pareto fronts, fishbase's scores,
probe telemetry lines) and the data-prep parsers; cls::train raises an
ImportError that names scikit-learn, the study figures one that names
matplotlib, and the TreeOfLife extraction one that names h5py."""

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

SCRIPT = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "orbax", "PIL", "pandas", "sklearn", "matplotlib", "h5py", "saev_tpu", "contrib",
           "tdiscovery", "mimics", "birdsong", "freshwater_fish")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import saev_tpu_torch
names = [m.name for m in pkgutil.walk_packages(saev_tpu_torch.__path__, "saev_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert callable(chip_smoke.main)

import numpy as np, scipy.sparse, torch
from saev_tpu_torch import helpers
from saev_tpu_torch.data import IndexedConfig, IndexedDataset
from saev_tpu_torch.framework import train
from saev_tpu_torch.nn import load, modeling
from saev_tpu_torch.utils import scheduling, statistics
assert callable(load) and IndexedDataset and IndexedConfig().tokens == "content"
assert helpers.csr_topk(scipy.sparse.csr_array(np.eye(4, dtype=np.float32)), 1, 0).indices.tolist() == [[0, 1, 2, 3]]
est = statistics.PercentileEstimator(50, 10)
est.update(1.0)
assert scheduling.WarmupCosine(0.0, 2, 1.0, 10, 0.0).step() == 0.5
assert train._newton_schulz(torch.eye(4)[None]).shape == (1, 4, 4)
assert torch.equal(modeling.matmul(torch.eye(3), torch.eye(3), "high"), torch.eye(3))
from saev_tpu_torch import viz
assert viz.colormap([0.0, 1.0]).shape == (2, 4) and viz.parse_color("#ff0000") == (1.0, 0.0, 0.0)
from saev_tpu_torch.tdiscovery import probe1d
x = scipy.sparse.csr_matrix(np.array([[1.0, 0.0], [0.0, 2.0], [1.5, 0.0], [0.0, 0.0]], dtype=np.float32))
y = np.array([[1.0], [0.0], [1.0], [0.0]], dtype=np.float32)
probe = probe1d.Sparse1DProbe(n_latents=2, n_classes=1, max_iter=5, device="cpu").fit(x, y)
assert np.isfinite(probe.coef_).all() and probe.coef_[0, 0] > 0
assert probe1d.plan_memory(n_latents=16384, n_classes=10, nnz=1 << 25, n_samples=1 << 20,
                           max_class_slab=8).class_slab_size == 8
from saev_tpu_torch.interactive_interp.semseg import training as semseg_training
params = {"w": torch.zeros(1, 2, 3), "b": torch.zeros(1, 3)}
params, opt, losses = semseg_training.step(params, semseg_training.init_opt(params), torch.ones(4, 2),
                                           torch.tensor([0, 1, 2, 1]), torch.tensor([0.1]), torch.tensor([0.0]))
assert opt["count"] == 1 and abs(float(losses[0]) - float(np.log(3))) < 1e-6 and params["b"][0, 1] > 0
from saev_tpu_torch.tdiscovery import classification
from saev_tpu_torch.mimics import scoring
ap = classification.tie_aware_ap(np.array([2.0, 1.0, 1.0, 0.0], np.float32), np.eye(4, 2, dtype=np.float32),
                                 np.ones(2, np.float32))
assert abs(float(ap[0]) - 1.0) < 1e-6 and abs(float(ap[1]) - 5 / 12) < 1e-6, ap  # rank 2 or 3: (1/2 + 1/3) / 2
assert scoring.auroc_per_latent(np.array([[0.0], [1.0], [2.0]]), np.array([0, 1, 1], np.int8)).tolist() == [1.0]
try:
    classification.train_worker_fn(classification.TrainConfig())
    raise AssertionError("cls::train ran without scikit-learn")
except ImportError as err:
    assert "pip install scikit-learn" in str(err), err
from saev_tpu_torch.birdsong import stats as bird_stats
from saev_tpu_torch.freshwater_fish import extract_tol
from saev_tpu_torch.tdiscovery import ablations, figplots, fishbase, logparse, runs
from saev_tpu_torch.tdiscovery.scripts import push_dinov3, scrape_fishbase
acts = np.random.default_rng(0).normal(size=(200, 8))
acts[:, 3] *= 50.0
assert bird_stats.outlier_dims(bird_stats.compute_stats(acts))[0]["dim"] == 3
assert runs.pareto_front(np.array([1.0, 1.0, 2.0]), np.array([0.5, 0.4, 0.6])).tolist() == [False, True, False]
assert fishbase.fast_pearson(np.array([[0.0], [1.0]]), np.array([0, 1]))[0] > 0.99
ev = logparse.parse_line('[x] {"event": "probe_iteration", "timestamp": "2026-01-01T00:00:00", "slab": [0, 2], "iter": 3}')
assert ev.slab == (0, 2) and ev.iter == 3
assert scrape_fishbase.parse_environment("<p>Marine; demersal; depth range 5 - 40 m</p>")["max_depth_m"] == 40.0
picked = push_dinov3.select_pareto([push_dinov3.RunMetrics("a", 0, 2.0, 0.5), push_dinov3.RunMetrics("b", 0, 4.0, 0.6)])
assert [r.run_id for r in picked] == ["a"]
for what, fn in (("matplotlib", lambda: figplots.fig_tradeoff(None)), ("matplotlib", lambda: logparse.fig_loss(None)),
                 ("matplotlib", lambda: ablations.fig_variant_grid(None)),
                 ("h5py", lambda: extract_tol.extract_h5_file("x.h5", [], 90)),
                 ("pandas", lambda: runs.load_df([]))):
    try:
        fn()
        raise AssertionError(f"ran without {what}")
    except ImportError as err:
        assert f"pip install {what}" in str(err), err
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED + ("saev_tpu",))
assert not leaked, leaked
print(" ".join(names))
print(len(names))
"""

# The training job's and inference's modules, each imported with the blocked
# packages above.
JOB_MODULES = {
    "saev_tpu_torch.helpers", "saev_tpu_torch.guards", "saev_tpu_torch.disk", "saev_tpu_torch.configs",
    "saev_tpu_torch.parallel", "saev_tpu_torch.data", "saev_tpu_torch.data.shards",
    "saev_tpu_torch.data.buffers", "saev_tpu_torch.data._native", "saev_tpu_torch.data.shuffled",
    "saev_tpu_torch.utils.scheduling", "saev_tpu_torch.utils.monitoring", "saev_tpu_torch.utils.statistics",
    "saev_tpu_torch.utils.wandb", "saev_tpu_torch.utils.cli", "saev_tpu_torch.nn.serialize",
    "saev_tpu_torch.framework.checkpoints", "saev_tpu_torch.framework.train",
    "saev_tpu_torch.metrics", "saev_tpu_torch.data.ordered", "saev_tpu_torch.framework.inference",
}

# The library surface that reads a run, imported with the blocked packages above.
LIBRARY_MODULES = {"saev_tpu_torch.data.indexed", "saev_tpu_torch.nn", "saev_tpu_torch.helpers",
                   "saev_tpu_torch.utils.statistics", "saev_tpu_torch.utils.scheduling"}

# Extraction's modules, each imported with the blocked packages above.
EXTRACT_MODULES = {
    "saev_tpu_torch.models", "saev_tpu_torch.models.vit", "saev_tpu_torch.models.convert",
    "saev_tpu_torch.models.families", "saev_tpu_torch.models.dinov3", "saev_tpu_torch.models.bird_mae",
    "saev_tpu_torch.data.models", "saev_tpu_torch.data.transforms", "saev_tpu_torch.data.fake_vit",
    "saev_tpu_torch.data.datasets", "saev_tpu_torch.data.extract", "saev_tpu_torch.utils.vorbis",
    "saev_tpu_torch.framework.shards",
}


# The interpretation layer's modules (the inference example, Grad-CAM, the
# web backend, export_demo and the interactive reports), each imported with
# the blocked packages above.
INTERPRET_MODULES = {
    "saev_tpu_torch.colors", "saev_tpu_torch.viz", "saev_tpu_torch.examples.inference",
    "saev_tpu_torch.scripts.gradcam", "saev_tpu_torch.scripts.export_demo", "saev_tpu_torch.web.backend",
    "saev_tpu_torch.web.__main__", "saev_tpu_torch.interactive.shards", "saev_tpu_torch.interactive.metrics",
    "saev_tpu_torch.interactive.features",
}


# Trait discovery, the launchers and the Slurm helpers' module, each imported
# with the blocked packages above.
TDISCOVERY_MODULES = {
    "saev_tpu_torch.__main__", "saev_tpu_torch.scripts.activations", "saev_tpu_torch.tdiscovery",
    "saev_tpu_torch.tdiscovery.__main__", "saev_tpu_torch.tdiscovery.probe1d", "saev_tpu_torch.tdiscovery.baselines",
    "saev_tpu_torch.tdiscovery.saes", "saev_tpu_torch.tdiscovery.metrics", "saev_tpu_torch.tdiscovery.fishvista",
    "saev_tpu_torch.tdiscovery.fishvista.utils", "saev_tpu_torch.tdiscovery.fishvista.evaluation",
}


# contrib's host-side analysis (trait discovery's classification heads and
# audit, frames, galleries and views; the mimics project), each imported
# with the blocked packages above.
CONTRIB_HOST_MODULES = {
    "saev_tpu_torch.tdiscovery.datasets", "saev_tpu_torch.tdiscovery.classification",
    "saev_tpu_torch.tdiscovery.analysis", "saev_tpu_torch.tdiscovery.audit_analysis",
    "saev_tpu_torch.tdiscovery.visuals", "saev_tpu_torch.tdiscovery.browse", "saev_tpu_torch.tdiscovery.clsview",
    "saev_tpu_torch.mimics", "saev_tpu_torch.mimics.__main__", "saev_tpu_torch.mimics.scoring",
    "saev_tpu_torch.mimics.consistency", "saev_tpu_torch.mimics.checkpoints", "saev_tpu_torch.mimics.tasks",
    "saev_tpu_torch.mimics.analysis", "saev_tpu_torch.mimics.render", "saev_tpu_torch.mimics.viewer",
}


# Interactive interpretability (semseg, semprobe, classification, the figure
# assets), FishVista's supervised skyline and Bird-MAE's channel trace, each
# imported with the blocked packages above.
INTERACTIVE_INTERP_MODULES = {
    "saev_tpu_torch.interactive_interp", "saev_tpu_torch.interactive_interp.semseg",
    "saev_tpu_torch.interactive_interp.semseg.training", "saev_tpu_torch.interactive_interp.semseg.validation",
    "saev_tpu_torch.interactive_interp.semseg.quantitative", "saev_tpu_torch.interactive_interp.semseg.visuals",
    "saev_tpu_torch.interactive_interp.semseg.interactive", "saev_tpu_torch.interactive_interp.semseg.__main__",
    "saev_tpu_torch.interactive_interp.semprobe", "saev_tpu_torch.interactive_interp.semprobe.scoring",
    "saev_tpu_torch.interactive_interp.classification", "saev_tpu_torch.interactive_interp.classification.training",
    "saev_tpu_torch.interactive_interp.classification.transforms",
    "saev_tpu_torch.interactive_interp.classification.download",
    "saev_tpu_torch.interactive_interp.classification.__main__", "saev_tpu_torch.interactive_interp.scripts",
    "saev_tpu_torch.interactive_interp.scripts.make_figures", "saev_tpu_torch.tdiscovery.fishvista.supervised",
    "saev_tpu_torch.birdsong", "saev_tpu_torch.birdsong.trace",
}


# The last of contrib (birdsong's statistics, clip galleries and browser;
# trait discovery's study modules and data-prep scripts; the freshwater-fish
# tools), each imported with the blocked packages above.
CONTRIB_LAST_MODULES = {
    "saev_tpu_torch.birdsong.stats", "saev_tpu_torch.birdsong.visuals", "saev_tpu_torch.birdsong.make_html",
    "saev_tpu_torch.birdsong.browse", "saev_tpu_torch.birdsong.__main__", "saev_tpu_torch.tdiscovery.runs",
    "saev_tpu_torch.tdiscovery.results", "saev_tpu_torch.tdiscovery.logparse", "saev_tpu_torch.tdiscovery.fishbase",
    "saev_tpu_torch.tdiscovery.mimicry", "saev_tpu_torch.tdiscovery.figplots", "saev_tpu_torch.tdiscovery.ablations",
    "saev_tpu_torch.freshwater_fish", "saev_tpu_torch.freshwater_fish.extract_tol",
    "saev_tpu_torch.freshwater_fish.make_gallery", "saev_tpu_torch.tdiscovery.scripts",
    "saev_tpu_torch.tdiscovery.scripts.format_ade20k", "saev_tpu_torch.tdiscovery.scripts.format_fishvista",
    "saev_tpu_torch.tdiscovery.scripts.download_butterflies", "saev_tpu_torch.tdiscovery.scripts.scrape_fishbase",
    "saev_tpu_torch.tdiscovery.scripts.push_dinov3",
}


def test_port_imports_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    # The subpackages and their modules: 41 since the training job, 44 since
    # inference, 57 since extraction, 58 since indexed, 72 since the
    # interpretation layer, 83 since trait discovery, 103 since interactive
    # interpretability and the channel trace, 119 since contrib's host-side
    # analysis, 140 since the last of contrib.
    assert int(proc.stdout.split()[-1]) >= 140
    assert JOB_MODULES <= set(proc.stdout.split()[:-1])
    assert EXTRACT_MODULES <= set(proc.stdout.split()[:-1])
    assert LIBRARY_MODULES <= set(proc.stdout.split()[:-1])
    assert INTERPRET_MODULES <= set(proc.stdout.split()[:-1])
    assert TDISCOVERY_MODULES <= set(proc.stdout.split()[:-1])
    assert INTERACTIVE_INTERP_MODULES <= set(proc.stdout.split()[:-1])
    assert CONTRIB_HOST_MODULES <= set(proc.stdout.split()[:-1])
    assert CONTRIB_LAST_MODULES <= set(proc.stdout.split()[:-1])
