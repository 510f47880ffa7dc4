"""saev_tpu_torch and chip_smoke.py import with jax, jaxlib, orbax, PIL,
pandas, scikit-learn, matplotlib and the JAX package (saev_tpu) blocked: the
machine with the card has no JAX (and maybe no Pillow, pandas, scikit-learn
or matplotlib). The library surface that reads a run (the `nn` names,
`IndexedDataset`, `csr_topk`, `PercentileEstimator`, the schedulers), Muon's
and "high"'s code and the interpretation layer's colormap run there too."""

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

SCRIPT = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "orbax", "PIL", "pandas", "sklearn", "matplotlib", "saev_tpu")

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


def test_port_imports_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    # The subpackages and their modules: 41 since the training job, 44 since
    # inference, 57 since extraction, 58 since indexed, 72 since the
    # interpretation layer.
    assert int(proc.stdout.split()[-1]) >= 72
    assert JOB_MODULES <= set(proc.stdout.split()[:-1])
    assert EXTRACT_MODULES <= set(proc.stdout.split()[:-1])
    assert LIBRARY_MODULES <= set(proc.stdout.split()[:-1])
    assert INTERPRET_MODULES <= set(proc.stdout.split()[:-1])
