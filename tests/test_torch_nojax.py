"""saev_tpu_torch and chip_smoke.py import with jax, jaxlib, orbax and PIL
blocked: the machine with the card has no JAX (and maybe no Pillow)."""

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

SCRIPT = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "orbax", "PIL")

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


def test_port_imports_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    # The five subpackages and their modules: 41 since the training job, 44
    # since inference.
    assert int(proc.stdout.split()[-1]) >= 44
    assert JOB_MODULES <= set(proc.stdout.split()[:-1])
