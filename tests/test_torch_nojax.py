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
print(len(names))
"""


def test_port_imports_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    # The four subpackages and their ten modules at least.
    assert int(proc.stdout.split()[-1]) >= 14
