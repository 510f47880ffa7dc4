"""Nothing the benchmark runs loads the JAX stack or the JAX package, by
whole top-level name; the reference loads nothing of the program."""

import ast
import subprocess
import sys

import pytest

from perfbench.lib import spec


@pytest.mark.parametrize("names, bad", [
    (["saev_tpu_torch", "saev_tpu_torch.nn.modeling", "numpy"], []),
    (["saev_tpu", "saev_tpu_torch"], ["saev_tpu"]),
    (["saev_tpu.nn.modeling", "jaxlib.xla_client", "flax", "jaxtyping"], ["flax", "jaxlib.xla_client",
                                                                          "saev_tpu.nn.modeling"]),
])
def test_names_are_compared_whole(names, bad):
    assert spec.forbidden_modules(names) == bad


def _loaded(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sorted(sys.modules)))"],
                         cwd=spec.ROOT, capture_output=True, text=True, check=True, timeout=300)
    return set(out.stdout.split())


def test_a_run_loads_no_jax():
    """Everything a run imports: run.py, every driver and reader, and the
    program's modules the drivers call."""
    code = """
import sys
sys.argv = ['run.py']
from perfbench import run
from perfbench.lib import spec
bench = spec.load_benchmark()
for w in bench['workloads']:
    spec.driver(spec.load_cell(w['name']).traffic['driver'])
for m in bench['per_layer']:
    spec.metric_reader(m['name'])
from saev_tpu_torch import parallel
from saev_tpu_torch.framework import inference, train
from saev_tpu_torch.nn import modeling, objectives
"""
    assert spec.forbidden_modules(_loaded(code)) == []


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded("from perfbench.reference import sae")
    assert not {n for n in loaded if n.split(".")[0] in ("saev_tpu", "saev_tpu_torch", "jax", "jaxlib", "flax")}
    for path in (spec.PERFBENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0] in ("saev_tpu", "saev_tpu_torch", "jax", "jaxlib", "flax")
                           for n in names), (path, names)
