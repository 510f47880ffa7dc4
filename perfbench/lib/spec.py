"""Finding a cell's files by name, and the guard against the JAX package.

A cell is one entry of `workloads` in the root `BENCHMARK.json`: a
configuration (`configs/<config>.json`) under a traffic mix
(`traffic/<traffic>.json`, whose "driver" names `drivers/<driver>.py`), with
its correctness limits in `checks/<cell>.json`. A per-layer metric is read by
`metrics/<metric>.py`. Nothing here names a cell, a configuration or a
metric: a later change adds one by adding files and entries.
"""

import dataclasses
import importlib.util
import json
import pathlib
import sys

PERFBENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = PERFBENCH.parent

# Whole top-level module names the benchmark's process may never load: the
# JAX stack and the JAX package. The port's name starts with the JAX
# package's, so names are compared whole, never by prefix.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "saev_tpu"})


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name (the part before the first
    dot) is one of FORBIDDEN, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    checks: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: pathlib.Path = ROOT, bench_dir: pathlib.Path = PERFBENCH) -> Cell:
    """The cell `name` of `root/BENCHMARK.json`, with its configuration,
    traffic and limits read from `bench_dir`, and the metrics it reports.
    Raises KeyError for a cell that BENCHMARK.json does not name."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    checks = json.loads((bench_dir / "checks" / f"{name}.json").read_text())
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic, checks=checks,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def load_module(path: pathlib.Path, name: str):
    """A module from its file (metric readers' names hold dots, so they are
    loaded by path, not imported by name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(name: str, bench_dir: pathlib.Path = PERFBENCH):
    return load_module(bench_dir / "drivers" / f"{name}.py", f"perfbench_driver_{name}")


def metric_reader(name: str, bench_dir: pathlib.Path = PERFBENCH):
    """`metrics/<name>.py`'s `read(run) -> float | None`."""
    return load_module(bench_dir / "metrics" / f"{name}.py", "perfbench_metric_" + name.replace(".", "_")).read
