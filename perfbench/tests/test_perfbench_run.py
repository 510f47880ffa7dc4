"""A run's last line, its correctness checks against the port's CPU step and
inference at a tiny size, and the checks failing where the timed path is
broken underneath (the harness's look for a card skipped)."""

import json
import subprocess
import sys
import time

import pytest
import torch

from perfbench import run as bench
from perfbench.lib import spec
from perfbench.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


def _execute(name, fault=None, seed=2**31 + 17):
    return bench.execute(tiny.cell(name, fault), seed, 0.3, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_last_line_keys_and_correct(name):
    line, lines = _execute(name)
    assert list(line) == KEYS, "checks come last"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    cell = spec.load_cell(name)
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(m["value"] > 0 for k, m in line["metrics"].items() if k != "peak_mem_gib")
    assert set(line["checks"]) == set(cell.checks)
    assert len(lines) == len(cell.checks) and all(t.startswith("check ") for t in lines)
    json.dumps(line)


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port_on_the_cpu(name):
    """On the CPU the port's step and inference are f32, as the reference is:
    every number compared is at rounding."""
    line, _ = _execute(name, seed=11)
    for check, c in line["checks"].items():
        assert c["value"] <= 1e-4, (check, c)


@pytest.mark.parametrize("name, fault", [(c, f) for c in CELLS if c.startswith("train")
                                         for f in ("unchanged", "half_batch")]
                         + [(c, f) for c in CELLS if c.startswith("infer") for f in ("altered", "half_batch")])
def test_a_broken_timed_path_is_not_correct(name, fault):
    line, lines = _execute(name, fault)
    assert line["correct"] is False and line["failed"] >= 1
    assert any(t.endswith("FAILED") for t in lines)


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELLS[0], "--seed", "1", "--seconds", "1"],
                         cwd=spec.ROOT, capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card(card, name):
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", name, "--seed", "12345",
                          "--seconds", "2", "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
