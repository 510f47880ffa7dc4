"""The harness finds configurations, cells, traffic, limits and metric
readers by name, and a new cell or metric is added by adding files."""

import json
import shutil

import pytest

from perfbench.lib import result, spec

BENCH = spec.load_benchmark()


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_by_name(name):
    cell = spec.load_cell(name)
    assert cell.chips == 1
    assert cell.config["name"] == next(w["config"] for w in BENCH["workloads"] if w["name"] == name)
    assert spec.driver(cell.traffic["driver"]).run
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    # Each per-layer metric's `moves` is an end-to-end metric the cell reports.
    assert {m["moves"] for m in cell.per_layer} <= names
    assert set(cell.checks) and all(isinstance(v, (int, float)) for v in cell.checks.values())


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_has_a_reader(name):
    assert callable(spec.metric_reader(name))


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no-such-cell")


def test_configs_state_their_keys():
    for c in BENCH["configs"]:
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
        assert cfg["source"] == c["source"]
        assert "activations" in cfg["assumed"]


def test_a_cell_and_a_metric_are_added_by_adding_files(tmp_path):
    """A throwaway cell (a configuration, a traffic mix, limits) and a
    throwaway metric reader, in a copy of the benchmark's folder, load by
    name with no file that was there edited."""
    bench_dir = tmp_path / "perfbench"
    shutil.copytree(spec.PERFBENCH, bench_dir, ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((spec.ROOT / "perfbench/configs/topk-16x.json").read_text())
    cfg.update(name="topk-8x", d_sae=8192)
    (bench_dir / "configs" / "topk-8x.json").write_text(json.dumps(cfg))
    (bench_dir / "traffic" / "sweep2.json").write_text(json.dumps(
        {"driver": "train_loop", "top_ks": [32], "lrs": [1e-4, 1e-3], "dead_share": 0.05, "dead_bias": -16.0,
         "start_step": 610, "ring": 4}))
    (bench_dir / "checks" / "train-8x-sweep2.json").write_text(json.dumps({"loss_gap": 0.5}))
    (bench_dir / "metrics" / "steps_seen.train.py").write_text(
        "def read(run):\n    return run.counts.get('steps')\n")
    bench["configs"].append({"name": "topk-8x", "source": "https://example.org/x", "file": "perfbench/configs/topk-8x.json",
                             "reduced": ["d_sae"], "why": "throwaway"})
    bench["workloads"].append({"name": "train-8x-sweep2", "config": "topk-8x", "traffic": "sweep2", "chips": 1,
                               "why": "throwaway"})
    bench["per_layer"].append({"name": "steps_seen.train", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "train step", "moves": "train_patches_per_s",
                               "workloads": ["train-8x-sweep2"]})
    bench["end_to_end"][1]["workloads"].append("train-8x-sweep2")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("train-8x-sweep2", root=tmp_path, bench_dir=bench_dir)
    assert cell.config["d_sae"] == 8192 and cell.traffic["lrs"] == [1e-4, 1e-3]
    assert [m["name"] for m in cell.per_layer] == ["steps_seen.train"]
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "train_patches_per_s", "peak_mem_gib"}
    reader = spec.metric_reader("steps_seen.train", bench_dir=bench_dir)
    assert reader(result.Run(cell=cell, counts={"steps": 7})) == 7
    assert spec.driver("train_loop", bench_dir=bench_dir).run
