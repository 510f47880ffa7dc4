"""The benchmark of saev_tpu_torch, one cell a run.

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Reads the cell NAME of BENCHMARK.json, its configuration, traffic and limits
(perfbench/lib/spec.py), runs its traffic's driver (perfbench/drivers/) on
the card: set-up from the seed, a window of S seconds of back-to-back work,
then the reference's check. Prints the numbers compared beside their limits
as the last lines of standard error, and as the last line of standard output
one JSON object: "correct", "attempted", "failed", "metrics" (with --trace 0
the cell's end-to-end metrics, with --trace 1 its per-layer ones, each read
by perfbench/metrics/<name>.py), "device", with --trace 1 "breakdown", and
last "checks".

Exits non-zero, printing no result, where no CUDA device is seen or fewer
than the cell asks for, and where a module of the JAX stack or of the JAX
package (by whole top-level name) is loaded at the start or once the window
has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# Caches of compilers the program may use, at fixed paths inside the checkout
# whatever the environment names, so that two checkouts share none.
CACHE = ROOT / ".perfbench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")
os.environ["USE_FLAX"] = "0"  # keep libraries that could load JAX from doing so

from perfbench.lib import result, spec  # noqa: E402


def power_limit() -> str | None:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def execute(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str, t0: float):
    """Run the cell and build the result: (the result's dict, the lines of
    the numbers compared). No check for a card here: `main` makes it."""
    run = spec.driver(cell.traffic["driver"]).run(cell, seed, seconds, trace, device, t0)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(run.end_to_end[m["name"]]), "unit": m["unit"]}
    if device == "cuda":
        dev = result.device_fields(cell.chips, run.memory_peak_bytes)
        dev["power_limit"] = power_limit()
    else:
        dev = {"platform": device, "kind": device, "count": cell.chips, "memory_peak_bytes": run.memory_peak_bytes}
    line = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed, "metrics": metrics,
            "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        line["breakdown"] = {"device_ops": run.trace.top_ops(), "idle_gaps": run.trace.idle_gaps()}
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in run.checks}
    lines = [f"check {c.name}: {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}" for c in run.checks]
    return line, lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    if spec.forbidden_modules():
        print(f"perfbench: modules of the JAX stack or the JAX package are loaded: {spec.forbidden_modules()}",
              file=sys.stderr)
        return 3
    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: cell {cell.name} needs {cell.chips} CUDA device(s); {n} seen", file=sys.stderr)
        return 2
    line, lines = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    bad = spec.forbidden_modules()
    if bad:
        print(f"perfbench: modules of the JAX stack or the JAX package are loaded: {bad}", file=sys.stderr)
        return 3
    for text in lines:
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
