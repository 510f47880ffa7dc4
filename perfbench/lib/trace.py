"""The traced part of a `--trace 1` run: torch.profiler over CUPTI (the
method of the port's `scripts/kprof.py`, copied, not imported), reduced to
device operations, host spans and matmul calls; and the kernel names of the
port's hand-written CUDA sources, by file.

The benchmark's own files open every host span (`span`, a
`torch.profiler.record_function` named "perfbench.<what>") around the calls
into each layer of the program; no span is added inside the program.
"""

import collections
import contextlib
import dataclasses
import pathlib
import re
import time

import torch

from . import spec, work

# Port kernels by source file -> layer. A source not listed here is a port
# kernel of no named layer: it counts as neither elementwise nor cuBLAS.
LAYER_OF_SOURCE = {
    "prefix_fwd.cu": "matryoshka", "dgrad.cu": "matryoshka", "wgrad.cu": "matryoshka",
    "matryoshka.cu": "matryoshka", "prefix_gouter.cu": "matryoshka", "prefix_walk.cuh": "matryoshka",
    "topk_stats.cu": "select", "kth.cu": "select", "kth_masked.cu": "select", "kth_wide.cu": "select",
    "kth_ops.cu": "select", "kth_shard.cu": "select", "encode_stats.cu": "select", "topk_row.cuh": "select",
    "row_stream.cuh": "select",
}
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)\s*)?(\w+)")


def port_kernels(csrc: pathlib.Path | None = None) -> dict[str, str]:
    """Kernel name -> layer ("matryoshka", "select" or "port") for every
    `__global__` function of the port's CUDA sources."""
    csrc = csrc or spec.ROOT / "saev_tpu_torch" / "csrc"
    out = {}
    for path in sorted(csrc.glob("*.cu*")):
        for name in _GLOBAL.findall(path.read_text()):
            out[name] = LAYER_OF_SOURCE.get(path.name, "port")
    return out


def kernel_layer(name: str, ports: dict[str, str]) -> str | None:
    """The port layer of a device operation's name, or None for a kernel of
    no port source (a library's, or PyTorch's own)."""
    for token in re.findall(r"\w+", name):
        if token in ports:
            return ports[token]
    return None


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


class Spans:
    """Host spans of the benchmark's own around its calls into the program.
    Each `span(name)` is a `record_function` "perfbench.<name>" that a
    profiler with host activity sees, and, while `recording`, an interval
    (name, start s, end s) on the host's perf_counter clock in `log`."""

    def __init__(self):
        self.recording = False
        self.log: list[tuple[str, float, float]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        with torch.profiler.record_function(f"perfbench.{name}"):
            if not self.recording:
                yield
                return
            t = time.perf_counter()
            try:
                yield
            finally:
                self.log.append((f"perfbench.{name}", t, time.perf_counter()))


@dataclasses.dataclass
class Trace:
    """One traced window: device operations (name, start s, end s) and the
    host spans (name, start s, end s) on the same clock, `window` = (start s,
    end s); from a second stretch, the matmul calls (op, input shapes, input
    dtypes, device s of their kernels, host start s, their kernels' names),
    the host spans around them (`call_spans`, on that stretch's clock) and
    `matmul_kernels`, the names of the kernels the matmul calls launched."""

    ops: list[tuple[str, float, float]]
    spans: list[tuple[str, float, float]]
    matmuls: list[tuple[str, list, list, float, float, tuple]]
    window: tuple[float, float]
    matmul_kernels: frozenset = frozenset()
    call_spans: list[tuple[str, float, float]] = dataclasses.field(default_factory=list)

    def enclosing(self, t: float, prefix: str) -> str | None:
        """The innermost span of `call_spans` named with `prefix` open at
        host time t of the matmul calls' stretch."""
        open_spans = [s for s in self.call_spans if s[0].startswith(prefix) and s[1] <= t <= s[2]]
        return min(open_spans, key=lambda s: s[2] - s[1])[0] if open_spans else None

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of device operations' intervals inside the window."""
        lo, hi = self.window
        merged: list[list[float]] = []
        for _, a, b in sorted((o for o in self.ops), key=lambda o: o[1]):
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def kernel_s(self, include) -> float:
        """Device seconds of the kernels whose name `include` accepts
        (copies and fills left out)."""
        return sum(b - a for name, a, b in self.ops if not is_copy(name) and include(name))

    def top_ops(self, n: int = 10) -> list[list]:
        total: dict[str, float] = collections.defaultdict(float)
        for name, a, b in self.ops:
            total[name[:200]] += b - a
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """The device's idle time inside the window by the innermost host
        span open at each gap's midpoint ("outside spans" where none is),
        the longest first."""
        lo, hi = self.window
        edges = [lo] + [t for iv in self.busy_intervals() for t in iv] + [hi]
        total: dict[str, float] = collections.defaultdict(float)
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            open_spans = [s for s in self.spans if s[1] <= mid <= s[2]]
            label = min(open_spans, key=lambda s: s[2] - s[1])[0] if open_spans else "outside spans"
            total[label] += b - a
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


MARKER = "spin_kernel"  # torch.cuda._sleep's kernel: ties the device's clock to the host's


def _device_ops(prof) -> list[tuple[str, float, float]]:
    cuda = torch.autograd.DeviceType.CUDA
    # The host spans' copies on the device's timeline are annotations, not operations.
    return [(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6) for e in prof.events()
            if e.device_type == cuda and not (e.is_user_annotation or e.name.startswith("perfbench."))]


def _matmuls(prof):
    """(matmul calls, the names of their kernels, the host spans) of a
    profile with host activity and recorded shapes."""
    calls, names, spans = [], set(), []
    for e in prof.events():
        start, end = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type == torch.autograd.DeviceType.CUDA:
            continue
        if e.name.startswith("perfbench."):
            spans.append((e.name, start, end))
        elif e.name in work.MATMUL_OPS and e.kernels:
            calls.append((e.name, list(e.input_shapes or []), list(getattr(e, "input_dtypes", None) or []),
                          sum(k.duration for k in e.kernels) / 1e6, start, tuple(k.name for k in e.kernels)))
            names.update(k.name for k in e.kernels)
    return calls, names, spans


def profile(fn, spans: Spans, tries: int = 3) -> Trace:
    """Trace `fn()` twice (each call runs the next stretch of the window's
    work) and return one Trace. First with device activity alone, so that
    the profiler adds next to nothing to the host's time: the device's
    operations, and the host spans from `spans`' clock, put on the device's
    by a marker kernel launched at a known host time. Then with host
    activity and recorded shapes: the matmul calls, their kernels and the
    spans around them. The profiler can record no device operation at all in
    a profile (seen on the card); such a profile is taken again after a
    second, up to `tries` times. Raises without a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("the trace needs a CUDA device; it does not profile the CPU")
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    for attempt in range(tries):
        if attempt:
            time.sleep(1.0)
        spans.log = []
        with _profile(activities=[ProfilerActivity.CUDA]) as prof:
            # The profiler can miss the first launch after it starts: give it one before the marker.
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            spans.recording = True
            t0 = time.perf_counter()
            torch.cuda._sleep(1000)
            try:
                fn()
                torch.cuda.synchronize()
            finally:
                spans.recording = False
            t1 = time.perf_counter()
        ops = _device_ops(prof)
        marker = [o for o in ops if MARKER in o[0]]
        if marker and len(ops) > len(marker) + 1:
            break
    offset = marker[0][1] - t0 if marker else 0.0
    first = marker[0][2] if marker else t0
    ops = [o for o in ops if MARKER not in o[0] and o[1] >= first]
    host = [(name, a + offset, b + offset) for name, a, b in spans.log]
    with _profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    calls, names, cpu_spans = _matmuls(prof)
    return Trace(ops=ops, spans=host, matmuls=calls, window=(first, t1 + offset), matmul_kernels=frozenset(names),
                 call_spans=cpu_spans)
