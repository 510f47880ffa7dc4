"""Parse probe1d structured-telemetry logs into frames and figures
(counterpart of contrib/trait_discovery/src/tdiscovery/logparse.py).

Capability mirror of reference contrib/trait_discovery/notebooks/logs.py
(Event/ProbeIter dataclasses + load_events + the VRAM/loss/gradient plots):
`probe1d.stats` emits one JSON line per LM iteration (grad/step norms, lambda,
loss, trust-region health, host RSS, device peak memory) plus CSR-load
bracketing events; this module loads them back as typed events, assembles a
tidy per-iteration dataframe, and renders the standard diagnostic figures.

The parser is prefix-tolerant: logging handlers usually prepend
"[timestamp] [LEVEL] [probe1d.stats]" to the JSON payload, so each line is
scanned for its first '{'.
"""

import dataclasses
import datetime
import json
import logging
import pathlib
import typing as tp

from .. import helpers

logger = logging.getLogger("tdiscovery.logparse")


@dataclasses.dataclass(frozen=True)
class Event:
    """Base telemetry event (reference notebooks/logs.py Event)."""

    timestamp: datetime.datetime
    name: str


@dataclasses.dataclass(frozen=True)
class ProbeIter(Event):
    """One LM iteration of a class slab (reference notebooks/logs.py
    ProbeIter; payload written by probe1d.fit)."""

    slab: tuple[int, int]
    iter: int
    grad_max: float | None
    step_max: float | None
    lambda_mean: float | None
    loss_mean: float | None
    loss_max: float | None
    rho_mean: float | None
    rho_min: float | None
    pred_mean: float | None
    success_frac: float | None
    fallback: int
    step_clipped: int
    rss_gb: float | None
    device_peak_gb: float | None

    @classmethod
    def from_payload(cls, payload: dict[str, object]) -> tp.Self:
        def opt_float(key: str) -> float | None:
            value = payload.get(key)
            return None if value is None else float(value)

        slab_raw = payload["slab"]
        if not isinstance(slab_raw, (list, tuple)) or len(slab_raw) != 2:
            raise ValueError(f"slab must be a length-2 sequence, got {slab_raw!r}")
        return cls(
            timestamp=datetime.datetime.fromisoformat(str(payload["timestamp"])),
            name="probe_iteration",
            slab=(int(slab_raw[0]), int(slab_raw[1])),
            iter=int(payload["iter"]),
            grad_max=opt_float("grad_max"),
            step_max=opt_float("step_max"),
            lambda_mean=opt_float("lambda_mean"),
            loss_mean=opt_float("loss_mean"),
            loss_max=opt_float("loss_max"),
            rho_mean=opt_float("rho_mean"),
            rho_min=opt_float("rho_min"),
            pred_mean=opt_float("pred_mean"),
            success_frac=opt_float("success_frac"),
            fallback=int(payload.get("fallback", 0)),
            step_clipped=int(payload.get("step_clipped", 0)),
            rss_gb=opt_float("rss_gb"),
            device_peak_gb=opt_float("device_peak_gb"),
        )


@dataclasses.dataclass(frozen=True)
class LoadCsr(Event):
    """CSR activation-matrix load bracket (reference notebooks/logs.py
    LoadCsrRamStart/End)."""

    split: str
    phase: tp.Literal["start", "end"]
    fpath: str | None
    nnz: int | None
    rss_gb: float | None

    @classmethod
    def from_payload(cls, payload: dict[str, object]) -> tp.Self:
        name = str(payload["event"])
        rss = payload.get("rss_gb")
        nnz = payload.get("nnz")
        return cls(
            timestamp=datetime.datetime.fromisoformat(str(payload["timestamp"])),
            name=name,
            split=str(payload["split"]),
            phase="start" if name.endswith("start") else "end",
            fpath=(None if payload.get("fpath") is None else str(payload["fpath"])),
            nnz=(None if nnz is None else int(nnz)),
            rss_gb=(None if rss is None else float(rss)),
        )


_PARSERS: dict[str, tp.Callable[[dict[str, object]], Event]] = {
    "probe_iteration": ProbeIter.from_payload,
    "load_csr_start": LoadCsr.from_payload,
    "load_csr_end": LoadCsr.from_payload,
}


def parse_line(line: str) -> Event | None:
    """One telemetry event from a log line, or None for non-event lines."""
    start = line.find("{")
    if start < 0:
        return None
    try:
        payload = json.loads(line[start:])
    except json.JSONDecodeError:
        return None
    if not isinstance(payload, dict):
        return None
    parser = _PARSERS.get(str(payload.get("event")))
    if parser is None:
        return None
    try:
        return parser(payload)
    except (KeyError, ValueError, TypeError) as err:
        logger.warning("Skipping malformed event line: %s", err)
        return None


def load_events(fpath: pathlib.Path | str) -> list[Event]:
    """All telemetry events in a log file, in file order."""
    events = []
    with open(fpath) as fd:
        for line in fd:
            event = parse_line(line)
            if event is not None:
                events.append(event)
    return events


def iters_df(events: list[Event]):
    """Tidy per-iteration dataframe: one row per ProbeIter, with a `slab_id`
    label column and seconds-since-first-event `elapsed_s`."""
    pd = helpers.optional_import("pandas", "tdiscovery.logparse")

    iters = [e for e in events if isinstance(e, ProbeIter)]
    if not iters:
        return pd.DataFrame()
    t0 = min(e.timestamp for e in events)
    rows = []
    for e in iters:
        row = dataclasses.asdict(e)
        row.pop("name")
        row["slab_id"] = f"{e.slab[0]}:{e.slab[1]}"
        row["elapsed_s"] = (e.timestamp - t0).total_seconds()
        rows.append(row)
    return pd.DataFrame(rows)


def summarize(events: list[Event]) -> dict[str, object]:
    """Run-level summary: slab count, total iterations, final/max loss, peak
    memory, fallback totals — the headline numbers of the reference notebook."""
    df = iters_df(events)
    if df.empty:
        return {"n_slabs": 0, "n_iterations": 0}
    last = df.sort_values("iter").groupby("slab_id").last()
    out: dict[str, object] = {
        "n_slabs": int(df["slab_id"].nunique()),
        "n_iterations": int(len(df)),
        "max_iter": int(df["iter"].max()) + 1,
        "final_loss_mean": float(last["loss_mean"].mean()),
        "final_grad_max": float(last["grad_max"].max()),
        "total_fallbacks": int(df["fallback"].sum()),
        "total_clipped": int(df["step_clipped"].sum()),
    }
    if df["rss_gb"].notna().any():
        out["peak_rss_gb"] = float(df["rss_gb"].max())
    if df["device_peak_gb"].notna().any():
        out["peak_device_gb"] = float(df["device_peak_gb"].max())
    loads = [e for e in events if isinstance(e, LoadCsr) and e.phase == "end"]
    if loads:
        # A list, not a dict: train and test splits may share a shards dir
        # (same key), and each load is its own event.
        out["csr_loads"] = [{"split": e.split, "nnz": e.nnz} for e in loads]
    return out


def _plt():
    helpers.optional_import("matplotlib", "tdiscovery.logparse's figures").use("Agg", force=False)
    return helpers.optional_import("matplotlib.pyplot", "tdiscovery.logparse's figures")


def fig_loss(df):
    """Per-slab loss_mean vs iteration (log y) — convergence at a glance."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(7, 4))
    for slab_id, grp in df.groupby("slab_id"):
        ax.plot(grp["iter"], grp["loss_mean"], marker=".", label=slab_id, alpha=0.7)
    ax.set_yscale("log")
    ax.set_xlabel("LM iteration")
    ax.set_ylabel("mean BCE loss")
    if df["slab_id"].nunique() <= 12:
        ax.legend(title="class slab", fontsize=8)
    fig.tight_layout()
    return fig


def fig_grad(df):
    """grad_max and step_max vs iteration (log y), per slab."""
    plt = _plt()
    fig, axes = plt.subplots(1, 2, figsize=(10, 4), sharex=True)
    for slab_id, grp in df.groupby("slab_id"):
        axes[0].plot(grp["iter"], grp["grad_max"], alpha=0.7, label=slab_id)
        axes[1].plot(grp["iter"], grp["step_max"], alpha=0.7)
    for ax, title in zip(axes, ("grad_max", "step_max")):
        ax.set_yscale("log")
        ax.set_xlabel("LM iteration")
        ax.set_title(title)
    fig.tight_layout()
    return fig


def fig_memory(df):
    """Host RSS (and device peak, when present) over wall-clock time."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(7, 4))
    have = df[df["rss_gb"].notna()]
    ax.plot(have["elapsed_s"], have["rss_gb"], label="host RSS")
    dev = df[df["device_peak_gb"].notna()]
    if not dev.empty:
        ax.plot(dev["elapsed_s"], dev["device_peak_gb"], label="device peak")
    ax.set_xlabel("elapsed (s)")
    ax.set_ylabel("GiB")
    ax.legend()
    fig.tight_layout()
    return fig


def fig_trust_region(df):
    """Lambda and rho trajectories — trust-region health (a stuck-high lambda
    or persistently negative rho flags an ill-conditioned slab)."""
    plt = _plt()
    fig, axes = plt.subplots(1, 2, figsize=(10, 4), sharex=True)
    for _, grp in df.groupby("slab_id"):
        axes[0].plot(grp["iter"], grp["lambda_mean"], alpha=0.7)
        axes[1].plot(grp["iter"], grp["rho_mean"], alpha=0.7)
    axes[0].set_yscale("log")
    axes[0].set_title("lambda_mean")
    axes[1].set_title("rho_mean")
    for ax in axes:
        ax.set_xlabel("LM iteration")
    fig.tight_layout()
    return fig
