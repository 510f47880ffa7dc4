"""Task-spec construction for Cambridge mimic-pair analysis (counterpart of
contrib/mimics/src/mimics/tasks.py; reference TaskSpec :30, parse_pair_spec
:58, decide_task_specs :145): expand Heliconius erato/melpomene pair specs x
views into candidate binary tasks, count class support from per-image
labels, and keep tasks with enough samples per side. Summaries are plain dict
rows and a CSV dump. Host-only.
"""

import csv
import dataclasses
import pathlib
import re

from ..tdiscovery.classification import LabelGrouping, load_image_labels

DEFAULT_PAIR_SPECS = [
    "lativitta:malleti",
    "cyrbia:cythera",
    "notabilis:plesseni",
    "hydara:melpomene",
    "venus:vulcanus",
    "demophoon:rosina",
    "phyllis:nanna",
    "erato:thelxiopeia",
]
DEFAULT_VIEWS = ["dorsal", "ventral"]
TASK_NAME_RE = re.compile(
    r"^(?P<erato>[a-zA-Z0-9]+)_(?P<view_a>[a-zA-Z0-9]+)"
    r"_vs_(?P<melp>[a-zA-Z0-9]+)_(?P<view_b>[a-zA-Z0-9]+)$"
)


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    task_name: str
    source_col: str
    groups: dict[str, list[str]]
    n_erato: int
    n_melpomene: int
    n_total: int
    keep: bool


@dataclasses.dataclass(frozen=True)
class DecideTaskSpecsConfig:
    shards: pathlib.Path = pathlib.Path("./shards/abcdef01")
    """Shard dir whose dataset supplies the subspecies_view labels."""
    pair_specs: tuple[str, ...] = tuple(DEFAULT_PAIR_SPECS)
    views: tuple[str, ...] = tuple(DEFAULT_VIEWS)
    task_names: tuple[str, ...] = ()
    """Explicit tasks; empty derives them from pair_specs x views."""
    min_samples_per_class: int = 50
    include_filtered: bool = False
    source_col: str = "subspecies_view"


def parse_pair_spec(pair_spec: str) -> tuple[str, str]:
    erato_ssp, sep, melp_ssp = pair_spec.partition(":")
    assert sep == ":", (
        f"Pair spec must look like 'erato_ssp:melp_ssp', got '{pair_spec}'."
    )
    erato_ssp, melp_ssp = erato_ssp.strip(), melp_ssp.strip()
    assert erato_ssp and melp_ssp, f"Pair spec has empty side: '{pair_spec}'."
    return erato_ssp, melp_ssp


def get_task_name(erato_ssp: str, melp_ssp: str, view: str) -> str:
    return f"{erato_ssp}_{view}_vs_{melp_ssp}_{view}"


def parse_task_name(task_name: str) -> tuple[str, str, str]:
    match = TASK_NAME_RE.fullmatch(task_name)
    assert match is not None, (
        "Task must match '{erato_ssp}_{view}_vs_{melp_ssp}_{view}', "
        f"got '{task_name}'."
    )
    view_a, view_b = match.group("view_a"), match.group("view_b")
    assert view_a == view_b, f"Task has mismatched views: '{view_a}' vs '{view_b}'."
    return match.group("erato"), match.group("melp"), view_a


def make_label_grouping(task_name: str, source_col: str = "subspecies_view") -> LabelGrouping:
    erato_ssp, melp_ssp, view = parse_task_name(task_name)
    return LabelGrouping(
        name=task_name,
        source_col=source_col,
        groups={
            "erato": [f"{erato_ssp}_{view}"],
            "melpomene": [f"{melp_ssp}_{view}"],
        },
    )


def dedup_keep_order(items: list[str]) -> list[str]:
    seen: set[str] = set()
    out = []
    for item in items:
        if item not in seen:
            seen.add(item)
            out.append(item)
    return out


def make_candidate_task_names(cfg: DecideTaskSpecsConfig) -> list[str]:
    if cfg.task_names:
        return dedup_keep_order(list(cfg.task_names))
    names = []
    for pair_spec in cfg.pair_specs:
        erato_ssp, melp_ssp = parse_pair_spec(pair_spec)
        for view in cfg.views:
            names.append(get_task_name(erato_ssp, melp_ssp, view))
    return dedup_keep_order(names)


def decide_task_specs(
    cfg: DecideTaskSpecsConfig, labels: list[str] | None = None
) -> tuple[list[TaskSpec], list[dict]]:
    """Count class support per candidate task and keep those with at least
    min_samples_per_class on each side (reference tasks.py:145-212).

    `labels` optionally injects per-image labels directly (tests); otherwise
    they load from the shards' dataset config.
    """
    if labels is None:
        cols, by_col = load_image_labels(pathlib.Path(cfg.shards))
        assert cfg.source_col in by_col, (
            f"Source column {cfg.source_col!r} not in {cols}"
        )
        labels = by_col[cfg.source_col]

    task_names = make_candidate_task_names(cfg)
    assert task_names, "No task candidates. Set task_names or pair_specs."

    specs, summary = [], []
    for task_name in task_names:
        grouping = make_label_grouping(task_name, cfg.source_col)
        y, class_names = grouping.apply(labels)
        idx = {name: i for i, name in enumerate(class_names)}
        n_erato = int((y == idx["erato"]).sum()) if "erato" in idx else 0
        n_melp = int((y == idx["melpomene"]).sum()) if "melpomene" in idx else 0
        keep = min(n_erato, n_melp) >= cfg.min_samples_per_class
        spec = TaskSpec(
            task_name=task_name,
            source_col=grouping.source_col,
            groups=grouping.groups,
            n_erato=n_erato,
            n_melpomene=n_melp,
            n_total=n_erato + n_melp,
            keep=keep,
        )
        summary.append({
            "task_name": spec.task_name,
            "n_erato": spec.n_erato,
            "n_melpomene": spec.n_melpomene,
            "n_total": spec.n_total,
            "keep": spec.keep,
            "source_col": spec.source_col,
            "erato_label": spec.groups["erato"][0],
            "melpomene_label": spec.groups["melpomene"][0],
        })
        if keep or cfg.include_filtered:
            specs.append(spec)

    summary.sort(key=lambda r: (not r["keep"], -r["n_total"], r["task_name"]))
    return specs, summary


def dump_summary_csv(summary: list[dict], fpath: pathlib.Path) -> None:
    fpath.parent.mkdir(parents=True, exist_ok=True)
    fields = [
        "task_name", "n_erato", "n_melpomene", "n_total", "keep",
        "source_col", "erato_label", "melpomene_label",
    ]
    with open(fpath, "w", newline="") as fd:
        writer = csv.DictWriter(fd, fieldnames=fields)
        writer.writeheader()
        writer.writerows(summary)
