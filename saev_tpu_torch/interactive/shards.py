"""Shards disk-usage browser (the counterpart of saev_tpu/interactive/shards.py).

Capability mirror of reference `src/saev/interactive/shards.py` (marimo
disk-usage notebook, 153 LoC): walk a shards root, summarize each content-hashed
dataset (model, layers, examples, bytes) as a table (stdout + optional HTML).

Usage:
    python -m saev_tpu_torch.interactive.shards --root $SAEV_SCRATCH/saev/shards
"""

import dataclasses
import html as html_mod
import json
import logging
import pathlib

logger = logging.getLogger("interactive.shards")


@dataclasses.dataclass(frozen=True)
class Config:
    root: pathlib.Path = pathlib.Path("./saev/shards")
    """Shards root to scan."""
    out: pathlib.Path | None = None
    """Optional HTML output path."""


def scan(root: pathlib.Path) -> list[dict]:
    rows = []
    for shard_dir in sorted(pathlib.Path(root).iterdir()):
        md_f = shard_dir / "metadata.json"
        if not md_f.exists():
            continue
        md = json.loads(md_f.read_text())
        n_bytes = sum(f.stat().st_size for f in shard_dir.glob("*.bin"))
        n_shards = len(list(shard_dir.glob("acts*.bin")))
        rows.append({
            "hash": shard_dir.name,
            "family": md.get("family"),
            "ckpt": md.get("ckpt"),
            "layers": md.get("layers"),
            "n_examples": md.get("n_examples"),
            "tokens_per_example": md.get("content_tokens_per_example"),
            "d_model": md.get("d_model"),
            "n_shards": n_shards,
            "gb": n_bytes / 1e9,
            "has_labels": (shard_dir / "labels.bin").exists(),
        })
    return rows


def format_table(rows: list[dict]) -> str:
    if not rows:
        return "(no shard datasets found)"
    cols = list(rows[0].keys())
    widths = {c: max(len(c), *(len(_fmt(r[c])) for r in rows)) for c in cols}
    header = "  ".join(c.ljust(widths[c]) for c in cols)
    lines = [header, "-" * len(header)]
    for r in rows:
        lines.append("  ".join(_fmt(r[c]).ljust(widths[c]) for c in cols))
    total_gb = sum(r["gb"] for r in rows)
    lines.append(f"\n{len(rows)} datasets, {total_gb:.2f} GB total.")
    return "\n".join(lines)


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.2f}"
    return str(v)


def cli(cfg: Config) -> None:
    logging.basicConfig(level=logging.INFO)
    rows = scan(cfg.root)
    print(format_table(rows))
    if cfg.out:
        cells = "".join(
            "<tr>" + "".join(f"<td>{html_mod.escape(_fmt(v))}</td>" for v in r.values()) + "</tr>"
            for r in rows
        )
        head = "".join(f"<th>{c}</th>" for c in (rows[0].keys() if rows else []))
        cfg.out.write_text(
            f"<!doctype html><meta charset='utf-8'><title>shards</title>"
            f"<style>td,th{{border:1px solid #ddd;padding:3px 7px;font:12px system-ui}}"
            f"table{{border-collapse:collapse}}</style>"
            f"<table><tr>{head}</tr>{cells}</table>"
        )
        logger.info("Wrote %s", cfg.out)


if __name__ == "__main__":
    from ..utils import cli as cli_mod

    cli_mod.run({"shards": cli})
