"""Audio-gallery discovery and browser-site assembly for birdsong clips
(counterpart of contrib/birdsong/src/birdsong/browse.py; reference
notebooks/clips.py has_clips/make_ckpt_dropdown :28-56 and the per-latent
clip navigation): scan runs roots for runs whose inference artifacts include
per-latent clip galleries (written by `birdsong.visuals.worker_fn`), and
assemble the static clip-gallery HTML (`birdsong.make_html`) for each (run,
shards) pair plus an index page. Host-only, stdlib.
"""

import dataclasses
import html
import logging
import pathlib

from .. import disk
from . import make_html

logger = logging.getLogger("birdsong.browse")


@dataclasses.dataclass(frozen=True)
class ClipRun:
    """A run with at least one browsable clip gallery."""

    run_dir: pathlib.Path
    shards: tuple[str, ...]


def shards_with_clips(run_dir: pathlib.Path) -> tuple[str, ...]:
    """Inference shard dirs under `run_dir` that have a clips/ gallery
    (reference clips.py has_clips :28-39)."""
    inference = run_dir / "inference"
    if not inference.is_dir():
        return ()
    return tuple(sorted(p.name for p in inference.iterdir() if (p / "clips").is_dir()))


def discover_runs(roots: list[pathlib.Path] | tuple[pathlib.Path, ...]) -> list[ClipRun]:
    """All runs under the given roots with clip galleries; the first root wins
    on duplicate run ids (reference clips.py make_ckpt_dropdown :40-56). A
    run whose layout `disk.Run` refuses is skipped, since make_html would
    refuse it later."""
    seen: dict[str, ClipRun] = {}
    for root in roots:
        root = pathlib.Path(root)
        if not root.is_dir():
            logger.info("Skipping missing runs root %s.", root)
            continue
        for run_dir in sorted(p for p in root.iterdir() if p.is_dir()):
            if run_dir.name in seen:
                continue
            shards = shards_with_clips(run_dir)
            if not shards:
                continue
            try:
                disk.Run(run_dir)
            except (ValueError, FileNotFoundError) as err:
                logger.info("Skipping %s: invalid run layout (%s).", run_dir, err)
                continue
            seen[run_dir.name] = ClipRun(run_dir=run_dir, shards=shards)
    return sorted(seen.values(), key=lambda c: c.run_dir.name)


def build_browsers(
    roots: list[pathlib.Path] | tuple[pathlib.Path, ...],
    out_dir: pathlib.Path,
    *,
    embed: bool = True,
    runs: list[ClipRun] | None = None,
) -> list[pathlib.Path]:
    """One self-contained clip-gallery HTML per (run, shards) plus an
    index.html linking them all. Pass `runs` (from discover_runs) to skip a
    second discovery walk."""
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    written, index_rows = [], []
    for clip_run in discover_runs(roots) if runs is None else runs:
        for shards_name in clip_run.shards:
            out = out_dir / f"{clip_run.run_dir.name}__{shards_name}.html"
            cfg = make_html.Config(run=clip_run.run_dir, shards=pathlib.Path(shards_name), embed=embed, out=out)
            written.append(make_html.make(cfg))
            index_rows.append(f'<li><a href="{out.name}">{html.escape(clip_run.run_dir.name)}'
                              f" / {html.escape(shards_name)}</a></li>")
    index = out_dir / "index.html"
    index.write_text("<!doctype html><meta charset='utf-8'><title>birdsong galleries</title>"
                     f"<h1>Clip galleries ({len(written)})</h1><ul>" + "".join(index_rows) + "</ul>")
    written.append(index)
    logger.info("Wrote %d browser pages to %s.", len(written), out_dir)
    return written
