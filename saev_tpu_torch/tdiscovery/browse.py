"""Run-gallery discovery + browser assembly for trait-discovery visuals
(counterpart of contrib/trait_discovery/src/tdiscovery/browse.py; reference
notebooks/visuals.py has_images/make_ckpt_dropdown :36-70 + the latent
gallery): scan one or more runs roots for runs whose inference artifacts
include per-latent image galleries (written by `tdiscovery.visuals.worker_fn`),
and assemble the single-file HTML feature browser (`interactive.features`)
for each (run, shards) pair. Host-only.
"""

import dataclasses
import logging
import pathlib

logger = logging.getLogger("tdiscovery.browse")


@dataclasses.dataclass(frozen=True)
class GalleryRun:
    """A run with at least one browsable image gallery."""

    run_dir: pathlib.Path
    shards: tuple[str, ...]
    """Shards-hash subdirectories of inference/ that contain images/."""


def shards_with_images(run_dir: pathlib.Path) -> tuple[str, ...]:
    """Inference shard dirs under `run_dir` that have a per-latent images/
    gallery (reference visuals.py has_images :36-46)."""
    inference = run_dir / "inference"
    if not inference.is_dir():
        return ()
    return tuple(
        sorted(p.name for p in inference.iterdir() if (p / "images").is_dir())
    )


def discover_runs(roots: list[pathlib.Path] | tuple[pathlib.Path, ...]) -> list[GalleryRun]:
    """All runs under the given roots with browsable galleries; first root
    wins on duplicate run ids (reference visuals.py make_ckpt_dropdown
    :48-70 skips already-seen names).

    Discovery applies the same validity contract the browser later requires
    (`disk.Run` layout): a dir with images but a broken run layout is
    skipped with a log line rather than crashing build_browsers mid-loop."""
    from .. import disk

    seen: dict[str, GalleryRun] = {}
    for root in roots:
        root = pathlib.Path(root)
        if not root.is_dir():
            logger.info("Skipping missing runs root %s.", root)
            continue
        for run_dir in sorted(p for p in root.iterdir() if p.is_dir()):
            if run_dir.name in seen:
                continue
            shards = shards_with_images(run_dir)
            if not shards:
                continue
            try:
                disk.Run(run_dir)
            except (ValueError, FileNotFoundError) as err:
                logger.info("Skipping %s: invalid run layout (%s).", run_dir, err)
                continue
            seen[run_dir.name] = GalleryRun(run_dir=run_dir, shards=shards)
    return sorted(seen.values(), key=lambda g: g.run_dir.name)


def build_browsers(
    roots: list[pathlib.Path] | tuple[pathlib.Path, ...],
    out_dir: pathlib.Path,
    *,
    n_features: int = 200,
    embed_images: bool = True,
    runs: list[GalleryRun] | None = None,
) -> list[pathlib.Path]:
    """One self-contained feature-browser HTML per (run, shards) gallery,
    plus an index.html linking them all. Pass `runs` (from discover_runs) to
    skip a second discovery walk over large runs trees."""
    import html as html_mod

    from ..interactive import features

    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    galleries = discover_runs(roots) if runs is None else runs
    written = []
    index_rows = []
    for gallery in galleries:
        for shards_name in gallery.shards:
            out = out_dir / f"{gallery.run_dir.name}__{shards_name}.html"
            cfg = features.Config(
                runs=(gallery.run_dir,),
                shards=pathlib.Path(shards_name),
                n_features=n_features,
                embed_images=embed_images,
                out=out,
            )
            written.append(features.generate(cfg))
            index_rows.append(
                f'<li><a href="{out.name}">{html_mod.escape(gallery.run_dir.name)}'
                f" / {html_mod.escape(shards_name)}</a></li>"
            )
    index = out_dir / "index.html"
    index.write_text(
        "<!doctype html><meta charset='utf-8'><title>saev galleries</title>"
        f"<h1>Feature galleries ({len(written)})</h1><ul>"
        + "".join(index_rows)
        + "</ul>"
    )
    written.append(index)
    logger.info("Wrote %d browser pages to %s.", len(written), out_dir)
    return written
