"""Launcher for the Cambridge mimicry utilities (counterpart of
contrib/mimics/launch.py; reference launch.py:22-90): `score` (per-latent
AUROC over mimic pair tasks, with TOML sweep expansion), `render`
(top-activation strips per feature), `consistency` (cross-run feature
correlation), `viewer` (self-contained HTML browser over the strips) and
`scores` (the cross-run mimic-scores browser). Host-only.

    python -m saev_tpu_torch.mimics score --run runs/<id> ... [--sweep s.toml]
    python -m saev_tpu_torch.mimics render --run runs/<id> ...
"""

import dataclasses
import logging
import pathlib
import tomllib

from .. import configs
from . import consistency as consistency_mod
from . import render as render_mod
from . import scoring
from . import viewer as viewer_mod

logger = logging.getLogger("mimics.launch")


def score(cfg: scoring.Config, sweep: pathlib.Path | None = None) -> None:
    """Score all SAE latents for mimic-pair discrimination; with --sweep,
    expand a TOML grid over the config (reference launch.py:22-63)."""
    if sweep is not None:
        cfgs = [dataclasses.replace(cfg, **dct) for dct in configs.expand(tomllib.loads(sweep.read_text()))]
    else:
        cfgs = [cfg]
    logger.info("Scoring %d config(s).", len(cfgs))
    for c in cfgs:
        scoring.score_run(c)


def render(cfg: render_mod.Config) -> None:
    """Render top-activation strips for scored features."""
    render_mod.worker_fn(cfg)


def consistency(cfg: consistency_mod.Config) -> None:
    """Cross-run feature-consistency correlations."""
    consistency_mod.worker_fn(cfg)


def build_viewer(cfg: viewer_mod.Config) -> None:
    """Self-contained HTML viewer over rendered strips."""
    viewer_mod.build(cfg)


def build_scores_viewer(cfg: viewer_mod.ScoresConfig) -> None:
    """Cross-run mimic-scores browser (no rendered strips needed)."""
    viewer_mod.build_scores(cfg)


COMMANDS = {
    "score": score,
    "render": render,
    "consistency": consistency,
    "viewer": build_viewer,
    "scores": build_scores_viewer,
}


def main(argv: list[str] | None = None) -> None:
    from ..utils import cli

    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s",
    )
    cli.run(COMMANDS, argv)


if __name__ == "__main__":
    main()
