"""Subcommand CLI for the classification probing demo (counterpart of
contrib/interactive_interp/classification/__main__.py: train with optional
TOML sweep, plus the dataset fetchers).

Usage:
    python -m saev_tpu_torch.interactive_interp.classification train --train-shards <dir> ... [--sweep grid.toml]
    python -m saev_tpu_torch.interactive_interp.classification flowers --dir data/flowers

`train` runs the probes on the card unless given `--device cpu`.
"""

import logging
import pathlib
import tomllib

from . import download, training

logger = logging.getLogger("contrib.classification")


def train(cfg: training.Train, sweep: pathlib.Path | None = None) -> None:
    """Train the probe grid; with --sweep, expand a TOML grid first."""
    if sweep is not None:
        cfgs, errs = training.grid(cfg, tomllib.loads(sweep.read_text()))
        for err in errs:
            logger.warning("Error in config: %s", err)
        if errs and not cfgs:
            raise SystemExit(1)
    else:
        cfgs = [cfg]
    logger.info("Training %d probe(s).", len(cfgs))
    training.main(cfgs)


COMMANDS = {
    "train": train,
    "flowers": download.flowers,
    "cub": download.cub,
    "caltech101": download.caltech101,
}


def main(argv: list[str] | None = None) -> None:
    from ...utils import cli

    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s",
    )
    cli.run(COMMANDS, argv)


if __name__ == "__main__":
    main()
