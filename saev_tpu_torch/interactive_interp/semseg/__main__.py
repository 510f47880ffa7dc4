"""Subcommand CLI for the semseg study (counterpart of contrib/
interactive_interp/semseg/__main__.py: train/visuals/validate/quantify, plus
the `interactive` intervention-app generator).

Usage:
    python -m saev_tpu_torch.interactive_interp.semseg train --shards <dir> --layer 0 ...
    python -m saev_tpu_torch.interactive_interp.semseg interactive --sae-ckpt ... --head-ckpt ... --out app.html

Each subcommand but validate (host numpy) runs on the card unless given
`--device cpu`.
"""

import logging

from . import interactive, quantitative, training, validation, visuals


def train(cfg: training.Train) -> None:
    """Train one linear patch-segmentation probe and dump it."""
    params = training.train([cfg])
    training.dump(cfg.ckpt_path, [cfg], params)


COMMANDS = {
    "train": train,
    "visuals": visuals.cli,
    "validate": validation.cli,
    "quantify": quantitative.cli,
    "interactive": interactive.cli,
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
