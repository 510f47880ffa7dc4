"""Birdsong launcher (the `__main__` blocks of contrib/birdsong/src/birdsong/
visuals.py and contrib/birdsong/scripts/make_html.py):

    python -m saev_tpu_torch.birdsong visuals --run runs/<id> --shards <dir> [--latents 3,7]
    python -m saev_tpu_torch.birdsong make_html --run runs/<id> --shards <dir> [--embed] [--notes N]

Both are host-only; they read what the port's inference wrote.
"""

import logging

from . import make_html, visuals


def _make_html(cfg: make_html.Config) -> None:
    logging.basicConfig(level=logging.INFO)
    make_html.make(cfg)


COMMANDS = {"visuals": visuals.cli, "make_html": _make_html}


def main(argv: list[str] | None = None) -> None:
    from ..utils import cli

    cli.run(COMMANDS, argv)


if __name__ == "__main__":
    main()
