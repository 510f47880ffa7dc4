"""Sweep-capable launcher for activation extraction (counterpart of
scripts/activations.py).

A TOML sweep file is a table whose list-valued entries cartesian-product into
many extraction configs (`configs.expand`, the same expansion as Python sweep
files):

    # sweep.toml
    family = "dinov2"
    ckpt = "dinov2_vitb14_reg"
    layers = [[-2], [-1]]        # two configs: one per layer choice
    [data]                       # nested fields update the dataset set on the
    n_examples = [128, 256]      # CLI/default config; x2 -> four configs total

Usage:
    python -m saev_tpu_torch.scripts.activations --sweep sweep.toml [field overrides...]
    python -m saev_tpu_torch.scripts.activations --family fake-clip --data.key fake-img --device cpu
"""

import logging
import pathlib
import sys
import tomllib

from .. import configs
from ..framework import shards as fshards
from ..utils import cli

logger = logging.getLogger("scripts.activations")


def load_cfgs(override: fshards.Config, sweep_path: pathlib.Path) -> tuple[list[fshards.Config], list[str]]:
    """The extraction configs a TOML sweep file expands to over `override`,
    and the errors of those that did not build."""
    with open(sweep_path, "rb") as fd:
        sweep = tomllib.load(fd)
    return configs.load_cfgs(override, default=fshards.Config(), sweep_dcts=list(configs.expand(sweep)))


def main(argv: list[str]) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s",
    )
    sweep_path = None
    if "--sweep" in argv:
        i = argv.index("--sweep")
        sweep_path = pathlib.Path(argv[i + 1])
        argv = argv[:i] + argv[i + 2 :]

    override = cli.parse(fshards.Config, argv, prog="activations")
    if sweep_path is None:
        cfgs = [override]
    else:
        cfgs, errs = load_cfgs(override, sweep_path)
        if errs:
            for err in errs:
                logger.error("Error in config: %s", err)
            return 1

    assert all(c.slurm_acct == cfgs[0].slurm_acct for c in cfgs)
    logger.info("Running %d extraction config(s).", len(cfgs))
    for i, cfg in enumerate(cfgs):
        logger.info("Config %d/%d: %s/%s.", i + 1, len(cfgs), cfg.family, cfg.ckpt)
        fshards.cli(cfg)
    logger.info("Jobs done.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
