"""Trait-discovery launcher (counterpart of contrib/trait_discovery/scripts/
launch.py), with its subcommands that do the device work:

    python -m saev_tpu_torch.tdiscovery probe1d --run R --train-shards T --test-shards V
    python -m saev_tpu_torch.tdiscovery baseline::train --method kmeans --k 4096 --train-data.shards T ...
    python -m saev_tpu_torch.tdiscovery baseline::inference --run R --data.shards T
    python -m saev_tpu_torch.tdiscovery metrics --run R --train-shards T --test-shards V

Each runs on the card unless given `--device cpu` (metrics is host-only).
The FishVista evaluation is `fishvista.evaluation.cli` / `worker_fn`.
"""

from . import baselines, metrics, probe1d

COMMANDS = {
    "baseline::train": baselines.train_cli,
    "baseline::inference": baselines.inference_cli,
    "metrics": metrics.cli,
    "probe1d": probe1d.cli,
}


def main(argv: list[str] | None = None) -> None:
    from ..utils import cli

    cli.run(COMMANDS, argv)


if __name__ == "__main__":
    main()
