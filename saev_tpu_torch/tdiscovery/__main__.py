"""Trait-discovery launcher (counterpart of contrib/trait_discovery/scripts/
launch.py), with all of its subcommands:

    python -m saev_tpu_torch.tdiscovery probe1d --run R --train-shards T --test-shards V
    python -m saev_tpu_torch.tdiscovery baseline::train --method kmeans --k 4096 --train-data.shards T ...
    python -m saev_tpu_torch.tdiscovery baseline::inference --run R --data.shards T
    python -m saev_tpu_torch.tdiscovery metrics --run R --train-shards T --test-shards V
    python -m saev_tpu_torch.tdiscovery cls::train --run R --train-shards T --test-shards V [--sweep S]
    python -m saev_tpu_torch.tdiscovery cls::eval --run R --test-shards V [--sweep S]
    python -m saev_tpu_torch.tdiscovery cls::audit --run R --test-shards V --cls-checkpoints C ...
    python -m saev_tpu_torch.tdiscovery visuals --run R --shards V

probe1d and the baseline subcommands run on the card unless given
`--device cpu`; the others are host-only. cls::train needs scikit-learn,
and cls::eval and cls::audit unpickle its heads. The FishVista evaluation is
`fishvista.evaluation.cli` / `worker_fn`.
"""

from . import baselines, classification, metrics, probe1d, visuals

COMMANDS = {
    "baseline::train": baselines.train_cli,
    "baseline::inference": baselines.inference_cli,
    "cls::train": classification.train_cli,
    "cls::eval": classification.eval_cli,
    "cls::audit": classification.audit_cli,
    "metrics": metrics.cli,
    "probe1d": probe1d.cli,
    "visuals": visuals.cli,
}


def main(argv: list[str] | None = None) -> None:
    from ..utils import cli

    cli.run(COMMANDS, argv)


if __name__ == "__main__":
    main()
