"""The port's command line (counterpart of launch.py):

    python -m saev_tpu_torch shards    [data:fake-img ...] [--family clip --ckpt ...]
    python -m saev_tpu_torch train     [sae.activation:relu ...] [--lr 4e-4 --sweep sweep.py]
    python -m saev_tpu_torch inference [--run runs/<id> --data.shards ...]

Each runs on the card unless given `--device cpu`.
"""


def main(argv: list[str] | None = None) -> None:
    from .framework import inference, shards, train
    from .utils import cli

    cli.run({"shards": shards.cli, "train": train.main, "inference": inference.main}, argv)


if __name__ == "__main__":
    main()
