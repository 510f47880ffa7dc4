"""Disk-layout helpers: runs root / shards root / run directories (a copy of
saev_tpu/disk.py, so the port imports nothing of the JAX package).

The on-disk layout is a compatibility contract with the reference protocol
(`src/saev/disk.py:13-161`, docs/src/developers/disk-layout.md) — run dirs
written here are readable by the reference and vice versa (proven live in
tests/test_reference_interop.py):

    $SAEV_SCRATCH/saev/shards/<hash>/{metadata.json, shards.json, acts*.bin[, labels.bin]}
    $SAEV_NFS/saev/runs/<run_id>/{checkpoint/{sae.pt,config.json}, links/{train,val}-shards, inference/<hash>/}
"""

import json
import pathlib

_RUN_SUBDIRS = ("checkpoint", "links", "inference")


def _tail_is(path: pathlib.Path, *tail: str) -> bool:
    """True when the last `len(tail)` path components equal `tail`."""
    n = len(tail)
    return len(path.parts) >= n and path.parts[-n:] == tail


def is_runs_root(path: pathlib.Path) -> bool:
    """True if `path` is an existing directory whose tail is saev/runs."""
    return path.is_dir() and _tail_is(path, "saev", "runs")


def is_shards_root(path: pathlib.Path) -> bool:
    """True if `path` is an existing directory whose tail is saev/shards."""
    return path.is_dir() and _tail_is(path, "saev", "shards")


def is_shards_dir(path: pathlib.Path) -> bool:
    """True if `path` is an existing directory shaped like saev/shards/<hash>.

    Only the path shape is checked here; content validation (metadata.json,
    shards.json, the .bin files) lives in `saev_tpu_torch.data.shards`.
    """
    return path.is_dir() and len(path.parts) >= 3 and _tail_is(
        path.parent, "saev", "shards"
    )


class Run:
    """Handle on one training-run directory under a saev/runs root.

    Construction validates an *existing* run (shape `.../saev/runs/<run_id>`
    plus the three required subdirectories); `Run.new()` is the only way to
    create one. Everything else is derived paths.
    """

    def __init__(self, run_dir: pathlib.Path):
        self.run_dir = pathlib.Path(run_dir)

        if not _tail_is(self.run_dir.parent, "saev", "runs"):
            raise ValueError("Run directory is invalid.")
        if not self.run_dir.exists():
            raise FileNotFoundError(
                f"no run at {self.run_dir} — Run.new() creates the layout"
            )
        missing = [s for s in _RUN_SUBDIRS if not (self.run_dir / s).exists()]
        if missing:
            raise FileNotFoundError(
                f"run at {self.run_dir} is missing {', '.join(missing)}/ — "
                "Run.new() creates the full layout"
            )

    @classmethod
    def new(
        cls,
        run_id: str,
        *,
        train_shards_dir: pathlib.Path,
        val_shards_dir: pathlib.Path,
        runs_root: pathlib.Path,
    ) -> "Run":
        """Create the run-dir skeleton + shard symlinks, then validate it."""
        run_dir = pathlib.Path(runs_root) / run_id
        run_dir.mkdir(parents=True)
        for sub in _RUN_SUBDIRS:
            (run_dir / sub).mkdir()

        (run_dir / "links" / "train-shards").symlink_to(train_shards_dir)
        (run_dir / "links" / "val-shards").symlink_to(val_shards_dir)

        return cls(run_dir)

    @property
    def run_id(self) -> str:
        """The run ID (directory name, typically from the metric tracker)."""
        return self.run_dir.name

    @property
    def config(self) -> dict[str, object]:
        """The training run config as a plain dict."""
        with open(self.run_dir / "checkpoint" / "config.json") as fd:
            return json.load(fd)

    @property
    def ckpt(self) -> pathlib.Path:
        """Path to the sae.pt checkpoint."""
        return self.run_dir / "checkpoint" / "sae.pt"

    @property
    def val_shards(self) -> pathlib.Path:
        """Resolved path to the validation shards directory."""
        return (self.run_dir / "links" / "val-shards").resolve()

    @property
    def train_shards(self) -> pathlib.Path:
        """Resolved path to the training shards directory."""
        return (self.run_dir / "links" / "train-shards").resolve()

    @property
    def inference(self) -> pathlib.Path:
        """Path to the inference/ directory."""
        return self.run_dir / "inference"
