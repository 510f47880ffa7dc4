"""SAE inference on PyTorch tensors: one ordered pass over a shard set that
writes the per-run artifacts (counterpart of saev_tpu/framework/inference.py,
reference `src/saev/framework/inference.py`).

    python -m saev_tpu_torch.framework.inference --run RUN_DIR --data.shards SHARDS_DIR [--data.layer L]

Writes, per (run, shard hash), under runs/<id>/inference/<hash>/ the same five
files as the JAX package, readable by either package and by the reference:

1. mean_values.pt     -- (d_sae,) mean activation value per latent when firing
2. sparsity.pt        -- (d_sae,) firing frequency per latent
3. distributions.pt   -- (n_tokens, n_dists) the first n_dists latents per token
4. token_acts.npz     -- scipy CSR matrix of all token x latent activations
5. metrics.json       -- a validated `saev_tpu_torch.metrics.Metrics`

Each batch stays on the device (`infer_batch`): the SAE forward at "highest"
(f32, TF32 off; a TopK threshold is kernel K6 on the card), the masked partial
sums in f32, and the compaction of the latents into CSR rows
(`compact_rows`). The host receives only the sums, which it adds in float64
across batches as the JAX package does, the (nnz,) columns and values, and
the first n_dists columns, and assembles the CSR blocks; the dense latents
never cross. The ordered loader's batches reach the card through
`parallel.prefetch_to_device` (pinned memory, a side stream, two batches
ahead). The .pt artifacts are written with torch.save.
"""

import collections.abc
import dataclasses
import logging
import os
import pathlib
import time
import typing as tp

import numpy as np
import scipy.sparse
import torch

from .. import configs, disk, guards, helpers, parallel
from ..data import Metadata, OrderedConfig, OrderedDataLoader
from ..metrics import Metrics
from ..nn import modeling, serialize

logger = logging.getLogger("inference")


@dataclasses.dataclass(frozen=True)
class Config:
    """Configuration for computing SAE inference artifacts (reference
    inference.py:44-75). The JAX package's fields and defaults but for
    `device`, which names "cuda" or "cpu" and says where the pass runs."""

    run: pathlib.Path = pathlib.Path("./runs/abcdefg")
    """Path to the run directory (containing checkpoint/sae.pt)."""
    data: OrderedConfig = OrderedConfig()
    """Data configuration."""
    n_dists: int = 25
    """Number of features to save distributions for."""
    ignore_labels: tuple[int, ...] = ()
    """Which token labels to ignore when calculating summarized image activations."""
    force_recompute: bool = False
    """Force recomputation even if files exist."""
    save: bool = True
    """Whether to write token_acts/statistics files. If False, only metrics.json."""
    device: tp.Literal["cuda", "cpu"] = "cuda"
    """Where the pass runs: the card unless "cpu" is asked for."""
    slurm_acct: str = ""
    """Slurm account string. Empty means to not use Slurm."""
    slurm_partition: str = ""
    """Slurm partition."""
    n_hours: float = 4.0
    """Slurm job length in hours."""
    mem_gb: int = 80
    """Node memory in GB."""
    log_to: str = os.path.join(".", "logs")
    """Where to log job stdout/stderr."""


@dataclasses.dataclass(frozen=True)
class Filepaths:
    """The 5 artifact paths under runs/<id>/inference/<shard-hash>/
    (reference inference.py:80-105)."""

    mean_values: pathlib.Path
    sparsity: pathlib.Path
    distributions: pathlib.Path
    token_acts: pathlib.Path
    metrics: pathlib.Path

    @classmethod
    def from_run(cls, run: disk.Run, md: Metadata) -> "Filepaths":
        root = run.inference / md.hash
        root.mkdir(exist_ok=True, parents=True)
        return cls(
            mean_values=root / "mean_values.pt",
            sparsity=root / "sparsity.pt",
            distributions=root / "distributions.pt",
            token_acts=root / "token_acts.npz",
            metrics=root / "metrics.json",
        )

    def __iter__(self) -> collections.abc.Iterator[pathlib.Path]:
        yield from (
            self.mean_values,
            self.sparsity,
            self.distributions,
            self.token_acts,
            self.metrics,
        )


def need_compute(cfg: Config) -> tuple[bool, str, Filepaths]:
    """Idempotency check (reference inference.py:110-135)."""
    run = disk.Run(cfg.run)
    md = Metadata.load(cfg.data.shards)
    fpaths = Filepaths.from_run(run, md)

    required = list(fpaths) if cfg.save else [fpaths.metrics]
    mode = "full artifacts" if cfg.save else "metrics only"
    missing = [fpath for fpath in required if not fpath.exists()]

    if not cfg.force_recompute and not missing:
        return False, f"Found all required files ({mode}).", fpaths
    if cfg.force_recompute:
        return True, f"Force recompute flag set; computing {mode}.", fpaths
    missing_msg = ", ".join(str(f) for f in missing)
    return True, f"Missing files {missing_msg}; computing {mode}.", fpaths


@torch.no_grad()
def infer_batch(
    sae_cfg: modeling.SparseAutoencoderConfig, params: modeling.Params, state: modeling.State,
    x: torch.Tensor, mask: torch.Tensor,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One batch's work on x's device (saev_tpu/framework/inference.py:122-151):
    the SAE forward in eval mode at "highest" and the f32 partial sums over
    the rows `mask` keeps. Returns (f, stats): f (batch, d_sae) with the
    masked rows zeroed; stats "n_tokens", "sse_recon", "sum_sq", "sum_vec"
    (d_model,), "mean_values" (d_sae,, the sum of f) and "sparsity" (d_sae,,
    the count of f > 0), which the caller adds in float64 across batches."""
    enc, _ = modeling.encode(sae_cfg, params, state, x, training=False)
    x_hat = modeling.decode(sae_cfg, params, enc.f_x)[:, 0]
    keep = mask[:, None]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    xm = torch.where(keep, x, zero)
    diff = torch.where(keep, x - x_hat, zero)
    f = torch.where(keep, enc.f_x, zero)
    stats = {
        "n_tokens": mask.sum(),
        "sse_recon": torch.sum(diff * diff),
        "sum_sq": torch.sum(xm * xm),
        "sum_vec": torch.sum(xm, dim=0),
        "mean_values": torch.sum(f, dim=0),
        "sparsity": torch.sum(f > 0, dim=0).to(torch.float32),
    }
    return f, stats


def compact_rows(f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The CSR rows of a (batch, d_sae) f32 tensor, on its device: (per-row
    count of nonzeros (batch,) int64, their columns (nnz,) int32 and values
    (nnz,) f32), row-major with columns ascending within a row, as
    `scipy.sparse.csr_array` of the dense array stores them. Every nonzero
    is kept, negative ones too (a TopK row whose k-th value is negative
    keeps them); zeros, -0.0 included, are dropped."""
    nz = f != 0
    counts = nz.sum(dim=1)
    cols = (torch.nonzero(nz.reshape(-1))[:, 0] % f.shape[1]).to(torch.int32)
    return counts, cols, f[nz]


def csr_block(counts: np.ndarray, cols: np.ndarray, vals: np.ndarray, d_sae: int) -> scipy.sparse.csr_array:
    """A batch's CSR block from `compact_rows`' output on the host, with the
    index dtype scipy gives the dense array's: int32 while the row count,
    d_sae and nnz fit it, else int64."""
    fits = max(len(counts), d_sae, len(vals)) <= np.iinfo(np.int32).max
    idx = np.int32 if fits else np.int64
    indptr = np.zeros(len(counts) + 1, dtype=idx)
    np.cumsum(counts, out=indptr[1:])
    return scipy.sparse.csr_array((vals, cols.astype(idx, copy=False), indptr), shape=(len(counts), d_sae))


class _Clock:
    """Seconds of a batch's device work between marks: CUDA events on the
    card (read after the batch's copies to the host, which wait for them),
    the host's clock on the CPU, where the work is synchronous."""

    def __init__(self, on_card: bool):
        self.on_card = on_card
        self.marks: list = []

    def mark(self) -> None:
        if self.on_card:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def spans(self) -> list[float]:
        """Seconds between consecutive marks; clears them."""
        m, self.marks = self.marks, []
        if self.on_card:
            return [a.elapsed_time(b) / 1e3 for a, b in zip(m, m[1:])]
        return [b - a for a, b in zip(m, m[1:])]


def worker_fn(cfg: Config) -> dict[str, float] | None:
    """Single ordered pass over the shards (saev_tpu/framework/inference.py:154-269).

    Returns None when every required file exists (and `force_recompute` is
    off), else the pass's measurements: "batches", "tokens", "seconds" (the
    loop's wall time), "tokens_per_s", and the seconds of the whole pass
    spent in each part of a batch: "wait_s" (waiting for the loader and the
    copy to the device), "forward_s" (`infer_batch`, device time),
    "compact_s" (`compact_rows` and the distributions' slice, device time)
    and "host_s" (the copies to the host and the CSR, sum and distribution
    assembly there); then "write_s", the seconds that stacking the CSR
    blocks and writing the files took after the loop.
    """
    run = disk.Run(cfg.run)
    md = Metadata.load(cfg.data.shards)
    root = run.inference / md.hash

    do, reason, fpaths = need_compute(cfg)
    logger.info(reason)
    if not do:
        return None

    root.mkdir(exist_ok=True, parents=True)
    with open(root / "config.json", "wb") as fd:
        helpers.jdump(cfg, fd)

    assert cfg.data.tokens == "content"
    device = torch.device(cfg.device)
    sae_cfg, params, state = serialize.load(run.ckpt, device=device)
    if sae_cfg.d_model != md.d_model:
        raise guards.GuardError(
            f"SAE checkpoint d_model={sae_cfg.d_model} ({run.ckpt}) does not "
            f"match the shards' d_model={md.d_model} ({cfg.data.shards})."
        )

    # Round the batch to a whole number of examples so distributions indexing and
    # the order asserts line up (reference inference.py:164-171).
    batch_size = max(
        cfg.data.batch_size
        // md.content_tokens_per_example
        * md.content_tokens_per_example,
        md.content_tokens_per_example,
    )
    dataloader = OrderedDataLoader(dataclasses.replace(cfg.data, batch_size=batch_size))
    n_samples = dataloader.n_samples

    d_sae = sae_cfg.d_sae
    if cfg.save:
        sparsity_s = np.zeros((d_sae,), dtype=np.float64)
        mean_values_s = np.zeros((d_sae,), dtype=np.float64)
        token_acts_blocks: list[scipy.sparse.csr_array] = []
        n_dists = min(cfg.n_dists, d_sae)
        distributions_nm = np.zeros((n_samples, n_dists), dtype=np.float32)

    sse_recon = 0.0
    sum_sq = 0.0
    sum_vec_s = np.zeros((sae_cfg.d_model,), dtype=np.float64)
    n_tokens = 0

    ignore = np.asarray(cfg.ignore_labels, dtype=np.int64)
    logger.info("Loaded SAE and data.")

    clock = _Clock(device.type == "cuda")
    parts = dict.fromkeys(("wait_s", "forward_s", "compact_s", "host_s"), 0.0)
    n_batches = 0
    prev_i = -1
    start = t_wait = time.perf_counter()
    batches = helpers.progress(dataloader, desc="infer")
    for x, batch in parallel.prefetch_to_device(batches, device, depth=2):
        parts["wait_s"] += time.perf_counter() - t_wait
        if ignore.size and "token_labels" in batch:
            mask = torch.from_numpy(np.isin(batch["token_labels"], ignore, invert=True)).to(device)
        else:
            mask = torch.ones(x.shape[0], dtype=torch.bool, device=device)
        clock.mark()
        f_masked, stats = infer_batch(sae_cfg, params, state, x, mask)
        clock.mark()
        if cfg.save:
            counts, cols, vals = compact_rows(f_masked)
            dists = f_masked[:, :n_dists]
            clock.mark()
        t_host = time.perf_counter()
        stats = {k: v.cpu().numpy() for k, v in stats.items()}

        n_tokens += int(stats["n_tokens"])
        sse_recon += float(stats["sse_recon"])
        sum_sq += float(stats["sum_sq"])
        sum_vec_s += stats["sum_vec"].astype(np.float64)

        if cfg.save:
            batch_idx = (
                batch["example_idx"] * md.content_tokens_per_example + batch["token_idx"]
            )
            # Sequential-order invariants (reference inference.py:233-238).
            assert int(batch_idx[0]) == prev_i + 1
            assert (np.sort(batch_idx) == batch_idx).all()
            assert (np.arange(batch_idx[0], batch_idx[-1] + 1) == batch_idx).all()

            # distributions are indexed by global token position, as in the
            # JAX package.
            distributions_nm[batch_idx] = dists.cpu().numpy()
            mean_values_s += stats["mean_values"].astype(np.float64)
            sparsity_s += stats["sparsity"].astype(np.float64)
            token_acts_blocks.append(
                csr_block(counts.cpu().numpy(), cols.cpu().numpy(), vals.cpu().numpy(), d_sae)
            )
            prev_i = int(batch_idx[-1])
        t_wait = time.perf_counter()
        parts["host_s"] += t_wait - t_host
        spans = clock.spans()
        parts["forward_s"] += spans[0]
        parts["compact_s"] += spans[1] if cfg.save else 0.0
        n_batches += 1
    seconds = time.perf_counter() - start

    t_write = time.perf_counter()
    if cfg.save:
        with np.errstate(divide="ignore", invalid="ignore"):
            mean_values_s = mean_values_s / sparsity_s
        sparsity_s = sparsity_s / n_samples

        token_acts = scipy.sparse.vstack(token_acts_blocks, format="csr")
        scipy.sparse.save_npz(fpaths.token_acts, token_acts)
        _torch_save(mean_values_s.astype(np.float32), fpaths.mean_values)
        _torch_save(sparsity_s.astype(np.float32), fpaths.sparsity)
        _torch_save(distributions_nm, fpaths.distributions)

    assert n_tokens > 0, (
        "Inference dataloader yielded zero valid tokens; cannot compute metrics."
    )
    sse_baseline = sum_sq - float(sum_vec_s @ sum_vec_s) / n_tokens
    if sse_baseline <= 0.0:
        raise RuntimeError(
            f"Baseline variance is non-positive (sse_baseline={sse_baseline:.6e}); "
            "cannot compute normalized MSE."
        )

    metrics = Metrics.from_accumulators(
        sse_recon=sse_recon,
        sse_baseline=sse_baseline,
        n_tokens=n_tokens,
        d_model=sae_cfg.d_model,
    )
    with open(fpaths.metrics, "wb") as fd:
        helpers.jdump(metrics.to_dict(), fd, indent=2)
    logger.info("Wrote metrics to '%s'.", fpaths.metrics)

    out = {"batches": n_batches, "tokens": n_samples, "seconds": seconds,
           "tokens_per_s": n_samples / seconds, **parts, "write_s": time.perf_counter() - t_write}
    logger.info(
        "%d batches, %d tokens in %.2f s (%.0f tokens/s); of it loader wait %.2f s, forward %.2f s, "
        "compaction %.2f s, host assembly %.2f s; then the files %.2f s.", n_batches, n_samples, seconds,
        out["tokens_per_s"], parts["wait_s"], parts["forward_s"], parts["compact_s"], parts["host_s"],
        out["write_s"],
    )
    return out


def _torch_save(arr: np.ndarray, fpath: pathlib.Path) -> None:
    """Write a .pt artifact readable by downstream reference tooling (torch.load)."""
    torch.save(torch.from_numpy(np.ascontiguousarray(arr)), fpath)


def main(cfg: Config, sweep: pathlib.Path | None = None):
    """Run SAE inference, optionally as a sweep of jobs (reference inference.py:289-361)."""
    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s",
    )
    if sweep is not None:
        sweep_dcts = configs.load_sweep(sweep)
        if not sweep_dcts:
            logger.error("No valid sweeps found in '%s'.", sweep)
            raise SystemExit(1)
        cfgs, errs = configs.load_cfgs(cfg, default=Config(), sweep_dcts=sweep_dcts)
        if errs:
            for err in errs:
                logger.warning("Error in config: %s", err)
            return
    else:
        cfgs = [cfg]

    if cfg.slurm_acct:
        try:
            import submitit
        except ImportError as err:
            raise RuntimeError(
                "slurm_acct set but submitit is not installed; run without Slurm."
            ) from err
        executor = submitit.SlurmExecutor(folder=cfg.log_to)
        executor.update_parameters(
            job_name="sae-inference",
            time=int(cfg.n_hours * 60),
            partition=cfg.slurm_partition,
            ntasks_per_node=1,
            mem=f"{cfg.mem_gb}GB",
            stderr_to_stdout=True,
            account=cfg.slurm_acct,
        )
        with executor.batch():
            jobs = [executor.submit(worker_fn, c) for c in cfgs]
        for j, job in enumerate(jobs):
            try:
                job.result()
                logger.info("Job %d/%d finished.", j + 1, len(jobs))
            except Exception:
                logger.warning("Job %s (%d) did not finish.", job.job_id, j)
        return

    for c in cfgs:
        worker_fn(c)


if __name__ == "__main__":
    import sys

    from saev_tpu_torch.framework import inference as _inference
    from saev_tpu_torch.utils import cli

    cli.run({"inference": _inference.main}, ["inference", *sys.argv[1:]])
