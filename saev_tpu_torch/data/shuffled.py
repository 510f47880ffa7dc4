"""High-throughput shuffled dataloader (a copy of saev_tpu/data/shuffled.py).

The reference runs a manager process over shared memory (reference
`src/saev/data/shuffled.py:33-699`); here, as in the JAX package, the trainer is
one Python process, so the manager is a daemon *thread* that owns N I/O worker threads; workers mmap shards
and stream (example-chunk × token) slices into a `ReservoirBuffer` (numpy, condition
variables) from which the consumer draws uniformly-random batches. All reference
semantics are kept: seeded shard permutation, label filtering, `min_buffer_fill`
warm-up, batch timeouts with liveness checks, error propagation with remote
tracebacks, `use_tmpdir` shard staging, and n_samples accounting.
"""

import collections.abc
import concurrent.futures
import dataclasses
import logging
import math
import os
import pathlib
import queue
import shutil
import threading
import time
import traceback
import typing as tp

import numpy as np

from .. import guards, helpers
from . import _native, buffers, shards


@dataclasses.dataclass(frozen=True)
class Config:
    """Configuration for loading shuffled activation data from disk.

    Attributes:
        shards: Directory with .bin shards and a metadata.json file.
        tokens: Which subset of tokens to use ('special' | 'content' | 'all').
        layer: Which transformer layer(s) to read. -1 must be changed; "all"
            enumerates every recorded layer.
        batch_size: Batch size.
        drop_last: Whether to drop the last batch if it's smaller than the others.
        scale_norm: Whether to scale norms to sqrt(D).
        ignore_labels: Exclude tokens with these label values (e.g. [0] = background).
        n_threads: Number of dataloading threads.
        buffer_size: Number of batches of reservoir capacity.
        min_buffer_fill: Fraction of the reservoir that must be populated before
            yielding batches.
        batch_timeout_s: How long to wait for at least one batch.
        seed: Random seed.
        debug: Whether the dataloader should log debug messages.
        log_every_s: How frequently to log (debug) performance messages.
        use_tmpdir: If True and $TMPDIR is set, copy shards to node-local storage.
        rank: This process's index among `world` cooperating loader processes.
        world: Number of cooperating processes. Each process owns the disjoint
            slice `permutation(n_shards)[rank::world]` of the SAME seeded shard
            permutation, so the union across processes covers every shard
            exactly once per epoch with zero coordination (multi-host data
            parallelism: the trainer gives each host rank=process_index and
            batch_size=global_batch/world). `n_samples` counts only the owned
            shards' tokens.
        descriptor_sampling: If True, the reservoir holds row *descriptors*
            (example_idx, token_idx — 16 bytes) instead of copied rows, and
            the consumer gathers sampled rows straight from refcounted shard
            mmaps. This halves per-row memory traffic (ONE page-cache→batch
            copy instead of page-cache→pool + pool→batch). Tradeoff:
            batch-assembly latency is coupled to the page cache — if sampled
            pages were evicted between the producer's readahead and the
            consumer's gather (memory pressure, slow disk), the gather blocks
            on disk I/O, where the row pool would have absorbed it. Shuffle
            semantics (uniform sampling from a `buffer_size`-batch pool) are
            identical.
    """

    shards: pathlib.Path = pathlib.Path("$SAEV_SCRATCH/saev/shards/abcdefg")
    tokens: str = "content"
    layer: int | str = -1
    batch_size: int = 1024 * 16
    drop_last: bool = False
    scale_norm: bool = False
    ignore_labels: list[int] = dataclasses.field(default_factory=list)
    n_threads: int = 4
    buffer_size: int = 64
    min_buffer_fill: float = 0.0
    batch_timeout_s: float = 30.0
    seed: int = 17
    debug: bool = False
    log_every_s: float = 30.0
    use_tmpdir: bool = False
    rank: int = 0
    world: int = 1
    descriptor_sampling: bool = False

    def __post_init__(self):
        assert 0 <= self.rank < self.world, (self.rank, self.world)
        # Frozen dataclass: normalize list for hashing-by-value comparisons elsewhere.
        object.__setattr__(self, "ignore_labels", list(self.ignore_labels))


class ExampleOutOfBoundsError(Exception):
    """Guards metadata/shard mismatch (reference shuffled.py:121-128)."""

    def __init__(self, metadata: shards.Metadata, i: int):
        self.metadata = metadata
        self.i = i
        super().__init__(self.message)

    @property
    def message(self) -> str:
        return (
            f"Metadata says there are {self.metadata.n_examples} examples, "
            f"but we found example {self.i}."
        )


def _copy_shards_to_tmpdir(
    src_dpath: pathlib.Path, logger: logging.Logger
) -> pathlib.Path:
    """Copy shard directory to $TMPDIR for node-local I/O. Returns the new path."""
    tmpdir = os.environ.get("TMPDIR")
    if not tmpdir:
        logger.warning("use_tmpdir=True but $TMPDIR not set; using original path")
        return src_dpath

    job_id = os.environ.get("SLURM_JOB_ID", "nojob")
    dst_dpath = pathlib.Path(tmpdir) / job_id / "saev" / "shards" / src_dpath.name

    marker = dst_dpath / ".copy_complete"
    if marker.exists():
        logger.info("Reusing existing TMPDIR copy: %s", dst_dpath)
        return dst_dpath

    dst_dpath.mkdir(parents=True, exist_ok=True)
    files = [f for f in src_dpath.iterdir() if f.is_file()]
    total_size = sum(f.stat().st_size for f in files)
    logger.info(
        "Copying %d files (%.1f GB) to TMPDIR: %s",
        len(files),
        total_size / 1e9,
        dst_dpath,
    )

    def copy_file(src: pathlib.Path) -> None:
        shutil.copy2(src, dst_dpath / src.name)

    with concurrent.futures.ThreadPoolExecutor(min(8, len(files)) or 1) as pool:
        list(pool.map(copy_file, files))

    marker.touch()
    logger.info("Finished copying shards to %s", dst_dpath)
    return dst_dpath


class _ShardRegistry:
    """Refcounted table of open shard mmaps for descriptor-sampling mode.

    A shard's mmap must outlive every descriptor pointing into it. Producers
    hold one reference while streaming a shard and add one per *published*
    descriptor; the consumer drops one per gathered descriptor. The mmap is
    opened lazily on the first acquire and closed when the count hits zero
    (i.e. the producer finished the shard AND every sampled row was gathered).
    All methods are thread-safe; the `np.memmap` handed out stays valid until
    the caller's references are released.
    """

    def __init__(self, shards_path: pathlib.Path, shard_shape: tuple[int, ...]):
        self._path = shards_path
        self._shape = shard_shape
        self._lock = threading.Lock()
        self._mmaps: dict[int, np.memmap] = {}
        self._refs: dict[int, int] = {}
        self._closed = False

    def acquire(self, shard_i: int, n: int = 1) -> np.memmap:
        """Add `n` references to shard `shard_i`, opening its mmap if needed."""
        with self._lock:
            if self._closed:
                raise buffers.BufferClosed("shard registry is closed")
            mm = self._mmaps.get(shard_i)
            if mm is None:
                mm = np.memmap(
                    self._path / f"acts{shard_i:06}.bin",
                    mode="r", dtype=np.float32, shape=self._shape,
                )
                self._mmaps[shard_i] = mm
                self._refs[shard_i] = 0
            self._refs[shard_i] += n
            return mm

    def get(self, shard_i: int) -> np.memmap:
        """The open mmap for a shard the caller already holds references to."""
        with self._lock:
            return self._mmaps[shard_i]

    def release(self, shard_i: int, n: int = 1) -> None:
        with self._lock:
            if shard_i not in self._refs:  # close_all already ran
                return
            self._refs[shard_i] -= n
            assert self._refs[shard_i] >= 0, (shard_i, self._refs[shard_i])
            if self._refs[shard_i] == 0:
                del self._refs[shard_i]
                # Dropping the last array reference unmaps the file.
                del self._mmaps[shard_i]

    def n_open(self) -> int:
        with self._lock:
            return len(self._mmaps)

    def close_all(self) -> None:
        with self._lock:
            self._closed = True
            self._mmaps.clear()
            self._refs.clear()


def _io_worker(
    worker_id: int,
    cfg: Config,
    md: shards.Metadata,
    shards_path: pathlib.Path,
    shard_info: shards.ShardInfo,
    work_queue: "queue.Queue[int | None]",
    reservoir: buffers.ReservoirBuffer,
    stop_event: threading.Event,
    err_queue: "queue.Queue[tuple[str, str]]",
    labels_mmap: np.memmap | None = None,
    registry: "_ShardRegistry | None" = None,
):
    """Pull shard indices from the work queue, mmap each shard, and stream
    (example-chunk × token) activation slices into the reservoir.

    With `registry` set (descriptor-sampling mode), no activation bytes are
    copied here: the worker publishes (example_idx, token_idx) descriptors,
    holds registry references for them, and relies on the native readahead
    hints to warm the page cache ahead of the consumer's gather.

    Mirrors reference shuffled.py:132-291.
    """
    logger = logging.getLogger(f"shuffled.worker{worker_id}")
    layer_i = md.layers.index(cfg.layer)

    assert cfg.tokens == "content"
    assert isinstance(cfg.layer, int)

    if cfg.ignore_labels and labels_mmap is None:
        raise ValueError("ignore_labels specified but no labels.bin found")

    bytes_sent = 0
    n_reads = 0
    t_last_report = time.time()

    chunk_size = min(1024, math.ceil(cfg.batch_size * cfg.buffer_size / cfg.n_threads))
    reason = ""
    producer_hold: int | None = None  # shard whose registry ref this worker holds

    while not stop_event.is_set():
        try:
            shard_i = work_queue.get(timeout=0.1)
        except queue.Empty:
            continue
        if shard_i is None:  # poison pill
            reason = "poison_pill"
            break

        try:
            fname = f"acts{shard_i:06}.bin"
            ex_i_offset = shard_i * md.examples_per_shard
            if registry is not None:
                # Producer hold: keeps the mmap open while this shard streams;
                # released when the shard's last span is published (or on any
                # exit path below). Per-descriptor references then keep the
                # mmap alive until the consumer gathers the rows.
                mmap = registry.acquire(shard_i, 1)
                producer_hold = shard_i
            else:
                mmap = np.memmap(
                    shards_path / fname,
                    mode="r", dtype=np.float32, shape=md.shard_shape,
                )
            # Native readahead hints (data/_native): advise the kernel
            # the scan is sequential and prefetch chunk i+1's byte span while
            # chunk i streams into the reservoir. No-ops without the toolchain.
            bytes_per_example = int(np.prod(md.shard_shape[1:])) * 4
            native_file = None
            try:
                native_file = _native.ShardFile(shards_path / fname)
                native_file.advise_sequential(
                    0, shard_info[shard_i].n_examples * bytes_per_example
                )
            except OSError:
                native_file = None

            spans = helpers.batched_idx(shard_info[shard_i].n_examples, chunk_size)
            spans = list(spans)
            for span_i, (start, end) in enumerate(spans):
                if stop_event.is_set():
                    break
                if native_file is not None and span_i + 1 < len(spans):
                    nxt_start, nxt_end = spans[span_i + 1]
                    native_file.prefetch(
                        nxt_start * bytes_per_example,
                        (nxt_end - nxt_start) * bytes_per_example,
                    )
                for t in range(md.content_tokens_per_example):
                    if stop_event.is_set():
                        break
                    token_idx = t + int(md.cls_token)

                    if cfg.ignore_labels:
                        ex_indices = np.arange(ex_i_offset + start, ex_i_offset + end)
                        patch_labels = labels_mmap[ex_indices, t]
                        mask = ~np.isin(patch_labels, cfg.ignore_labels)
                        valid = np.where(mask)[0]
                        if len(valid) == 0:
                            continue
                        # Fancy indexing materializes a copy (pool mode only —
                        # descriptor mode must not fault the data pages here).
                        rows = (
                            None if registry is not None
                            else mmap[start + valid, layer_i, token_idx]
                        )
                        example_idx = ex_i_offset + start + valid
                        token_col = np.full(len(valid), t, dtype=np.int64)
                    else:
                        # Strided VIEW into the mmap: the only copy happens
                        # below, page cache -> reserved pool slots.
                        rows = (
                            None if registry is not None
                            else mmap[start:end, layer_i, token_idx]
                        )
                        example_idx = np.arange(
                            ex_i_offset + start, ex_i_offset + end, dtype=np.int64
                        )
                        token_col = np.full(end - start, t, dtype=np.int64)

                    last_ex_i = int(example_idx.max())
                    if last_ex_i >= md.n_examples:
                        err = ExampleOutOfBoundsError(md, last_ex_i)
                        logger.warning(err.message)
                        raise err

                    fill_before = reservoir.fill()
                    t0 = time.perf_counter()
                    # reserve/fill/commit: rows land in the reservoir with ONE
                    # memcpy (page cache -> pool), outside the buffer lock —
                    # the 1-core ceiling is memcpy-bound (docs/performance.md).
                    # Descriptor mode copies no activation bytes at all: the
                    # slots carry only (example_idx, token_idx), each backed by
                    # one registry reference until the consumer gathers it.
                    total, done = len(example_idx), 0
                    while done < total:
                        slot_ids = reservoir.reserve(total - done)
                        fit = len(slot_ids)
                        acquired = False
                        try:
                            if registry is not None:
                                # Inside the try: an acquire failure (registry
                                # closed mid-shutdown, mmap OSError) must
                                # cancel the just-reserved slots or they leak
                                # from the pool's slot-conservation invariant.
                                registry.acquire(shard_i, fit)
                                acquired = True
                            if rows is not None:
                                reservoir.acts[slot_ids] = rows[done : done + fit]
                            reservoir.meta["example_idx"][slot_ids] = example_idx[
                                done : done + fit
                            ]
                            reservoir.meta["token_idx"][slot_ids] = token_col[
                                done : done + fit
                            ]
                        except BaseException:
                            if acquired:
                                registry.release(shard_i, fit)
                            reservoir.cancel(slot_ids)
                            raise
                        try:
                            reservoir.commit(slot_ids)
                        except buffers.BufferClosed:
                            # Keep slot conservation if the buffer closed
                            # between reserve and commit.
                            if registry is not None:
                                registry.release(shard_i, fit)
                            reservoir.cancel(slot_ids)
                            raise
                        done += fit
                    t1 = time.perf_counter()

                    n_reads += 1
                    row_bytes = (
                        rows.nbytes if rows is not None
                        else len(example_idx) * md.d_model * 4
                    )
                    bytes_sent += row_bytes + example_idx.nbytes + token_col.nbytes

                    now = time.time()
                    if cfg.debug and now - t_last_report >= cfg.log_every_s:
                        # The mmap read is a lazy view now; reserve/copy/commit
                        # is the ONE timed phase (page-cache fault + memcpy +
                        # slot accounting together).
                        logger.debug(
                            "shard=%s mb_sent=%.1f copy_ms=%.2f "
                            "fill-before=%.3f fill-after=%.3f",
                            shard_i,
                            bytes_sent / 1e6,
                            (t1 - t0) * 1e3,
                            fill_before,
                            reservoir.fill(),
                        )
                        t_last_report = now
            if native_file is not None:
                native_file.close()
        except buffers.BufferClosed:
            reason = "buffer_closed"
            break
        except Exception as err:
            logger.exception("Error in worker.")
            err_queue.put((f"worker{worker_id}", traceback.format_exc()))
            reason = f"exception:{type(err).__name__}"
            break
        finally:
            if producer_hold is not None and registry is not None:
                registry.release(producer_hold, 1)
                producer_hold = None

    if not reason:
        reason = "stop_event_set" if stop_event.is_set() else "loop_exhausted"
    logger.info(
        "Worker finished (%s). bytes_sent=%.1fMB n_reads=%d",
        reason,
        bytes_sent / 1e6,
        n_reads,
    )


def owned_shards(cfg: Config, n_shards: int) -> np.ndarray:
    """This rank's disjoint slice of the seeded shard permutation.

    Every process permutes with the SAME seed, then takes its rank-strided
    slice: the union over ranks covers each shard exactly once per epoch
    without any cross-process coordination. The manager's work list and the
    consumer's sample accounting (`_owned_example_mask`) both call THIS
    function, so the two views of "which shards are mine" cannot drift."""
    rng = np.random.default_rng(cfg.seed)
    return rng.permutation(n_shards)[cfg.rank :: cfg.world]


def _manager_main(
    cfg: Config,
    metadata: shards.Metadata,
    shards_path: pathlib.Path,
    reservoir: buffers.ReservoirBuffer,
    stop_event: threading.Event,
    err_queue: "queue.Queue[tuple[str, str]]",
    labels_mmap: np.memmap | None = None,
    registry: "_ShardRegistry | None" = None,
):
    """Manager thread: permutes shard order with a seeded RNG and runs I/O workers.

    Mirrors reference shuffled.py:295-376.
    """
    logger = logging.getLogger("shuffled.manager")

    if cfg.tokens != "content" or not isinstance(cfg.layer, int):
        err_queue.put((
            "manager",
            "High-throughput loader only supports `content` and fixed `layer` mode "
            "for now.",
        ))
        return

    if cfg.layer not in metadata.layers:
        err_queue.put((
            "manager",
            f"Layer {cfg.layer} not in {metadata.layers}",
        ))
        return

    work_items = owned_shards(cfg, metadata.n_shards)
    logger.info("First 10 shards: %s", work_items[:10])

    # Cap I/O threads at the core count: with fewer cores than threads the
    # GIL/lock ping-pong between producers and the consumer's gather costs
    # more than the parallelism buys.
    n_io = max(1, min(cfg.n_threads, os.cpu_count() or cfg.n_threads))
    if n_io < cfg.n_threads:
        logger.info(
            "Capping I/O threads at %d (%d requested, %s cores).",
            n_io, cfg.n_threads, os.cpu_count(),
        )

    threads: list[threading.Thread] = []
    try:
        shard_info = shards.ShardInfo.load(shards_path)
        work_queue: "queue.Queue[int | None]" = queue.Queue()
        for shard_i in work_items:
            work_queue.put(int(shard_i))
        for _ in range(n_io):
            work_queue.put(None)

        for i in range(n_io):
            thread = threading.Thread(
                target=_io_worker,
                args=(
                    i,
                    cfg,
                    metadata,
                    shards_path,
                    shard_info,
                    work_queue,
                    reservoir,
                    stop_event,
                    err_queue,
                    labels_mmap,
                    registry,
                ),
                daemon=True,
                name=f"shuffled-io-{i}",
            )
            thread.start()
            threads.append(thread)
        logger.info("Launched %d I/O threads.", n_io)

        while any(t.is_alive() for t in threads):
            if stop_event.wait(timeout=0.25):
                break
    except Exception:
        logger.exception("Fatal error in manager thread")
        err_queue.put(("manager", traceback.format_exc()))
    finally:
        stop_event.set()
        for t in threads:
            t.join(timeout=10.0)
        logger.info("Manager thread finished.")


class DataLoader:
    """High-throughput streaming loader that deterministically shuffles disk shards.

    Yields dict batches `{act: (B, d_model) float32, example_idx: (B,) int64,
    token_idx: (B,) int64}` as numpy arrays (device transfer is the trainer's job via
    the prefetch pipeline).
    """

    class ExampleBatch(tp.TypedDict):
        act: np.ndarray
        example_idx: np.ndarray
        token_idx: np.ndarray

    def __init__(self, cfg: Config):
        guards.positive("batch_size", cfg.batch_size)
        guards.positive("n_threads", cfg.n_threads)
        guards.positive("buffer_size", cfg.buffer_size)
        guards.fraction("min_buffer_fill", cfg.min_buffer_fill)
        self.cfg = cfg

        self.manager_thread: threading.Thread | None = None
        self.reservoir: buffers.ReservoirBuffer | None = None
        self.registry: _ShardRegistry | None = None
        self.stop_event: threading.Event | None = None
        self.err_queue: "queue.Queue[tuple[str, str]] | None" = None
        self._last_reservoir_fill: float | None = None
        self._logged_effective_capacity = False

        self.logger = logging.getLogger("shuffled.DataLoader")

        if not os.path.isdir(self.cfg.shards):
            raise RuntimeError(f"Activations are not saved at '{self.cfg.shards}'.")

        if self.cfg.use_tmpdir:
            self._shards_path = _copy_shards_to_tmpdir(self.cfg.shards, self.logger)
        else:
            self._shards_path = pathlib.Path(self.cfg.shards)

        if self.cfg.scale_norm:
            raise NotImplementedError("scale_norm not implemented.")

        self.metadata = shards.Metadata.load(self._shards_path)

        if self.cfg.world > self.metadata.n_shards:
            raise ValueError(
                f"world={self.cfg.world} cooperating loader processes over "
                f"{self.metadata.n_shards} shard(s): rank-strided partitioning "
                "would leave some rank(s) owning no shards — that rank yields "
                "nothing and times out while its peers hang in their next "
                "collective. Use at most n_shards processes, or re-extract "
                "with a smaller max_tokens_per_shard."
            )

        self._shard_info = shards.ShardInfo.load(self._shards_path)
        self._shard_info.validate(self._shards_path)

        self._n_samples = self._calculate_n_samples()

        if self.cfg.drop_last and self._n_samples < self.cfg.batch_size:
            # Same stall class as the world > n_shards guard: a drop_last
            # loader over fewer samples than one batch yields NOTHING, and a
            # BatchLimiter around it spins forever (fatal on a pod: this
            # rank never reaches its first collective). Uneven multi-host
            # shard partitions with small shards hit this.
            raise ValueError(
                f"drop_last with n_samples={self._n_samples} < batch_size="
                f"{self.cfg.batch_size}"
                + (
                    f" (rank {self.cfg.rank}/{self.cfg.world}'s shard "
                    "partition)" if self.cfg.world > 1 else ""
                )
                + ": this loader would yield zero batches. Lower the batch "
                "size or provide more data."
            )

        if self.cfg.ignore_labels:
            labels_path = self._shards_path / "labels.bin"
            if not labels_path.exists():
                raise FileNotFoundError(
                    f"ignore_labels filtering requested but labels.bin not found at "
                    f"{labels_path}"
                )

    @property
    def n_batches(self) -> int:
        return len(self)

    @property
    def n_samples(self) -> int:
        return self._n_samples

    @property
    def batch_size(self) -> int:
        return self.cfg.batch_size

    @property
    def drop_last(self) -> bool:
        return self.cfg.drop_last

    @property
    def manager_alive(self) -> bool:
        return self.manager_thread is not None and self.manager_thread.is_alive()

    def _start_manager(self):
        if self.manager_alive:
            return

        self.logger.info("Starting manager thread.")
        # Descriptor mode: zero-width act slots — the reservoir shuffles
        # 16-byte (example_idx, token_idx) descriptors and the consumer
        # gathers rows straight from the registry's mmaps in __iter__.
        self.reservoir = buffers.ReservoirBuffer(
            self.cfg.buffer_size * self.cfg.batch_size,
            0 if self.cfg.descriptor_sampling else self.metadata.d_model,
            seed=self.cfg.seed,
        )
        self.registry = (
            _ShardRegistry(self._shards_path, self.metadata.shard_shape)
            if self.cfg.descriptor_sampling
            else None
        )
        self.stop_event = threading.Event()
        self.err_queue = queue.Queue(maxsize=self.cfg.n_threads + 1)

        labels_mmap = None
        if self.cfg.ignore_labels:
            labels_mmap = np.memmap(
                self._shards_path / "labels.bin",
                mode="r",
                dtype=np.uint8,
                shape=(
                    self.metadata.n_examples,
                    self.metadata.content_tokens_per_example,
                ),
            )

        self.manager_thread = threading.Thread(
            target=_manager_main,
            args=(
                self.cfg,
                self.metadata,
                self._shards_path,
                self.reservoir,
                self.stop_event,
                self.err_queue,
                labels_mmap,
                self.registry,
            ),
            daemon=True,
            name="shuffled-manager",
        )
        self.manager_thread.start()

    def _gather_descriptors(
        self, meta: dict[str, np.ndarray]
    ) -> tuple[np.ndarray, dict[str, np.ndarray]]:
        """Assemble the act batch for sampled descriptors with ONE copy, page
        cache → batch: rows are sorted by shard (meta is permuted to match —
        row order within a shuffled batch is arbitrary) and each shard's run
        is gathered by `np.take(..., out=act[lo:hi], mode="clip")` straight
        from the mmap's flat 2-D row view. mode="clip" skips numpy's buffered
        bounds-checking path, which a temp+scatter formulation takes
        (descriptors are producer-validated, so the bounds semantics don't
        differ). Releases the per-descriptor registry references
        afterwards."""
        assert self.registry is not None
        md = self.metadata
        layer_i = md.layers.index(self.cfg.layer)
        shard_col = meta["example_idx"] // md.examples_per_shard
        order = np.argsort(shard_col, kind="stable")
        shard_col = shard_col[order]
        meta = {name: col[order] for name, col in meta.items()}
        ex_row = meta["example_idx"] % md.examples_per_shard
        tok = meta["token_idx"] + int(md.cls_token)
        # Flat row index into the (ex·layers·tokens, d_model) view of a shard.
        _, n_layers, n_tok, _ = md.shard_shape
        flat = (ex_row * n_layers + layer_i) * n_tok + tok
        act = np.empty((len(flat), md.d_model), dtype=np.float32)
        bounds = np.flatnonzero(np.diff(shard_col)) + 1
        lo = 0
        for hi in (*bounds.tolist(), len(flat)):
            shard_i = int(shard_col[lo])
            mm = self.registry.get(shard_i).reshape(-1, md.d_model)
            np.take(mm, flat[lo:hi], axis=0, out=act[lo:hi], mode="clip")
            self.registry.release(shard_i, hi - lo)
            lo = hi
        return act, meta

    def __iter__(self) -> collections.abc.Iterator[ExampleBatch]:
        """Yields batches until n_samples have been produced."""
        self._start_manager()
        n, b = 0, 0

        try:
            while n < self.n_samples:
                need = min(self.cfg.batch_size, self.n_samples - n)
                if need < self.cfg.batch_size and self.cfg.drop_last:
                    break
                remaining = self.n_samples - n
                self._wait_for_min_buffer_fill(remaining)
                if self.err_queue is not None and not self.err_queue.empty():
                    who, tb = self.err_queue.get_nowait()
                    raise RuntimeError(f"{who} crashed:\n{tb}")

                try:
                    act, meta = self.reservoir.get(
                        need, timeout=self.cfg.batch_timeout_s
                    )
                    if self.registry is not None:
                        act, meta = self._gather_descriptors(meta)
                    if b == 0:
                        guards.check(
                            "act", act, ndim=2, last_dim=self.metadata.d_model,
                            what="(batch, d_model) activations from the reservoir",
                        )
                    n += need
                    b += 1
                    yield self.ExampleBatch(
                        act=act,
                        example_idx=meta["example_idx"],
                        token_idx=meta["token_idx"],
                    )
                    continue
                except TimeoutError:
                    if self.cfg.ignore_labels:
                        self.logger.info(
                            "Did not get a batch from %d worker threads in %.1fs. "
                            "This can happen when filtering out many labels.",
                            self.cfg.n_threads,
                            self.cfg.batch_timeout_s,
                        )
                    else:
                        self.logger.info(
                            "Did not get a batch from %d worker threads in %.1fs.",
                            self.cfg.n_threads,
                            self.cfg.batch_timeout_s,
                        )

                if not self.manager_alive:
                    # Prefer the remote traceback when a worker/manager pushed
                    # one before dying (reference shuffled.py:516-549 raises the
                    # crash cause, not just the liveness symptom).
                    if self.err_queue is not None and not self.err_queue.empty():
                        who, tb = self.err_queue.get_nowait()
                        raise RuntimeError(f"{who} crashed:\n{tb}")
                    raise RuntimeError(
                        f"Manager thread died unexpectedly after {b}/{len(self)} "
                        f"batches."
                    )
        finally:
            self.shutdown()

    def shutdown(self):
        if self.stop_event is not None and not self.stop_event.is_set():
            self.stop_event.set()
        if self.reservoir is not None:
            self.reservoir.close()
        if self.manager_thread is not None and self.manager_thread.is_alive():
            self.manager_thread.join(timeout=5.0)
            if self.manager_thread.is_alive():
                self.logger.warning("Manager thread did not shut down cleanly.")
        if self.registry is not None:
            # After stop+join no thread touches the mmaps; drop them all.
            self.registry.close_all()

        self.manager_thread = None
        self.reservoir = None
        self.registry = None
        self.stop_event = None
        self.err_queue = None
        self._last_reservoir_fill = None
        self._logged_effective_capacity = False

    def __del__(self):
        try:
            self.shutdown()
        except Exception:
            pass

    def _wait_for_min_buffer_fill(
        self, remaining: int, *, poll_interval_s: float = 0.05
    ) -> None:
        """Warm-up gate: block until the reservoir is sufficiently full.

        Mirrors reference shuffled.py:586-636, including manager-death and
        end-of-epoch effective-capacity handling.
        """
        if self.cfg.min_buffer_fill <= 0.0 or self.reservoir is None or remaining <= 0:
            self._last_reservoir_fill = None
            return

        effective_capacity = min(self.reservoir.capacity, remaining)
        if effective_capacity <= 0:
            self._last_reservoir_fill = None
            return

        if not self._logged_effective_capacity and self.reservoir.capacity > remaining:
            self.logger.debug(
                "Reservoir capacity (%d) exceeds remaining samples (%d); using %d "
                "slots for warmup.",
                self.reservoir.capacity,
                remaining,
                effective_capacity,
            )
            self._logged_effective_capacity = True

        while True:
            if self.err_queue is not None and not self.err_queue.empty():
                who, tb = self.err_queue.get_nowait()
                raise RuntimeError(f"{who} crashed:\n{tb}")

            qsize = self.reservoir.qsize()
            fill_fraction = qsize / effective_capacity
            if fill_fraction >= self.cfg.min_buffer_fill:
                self._last_reservoir_fill = fill_fraction
                return

            if not self.manager_alive:
                if qsize > 0:
                    self._last_reservoir_fill = fill_fraction
                    return
                raise RuntimeError(
                    "Manager thread died while waiting for reservoir fill."
                )

            time.sleep(poll_interval_s)

    def _owned_example_mask(self) -> np.ndarray | None:
        """(n_examples,) bool of examples in this rank's shard slice, or None
        when world == 1 (everything owned). Mirrors the manager's seeded
        permutation slice exactly."""
        if self.cfg.world == 1:
            return None
        owned = owned_shards(self.cfg, self.metadata.n_shards)
        mask = np.zeros(self.metadata.n_examples, dtype=bool)
        per_shard = self.metadata.examples_per_shard
        for shard_i in owned:
            start = int(shard_i) * per_shard
            mask[start : start + self._shard_info[int(shard_i)].n_examples] = True
        return mask

    def _calculate_n_samples(self) -> int:
        """Total samples for this (tokens, layer) view, after label filtering
        — counting only this rank's owned shards when world > 1.

        Mirrors reference shuffled.py:638-698.
        """
        owned = self._owned_example_mask()
        n_examples = (
            self.metadata.n_examples if owned is None else int(owned.sum())
        )
        match (self.cfg.tokens, self.cfg.layer):
            case ("special", "all"):
                max_samples = n_examples * len(self.metadata.layers)
            case ("special", int()):
                max_samples = n_examples
            case ("content", int()):
                max_samples = (
                    n_examples * self.metadata.content_tokens_per_example
                )
            case ("content", "all"):
                max_samples = (
                    n_examples
                    * len(self.metadata.layers)
                    * self.metadata.content_tokens_per_example
                )
            case _:
                raise ValueError(
                    f"Unsupported (tokens, layer): "
                    f"({self.cfg.tokens}, {self.cfg.layer})"
                )

        if not self.cfg.ignore_labels:
            return max_samples

        if self.cfg.tokens != "content" or not isinstance(self.cfg.layer, int):
            raise NotImplementedError(
                "Patch label filtering only supports 'content' patches with fixed layer"
            )

        labels_path = self._shards_path / "labels.bin"
        if not labels_path.exists():
            raise FileNotFoundError(f"labels.bin not found at {labels_path}")

        labels = np.memmap(
            labels_path,
            mode="r",
            dtype=np.uint8,
            shape=(self.metadata.n_examples, self.metadata.content_tokens_per_example),
        )
        mask = ~np.isin(labels, self.cfg.ignore_labels)
        if owned is not None:
            mask = mask[owned]
        n_remaining = int(np.sum(mask))
        del labels
        return n_remaining

    def __len__(self) -> int:
        """Number of batches in an epoch."""
        if self.cfg.drop_last:
            return self.n_samples // self.cfg.batch_size
        return math.ceil(self.n_samples / self.cfg.batch_size)
