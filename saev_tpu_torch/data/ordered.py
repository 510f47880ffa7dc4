"""Ordered (sequential) dataloader for activation data (a copy of
saev_tpu/data/ordered.py on the port's shard protocol, held to the original
by tests/test_torch_inference.py).

Reads activations from disk shards in exact global-index order, for eval and
inference: a single producer thread reads whole (example-range x token) slabs
sequentially through the OS page cache and pushes dict batches into a bounded
queue; the consumer yields them in order (reference
`src/saev/data/ordered.py:46-376`, design rationale in
src/saev/data/performance.md:49-96).

Patch labels are attached if a labels.bin file exists on disk.
"""

import collections.abc
import dataclasses
import logging
import math
import os
import pathlib
import queue
import threading
import traceback
import typing as tp

import numpy as np

from .. import guards
from . import shards


@dataclasses.dataclass(frozen=True)
class Config:
    """Configuration for loading ordered (non-shuffled) activation data from disk.

    Attributes:
        shards: Directory with .bin shards and a metadata.json file.
        tokens: Which kinds of tokens to use (only 'content' supported).
        layer: Which ViT layer to read.
        batch_size: Batch size.
        batch_timeout_s: How long to wait for at least one batch.
        drop_last: Whether to drop the last batch if it's smaller than the others.
        buffer_size: Number of batches to queue.
        debug: Whether to log debug messages.
        log_every_s: How frequently to log performance messages.
    """

    shards: pathlib.Path = pathlib.Path("$SAEV_SCRATCH/saev/shards/abcdefg")
    tokens: str = "content"
    layer: int | str = -2
    batch_size: int = 1024 * 16
    batch_timeout_s: float = 30.0
    drop_last: bool = False
    buffer_size: int = 64
    debug: bool = False
    log_every_s: float = 30.0


_SENTINEL = object()


def _producer_main(
    cfg: Config,
    md: shards.Metadata,
    shard_info: shards.ShardInfo,
    batch_queue: "queue.Queue",
    stop_event: threading.Event,
    err_queue: "queue.Queue[tuple[str, str]]",
    labels_mmap: np.memmap | None,
):
    """Sequentially read shards and emit ordered batches (reference ordered.py:73-199)."""
    logger = logging.getLogger("ordered.producer")
    try:
        assert cfg.tokens == "content"
        assert isinstance(cfg.layer, int)
        layer_i = md.layers.index(cfg.layer)
        ctpe = md.content_tokens_per_example

        # Buffers for assembling fixed-size batches out of shard-slab reads.
        pend_acts: list[np.ndarray] = []
        pend_meta: list[np.ndarray] = []  # columns: example_idx, token_idx[, label]
        pend_rows = 0
        emitted = 0

        def emit(force_partial: bool):
            nonlocal pend_acts, pend_meta, pend_rows, emitted
            while pend_rows >= cfg.batch_size or (
                force_partial and pend_rows > 0
            ):
                take = min(cfg.batch_size, pend_rows)
                acts = np.concatenate(pend_acts)
                meta = np.concatenate(pend_meta)
                batch_acts, rest_acts = acts[:take], acts[take:]
                batch_meta, rest_meta = meta[:take], meta[take:]
                pend_acts = [rest_acts] if len(rest_acts) else []
                pend_meta = [rest_meta] if len(rest_meta) else []
                pend_rows -= take

                batch: dict[str, np.ndarray] = {
                    "act": np.ascontiguousarray(batch_acts, dtype=np.float32),
                    "example_idx": batch_meta[:, 0].astype(np.int64),
                    "token_idx": batch_meta[:, 1].astype(np.int64),
                }
                if labels_mmap is not None:
                    batch["token_labels"] = batch_meta[:, 2].astype(np.int64)

                while not stop_event.is_set():
                    try:
                        batch_queue.put(batch, timeout=0.25)
                        emitted += take
                        break
                    except queue.Full:
                        continue
                if stop_event.is_set():
                    return
                if force_partial and pend_rows == 0:
                    return

        for shard_i, shard in enumerate(shard_info):
            if stop_event.is_set():
                return
            mmap = np.memmap(
                pathlib.Path(cfg.shards) / shard.name,
                mode="r",
                dtype=np.float32,
                shape=md.shard_shape,
            )
            ex_offset = shard_i * md.examples_per_shard

            # Read in example-range slabs; reshape keeps global index order
            # (idx = example_idx * ctpe + token_idx).
            slab_examples = max(1, min(shard.n_examples, 8192 // max(1, ctpe) + 1))
            for start in range(0, shard.n_examples, slab_examples):
                if stop_event.is_set():
                    return
                end = min(start + slab_examples, shard.n_examples)
                tok0 = int(md.cls_token)
                slab = np.array(
                    mmap[start:end, layer_i, tok0 : tok0 + ctpe, :]
                )  # (E, T, D)
                n_rows = (end - start) * ctpe
                acts = slab.reshape(n_rows, md.d_model)

                ex_idx = np.repeat(
                    np.arange(ex_offset + start, ex_offset + end, dtype=np.int64), ctpe
                )
                tok_idx = np.tile(
                    np.arange(ctpe, dtype=np.int64), end - start
                )
                cols = [ex_idx, tok_idx]
                if labels_mmap is not None:
                    lab = np.array(
                        labels_mmap[ex_offset + start : ex_offset + end]
                    ).reshape(n_rows)
                    cols.append(lab.astype(np.int64))
                meta = np.stack(cols, axis=1)

                pend_acts.append(acts)
                pend_meta.append(meta)
                pend_rows += n_rows
                emit(force_partial=False)

        if not cfg.drop_last:
            emit(force_partial=True)

        batch_queue.put(_SENTINEL, timeout=max(1.0, cfg.batch_timeout_s))
        logger.info("Producer finished; emitted %d samples.", emitted)
    except Exception:
        logger.exception("Fatal error in ordered producer")
        err_queue.put(("producer", traceback.format_exc()))


class DataLoader:
    """Strictly-sequential loader yielding ordered dict batches.

    Batch dict: `{act, example_idx, token_idx[, token_labels]}` (numpy arrays).
    """

    def __init__(self, cfg: Config):
        guards.positive("batch_size", cfg.batch_size)
        guards.positive("buffer_size", cfg.buffer_size)
        self.cfg = cfg
        self.logger = logging.getLogger("ordered.DataLoader")

        if not os.path.isdir(self.cfg.shards):
            raise RuntimeError(f"Activations are not saved at '{self.cfg.shards}'.")

        self.metadata = shards.Metadata.load(pathlib.Path(self.cfg.shards))
        self.shard_info = shards.ShardInfo.load(pathlib.Path(self.cfg.shards))
        self.shard_info.validate(pathlib.Path(self.cfg.shards))

        if self.cfg.tokens != "content" or not isinstance(self.cfg.layer, int):
            raise NotImplementedError(
                "Ordered loader only supports 'content' tokens with a fixed layer."
            )
        assert self.cfg.layer in self.metadata.layers, (
            f"Layer {self.cfg.layer} not in {self.metadata.layers}"
        )

        self._has_labels = (pathlib.Path(self.cfg.shards) / "labels.bin").exists()

        total = sum(s.n_examples for s in self.shard_info)
        self._n_samples = total * self.metadata.content_tokens_per_example

        self.producer_thread: threading.Thread | None = None
        self.stop_event: threading.Event | None = None
        self.batch_queue: "queue.Queue | None" = None
        self.err_queue: "queue.Queue | None" = None

    @property
    def n_samples(self) -> int:
        if self.cfg.drop_last:
            return (self._n_samples // self.cfg.batch_size) * self.cfg.batch_size
        return self._n_samples

    @property
    def batch_size(self) -> int:
        return self.cfg.batch_size

    @property
    def drop_last(self) -> bool:
        return self.cfg.drop_last

    def __len__(self) -> int:
        if self.cfg.drop_last:
            return self._n_samples // self.cfg.batch_size
        return math.ceil(self._n_samples / self.cfg.batch_size)

    def _start(self):
        self.stop_event = threading.Event()
        self.batch_queue = queue.Queue(maxsize=self.cfg.buffer_size)
        self.err_queue = queue.Queue(maxsize=2)

        labels_mmap = None
        if self._has_labels:
            labels_mmap = np.memmap(
                pathlib.Path(self.cfg.shards) / "labels.bin",
                mode="r",
                dtype=np.uint8,
                shape=(
                    self.metadata.n_examples,
                    self.metadata.content_tokens_per_example,
                ),
            )

        self.producer_thread = threading.Thread(
            target=_producer_main,
            args=(
                self.cfg,
                self.metadata,
                self.shard_info,
                self.batch_queue,
                self.stop_event,
                self.err_queue,
                labels_mmap,
            ),
            daemon=True,
            name="ordered-producer",
        )
        self.producer_thread.start()

    def __iter__(self) -> collections.abc.Iterator[dict[str, np.ndarray]]:
        self._start()
        yielded = 0
        try:
            while True:
                if self.err_queue is not None and not self.err_queue.empty():
                    who, tb = self.err_queue.get_nowait()
                    raise RuntimeError(f"{who} crashed:\n{tb}")
                try:
                    item = self.batch_queue.get(timeout=self.cfg.batch_timeout_s)
                except queue.Empty:
                    if not (
                        self.producer_thread and self.producer_thread.is_alive()
                    ):
                        if self.err_queue is not None and not self.err_queue.empty():
                            who, tb = self.err_queue.get_nowait()
                            raise RuntimeError(f"{who} crashed:\n{tb}")
                        raise RuntimeError(
                            f"Producer died unexpectedly after {yielded} samples."
                        )
                    continue
                if item is _SENTINEL:
                    return
                if yielded == 0:
                    guards.check(
                        "act", item["act"], ndim=2, last_dim=self.metadata.d_model,
                        what="(batch, d_model) ordered activations",
                    )
                yielded += len(item["act"])
                yield item
        finally:
            self.shutdown()

    def shutdown(self):
        if self.stop_event is not None:
            self.stop_event.set()
        if self.producer_thread is not None and self.producer_thread.is_alive():
            # Drain the queue so the producer can exit its blocking put.
            try:
                while True:
                    self.batch_queue.get_nowait()
            except queue.Empty:
                pass
            self.producer_thread.join(timeout=5.0)
        self.producer_thread = None
        self.stop_event = None
        self.batch_queue = None
        self.err_queue = None

    def __del__(self):
        try:
            self.shutdown()
        except Exception:
            pass
