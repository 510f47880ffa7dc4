"""Activation extraction: run a frozen ViT over a dataset and write shards (the
counterpart of saev_tpu/data/extract.py).

As in the JAX package's redesign of the reference's worker
(`src/saev/data/shards.py:698-890`):
- a host thread-pool loader keeps the examples in order (PIL's decode and
  resampling release the GIL; Bird-MAE's numpy filterbank gains little from
  the threads),
- forward hooks become functional activation taps (`models.Recorder`),
- the ViT forward runs on `device` ("cuda" unless the caller asks for "cpu";
  without a card "cuda" raises); activations come back to the host as
  float32 and stream into memmaps via `ShardWriter`.

Over several cards (the JAX package shards each batch over its devices,
saev_tpu/models/vit.py:640-662) the port runs one process a card, under
torchrun (`framework/shards.py`'s `cli` joins the process group):
- the one-process run's batches (`helpers.batched_idx`) are dealt
  round-robin, rank r taking batches r, r + W, ... (`parallel.batch_spans`),
  each rank with its own loader over its own batches, so the decode and the
  filterbank run in W processes and every forward sees the rows and the
  shape of the one-process run: the files come out bit for bit its files;
- rank 0 writes metadata.json and creates every acts file (and labels.bin
  for a segmentation dataset), each rank writes its rows at their global
  offsets (`shards.RowWriter`), and rank 0 writes shards.json once every
  rank is done (`shards.finish`);
- a rank that raises fails every rank at the next agreement (`_all_ranks`,
  one all-reduce), and no shards.json is written.
"""

import concurrent.futures
import contextlib
import logging
import math
import pathlib
import time
import typing as tp

import numpy as np
import torch

from .. import guards, helpers, parallel
from . import datasets, models, shards

logger = logging.getLogger(__name__)


def _collate(samples: list[dict[str, object]]) -> dict[str, object]:
    """Collate a list of sample dicts into a batch dict of stacked arrays."""
    batch: dict[str, object] = {}
    keys = samples[0].keys()
    for key in keys:
        vals = [s[key] for s in samples]
        first = vals[0]
        if isinstance(first, np.ndarray):
            batch[key] = np.stack(vals)
        elif isinstance(first, (int, float, np.integer, np.floating)):
            batch[key] = np.asarray(vals)
        else:
            batch[key] = vals
    return batch


class ThreadedDataLoader:
    """Ordered batch loader over a map-style dataset using a thread pool.

    Keeps strict example order (required by ShardWriter's start_idx bookkeeping) while
    overlapping per-example decode/preprocess across threads. `spans` are the
    (start, end) example spans of the batches to load, in order; by default
    every batch of the dataset (`helpers.batched_idx`).
    """

    def __init__(self, dataset, *, batch_size: int, n_workers: int = 8,
                 spans: list[tuple[int, int]] | None = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.n_workers = max(1, n_workers)
        self.drop_last = False
        self.spans = list(helpers.batched_idx(len(dataset), batch_size)) if spans is None else list(spans)

    def __len__(self) -> int:
        return len(self.spans)

    def __iter__(self) -> tp.Iterator[dict[str, object]]:
        if self.n_workers == 1:
            for start, end in self.spans:
                yield _collate([self.dataset[i] for i in range(start, end)])
            return

        with concurrent.futures.ThreadPoolExecutor(self.n_workers) as pool:
            # Pipeline two batches deep: submit batch i+1 while yielding batch i.
            pending: list[list[concurrent.futures.Future]] = []
            for j, (start, end) in enumerate(self.spans):
                pending.append([
                    pool.submit(self.dataset.__getitem__, i)
                    for i in range(start, end)
                ])
                if len(pending) > 2 or j == len(self.spans) - 1:
                    futs = pending.pop(0)
                    yield _collate([f.result() for f in futs])
            while pending:
                futs = pending.pop(0)
                yield _collate([f.result() for f in futs])


def get_dataloader(
    data: "datasets.Config",
    *,
    batch_size: int,
    n_workers: int,
    data_tr=None,
    mask_tr=None,
    sample_tr=None,
    spans: list[tuple[int, int]] | None = None,
) -> ThreadedDataLoader:
    """Build an ordered extraction dataloader (reference shards.py:854-890)
    over the batches `spans` (by default all of them)."""
    dataset = datasets.get_dataset(
        data,
        data_transform=data_tr,
        mask_transform=mask_tr,
        sample_transform=sample_tr,
    )
    return ThreadedDataLoader(dataset, batch_size=batch_size, n_workers=n_workers, spans=spans)


@contextlib.contextmanager
def _all_ranks(what: str):
    """Runs the block on every rank, then every rank learns whether any
    rank's block raised (one all-reduce, which is also a barrier): a rank
    that raised raises its own error, the others an error that counts the
    failed ranks. Single-process, the block alone."""
    err = None
    try:
        yield
    except Exception as e:  # noqa: BLE001 - raised again below, after the other ranks know
        err = e
    failed = int(parallel.global_sum(np.array([err is not None], np.int64))[0])
    if err is not None:
        raise err
    if failed:
        raise RuntimeError(f"extraction: {failed} other rank(s) failed {what}; no shards.json is written")


def worker_fn(
    *,
    family: str,
    ckpt: str,
    content_tokens_per_example: int,
    cls_token: bool,
    d_model: int,
    layers: list[int],
    data: "datasets.Config",
    batch_size: int,
    n_workers: int,
    max_tokens_per_shard: int,
    shards_root: pathlib.Path,
    device: str = "cuda",
    pixel_agg: shards.PixelAgg = shards.PixelAgg.MAJORITY,
) -> pathlib.Path:
    """Extract ViT activations over a dataset and write content-addressed shards.

    Mirrors the reference worker (shards.py:698-850): builds the model + recorder
    on `device`, builds transforms (incl. the seg-mask → patch-labels path),
    iterates the dataloader, and writes activations (+labels) through
    `ShardWriter`. In a process group of W ranks (torch.distributed, one
    rank a card) this rank runs its share of the batches
    (`parallel.batch_spans`) and writes its rows into the directory rank 0
    lays out (module doc); the directory is byte for byte one process's.

    Returns:
        Path to the shards directory.
    """
    guards.positive("content_tokens_per_example", content_tokens_per_example)
    guards.positive("d_model", d_model)
    guards.positive("batch_size", batch_size)
    guards.positive("max_tokens_per_shard", max_tokens_per_shard)
    if not layers:
        raise guards.GuardError("layers: expected at least one recorded layer")

    shards_root = pathlib.Path(shards_root)
    assert shards_root.name == "shards"

    # Recorders tap residuals in ascending block order regardless of the
    # request order, so Metadata.layers must be the sorted unique list or
    # every reader would silently index the wrong layer axis.
    normalized = sorted(set(int(l) for l in layers))
    assert list(layers) == normalized, (
        f"layers must be sorted and unique (taps are stored in block order); "
        f"got {list(layers)}, expected {normalized}"
    )

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f'extraction runs on device "{device}" and torch sees no CUDA device; '
            'pass device="cpu" to run it on the CPU'
        )
    rank, world = parallel.process_index(), parallel.process_count()
    spans = parallel.batch_spans(data.n_examples, batch_size)
    md = shards.Metadata(
        family=family,
        ckpt=ckpt,
        layers=tuple(layers),
        content_tokens_per_example=content_tokens_per_example,
        cls_token=cls_token,
        d_model=d_model,
        n_examples=data.n_examples,
        max_tokens_per_shard=max_tokens_per_shard,
        data=shards.encode_dataset_cfg(data),
        dataset=data.root,
        pixel_agg=pixel_agg,
    )
    shards_dir = shards_root / md.hash

    with _all_ranks("to set up"):
        model_cls = models.load_model_cls(family)
        model_instance = model_cls(ckpt, device=device)
        recorder = models.Recorder(
            model_instance, content_tokens_per_example, cls_token, layers
        )

        data_tr, sample_tr = model_cls.make_transforms(ckpt, content_tokens_per_example)

        mask_tr = None
        if datasets.is_img_seg_dataset(data):
            seg_resize_tr = model_cls.make_resize(
                ckpt, content_tokens_per_example, scale=1.0, resample="NEAREST"
            )

            def seg_to_patches(seg):
                return shards.pixel_to_patch_labels(
                    np.asarray(seg_resize_tr(seg), dtype=np.uint8),
                    content_tokens_per_example,
                    patch_size=model_instance.patch_size,
                    pixel_agg=pixel_agg,
                    bg_label=data.bg_label,
                )

            mask_tr = seg_to_patches

        dataloader = get_dataloader(
            data,
            batch_size=batch_size,
            n_workers=n_workers,
            data_tr=data_tr,
            mask_tr=mask_tr,
            sample_tr=sample_tr,
            spans=spans,
        )

        n_batches = math.ceil(data.n_examples / batch_size)
        if parallel.is_primary():
            logger.info("Dumping %d batches of %d examples.", n_batches, batch_size)
            md.dump(shards_root)
            if world > 1:
                shards.create_files(shards_dir, md, labels=datasets.is_img_seg_dataset(data))

    seconds = {"loader wait": 0.0, "forward": 0.0, "write": 0.0}
    clock = time.perf_counter
    with _all_ranks("to write their rows"):
        writer = shards.ShardWriter(shards_root, md) if world == 1 else shards.RowWriter(shards_dir, md)
        batches = zip(dataloader, spans)
        if parallel.is_primary():
            batches = helpers.progress(batches, total=len(spans))
        with writer:
            t = clock()
            for batch, (start, end) in batches:
                t_loaded = clock()
                seconds["loader wait"] += t_loaded - t
                x = batch["data"]
                grid = batch.get("grid")
                if grid is not None:
                    _, cache = recorder(x, grid=grid)
                else:
                    _, cache = recorder(x)
                # cache: (batch, n_layers, tokens_per_example, d_model)
                assert len(cache) == end - start

                patch_labels = batch.get("patch_labels")
                if patch_labels is not None:
                    patch_labels = np.asarray(patch_labels, dtype=np.uint8)
                    assert patch_labels.shape == (len(cache), content_tokens_per_example)

                t_forward = clock()
                seconds["forward"] += t_forward - t_loaded
                writer.write_batch(cache, start, patch_labels=patch_labels)
                t = clock()
                seconds["write"] += t - t_forward
    logger.info(
        "Rank %d of %d: %d batches; %s.", rank, world, len(spans),
        ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items()),
    )

    if world > 1:
        labels = int(parallel.global_sum(np.array([writer.wrote_labels], np.int64))[0])
        if parallel.is_primary():
            shards.finish(shards_dir, md, labels_written=bool(labels))
        parallel.sync()
    return shards_dir
