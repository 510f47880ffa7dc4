"""Host-to-device transfer for the train loop (the counterpart of
saev_tpu/parallel `prefetch_to_device`; multi-GPU is not ported yet).
"""

import queue
import threading
import typing as tp

import numpy as np
import torch

_DONE = object()


def _fetch_ahead(
    iterator: tp.Iterable, depth: int, key: str, pin: bool
) -> tp.Iterator[tuple[torch.Tensor, tp.Any]]:
    """Yields (host tensor of batch[key], batch), pulled from `iterator` by a
    thread that stays up to `depth` batches ahead of the caller. With `pin`
    each array is copied into pinned memory there (torch's pinned allocator
    reuses a buffer only once the copies issued from it have ended), else it
    is wrapped without a copy. An exception of `iterator` is raised to the
    caller. A caller that stops early leaves the thread to stop at its next
    hand-over, where it drops the iterator, which closes it."""
    ready: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                ready.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def fetch() -> None:
        try:
            for batch in iterator:
                host = torch.from_numpy(np.asarray(batch[key]))
                if pin:
                    host = host.pin_memory()
                if not put((host, batch)):
                    return
            put(_DONE)
        except BaseException as err:  # noqa: BLE001 - raised again in the caller's thread
            put(err)

    threading.Thread(target=fetch, daemon=True, name="prefetch-to-device").start()
    try:
        while (item := ready.get()) is not _DONE:
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def prefetch_to_device(
    iterator: tp.Iterable, device: torch.device | str, *, depth: int = 2, key: str = "act"
) -> tp.Iterator[tuple[torch.Tensor, tp.Any]]:
    """Yields (device tensor of batch[key], host batch) pairs, with up to
    `depth` batches fetched ahead of the one in use by a thread
    (`_fetch_ahead`), so the loader's wait runs while the caller's step runs
    (the step reads its prefix cuts back to the host, which holds the host
    to the device a step; fetched in the caller's thread, the loop would
    take the sum of the two).

    On a CUDA device each batch is fetched into pinned host memory and goes
    to the card on a side stream, behind an event that the consuming stream
    waits on. On the CPU the batch's array is wrapped without a copy.
    """
    device = torch.device(device)
    on_card = device.type == "cuda"
    stream = torch.cuda.Stream(device) if on_card else None
    for host, batch in _fetch_ahead(iterator, depth, key, pin=on_card):
        if not on_card:
            yield host, batch
            continue
        with torch.cuda.stream(stream):
            x = torch.empty(host.shape, dtype=host.dtype, device=device)
            x.copy_(host, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        # x was allocated on the side stream: keep its memory from reuse
        # until the consumer's work on it has run.
        x.record_stream(consumer)
        yield x, batch
