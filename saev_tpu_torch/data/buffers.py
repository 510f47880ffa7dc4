"""Host-side concurrent buffers: the FIFO ring and the shuffling reservoir (a
copy of saev_tpu/data/buffers.py).

The reference's buffers are shared-memory torch tensors
(`src/saev/data/buffers.py:16-231`); here, as in the JAX package, the dataloader is threads inside
one process (numpy/memmap reads release the GIL for the big memcpys), so the buffers
are plain numpy arrays guarded by condition variables — same blocking put/get
semantics, timeouts and poison behavior, without multiprocessing shared memory.
"""

import threading

import numpy as np


class BufferClosed(RuntimeError):
    """Raised when putting/getting on a closed buffer."""


class RingBuffer:
    """Fixed-capacity MPMC FIFO of equal-shaped numpy batches.

    Mirrors reference buffers.py:16-88 (blocking put/get, advisory qsize/fill, close).
    """

    def __init__(self, slots: int, shape: tuple[int, ...], dtype=np.float32):
        assert slots > 0
        self.slots = slots
        self.data = np.zeros((slots, *shape), dtype=dtype)
        self._head = 0  # next slot to read
        self._tail = 0  # next slot to write
        self._count = 0
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._not_empty = threading.Condition(self._lock)
        self._closed = False

    def put(self, value: np.ndarray, timeout: float | None = None) -> None:
        with self._not_full:
            if not self._not_full.wait_for(
                lambda: self._count < self.slots or self._closed, timeout=timeout
            ):
                raise TimeoutError("RingBuffer.put timed out")
            if self._closed:
                raise BufferClosed("RingBuffer is closed")
            self.data[self._tail] = value
            self._tail = (self._tail + 1) % self.slots
            self._count += 1
            self._not_empty.notify()

    def get(self, timeout: float | None = None) -> np.ndarray:
        with self._not_empty:
            if not self._not_empty.wait_for(
                lambda: self._count > 0 or self._closed, timeout=timeout
            ):
                raise TimeoutError("RingBuffer.get timed out")
            if self._count == 0 and self._closed:
                raise BufferClosed("RingBuffer is closed")
            out = self.data[self._head].copy()
            self._head = (self._head + 1) % self.slots
            self._count -= 1
            self._not_full.notify()
            return out

    def qsize(self) -> int:
        """Advisory number of filled slots."""
        return self._count

    def fill(self) -> float:
        """Advisory fill fraction in [0, 1]."""
        return self._count / self.slots

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._not_full.notify_all()
            self._not_empty.notify_all()


class ReservoirBuffer:
    """The shuffling core: a pool of (activation, metadata) rows; producers `put`
    batches, consumers `get(n)` draw uniformly-random rows without replacement
    (a streaming shuffle). Same semantics as reference buffers.py:91-231.

    Performance design: rows live in fixed slots; a consumer never moves row
    data to compact the pool. Sampling and removal happen on an int32 `live`
    slot-id array (swap-with-tail on 4-byte ids instead of 4 KB rows), and the
    heavy row gather runs OUTSIDE the lock — sampled slots are neither live nor
    free while in flight, so producers can fill other slots concurrently. This
    halves per-batch memory traffic vs compacting the row pool and
    unserializes producers from the consumer's gather.
    """

    def __init__(
        self,
        capacity: int,
        d_model: int,
        *,
        meta_names: tuple[str, ...] = ("example_idx", "token_idx"),
        seed: int = 0,
        dtype=np.float32,
    ):
        assert capacity > 0
        self.capacity = capacity
        self.acts = np.zeros((capacity, d_model), dtype=dtype)
        self.meta = {name: np.zeros(capacity, dtype=np.int64) for name in meta_names}
        # live[:_n] = slot ids holding live rows; free[:_n_free] = empty slots.
        self._live = np.empty(capacity, dtype=np.int32)
        self._free = np.arange(capacity - 1, -1, -1, dtype=np.int32)
        self._n = 0
        self._n_free = capacity
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._not_empty = threading.Condition(self._lock)
        self._closed = False
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._n

    def fill(self) -> float:
        return self._n / self.capacity

    def qsize(self) -> int:
        return self._n

    def reserve(self, n: int, timeout: float | None = None) -> np.ndarray:
        """Claim up to `n` free slot ids (at least 1) for a direct producer
        write. Reserved slots are neither free nor live — the same in-flight
        convention `get` uses — so the producer can fill `self.acts[ids]` /
        `self.meta[...][ids]` WITHOUT holding the lock (typically straight from
        a shard mmap: one page-cache→pool copy instead of two), then `commit`.
        On error, `cancel` returns the slots to the free pool."""
        assert n >= 1
        with self._not_full:
            if not self._not_full.wait_for(
                lambda: self._n_free > 0 or self._closed, timeout=timeout
            ):
                raise TimeoutError("ReservoirBuffer.reserve timed out")
            if self._closed:
                raise BufferClosed("ReservoirBuffer is closed")
            fit = min(self._n_free, n)
            slot_ids = self._free[self._n_free - fit : self._n_free].copy()
            self._n_free -= fit
        # Ascending slots improve scatter-write locality; row order within the
        # pool is irrelevant (sampling is uniform).
        slot_ids.sort()
        return slot_ids

    def commit(self, slot_ids: np.ndarray) -> None:
        """Publish reserved-and-filled slots to consumers."""
        n = len(slot_ids)
        with self._not_empty:
            if self._closed:
                raise BufferClosed("ReservoirBuffer is closed")
            self._live[self._n : self._n + n] = slot_ids
            self._n += n
            self._not_empty.notify_all()

    def cancel(self, slot_ids: np.ndarray) -> None:
        """Return reserved slots to the free pool without publishing them."""
        n = len(slot_ids)
        with self._not_full:
            self._free[self._n_free : self._n_free + n] = slot_ids
            self._n_free += n
            self._not_full.notify_all()

    def put(
        self,
        acts: np.ndarray,
        meta: dict[str, np.ndarray],
        timeout: float | None = None,
    ) -> None:
        """Blocking append of a batch of rows; splits the batch if it doesn't
        fit. Built on reserve/commit, so the row copies run outside the lock."""
        n = len(acts)
        assert all(len(v) == n for v in meta.values())
        start = 0
        deadline = None if timeout is None else _Deadline(timeout)
        while start < n:
            remaining = None if deadline is None else deadline.remaining()
            try:
                slot_ids = self.reserve(n - start, timeout=remaining)
            except TimeoutError:
                raise TimeoutError("ReservoirBuffer.put timed out") from None
            try:
                fit = len(slot_ids)
                self.acts[slot_ids] = acts[start : start + fit]
                for name, col in self.meta.items():
                    col[slot_ids] = meta[name][start : start + fit]
            except BaseException:
                self.cancel(slot_ids)
                raise
            try:
                self.commit(slot_ids)
            except BufferClosed:
                # Preserve slot conservation: a commit refused by close() must
                # return the reserved slots to the free pool before raising.
                self.cancel(slot_ids)
                raise
            start += fit

    def get(
        self, n: int, timeout: float | None = None
    ) -> tuple[np.ndarray, dict[str, np.ndarray]]:
        """Draw `n` uniformly random rows, removing them from the pool.

        Blocks until `n` rows are available or `timeout` expires (TimeoutError; no
        partial results — matches reference rollback semantics, buffers.py:179-204).
        """
        assert n <= self.capacity, f"get({n}) exceeds capacity {self.capacity}"
        with self._not_empty:
            if not self._not_empty.wait_for(
                lambda: self._n >= n or self._closed, timeout=timeout
            ):
                raise TimeoutError("ReservoirBuffer.get timed out")
            if self._closed and self._n < n:
                raise BufferClosed("ReservoirBuffer is closed")

            idx = self._rng.choice(self._n, size=n, replace=False)
            slot_ids = self._live[idx].copy()
            # Swap-with-tail removal on the 4-byte id array (not the rows).
            keep_tail = np.setdiff1d(
                np.arange(self._n - n, self._n), idx, assume_unique=True
            )
            holes = idx[idx < self._n - n]
            assert len(keep_tail) == len(holes)
            if len(holes):
                self._live[holes] = self._live[keep_tail]
            self._n -= n

        # Heavy gather outside the lock: the sampled slots are neither live nor
        # free here, so producers can't overwrite them and can keep filling.
        out_acts = self.acts[slot_ids]
        out_meta = {name: col[slot_ids] for name, col in self.meta.items()}

        with self._not_full:
            self._free[self._n_free : self._n_free + n] = slot_ids
            self._n_free += n
            self._not_full.notify_all()
        return out_acts, out_meta

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._not_full.notify_all()
            self._not_empty.notify_all()


class _Deadline:
    def __init__(self, timeout: float):
        import time

        self._deadline = time.monotonic() + timeout

    def remaining(self) -> float:
        import time

        return max(0.0, self._deadline - time.monotonic())
