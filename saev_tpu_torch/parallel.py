"""Multi-GPU training over torch.distributed, one process a card, and the
host-to-device transfer of the train loop (counterpart of
saev_tpu/parallel/__init__.py).

The processes form a 3-D grid in the JAX package's axis order, the feature
axis innermost: rank = (d * n_sweep + s) * n_feature + f, with d the data
index, s the sweep index and f the feature index (`make_mesh`). Every process
loads global_batch / world rows from its own shard partition; the global
batch of a step is those slices in rank order.

- `rows`: the ranks with the same d (every sweep and feature index) form a
  rows group, which all-gathers its members' rows (`shard_batch`), so that
  every rank of data index d computes on the same global_batch / n_data
  rows.
- `sweep`: the ranks with the same d and f form a sweep group. Each owns
  n_sae / n_sweep whole SAEs (`shard_sweep`).
- `feature`: the ranks with the same d and s form a feature group. They own
  the same SAEs, each the contiguous latents [f * S / F, (f + 1) * S / F) of
  every leaf with a latent dim (`shard_features`: W_enc's columns, W_dec's
  rows, b_enc, the dead-latent counters and the optimizer moments that
  mirror them); b_dec and scalars are whole on every member. The train step
  combines what spans the latents over the group: the exact TopK threshold
  of a whole row, the partial reconstructions, the row sums, the dead
  counts, the gradient's norm and Muon's Gram matrices.
- `data`: the ranks with the same s and f form a data group. They own the
  same SAEs (and the same latents of them), and all-reduce their gradients
  and the statistics that span the batch (BatchTopK's threshold, the
  dead-latent counters, max|x|).

The JAX package keeps its sweep and feature axes inside one process (its
`make_mesh` refuses ones that cross processes); here they cross processes by
design, and the groups' collectives keep the same semantics.

Extraction (`data/extract.py`) runs one process a card too, with no mesh:
it splits the examples into the one-process run's batches
(`helpers.batched_idx`) and deals them round-robin (`batch_spans`: rank r
runs batches r, r + W, ...), so that every forward sees the rows and the
shape it sees in one process. Rank 0 writes metadata.json and creates every
acts file at full size, each rank writes its batches' rows at their global
offsets, and rank 0 writes shards.json after the last of them
(`data/shards.py`'s `create_files`, `RowWriter`, `finish`).

Host-side effects (run dirs, the run recorder, checkpoint and SAE files)
happen on rank 0 (`is_primary`), from whole arrays (`to_host` gathers the
latents and the sweep), and host-accumulated statistics cross processes by
`global_sum` / `global_min`. At world 1 every helper is the identity and
needs no process group.

Backends are explicit: "nccl" for CUDA, "gloo" for the CPU; gloo over CUDA
tensors (two ranks on one card, which NCCL refuses) only where the caller
passes backend="gloo". Both backends take the collectives used here
(all_reduce, broadcast, all_gather_into_tensor) on CPU and CUDA tensors.
"""

import dataclasses
import datetime
import logging
import os
import queue
import threading
import typing as tp

import numpy as np
import torch
import torch.distributed as dist

from . import helpers

logger = logging.getLogger("parallel")

DATA_AXIS = "data"
SWEEP_AXIS = "sweep"
FEATURE_AXIS = "feature"

# How long a collective may wait for the other ranks before it fails.
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)

_DONE = object()


def init_distributed(
    device: torch.device | str = "cuda",
    *,
    backend: str | None = None,
    rank: int | None = None,
    world_size: int | None = None,
    local_rank: int | None = None,
    init_method: str = "env://",
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> torch.device:
    """Join the job's process group (counterpart of the JAX package's
    `init_distributed`) and return the device this process computes on.

    rank, world_size and local_rank default to torchrun's RANK, WORLD_SIZE
    and LOCAL_RANK (0, 1 and rank without them); init_method to torchrun's
    env:// rendezvous. On "cuda" without an index the process takes card
    `local_rank`, and sets it as the current device. The backend is "nccl"
    on CUDA and "gloo" on the CPU unless given. At world 1 no group is made.
    """
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    local_rank = int(os.environ.get("LOCAL_RANK", rank)) if local_rank is None else local_rank
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    if world_size > 1:
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world_size, timeout=timeout
        )
        logger.info("torch.distributed initialized: rank %d/%d (%s) on %s.", rank, world_size, backend, device)
    return device


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def batch_spans(n_examples: int, batch_size: int, rank: int | None = None,
                world: int | None = None) -> list[tuple[int, int]]:
    """The (start, end) example spans of this rank's batches: the batches of
    a one-process run (`helpers.batched_idx`) dealt round-robin, rank r
    taking batches r, r + world, r + 2 * world, ... (none where world
    exceeds the batches). rank and world default to this process's."""
    rank = process_index() if rank is None else rank
    world = process_count() if world is None else world
    return list(helpers.batched_idx(n_examples, batch_size))[rank::world]


def is_primary() -> bool:
    """True on the process that owns host-side effects (run dirs, the run
    recorder, checkpoint and SAE files). Always true single-process."""
    return process_index() == 0


@dataclasses.dataclass(frozen=True)
class Group:
    """A process group and its members' global ranks, in group order."""

    pg: tp.Any
    ranks: tuple[int, ...]
    backend: str

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def index(self) -> int:
        """This process's place in the group."""
        return self.ranks.index(process_index())

    def comm_device(self) -> torch.device:
        """Where a host value goes for a collective: NCCL takes only CUDA
        tensors; gloo takes host tensors."""
        return torch.device("cuda", torch.cuda.current_device()) if self.backend == "nccl" else torch.device("cpu")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The (data, sweep, feature) grid of the job's processes and this
    rank's place in it. A group is None where it would hold one process:
    collectives over it are the identity."""

    n_data: int
    n_sweep: int
    d: int
    s: int
    data: Group | None
    sweep: Group | None
    n_feature: int = 1
    f: int = 0
    feature: Group | None = None
    rows: Group | None = None

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.n_data, SWEEP_AXIS: self.n_sweep, FEATURE_AXIS: self.n_feature}


def _group(ranks: list[int], backend: str) -> Group:
    return Group(pg=dist.new_group(ranks), ranks=tuple(ranks), backend=backend)


def make_mesh(*, sweep: int = 1, feature: int = 1) -> Mesh:
    """The (data, sweep, feature) grid over every process of the job:
    n_data = world / (sweep * feature), rank = (d * sweep + s) * feature + f.
    Every process must call it, in the same order as the others (process
    groups are made collectively).

    Raises ValueError when sweep * feature does not divide the world."""
    world = process_count()
    if sweep < 1 or feature < 1 or world % (sweep * feature):
        what = f"sweep_parallel={sweep}" + (f" x feature_parallel={feature}" if feature != 1 else "")
        raise ValueError(f"{what} does not divide the job's {world} process(es)")
    inner = sweep * feature
    n_data = world // inner
    d, rem = divmod(process_index(), inner)
    s, f = divmod(rem, feature)
    if world == 1:
        return Mesh(n_data=1, n_sweep=1, d=0, s=0, data=None, sweep=None)
    backend = dist.get_backend()

    def rank(dd, ss, ff):
        return (dd * sweep + ss) * feature + ff

    # new_group is collective: every rank makes every group, in one order.
    data = {(ss, ff): _group([rank(dd, ss, ff) for dd in range(n_data)], backend)
            for ss in range(sweep) for ff in range(feature)} if n_data > 1 else {}
    swept = {(dd, ff): _group([rank(dd, ss, ff) for ss in range(sweep)], backend)
             for dd in range(n_data) for ff in range(feature)} if sweep > 1 else {}
    feat = {(dd, ss): _group([rank(dd, ss, ff) for ff in range(feature)], backend)
            for dd in range(n_data) for ss in range(sweep)} if feature > 1 else {}
    if sweep > 1 and feature > 1:
        rows = {dd: _group([dd * inner + i for i in range(inner)], backend) for dd in range(n_data)}
    else:
        rows = {dd: (swept or feat).get((dd, 0)) for dd in range(n_data)}
    return Mesh(n_data=n_data, n_sweep=sweep, d=d, s=s, data=data.get((s, f)), sweep=swept.get((d, f)),
                n_feature=feature, f=f, feature=feat.get((d, s)), rows=rows[d])


# ---------------------------------------------------------------------------
# Collectives on device tensors (identity where the group is None)
# ---------------------------------------------------------------------------


def all_reduce(t: torch.Tensor, op: str, group: Group | None) -> torch.Tensor:
    """`t` reduced over the group ("sum", "max" or "min"), in place; returned."""
    if group is not None:
        dist.all_reduce(t, op=getattr(dist.ReduceOp, op.upper()), group=group.pg)
    return t


def all_reduce_mean(tensors: list[torch.Tensor], group: Group | None) -> list[torch.Tensor]:
    """The mean of each tensor over the group, in one collective on one flat
    f32 buffer (the tensors are f32)."""
    if group is None:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce(flat, "sum", group).div_(group.size)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at : at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def gather_rows(t: torch.Tensor, group: Group | None) -> torch.Tensor:
    """The members' `t` (the same shape on each) concatenated along axis 0
    in group order, in one all_gather_into_tensor."""
    if group is None:
        return t
    t = t.contiguous()
    out = torch.empty((group.size * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t, group=group.pg)
    return out


def sum_over(t: torch.Tensor, group: Group | None) -> torch.Tensor:
    """The sum of `t` over the group, out of place, differentiable: its
    backward passes the cotangent through as it is, which is the gradient
    where every member computes the same loss from the sum (a feature
    group's partial reconstructions and row sums)."""
    return t if group is None else _SumOver.apply(t, group)


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce(t.clone(), "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather_cols(t: torch.Tensor, group: Group | None) -> torch.Tensor:
    """The members' (B, n) `t` (the same shape on each) side by side, (B,
    size * n), in group order: one all_gather_into_tensor."""
    if group is None:
        return t
    b = t.shape[0]
    return gather_rows(t, group).reshape(group.size, b, -1).transpose(0, 1).reshape(b, -1)


def shard_batch(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This process's rows (global_batch / world) -> the rows of its data
    index (global_batch / n_data), gathered over its rows group in rank
    order."""
    return gather_rows(x, mesh.rows)


def shard_sweep(mesh: Mesh, tree):
    """This rank's n_sae / n_sweep SAEs of a stacked tree: rows [s * m, (s +
    1) * m) of every leaf with a leading axis (a tensor's copied, so that
    the rest of the stack can be freed); 0-d leaves stay whole."""
    def one(x):
        if not isinstance(x, (torch.Tensor, np.ndarray)) or x.ndim == 0 or mesh.n_sweep == 1:
            return x
        if x.shape[0] % mesh.n_sweep:
            raise ValueError(f"a leading axis of {x.shape[0]} does not divide over sweep_parallel={mesh.n_sweep}")
        m = x.shape[0] // mesh.n_sweep
        part = x[mesh.s * m : (mesh.s + 1) * m]
        return part.clone() if isinstance(part, torch.Tensor) else part

    return _map(one, tree)


def latent_axes(tree, d_sae: int):
    """The latent axis of each leaf of a whole stacked tree (the same
    structure, an int or None a leaf), by the JAX package's structural rule
    (saev_tpu/parallel/__init__.py `shard_features`): the first dim of size
    d_sae beyond the leading stacked axis, one a leaf. Keep d_model !=
    d_sae, or W_enc's d_model dim would be taken for it."""
    def one(x):
        if isinstance(x, (torch.Tensor, np.ndarray)):
            return next((i for i in range(1, x.ndim) if x.shape[i] == d_sae), None)
        return None

    return _map(one, tree)


def shard_features(mesh: Mesh, tree, d_sae: int):
    """This rank's part of a whole stacked tree (counterpart of the JAX
    package's `shard_features`): its SAEs (`shard_sweep`), and of each leaf
    with a latent dim (`latent_axes`) its latents [f * S / F, (f + 1) * S /
    F), copied; other leaves whole. Raises ValueError where F does not
    divide d_sae."""
    n_feature = mesh.n_feature
    tree = shard_sweep(mesh, tree)
    if n_feature == 1:
        return tree
    if d_sae % n_feature:
        raise ValueError(
            f"d_sae={d_sae} is not divisible by the feature axis ({n_feature}); "
            "the latent dimension would silently replicate instead of sharding."
        )
    width = d_sae // n_feature

    def one(x, axis):
        if axis is None:
            return x
        part = x.narrow(axis, mesh.f * width, width) if isinstance(x, torch.Tensor) else \
            np.take(x, np.arange(mesh.f * width, (mesh.f + 1) * width), axis=axis)
        return part.clone() if isinstance(part, torch.Tensor) else part

    return _map2(one, tree, latent_axes(tree, d_sae))


def gather_features(mesh: Mesh, tree, axes):
    """The inverse of `shard_features`' latent slicing (a collective over
    the feature group): each tensor leaf whose `axes` entry is an int is
    all-gathered along that axis, in latent order; other leaves as they
    are."""
    if mesh.feature is None:
        return tree

    def one(x, axis):
        if axis is None or not isinstance(x, torch.Tensor):
            return x
        return gather_rows(x.detach().movedim(axis, 0), mesh.feature).movedim(0, axis)

    return _map2(one, tree, axes)


def to_host(mesh: Mesh, tree, axes=None):
    """A tree of this rank's SAEs -> the whole stack as numpy on every rank
    of its sweep group (a collective there, and over the feature group
    first where `axes`, the tree's `latent_axes`, is given): leaves with a
    leading axis are gathered along it, 0-d leaves are this rank's."""
    if axes is not None:
        tree = gather_features(mesh, tree, axes)

    def one(x):
        if isinstance(x, torch.Tensor):
            x = x.detach()
            if x.ndim:
                x = gather_rows(x, mesh.sweep)
            return x.cpu().numpy()
        return np.asarray(x)

    return _map(one, tree)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _map2(fn, tree, other):
    """fn(leaf, its entry of `other`, a tree of the same structure)."""
    if isinstance(tree, dict):
        return {k: _map2(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map2(fn, v, o) for v, o in zip(tree, other)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map2(fn, v, o) for v, o in zip(tree, other))
    return fn(tree, other)


# ---------------------------------------------------------------------------
# Host values across the job's processes
# ---------------------------------------------------------------------------


def world_group() -> Group | None:
    """Every process of the job as one group; None single-process."""
    if process_count() == 1:
        return None
    return Group(pg=dist.group.WORLD, ranks=tuple(range(process_count())), backend=dist.get_backend())


def _host_reduce(values, op: str) -> np.ndarray:
    arr = np.asarray(values)
    group = world_group()
    if group is None:
        return arr
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(group.comm_device())
    return all_reduce(t, op, group).cpu().numpy()


def global_sum(values) -> np.ndarray:
    """Element-wise sum of a small host array over every process (identity
    single-process): host accumulators each process builds from its rows."""
    return _host_reduce(values, "sum")


def global_min(values) -> np.ndarray:
    """Element-wise min of a small host array over every process (identity
    single-process): a count of collective-bearing steps all agree on."""
    return _host_reduce(values, "min")


def broadcast_from_primary(tree):
    """Rank 0's host tree (numpy leaves) on every process (identity
    single-process): data-dependent initialization read from each rank's
    own partition starts from rank 0's values everywhere."""
    group = world_group()
    if group is None:
        return tree

    def one(x):
        arr = np.asarray(x)
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(group.comm_device())
        dist.broadcast(t, src=0, group=group.pg)
        return t.cpu().numpy().reshape(arr.shape)

    return _map(one, tree)


def sync() -> None:
    """Barrier over every process (no-op single-process): one all_reduce
    whose result the host waits for."""
    _host_reduce(np.zeros(1, np.int32), "sum")


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
