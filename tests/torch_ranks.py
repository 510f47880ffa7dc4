"""Ranks of a multi-process job of the port on the CPU, for
tests/test_torch_parallel.py, test_torch_feature_parallel.py and
test_torch_extract_parallel.py: `spawn` starts `world` processes with
torch.multiprocessing over gloo, each running one of the functions below,
which read their inputs from and write their results to a directory.

Jax-free: the spawned processes import only torch and the port.
"""

import datetime
import json
import pathlib
import socket
import time
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

# How long a collective waits for the other ranks before it fails.
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=60)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, world: int, port: int, out: str, args: tuple) -> None:
    from saev_tpu_torch import parallel

    torch.set_num_threads(1)
    out = pathlib.Path(out)
    try:
        parallel.init_distributed(
            "cpu", rank=rank, world_size=world, init_method=f"tcp://localhost:{port}", timeout=COLLECTIVE_TIMEOUT
        )
        fn(rank, world, out, *args)
    except BaseException:  # noqa: BLE001 - reported to the parent, then the rank exits non-zero
        (out / f"error_rank{rank}.txt").write_text(traceback.format_exc())
        raise SystemExit(1)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def spawn(fn, world: int, out: pathlib.Path, *args, limit: float = 60.0) -> None:
    """Run fn(rank, world, out, *args) in `world` processes over gloo; raise
    if any fails, or if any is still running after `limit` seconds (then
    every rank is killed)."""
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, port, str(out), args)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + limit
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    stalled = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = {r: (out / f"error_rank{r}.txt").read_text() for r in range(world)
              if (out / f"error_rank{r}.txt").exists()}
    if stalled or errors or any(p.exitcode != 0 for p in procs):
        raise AssertionError(
            f"ranks stalled past {limit} s: {stalled}; exit codes {[p.exitcode for p in procs]}; errors: "
            + "".join(f"\n--- rank {r}\n{e}" for r, e in errors.items())
        )


# ---------------------------------------------------------------------------
# The helpers of saev_tpu_torch.parallel
# ---------------------------------------------------------------------------


def helpers_rank(rank: int, world: int, out: pathlib.Path) -> None:
    """make_mesh at sweep 1 and 2, and every collective helper, on small
    values that tell the ranks apart; the results as JSON."""
    from saev_tpu_torch import parallel

    res = {}
    for sweep in (1, 2):
        mesh = parallel.make_mesh(sweep=sweep)
        res[f"mesh{sweep}"] = {
            "shape": mesh.shape, "d": mesh.d, "s": mesh.s,
            "data": None if mesh.data is None else list(mesh.data.ranks),
            "sweep": None if mesh.sweep is None else list(mesh.sweep.ranks),
        }
        # This rank's rows (2 a rank, tagged by rank) gathered over its sweep group.
        rows = torch.full((2, 3), float(rank)) + torch.arange(2.0)[:, None] / 10
        res[f"shard_batch{sweep}"] = parallel.shard_batch(mesh, rows).tolist()
        # A stacked tree of 4 SAEs -> this rank's slice, and back.
        tree = {"w": torch.arange(4 * 3, dtype=torch.float32).reshape(4, 3), "n": torch.tensor(7)}
        local = parallel.shard_sweep(mesh, tree)
        res[f"shard_sweep{sweep}"] = local["w"].tolist()
        host = parallel.to_host(mesh, {"w": local["w"] * (1 + mesh.d), "n": local["n"]})
        res[f"to_host{sweep}"] = {"w": host["w"].tolist(), "n": int(host["n"])}
        # The mean over the data group of two tensors in one buffer.
        a, b = parallel.all_reduce_mean([torch.full((2,), float(rank)), torch.full((1, 2), 10.0 * rank)], mesh.data)
        res[f"mean{sweep}"] = [a.tolist(), b.tolist()]
    res["process"] = [parallel.process_index(), parallel.process_count(), parallel.is_primary()]
    res["global_sum"] = parallel.global_sum(np.asarray([1.5, rank], np.float64)).tolist()
    res["global_min"] = parallel.global_min(np.asarray([rank + 3, 10 - rank], np.int64)).tolist()
    got = parallel.broadcast_from_primary([{"a": np.full((2, 2), rank, np.float32)}, np.asarray(rank + 5)])
    res["broadcast"] = [got[0]["a"].tolist(), int(got[1])]
    parallel.sync()
    (out / f"helpers_rank{rank}.json").write_text(json.dumps(res))


# ---------------------------------------------------------------------------
# The data-parallel step and BatchTopK's threshold
# ---------------------------------------------------------------------------


def _sae_cfg(spec: dict):
    from saev_tpu_torch.nn import modeling

    aux = modeling.AuxK(k_aux=spec["k_aux"])
    act = (modeling.BatchTopK(top_k=spec["k"], aux=aux) if spec["activation"] == "BatchTopK"
           else modeling.TopK(top_k=spec["k"], aux=aux))
    return modeling.SparseAutoencoderConfig(d_model=spec["d_model"], d_sae=spec["d_sae"], activation=act)


def step_rank(rank: int, world: int, out: pathlib.Path, names: list[str]) -> None:
    """For each case in `out/<name>.npz` (a numpy SweepState, its spec,
    batches, prefixes and hyperparameters): the step on this rank's rows of
    each global batch at n_data = world; rank 0 writes the final state and
    each step's stats."""
    from saev_tpu_torch import parallel
    from saev_tpu_torch.framework import train
    from saev_tpu_torch.nn import objectives

    mesh = parallel.make_mesh()
    for name in names:
        spec = json.loads((out / f"{name}.json").read_text())
        data = dict(np.load(out / f"{name}.npz"))
        ts = train.SweepState(
            params={k[2:]: torch.from_numpy(v) for k, v in data.items() if k.startswith("p.")},
            sae_state={k[2:]: torch.from_numpy(v) for k, v in data.items() if k.startswith("s.")},
            obj_state={"toks_since_active": torch.from_numpy(data["toks"])},
            opt_state=None, step=torch.zeros((), dtype=torch.int32),
        )
        ts = ts._replace(opt_state=train._opt_init(spec["optim"], ts.params))
        step = train.make_train_step(
            _sae_cfg(spec), objectives.Matryoshka(n_prefixes=spec["n_prefixes"], dead_threshold_tokens=spec["dead"]),
            n_steps=10, optim=spec["optim"], matmul_precision=spec["precision"],
            aux_enabled=spec["aux_enabled"], aux_subspace_cap=spec["cap"], mesh=mesh,
        )
        hp = {k[3:]: torch.from_numpy(v) for k, v in data.items() if k.startswith("hp.")}
        stats_log = []
        for i in range(spec["n_steps"]):
            xs = np.split(data[f"x{i}"], world)
            ts, stats = step(ts, torch.from_numpy(xs[rank]), torch.from_numpy(data["prefixes"]), hp)
            stats_log.append({k: v.numpy() for k, v in stats.items()})
        if rank == 0:
            flat = {f"p.{k}": v.numpy() for k, v in ts.params.items()}
            flat |= {f"s.{k}": v.numpy() for k, v in ts.sae_state.items()}
            flat["toks"] = ts.obj_state["toks_since_active"].numpy()
            flat |= {f"stats{i}.{k}": v for i, st in enumerate(stats_log) for k, v in st.items()}
            np.savez(out / f"{name}_out.npz", **flat)


def batch_topk_rank(rank: int, world: int, out: pathlib.Path) -> None:
    """`modeling.batch_topk_train` on this rank's rows of `out/h.npy` over
    the data group; each rank writes its f and the moved threshold."""
    from saev_tpu_torch import parallel
    from saev_tpu_torch.nn import modeling

    mesh = parallel.make_mesh()
    spec = json.loads((out / "h.json").read_text())
    h = np.split(np.load(out / "h.npy"), world)[rank]
    f, thr = modeling.batch_topk_train(
        torch.from_numpy(h), spec["k"], spec["momentum"], torch.tensor(spec["threshold"]), mesh.data
    )
    np.savez(out / f"h_out{rank}.npz", f=f.numpy(), threshold=thr.numpy())


# ---------------------------------------------------------------------------
# train(), and worker_fn with a crash and a resume
# ---------------------------------------------------------------------------


def _recording(train, log: dict) -> None:
    """Record, in this process, the cohort `make_saes` returns (before the
    sweep is split) and the rows each train-loop and eval step got from the
    loader and from its sweep group (`shard_batch`)."""
    from saev_tpu_torch import parallel

    real_make, real_shard = train.make_saes, parallel.shard_batch

    def make_saes(*args, **kwargs):
        out = real_make(*args, **kwargs)
        log["init"] = [{k: v.numpy().copy() for k, v in t.items()} for t in out]
        return out

    def shard_batch(mesh, x):
        got = real_shard(mesh, x)
        log.setdefault(log["phase"], []).append((x.numpy().copy(), got.numpy().copy()))
        return got

    train.make_saes, parallel.shard_batch = make_saes, shard_batch


def _save_log(out: pathlib.Path, rank: int, log: dict, what: str) -> None:
    flat = {}
    for phase in ("train", "eval"):
        for i, (local, got) in enumerate(log.get(phase, [])):
            flat[f"{phase}.local{i}"], flat[f"{phase}.gathered{i}"] = local, got
    if "init" in log:
        for name, tree in zip(("params", "sae_state", "obj_state"), log["init"]):
            flat |= {f"init.{name}.{k}": v for k, v in tree.items()}
    np.savez(out / f"{what}_rank{rank}.npz", **flat)


def train_rank(rank: int, world: int, out: pathlib.Path, cfgs) -> None:
    """train.train(cfgs) in a job of `world` processes; each rank writes
    what it recorded, and rank 0 the whole cohort's final state."""
    from saev_tpu_torch import parallel
    from saev_tpu_torch.framework import train

    log = {"phase": "train"}
    _recording(train, log)
    runtimes, run, steps = train.train(cfgs)
    run.finish()
    (rt,) = runtimes
    host = parallel.to_host(rt.mesh, rt.ts, rt.axes)
    _save_log(out, rank, log, "train")
    if rank == 0:
        np.savez(out / "train_final.npz", **{f"p.{k}": v for k, v in host.params.items()}, steps=steps)


class Stop(Exception):
    """Stands in for a crash of every rank at one point of the job."""


def job_rank(rank: int, world: int, out: pathlib.Path, cfgs, stop_at: int) -> None:
    """worker_fn(cfgs) stopped on every rank once the step-`stop_at`
    checkpoint is written, then worker_fn with resume=True. Each rank writes
    what it recorded in each run and how many checkpoint and SAE files it
    wrote; rank 0 the final state."""
    import dataclasses

    from saev_tpu_torch import parallel
    from saev_tpu_torch.framework import checkpoints, train

    writes = {"state": 0, "sae": 0}
    real_to_cpu, real_dump, real_save = checkpoints._to_cpu, train.serialize.dump, checkpoints.save
    real_train, real_eval = train.train, train.evaluate

    depth = [0]

    def to_cpu(state):  # called (and calls itself) where a checkpoint is written, and only there
        writes["state"] += depth[0] == 0
        depth[0] += 1
        try:
            return real_to_cpu(state)
        finally:
            depth[0] -= 1

    def dump(*args, **kwargs):
        writes["sae"] += 1
        return real_dump(*args, **kwargs)

    def save(runs_root, key, step, state, **kwargs):
        path = real_save(runs_root, key, step, state, **kwargs)
        if step == stop_at and "stopped" not in writes:
            writes["stopped"] = step
            raise Stop(step)
        return path

    finals, log = {}, {}

    def spy_train(c):
        log["phase"] = "train"
        finals["train"] = real_train(c)
        return finals["train"]

    def spy_eval(c, r):
        log["phase"] = "eval"
        metrics = real_eval(c, r)
        (out / f"eval_rank{rank}.json").write_text(json.dumps([
            {**{f.name: getattr(m, f.name) for f in dataclasses.fields(m) if not f.name.endswith("values")},
             "freqs": m.freqs.tolist()}
            for m in metrics
        ]))
        return metrics

    checkpoints._to_cpu, train.serialize.dump, checkpoints.save = to_cpu, dump, save
    train.train, train.evaluate = spy_train, spy_eval
    _recording(train, log)
    resumed = [dataclasses.replace(c, resume=True) for c in cfgs]
    for what, run_cfgs in (("crashed", cfgs), ("resumed", resumed)):
        log.clear()
        try:
            ids = train.worker_fn(run_cfgs)
        except Stop:
            ids = None
        _save_log(out, rank, log, what)
    (rt,) = finals["train"][0]
    host = parallel.to_host(rt.mesh, rt.ts, rt.axes)
    (out / f"job_rank{rank}.json").write_text(json.dumps({"writes": writes, "ids": ids}))
    if rank == 0:
        np.savez(out / "job_final.npz", **{f"p.{k}": v for k, v in host.params.items()},
                 **{f"s.{k}": v for k, v in host.sae_state.items()}, step=host.step)


# ---------------------------------------------------------------------------
# Feature-parallel (latent-sharded) training, tests/test_torch_feature_parallel.py
# ---------------------------------------------------------------------------


def _whole_state(data: dict, optim: str):
    from saev_tpu_torch.framework import train

    params = {k[2:]: torch.from_numpy(v) for k, v in data.items() if k.startswith("p.")}
    return train.SweepState(
        params=params,
        sae_state={k[2:]: torch.from_numpy(v) for k, v in data.items() if k.startswith("s.")},
        obj_state={"toks_since_active": torch.from_numpy(data["toks"])},
        opt_state=train._opt_init(optim, params), step=torch.zeros((), dtype=torch.int32),
    )


def feature_step(out: pathlib.Path, name: str, mesh, tag: str) -> None:
    """The step of case `out/<name>.npz` (as `step_rank` reads it) under
    `mesh`: the whole state sharded over its feature axis, this rank's rows
    of each global batch; rank 0 writes the whole final state and each
    step's stats to `out/<name>_<tag>.npz`. A spec with "kernels" runs the
    kernel path's algebra (`matryoshka._use_kernels` patched)."""
    from saev_tpu_torch import parallel
    from saev_tpu_torch.framework import train
    from saev_tpu_torch.nn import objectives
    from saev_tpu_torch.ops import matryoshka

    spec = json.loads((out / f"{name}.json").read_text())
    data = dict(np.load(out / f"{name}.npz"))
    whole = _whole_state(data, spec["optim"])
    axes = parallel.latent_axes(whole, spec["d_sae"])
    ts = parallel.shard_features(mesh, whole, spec["d_sae"])
    real = matryoshka._use_kernels
    if spec.get("kernels"):
        matryoshka._use_kernels = lambda t: True
    try:
        step = train.make_train_step(
            _sae_cfg(spec), objectives.Matryoshka(n_prefixes=spec["n_prefixes"], dead_threshold_tokens=spec["dead"]),
            n_steps=10, optim=spec["optim"], matmul_precision=spec["precision"],
            aux_enabled=spec["aux_enabled"], aux_subspace_cap=spec["cap"], mesh=mesh,
        )
        hp = {k[3:]: torch.from_numpy(v) for k, v in data.items() if k.startswith("hp.")}
        stats_log = []
        world, rank = parallel.process_count(), parallel.process_index()
        for i in range(spec["n_steps"]):
            x = np.split(data[f"x{i}"], world)[rank]
            ts, stats = step(ts, parallel.shard_batch(mesh, torch.from_numpy(x)), torch.from_numpy(data["prefixes"]),
                             hp)
            stats_log.append({k: v.numpy() for k, v in stats.items()})
    finally:
        matryoshka._use_kernels = real
    host = parallel.to_host(mesh, ts, axes)
    if rank == 0:
        flat = {f"p.{k}": v for k, v in host.params.items()}
        flat |= {f"s.{k}": v for k, v in host.sae_state.items()}
        flat["toks"] = host.obj_state["toks_since_active"]
        flat |= {f"stats{i}.{k}": v for i, st in enumerate(stats_log) for k, v in st.items()}
        np.savez(out / f"{name}_{tag}.npz", **flat)


def feature_ops(out: pathlib.Path, mesh) -> None:
    """At feature_parallel = world, on this rank's columns: the whole row's
    k-th largest (plain and masked, and masked over columns split unevenly,
    one rank holding none) and `topk_stats` over the group for each k of
    `out/kth.npz`; `stalest_columns` for each cap; Newton-Schulz on each
    matrix of `out/ns.npz`; the prefix MSE with its gradients, plain and on
    the kernel path's algebra. Each rank writes its
    results to `out/ops_rank<r>.npz`."""
    from saev_tpu_torch import ops, parallel
    from saev_tpu_torch.nn import objectives
    from saev_tpu_torch.ops import matryoshka

    group, rank, world = mesh.feature, parallel.process_index(), parallel.process_count()
    res = {}
    kd = dict(np.load(out / "kth.npz"))
    h, mask = kd["h"], kd["mask"]
    w = h.shape[1] // world
    mine = slice(rank * w, (rank + 1) * w)
    hl, ml = torch.from_numpy(h[:, mine].copy()), torch.from_numpy(mask[mine].copy())
    # Uneven: rank 0 holds the first `split` columns, the others none.
    split = int(kd["split"])
    hu = torch.from_numpy(h[:, :split].copy() if rank == 0 else np.zeros((h.shape[0], 0), np.float32))
    mu = torch.from_numpy(mask[:split].copy() if rank == 0 else np.zeros(0, bool))
    for k in kd["ks"].tolist():
        res[f"kth{k}"] = ops.exact_kth_value(hl, k, group=group).numpy()
        res[f"masked{k}"] = ops.exact_kth_value_masked(hl, ml, k, group=group).numpy()
        if k <= split:
            res[f"uneven{k}"] = ops.exact_kth_value_masked(hu, mu, k, group=group).numpy()
        st = ops.topk_stats(hl.clone().requires_grad_(True), k, group=group)
        res |= {f"stats{k}.{f}": getattr(st, f).detach().float().numpy() for f in st._fields}
    toks = torch.from_numpy(kd["toks"])
    for cap in kd["caps"].tolist():
        res[f"stalest{cap}"] = objectives.stalest_columns(toks[mine], cap, group).numpy()

    from saev_tpu_torch.framework import train

    # Newton-Schulz on this rank's latents of whole matrices, wider and
    # narrower than d_model (the Gram path and the gather path).
    for name, g in dict(np.load(out / "ns.npz")).items():
        axis = -1 if name.startswith("enc") else -2
        n = g.shape[axis] // world
        part = torch.from_numpy(g).narrow(axis, rank * n, n).contiguous()
        res[f"ns.{name}"] = train._newton_schulz(part, feature=group, latent_axis=axis).numpy()

    md = dict(np.load(out / "mse.npz"))
    real = matryoshka._use_kernels
    try:
        for route in ("plain", "kernels"):
            matryoshka._use_kernels = (lambda t: True) if route == "kernels" else real
            for name in ("cuts_a", "cuts_b"):
                w_dec = torch.from_numpy(md["w"][mine].copy()).requires_grad_(True)
                b_dec = torch.from_numpy(md["b"]).requires_grad_(True)
                f = torch.from_numpy(md["f"][:, mine].copy()).requires_grad_(True)
                loss, xhat = matryoshka.prefix_mse(w_dec, b_dec, f, torch.from_numpy(md["x"]),
                                                   torch.from_numpy(md[name]), 64, None, group)
                loss.backward()
                res |= {f"mse.{route}.{name}.{k}": v.detach().float().numpy() for k, v in
                        (("loss", loss), ("xhat", xhat), ("dw", w_dec.grad), ("db", b_dec.grad), ("df", f.grad))}
    finally:
        matryoshka._use_kernels = real
    np.savez(out / f"ops_rank{rank}.npz", **res)


def feature_router(out: pathlib.Path, mesh) -> None:
    """`make_step_router` at feature_parallel = world on the state of
    `out/router.npz`: the variant each rank's router picks at each step,
    by name, to `out/router_rank<r>.json`."""
    from saev_tpu_torch import parallel
    from saev_tpu_torch.framework import train
    from saev_tpu_torch.nn import objectives

    spec = json.loads((out / "router.json").read_text())
    data = dict(np.load(out / "router.npz"))
    cfg = _sae_cfg(spec)
    obj = objectives.Matryoshka(n_prefixes=spec["n_prefixes"], dead_threshold_tokens=spec["dead"])
    router = train.make_step_router(cfg, obj, 10, spec["router_batch"], mesh=mesh)
    names = {id(router.step_fn): "dense", id(router.step_fn_warm): "warm"}
    names |= {id(fn): f"cap{cap}" for cap, fn in router.step_fn_subs}
    ts = parallel.shard_features(mesh, _whole_state(data, "adam"), spec["d_sae"])
    hp = {k[3:]: torch.from_numpy(v) for k, v in data.items() if k.startswith("hp.")}
    world, rank = parallel.process_count(), parallel.process_index()
    picked = []
    for i in range(spec["n_steps"]):
        fn = router.step_fn_at(i)
        picked.append(names[id(fn)])
        x = np.split(data[f"x{i}"], world)[rank]
        ts, stats = fn(ts, parallel.shard_batch(mesh, torch.from_numpy(x)), torch.from_numpy(data["prefixes"]), hp)
        router.record_stats(i, stats)
    (out / f"router_rank{rank}.json").write_text(json.dumps(picked))


def feature_rank2(rank: int, world: int, out: pathlib.Path, names: list[str], cfgs, stop_at: int) -> None:
    """The world-2 battery: each step case at feature_parallel 2, the
    threshold, subspace and prefix-MSE operations, the router, then a
    worker_fn job at feature_parallel 2 (`job_rank`)."""
    from saev_tpu_torch import parallel

    mesh = parallel.make_mesh(feature=2)
    for name in names:
        feature_step(out, name, mesh, "F2")
    feature_ops(out, mesh)
    feature_router(out, mesh)
    job_rank(rank, world, out, cfgs, stop_at)


def feature_rank4(rank: int, world: int, out: pathlib.Path, names: list[str]) -> None:
    """The world-4 battery: each step case at feature_parallel 4 and at data
    2 x feature 2; the meshes' groups and `shard_features`' placement of a
    stacked tree at sweep 2 x feature 2, with its gather back."""
    from saev_tpu_torch import parallel

    res = {}
    for tag, kw in (("F4", dict(feature=4)), ("D2F2", dict(feature=2)), ("S2F2", dict(sweep=2, feature=2))):
        mesh = parallel.make_mesh(**kw)
        res[tag] = {"shape": mesh.shape, "dsf": [mesh.d, mesh.s, mesh.f]}
        res[tag] |= {g: None if getattr(mesh, g) is None else list(getattr(mesh, g).ranks)
                     for g in ("data", "sweep", "feature", "rows")}
        if tag != "S2F2":
            for name in names:
                feature_step(out, name, mesh, tag)
            continue
        tree = {"W_enc": torch.arange(4 * 16 * 32.0).reshape(4, 16, 32), "W_dec": torch.arange(4 * 32 * 16.0).reshape(4, 32, 16),
                "b_enc": torch.arange(4 * 32.0).reshape(4, 32), "b_dec": torch.arange(4 * 16.0).reshape(4, 16),
                "scalar": torch.tensor(3.0)}
        local = parallel.shard_features(mesh, tree, 32)
        res["placed"] = {k: v.tolist() for k, v in local.items()}
        back = parallel.to_host(mesh, local, parallel.latent_axes(tree, 32))
        res["back"] = all(np.array_equal(back[k], tree[k].numpy()) for k in tree)
    (out / f"rank4_{rank}.json").write_text(json.dumps(res))


# ---------------------------------------------------------------------------
# Data-parallel extraction
# ---------------------------------------------------------------------------


class Injected(RuntimeError):
    """Stands in for a failure of one rank's forward."""


def extract_rank(rank: int, world: int, out: pathlib.Path, cases: list[dict]) -> None:
    """Each case's extraction (`worker_fn(**case["kw"], device="cpu")`)
    into out/<name>/saev/shards, with the fake-clip params of
    case["params"] (a pickle) in place of the port's own, and the Bird-MAE
    spec case["bird_spec"] (kwargs of `dataclasses.replace`) as
    Bird-MAE-Base's, where given. Each rank writes its forwards' batch sizes
    to out/<name>_rank<r>.json. Where case["fail_rank"] is this rank, its
    first forward raises `Injected`; in such a case every rank writes the
    error it raised to out/<name>_error<r>.txt and goes on."""
    import dataclasses
    import pickle

    from saev_tpu_torch.data import extract, fake_vit, models
    from saev_tpu_torch.models import bird_mae, vit

    real_make, real_call = fake_vit._make_params, models.Recorder.__call__
    real_spec = bird_mae.PRETRAINED_SPECS["Bird-MAE-Base"]
    for case in cases:
        name, sizes = case["name"], []
        fail = case.get("fail_rank") == rank

        def call(self, batch, **kw):
            if fail:
                raise Injected(f"rank {rank}: injected failure")
            sizes.append(len(batch))
            return real_call(self, batch, **kw)

        models.Recorder.__call__ = call
        if "params" in case:
            params = pickle.loads(pathlib.Path(case["params"]).read_bytes())
            fake_vit._make_params = lambda seed: vit.to_device(params, "cpu")
        if "bird_spec" in case:
            bird_mae.PRETRAINED_SPECS["Bird-MAE-Base"] = dataclasses.replace(real_spec, **case["bird_spec"])
        root = out / name / "saev" / "shards"
        root.mkdir(parents=True, exist_ok=True)
        try:
            extract.worker_fn(**case["kw"], shards_root=root, device="cpu")
        except Exception as err:  # noqa: BLE001 - the failure case's, written for the test
            if "fail_rank" not in case:
                raise
            (out / f"{name}_error{rank}.txt").write_text(f"{type(err).__name__}: {err}")
        finally:
            models.Recorder.__call__, fake_vit._make_params = real_call, real_make
            bird_mae.PRETRAINED_SPECS["Bird-MAE-Base"] = real_spec
        (out / f"{name}_rank{rank}.json").write_text(json.dumps(sizes))
