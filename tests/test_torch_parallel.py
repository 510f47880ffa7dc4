"""Multi-GPU training of the port (saev_tpu_torch.parallel and the
framework's multi-process paths) on the CPU, against the JAX package.

Ranks are processes spawned with torch.multiprocessing over gloo
(tests/torch_ranks.py); each spawn joins its ranks within a limit of its own
and fails, killing them, when one stalls; each collective waits at most 60 s.
The JAX side runs in this process on the 8 virtual CPU devices of
tests/conftest.py, on a 2-device mesh (`saev_tpu.parallel.make_mesh(
n_devices=2, ...)`); both packages take the same numpy inputs.

- world 1: `make_mesh` and every helper are the identity, with no process
  group; `_partitioned_data_cfg` and the divisibility checks; the
  checkpoint key is the same in processes with other hash seeds.
- worlds 2 and 4: the mesh's groups, broadcast, global_sum / global_min,
  to_host, shard_batch, shard_sweep and the one-buffer mean.
- the data-parallel step at world 2 (d_model 64, d_sae 2048, batch 64, TopK
  8, AuxK 64 with dead latents planted, Matryoshka 4, two SAEs, 3 steps)
  against the JAX step on a 2-device data mesh: Adam at "default" (the
  fused path) in warm-up and with AuxK dense and in the subspace, Muon,
  Adam at "highest" (the decode path) and BatchTopK. Tolerances are the single-process step
  test's (tests/test_torch_train_step.py): every stat to rel 1e-4 at every
  step, params to atol 1e-5, counters exact; BatchTopK's threshold to rel
  1e-6. Measured on a CPU: params differ by at most 4.5e-8 (5.9e-6 in
  the warm-up case), stats by 1.4e-6 relative, the threshold by 8.3e-8.
- BatchTopK's threshold and mask at world 2 with the large rows on one rank,
  against JAX's global view: the mask exact, values and threshold bit for
  bit.
- `train()` at sweep_parallel 2 over 2 processes through the shuffled
  loader (four SAEs, two a rank): every rank trains on the whole global
  batch; the params equal bit for bit the world-1 run of the cohort on the
  recorded global batches from the recorded initialization, and the JAX
  package's train() on a 2-device sweep mesh to rel-norm 1e-5.
- a two-rank data-parallel `worker_fn` job stopped after its step-4
  checkpoint and resumed: rank 0 writes every checkpoint and each SAE file
  once, rank 1 none; its trajectory equals one process replaying the
  recorded global batches (params to rel-norm 1e-5, eval metrics to rel
  1e-5, counts equal).
"""

import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_ranks

from saev_tpu import parallel as jparallel
from saev_tpu.data import shards as jshards
from saev_tpu.framework import train as jtrain
from saev_tpu.nn import modeling as jmod
from saev_tpu.nn import objectives as jobj
from saev_tpu_torch import parallel
from saev_tpu_torch.data import ShuffledConfig, shards, shuffled
from saev_tpu_torch.framework import train
from saev_tpu_torch.nn import modeling, objectives, serialize


def rel_norm(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# World 1 and the setup checks
# ---------------------------------------------------------------------------


def test_make_mesh_shapes_and_world1_identities():
    mesh = parallel.make_mesh()
    assert mesh.shape == {"data": 1, "sweep": 1, "feature": 1}
    assert (mesh.d, mesh.s, mesh.data, mesh.sweep) == (0, 0, None, None)
    with pytest.raises(ValueError, match="does not divide"):
        parallel.make_mesh(sweep=2)
    with pytest.raises(ValueError, match="sweep_parallel=1 x feature_parallel=2 does not divide the job's 1 process"):
        parallel.make_mesh(feature=2)

    v = np.asarray([1.5, 2.5])
    np.testing.assert_array_equal(parallel.global_sum(v), v)
    np.testing.assert_array_equal(parallel.global_min(v), v)
    tree = {"a": np.ones(3), "b": 2}
    assert parallel.broadcast_from_primary(tree) is tree
    host = parallel.to_host(mesh, {"x": torch.arange(4), "n": torch.tensor(3)})
    np.testing.assert_array_equal(host["x"], np.arange(4))
    assert int(host["n"]) == 3
    x = torch.randn(4, 3)
    assert parallel.shard_batch(mesh, x) is x
    assert parallel.gather_rows(x, None) is x
    assert parallel.shard_sweep(mesh, {"x": x})["x"] is x
    assert parallel.all_reduce_mean([x], None)[0] is x
    assert parallel.all_reduce(x, "max", None) is x
    parallel.sync()
    assert parallel.is_primary() and parallel.process_count() == 1 and parallel.process_index() == 0
    assert parallel.world_group() is None


def test_partitioned_data_cfg(monkeypatch):
    """Identity single-process; 1/world rows, the rank's slice and drop_last
    in a job of 4; a batch that does not divide over the processes, and a
    config that sets the partition itself, raise (as test_multihost.py
    holds the JAX package's)."""
    cfg = ShuffledConfig(shards=pathlib.Path("s"), layer=0, batch_size=32)
    assert train._partitioned_data_cfg(cfg, "train") is cfg
    monkeypatch.setattr(parallel, "process_count", lambda: 4)
    monkeypatch.setattr(parallel, "process_index", lambda: 2)
    out = train._partitioned_data_cfg(cfg, "train")
    assert (out.batch_size, out.rank, out.world, out.drop_last) == (8, 2, 4, True)
    with pytest.raises(ValueError, match="does not divide"):
        train._partitioned_data_cfg(dataclasses.replace(cfg, batch_size=30), "train")
    with pytest.raises(ValueError, match="the trainer partitions the loader"):
        train._partitioned_data_cfg(dataclasses.replace(cfg, rank=1, world=2), "val")


def test_check_full_mesh_rejects_indivisible_batch():
    """The data axis must divide the global batch: every process takes part
    (the JAX package shrinks its mesh instead, and refuses a partial one
    multi-host)."""
    mesh = parallel.Mesh(n_data=4, n_sweep=2, d=0, s=0, data=None, sweep=None)
    train._check_full_mesh(mesh, 64)
    with pytest.raises(ValueError, match="multiple of the data-axis extent 4"):
        train._check_full_mesh(mesh, 90)
    train._check_full_mesh(parallel.make_mesh(), 90)


def test_group_key_is_the_same_in_every_process():
    """The checkpoint directory's key, computed in processes with other hash
    seeds (every rank of a job, or a job restarted to resume), is one key."""
    import os
    import subprocess
    import sys

    code = "from saev_tpu_torch.framework import train; print(train._group_key(train.Config()))"
    root = pathlib.Path(__file__).resolve().parents[1]
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE, text=True, cwd=root,
                              env={**os.environ, "PYTHONHASHSEED": seed}) for seed in ("1", "2")]
    keys = {p.communicate(timeout=60)[0].strip() for p in procs}
    assert all(p.returncode == 0 for p in procs)
    assert keys == {train._group_key(train.Config())}


# ---------------------------------------------------------------------------
# The helpers across processes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_helpers_across_processes(tmp_path, world):
    torch_ranks.spawn(torch_ranks.helpers_rank, world, tmp_path)
    full = np.arange(12.0).reshape(4, 3)
    for rank in range(world):
        res = json.loads((tmp_path / f"helpers_rank{rank}.json").read_text())
        rows = lambda r: [[r + i / 10] * 3 for i in range(2)]  # noqa: E731 - rank r's tagged rows
        # Sweep 1: every rank on the data axis.
        assert res["mesh1"] == {"shape": {"data": world, "sweep": 1, "feature": 1}, "d": rank, "s": 0,
                                "data": list(range(world)), "sweep": None}
        np.testing.assert_allclose(res["shard_batch1"], rows(rank))
        assert res["shard_sweep1"] == full.tolist()
        assert res["to_host1"] == {"w": (full * (1 + rank)).tolist(), "n": 7}
        np.testing.assert_allclose(res["mean1"][0], [(world - 1) / 2] * 2)
        np.testing.assert_allclose(res["mean1"][1], [[10 * (world - 1) / 2] * 2])
        # Sweep 2: rank = d * 2 + s.
        d, s = divmod(rank, 2)
        n_data = world // 2
        assert res["mesh2"] == {"shape": {"data": n_data, "sweep": 2, "feature": 1}, "d": d, "s": s,
                                "data": None if n_data == 1 else [dd * 2 + s for dd in range(n_data)],
                                "sweep": [2 * d, 2 * d + 1]}
        np.testing.assert_allclose(res["shard_batch2"], rows(2 * d) + rows(2 * d + 1))
        assert res["shard_sweep2"] == full[2 * s : 2 * s + 2].tolist()
        assert res["to_host2"] == {"w": (full * (1 + d)).tolist(), "n": 7}
        members = [dd * 2 + s for dd in range(n_data)]
        np.testing.assert_allclose(res["mean2"][0], [np.mean(members)] * 2)
        np.testing.assert_allclose(res["mean2"][1], [[10 * np.mean(members)] * 2])
        assert res["process"] == [rank, world, rank == 0]
        assert res["global_sum"] == [1.5 * world, sum(range(world))]
        assert res["global_min"] == [3, 10 - (world - 1)]
        assert res["broadcast"] == [[[0.0, 0.0], [0.0, 0.0]], 5]


# ---------------------------------------------------------------------------
# The data-parallel step against the JAX step on a 2-device data mesh
# ---------------------------------------------------------------------------

D_MODEL, D_SAE, BATCH, K, J, N_SAE, N_STEPS, K_AUX = 64, 2048, 64, 8, 4, 2, 3, 64
N_DEAD = (100, 60)
STEP_CASES = {
    # name: (optim, precision, activation, aux_enabled, aux_subspace_cap)
    "adam-dense": ("adam", "default", "TopK", True, None),
    "adam-subspace": ("adam", "default", "TopK", True, 128),
    "adam-warm": ("adam", "default", "TopK", False, None),
    "muon-dense": ("muon", "default", "TopK", True, None),
    "adam-highest": ("adam", "highest", "TopK", True, None),
    "batchtopk-subspace": ("adam", "default", "BatchTopK", True, 128),
}


def _jax_cfg(activation):
    act = getattr(jmod, activation)(top_k=K, aux=jmod.AuxK(k_aux=K_AUX))
    return jmod.SparseAutoencoderConfig(d_model=D_MODEL, d_sae=D_SAE, activation=act)


def _step_inputs(name: str) -> tuple[dict, dict]:
    """A two-SAE state with dead latents planted as bench.py plants them
    (encoder bias -1e6, counters at 1 << 30), 3 batches, prefixes and
    hyperparameters, from seeds."""
    optim, precision, activation, aux_enabled, cap = STEP_CASES[name]
    jcfg = _jax_cfg(activation)
    inits = [jmod.init(jcfg, key) for key in jax.random.split(jax.random.key(0), N_SAE)]
    rng = np.random.default_rng(sorted(STEP_CASES).index(name))
    data = {f"p.{k}": np.stack([np.asarray(p[k]) for p, _ in inits]) for k in inits[0][0]}
    data |= {f"s.{k}": np.stack([np.asarray(s[k]) for _, s in inits]) for k in inits[0][1]}
    b_enc = (rng.normal(size=(N_SAE, D_SAE)) * 0.05).astype(np.float32)
    toks = np.zeros((N_SAE, D_SAE), np.int32)
    for i, n in enumerate(N_DEAD):
        b_enc[i, :n] = -1e6
        toks[i, :n] = 1 << 30
    data["p.b_enc"], data["toks"] = b_enc, toks
    data |= {f"x{i}": rng.normal(size=(BATCH, D_MODEL)).astype(np.float32) for i in range(N_STEPS)}
    data["prefixes"] = np.stack([jobj.sample_prefixes(D_SAE, J, rng=rng) for _ in range(N_SAE)])
    data |= {
        "hp.lr": np.asarray([1e-3, 3e-3], np.float32), "hp.n_lr_warmup": np.ones(N_SAE, np.float32),
        "hp.grad_clip": np.ones(N_SAE, np.float32), "hp.sparsity_coeff": np.zeros(N_SAE, np.float32),
        "hp.aux_alpha": np.asarray([1 / 32, 1 / 8], np.float32), "hp.momentum": np.asarray([0.1, 0.3], np.float32),
    }
    spec = dict(optim=optim, precision=precision, activation=activation, aux_enabled=aux_enabled, cap=cap,
                k=K, k_aux=K_AUX, d_model=D_MODEL, d_sae=D_SAE, n_prefixes=J, dead=1 << 20, n_steps=N_STEPS)
    return spec, data


BATCH_TOPK = dict(k=4, momentum=0.1, threshold=0.25)


def _batch_topk_h() -> np.ndarray:
    """Rows 0-3, rank 0's, get large values: the global budget k * B takes
    most of its entries there, where a rank-local top-k would not."""
    h = np.random.default_rng(0).normal(size=(32, 64)).astype(np.float32)
    h[:4] += 100.0
    return h


def _battery_rank(rank, world, out, names):
    torch_ranks.step_rank(rank, world, out, names)
    torch_ranks.batch_topk_rank(rank, world, out)


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    """Every step case and BatchTopK's threshold, in one spawn of 2 ranks."""
    out = tmp_path_factory.mktemp("steps")
    for name in STEP_CASES:
        spec, data = _step_inputs(name)
        (out / f"{name}.json").write_text(json.dumps(spec))
        np.savez(out / f"{name}.npz", **data)
    np.save(out / "h.npy", _batch_topk_h())
    (out / "h.json").write_text(json.dumps(BATCH_TOPK))
    torch_ranks.spawn(_battery_rank, 2, out, list(STEP_CASES), limit=120.0)
    return out


@pytest.mark.parametrize("name", STEP_CASES)
def test_data_parallel_step_matches_jax(step_runs, name):
    spec, data = _step_inputs(name)
    got = dict(np.load(step_runs / f"{name}_out.npz"))
    mesh = jparallel.make_mesh(n_devices=2)
    params = {k[2:]: jnp.asarray(v) for k, v in data.items() if k.startswith("p.")}
    init = jtrain._adam_init if spec["optim"] == "adam" else jtrain._muon_init
    ts = jtrain.SweepState(
        params=jparallel.shard_sweep(mesh, params),
        sae_state=jparallel.shard_sweep(mesh, {k[2:]: jnp.asarray(v) for k, v in data.items() if k.startswith("s.")}),
        obj_state=jparallel.shard_sweep(mesh, {"toks_since_active": jnp.asarray(data["toks"])}),
        opt_state=jparallel.shard_sweep(mesh, init(params)),
        step=jnp.zeros((), jnp.int32),
    )
    step = jtrain.make_train_step(
        _jax_cfg(spec["activation"]), jobj.Matryoshka(n_prefixes=J, dead_threshold_tokens=spec["dead"]),
        n_steps=10, optim=spec["optim"], matmul_precision=spec["precision"],
        aux_enabled=spec["aux_enabled"], aux_subspace_cap=spec["cap"],
    )
    hp = {k[3:]: jnp.asarray(v) for k, v in data.items() if k.startswith("hp.")}
    for i in range(N_STEPS):
        x = jparallel.shard_batch(mesh, data[f"x{i}"])
        assert len(x.sharding.device_set) == 2
        ts, stats = step(ts, x, jnp.asarray(data["prefixes"]), hp)
        for k, v in stats.items():
            np.testing.assert_allclose(got[f"stats{i}.{k}"], np.asarray(v), rtol=1e-4, atol=0, err_msg=f"{k} {i}")
    if spec["aux_enabled"]:
        assert got[f"stats{N_STEPS - 1}.n_dead"].tolist() == list(N_DEAD)
    for k, v in ts.params.items():
        np.testing.assert_allclose(got[f"p.{k}"], np.asarray(v), rtol=0, atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(got["toks"], np.asarray(ts.obj_state["toks_since_active"]))
    if spec["activation"] == "BatchTopK":
        np.testing.assert_allclose(got["s.threshold"], np.asarray(ts.sae_state["threshold"]), rtol=1e-6)
        assert not np.array_equal(got["s.threshold"], data["s.threshold"])
    assert float(got[f"stats{N_STEPS - 1}.lr"][0]) > 0


def test_batch_topk_global_threshold_matches_jax(step_runs):
    """The batch-global top-(k B) spans both ranks' rows (JAX's pjit global
    view; tests/test_parallel.py holds the JAX package to it): the mask and
    the moved threshold of the two ranks together equal JAX's on a 2-device
    data mesh, and the port's in one process."""
    h = _batch_topk_h()
    outs = [np.load(step_runs / f"h_out{r}.npz") for r in range(2)]
    f = np.concatenate([o["f"] for o in outs])
    mesh = jparallel.make_mesh(n_devices=2)
    jf, jthr = jax.jit(lambda h: jmod.batch_topk_train(
        h, BATCH_TOPK["k"], BATCH_TOPK["momentum"], jnp.asarray(BATCH_TOPK["threshold"])
    ))(jparallel.shard_batch(mesh, h))
    np.testing.assert_array_equal(f != 0, np.asarray(jf) != 0)
    np.testing.assert_array_equal(f, np.asarray(jf))
    tf, tthr = modeling.batch_topk_train(torch.from_numpy(h), BATCH_TOPK["k"], BATCH_TOPK["momentum"],
                                         torch.tensor(BATCH_TOPK["threshold"]))
    np.testing.assert_array_equal(f, tf.numpy())
    for o in outs:
        assert float(o["threshold"]) == float(jthr) == float(tthr)
    assert (f[:4] != 0).sum() > (f[4:] != 0).sum()


# ---------------------------------------------------------------------------
# train() at sweep_parallel 2, and a two-rank worker_fn job
# ---------------------------------------------------------------------------

JOB_D_MODEL, JOB_D_SAE, JOB_BATCH, TOKENS = 32, 256, 64, 16


def _md(pkg_shards, n_examples):
    return pkg_shards.Metadata(
        family="clip", ckpt="random", layers=(0,), content_tokens_per_example=TOKENS, cls_token=False,
        d_model=JOB_D_MODEL, n_examples=n_examples, max_tokens_per_shard=TOKENS * 8, data="e30=",
        dataset=pathlib.Path("/data/images"),
    )


def _write_shards(root: pathlib.Path, n_examples: int, seed: int) -> pathlib.Path:
    """Low-rank Gaussian rows in shards of 8 examples, with the port's writer."""
    md = _md(shards, n_examples)
    md.dump(root)
    rng = np.random.default_rng(seed)
    basis = rng.normal(size=(8, JOB_D_MODEL))
    with shards.ShardWriter(root, md) as w:
        for start in range(0, n_examples, 4):
            a = rng.normal(size=(4, 1, TOKENS, 8)) @ basis + 0.1 * rng.normal(size=(4, 1, TOKENS, JOB_D_MODEL))
            w.write_batch(a.astype(np.float32), start)
    return root / md.hash


def _job_cfgs(pkg_train, pkg_mod, pkg_obj, pkg_shuffled, train_dir, val_dir, runs_root, n_sae, **kw):
    data = dict(layer=0, batch_size=JOB_BATCH, n_threads=2, batch_timeout_s=10.0)
    base = pkg_train.Config(
        train_data=pkg_shuffled.Config(shards=train_dir, **data),
        val_data=pkg_shuffled.Config(shards=val_dir, **data),
        n_train=8 * JOB_BATCH, n_val=2 * JOB_BATCH,
        sae=pkg_mod.SparseAutoencoderConfig(
            d_model=JOB_D_MODEL, d_sae=JOB_D_SAE, activation=pkg_mod.TopK(top_k=4, aux=pkg_mod.AuxK(k_aux=16)),
        ),
        objective=pkg_obj.Matryoshka(n_prefixes=3, dead_threshold_tokens=3 * JOB_BATCH),
        n_lr_warmup=2, log_every=4, track=False, runs_root=runs_root, device="cpu", seed=5, **kw,
    )
    return [dataclasses.replace(base, lr=lr) for lr in (4e-4, 1e-3, 3e-3, 1e-4)[:n_sae]]


class FixedLoader:
    """Stands in for a ShuffledDataLoader: the given global batches, in
    order, every epoch."""

    drop_last = False

    def __init__(self, cfg, metadata, acts: list[np.ndarray]):
        self.cfg, self.metadata, self.batch_size = cfg, metadata, cfg.batch_size
        self.batches = [
            {"act": a, "example_idx": np.arange(len(a)) % metadata.n_examples, "token_idx": np.arange(len(a)) % TOKENS}
            for a in acts
        ]
        self.n_samples = len(acts) * cfg.batch_size

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        for b in self.batches:
            yield {k: v.copy() for k, v in b.items()}


def _global_batches(logs: list[dict], phase: str) -> list[np.ndarray]:
    """The rows of each step in rank order, from each rank's record."""
    n = sum(k.startswith(f"{phase}.local") for k in logs[0])
    return [np.concatenate([log[f"{phase}.local{i}"] for log in logs]) for i in range(n)]


def test_train_sweep_parallel_matches_world1_and_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the local run recorder writes under ./.wandb
    shards_root, runs_root = tmp_path / "saev" / "shards", tmp_path / "saev" / "runs"
    shards_root.mkdir(parents=True)
    runs_root.mkdir(parents=True)
    train_dir = _write_shards(shards_root, 48, 0)
    cfgs = _job_cfgs(train, modeling, objectives, shuffled, train_dir, train_dir, runs_root, 4, sweep_parallel=2)
    out = tmp_path / "out"
    out.mkdir()
    torch_ranks.spawn(torch_ranks.train_rank, 2, out, cfgs, limit=120.0)

    logs = [dict(np.load(out / f"train_rank{r}.npz")) for r in range(2)]
    batches = _global_batches(logs, "train")
    assert len(batches) == 8 and batches[0].shape == (JOB_BATCH, JOB_D_MODEL)
    for log in logs:  # each rank trained on the whole global batch
        for i, x in enumerate(batches):
            np.testing.assert_array_equal(log[f"train.gathered{i}"], x)
    np.testing.assert_array_equal(logs[0]["init.params.W_dec"], logs[1]["init.params.W_dec"])
    final = dict(np.load(out / "train_final.npz"))
    assert int(final["steps"]) == 8
    init = [{k.split(".", 2)[2]: v for k, v in logs[0].items() if k.startswith(f"init.{n}.")}
            for n in ("params", "sae_state", "obj_state")]

    # The world-1 run of the cohort on the same batches, from the same init.
    md = _md(shards, 48)
    monkeypatch.setattr(train, "ShuffledDataLoader", lambda cfg: FixedLoader(cfg, md, batches))
    monkeypatch.setattr(train, "make_saes", lambda *a, **k: tuple(
        {n: torch.from_numpy(v.copy()) for n, v in t.items()} for t in init))
    runtimes, run, steps = train.train([dataclasses.replace(c, sweep_parallel=1) for c in cfgs])
    run.finish()
    for k, v in runtimes[0].ts.params.items():
        np.testing.assert_array_equal(final[f"p.{k}"], v.numpy(), err_msg=k)

    # The JAX package's train() on a 2-device sweep mesh.
    from saev_tpu.data import shuffled as jshuffled

    jcfgs = _job_cfgs(jtrain, jmod, jobj, jshuffled, train_dir, train_dir, runs_root, 4, sweep_parallel=2)
    jmd = _md(jshards, 48)
    monkeypatch.setattr(jtrain, "ShuffledDataLoader", lambda cfg: FixedLoader(cfg, jmd, batches))
    monkeypatch.setattr(jtrain, "make_saes", lambda *a, **k: tuple(
        {n: jnp.asarray(v) for n, v in t.items()} for t in init))
    monkeypatch.setattr(jtrain, "_device_mesh", lambda bsz, sweep=1, feature=1: jparallel.make_mesh(
        n_devices=2, sweep=sweep, feature=feature))
    jruntimes, jrun, jsteps = jtrain.train(jcfgs)
    jrun.finish()
    assert jsteps == 8
    w = jruntimes[0].ts.params["W_dec"]
    assert w.sharding.spec[0] == jparallel.SWEEP_AXIS and len(w.sharding.device_set) == 2
    for k, v in jruntimes[0].ts.params.items():
        for i in range(4):
            assert rel_norm(final[f"p.{k}"][i], np.asarray(v)[i]) <= 1e-5, (k, i)


def test_two_rank_worker_fn_checkpoints_resumes_and_matches_replay(tmp_path, monkeypatch):
    """A data-parallel job of 2 processes (global batch 64, 32 a rank from
    each one's half of the shards), checkpoints every 2 steps, stopped on
    every rank once the step-4 checkpoint is written, then resumed to step
    8, evaluated and written."""
    monkeypatch.chdir(tmp_path)
    shards_root, runs_root = tmp_path / "saev" / "shards", tmp_path / "saev" / "runs"
    shards_root.mkdir(parents=True)
    runs_root.mkdir(parents=True)
    train_dir, val_dir = _write_shards(shards_root, 48, 0), _write_shards(shards_root, 16, 1)
    cfgs = _job_cfgs(train, modeling, objectives, shuffled, train_dir, val_dir, runs_root, 2, ckpt_every=2)
    out = tmp_path / "out"
    out.mkdir()
    torch_ranks.spawn(torch_ranks.job_rank, 2, out, cfgs, 4, limit=120.0)

    # Rank 0 wrote the checkpoints (steps 2 and 4, then 6 and 8) and each SAE
    # file once; rank 1 wrote nothing. The last step alone is left.
    ranks = [json.loads((out / f"job_rank{r}.json").read_text()) for r in range(2)]
    assert ranks[0]["writes"] == {"state": 4, "sae": 2, "stopped": 4}
    assert ranks[1]["writes"] == {"state": 0, "sae": 0, "stopped": 4}
    ids = ranks[0]["ids"]
    assert len(ids) == 2 and ranks[1]["ids"] == []
    (group,) = (runs_root / ".train_state").iterdir()
    assert sorted(p.name for p in group.iterdir()) == ["step_00000008"]
    final = dict(np.load(out / "job_final.npz"))
    assert int(final["step"]) == 8
    for i, run_id in enumerate(ids):
        cfg, params, _ = serialize.load(runs_root / run_id / "checkpoint" / "sae.pt", device="cpu")
        assert dataclasses.asdict(cfg) == dataclasses.asdict(cfgs[i].sae)
        for k, v in params.items():
            np.testing.assert_array_equal(v.numpy(), final[f"p.{k}"][i], err_msg=k)

    # One process replays the recorded global batches: 4 steps from the
    # recorded init, then 4 from there with a fresh router and prefix
    # generator, as the resumed job starts them.
    crashed = [dict(np.load(out / f"crashed_rank{r}.npz")) for r in range(2)]
    resumed = [dict(np.load(out / f"resumed_rank{r}.npz")) for r in range(2)]
    c0 = cfgs[0]
    init = {n: {k.split(".", 2)[2]: torch.from_numpy(v) for k, v in crashed[0].items() if k.startswith(f"init.{n}.")}
            for n in ("params", "sae_state", "obj_state")}
    ts = train.SweepState(init["params"], init["sae_state"], init["obj_state"],
                          train._opt_init(c0.optim, init["params"]), torch.zeros((), dtype=torch.int32))
    hp = {k: torch.from_numpy(v) for k, v in train._hp_arrays(cfgs).items()}
    for start, logs in ((0, crashed), (4, resumed)):
        router = train.make_step_router(c0.sae, c0.objective, 8, JOB_BATCH, c0.optim, c0.matmul_precision)
        rng = np.random.default_rng(c0.seed + 1000)
        for i, x in enumerate(_global_batches(logs, "train")):
            prefixes = torch.from_numpy(np.stack([
                objectives.sample_prefixes(JOB_D_SAE, 3, rng=rng) for _ in cfgs]))
            ts, stats = router.step_fn_at(start + i)(ts, torch.from_numpy(x), prefixes, hp)
            router.record_stats(start + i, stats)
        assert int(ts.step) == start + 4
    for k, v in ts.params.items():
        for i in range(2):
            assert rel_norm(final[f"p.{k}"][i], v[i].numpy()) <= 1e-5, (k, i, rel_norm(final[f"p.{k}"][i], v[i]))

    # Eval over both ranks' val partitions equals one process's eval of the
    # replayed params on the same rows.
    got = json.loads((out / "eval_rank0.json").read_text())
    val = _global_batches(resumed, "eval")
    assert len(val) == 2
    monkeypatch.setattr(train, "ShuffledDataLoader", lambda cfg: FixedLoader(cfg, _md(shards, 16), val))
    cohort = train.make_cohorts(cfgs)[0]
    rt = train._CohortRuntime(cohort=cohort, ts=ts, router=None, metrics_fn=None, hp=hp, prefix_rng=rng,
                              mesh=parallel.make_mesh())
    want = train.evaluate(cfgs, [rt])
    for g, w in zip(got, want):
        for f in ("l0", "l1", "mse", "normalized_mse", "sse_sae", "sse_baseline"):
            assert abs(g[f] - getattr(w, f)) <= 1e-5 * abs(getattr(w, f)), (f, g[f], getattr(w, f))
        for f in ("n_dead", "n_almost_dead", "n_dense"):
            assert g[f] == getattr(w, f), f
        assert rel_norm(g["freqs"], w.freqs) <= 1e-5
