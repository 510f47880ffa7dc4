"""The port's training job (saev_tpu_torch.framework.train and the modules it
runs) against the JAX package's, on the CPU:

- `make_saes` on one fixed list of batches: W_enc and W_dec bit for bit with
  JAX's at reinit_blend 0.8 and 1.0 (the numpy draws are the same);
- `worker_fn` (train, evaluate, the SAE files) in both packages, each one's
  `ShuffledDataLoader` replaced by the same fixed batches (loader order is
  not deterministic across threads, so the loops are compared on one list of
  batches): two SAEs that differ in lr, AuxK from step 2 of 8. Final params
  to rel-norm 1e-5; every EvalMetrics float to rel 1e-4 (freqs and
  mean_values to rel-norm 1e-4); n_dead and the other counts equal; every
  SAE file reads bit for bit in both packages' `serialize.load`;
- `split_cfgs`, `make_cohorts` and `configs.load_cfgs` on a sweep file give
  the same groups; `Config`'s fields and defaults are JAX's but for `device`;
- `worker_fn` on tiny real shards (the port's `ShardWriter`) trains, keeps
  the last step checkpoint, and writes files JAX's `serialize.load` reads
  bit for bit; a JAX-written file reads bit for bit in the port;
- `cfg_from_header` on the five checkpoint schemas, against JAX's;
- resume after a crash between cohort saves restores the common step, as
  tests/test_checkpoint_resume.py holds the JAX package to.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest

from saev_tpu import configs as jconfigs
from saev_tpu.data import shards as jshards
from saev_tpu.data import shuffled as jshuffled
from saev_tpu.framework import train as jtrain
from saev_tpu.nn import modeling as jmod
from saev_tpu.nn import objectives as jobj
from saev_tpu.nn import serialize as jser
from saev_tpu_torch import configs
from saev_tpu_torch.data import shards, shuffled
from saev_tpu_torch.framework import checkpoints, train
from saev_tpu_torch.nn import modeling, objectives, serialize

D_MODEL, D_SAE, BATCH, TOKENS = 32, 256, 64, 16
PKGS = {
    "jax": dict(train=jtrain, mod=jmod, obj=jobj, shuffled=jshuffled, shards=jshards, ser=jser),
    "torch": dict(train=train, mod=modeling, obj=objectives, shuffled=shuffled, shards=shards, ser=serialize),
}


def rel_norm(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _roots(tmp_path):
    shards_root = tmp_path / "saev" / "shards"
    runs_root = tmp_path / "saev" / "runs"
    shards_root.mkdir(parents=True)
    runs_root.mkdir(parents=True)
    return shards_root, runs_root


def _md(pkg, n_examples):
    return PKGS[pkg]["shards"].Metadata(
        family="clip", ckpt="random", layers=(0,), content_tokens_per_example=TOKENS, cls_token=False,
        d_model=D_MODEL, n_examples=n_examples, max_tokens_per_shard=TOKENS * 8, data="e30=",
        dataset=pathlib.Path("/data/images"),
    )


def _cfgs(pkg, train_dir, val_dir, runs_root, *, n_train=8 * BATCH, **kw):
    p = PKGS[pkg]
    data = dict(layer=0, batch_size=BATCH, n_threads=2, batch_timeout_s=5.0)
    fields = dict(
        train_data=p["shuffled"].Config(shards=train_dir, **data),
        val_data=p["shuffled"].Config(shards=val_dir, **data),
        n_train=n_train, n_val=2 * BATCH,
        sae=p["mod"].SparseAutoencoderConfig(
            d_model=D_MODEL, d_sae=D_SAE,
            activation=p["mod"].TopK(top_k=4, aux=p["mod"].AuxK(k_aux=16)),
        ),
        objective=p["obj"].Matryoshka(n_prefixes=3, dead_threshold_tokens=3 * BATCH),
        n_lr_warmup=2, log_every=4, track=False, runs_root=runs_root, device="cpu", seed=5,
    )
    fields.update(kw)
    base = p["train"].Config(**fields)
    return [base, dataclasses.replace(base, lr=1e-3)]


def _batches(n, seed):
    """Low-rank Gaussian rows with their shard indices."""
    rng = np.random.default_rng(seed)
    basis = rng.normal(size=(8, D_MODEL))
    out = []
    for b in range(n):
        act = (rng.normal(size=(BATCH, 8)) @ basis + 0.1 * rng.normal(size=(BATCH, D_MODEL))).astype(np.float32)
        idx = np.arange(b * BATCH, (b + 1) * BATCH)
        out.append({"act": act, "example_idx": idx // TOKENS, "token_idx": idx % TOKENS})
    return out


class FixedLoader:
    """Stands in for a ShuffledDataLoader: the same batches, in the same
    order, every epoch."""

    drop_last = False

    def __init__(self, cfg, metadata, batches):
        self.cfg, self.metadata, self.batches = cfg, metadata, batches
        self.batch_size = cfg.batch_size
        self.n_samples = len(batches) * cfg.batch_size

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        for b in self.batches:
            yield {k: v.copy() for k, v in b.items()}


@pytest.mark.parametrize("blend", [0.8, 1.0])
def test_make_saes_matches_jax(blend):
    batches = _batches(6, seed=1)
    got = {}
    for pkg, p in PKGS.items():
        cfgs = [dataclasses.replace(c, sae=dataclasses.replace(c.sae, reinit_blend=blend))
                for c in _cfgs(pkg, pathlib.Path("t"), pathlib.Path("v"), pathlib.Path("r"))]
        md = _md(pkg, 64)
        dl = FixedLoader(cfgs[0].train_data, md, batches)
        kw = {"device": "cpu"} if pkg == "torch" else {}
        params, _, obj_state = p["train"].make_saes(cfgs, dl, seed=3, **kw)
        got[pkg] = {k: np.asarray(v) for k, v in params.items()}
        assert np.asarray(obj_state["toks_since_active"]).shape == (2, D_SAE)
    for k in ("W_enc", "W_dec", "b_enc", "b_dec"):
        assert got["torch"][k].dtype == got["jax"][k].dtype == np.float32
        np.testing.assert_array_equal(got["torch"][k].view(np.int32), got["jax"][k].view(np.int32), err_msg=k)
    assert not np.array_equal(got["torch"]["W_dec"][0], got["torch"]["W_dec"][1])


def _spied_worker(pkg, monkeypatch, cfgs, loaders):
    """worker_fn with the loaders replaced, returning (ids, runtimes, eval metrics)."""
    t = PKGS[pkg]["train"]
    seen = {}
    real_train, real_eval = t.train, t.evaluate

    def spy_train(c):
        seen["train"] = real_train(c)
        return seen["train"]

    def spy_eval(c, r):
        seen["eval"] = real_eval(c, r)
        return seen["eval"]

    monkeypatch.setattr(t, "ShuffledDataLoader", lambda cfg: loaders[str(cfg.shards)])
    monkeypatch.setattr(t, "train", spy_train)
    monkeypatch.setattr(t, "evaluate", spy_eval)
    ids = t.worker_fn(cfgs)
    return ids, seen["train"][0], seen["eval"]


def test_worker_fn_matches_jax_on_fixed_batches(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the local run recorder writes under ./.wandb
    train_b, val_b = _batches(10, seed=7), _batches(2, seed=8)
    out = {}
    for pkg in PKGS:
        _, runs_root = _roots(tmp_path / pkg)
        cfgs = _cfgs(pkg, tmp_path / "train", tmp_path / "val", runs_root)
        loaders = {
            str(tmp_path / "train"): FixedLoader(cfgs[0].train_data, _md(pkg, 40), train_b),
            str(tmp_path / "val"): FixedLoader(cfgs[0].val_data, _md(pkg, 8), val_b),
        }
        ids, runtimes, metrics = _spied_worker(pkg, monkeypatch, cfgs, loaders)
        (rt,) = runtimes
        params = {k: np.asarray(v) for k, v in rt.ts.params.items()}
        files = [runs_root / i / "checkpoint" / "sae.pt" for i in ids]
        out[pkg] = (params, metrics, files, int(rt.ts.step))
        monkeypatch.undo()
        monkeypatch.chdir(tmp_path)

    (tp_, tm, tfiles, tstep), (jp, jm, jfiles, jstep) = out["torch"], out["jax"]
    assert tstep == jstep == 8
    for k in jp:
        for i in range(2):
            assert rel_norm(tp_[k][i], jp[k][i]) <= 1e-5, (k, i, rel_norm(tp_[k][i], jp[k][i]))
    for t_m, j_m in zip(tm, jm):
        for f in dataclasses.fields(j_m):
            a, b = getattr(t_m, f.name), getattr(j_m, f.name)
            if isinstance(b, int):
                assert a == b, f.name
            elif isinstance(b, np.ndarray):
                fin = np.isfinite(b)
                np.testing.assert_array_equal(np.isfinite(a), fin, err_msg=f.name)
                assert rel_norm(a[fin], b[fin]) <= 1e-4, f.name
            else:
                assert abs(a - b) <= 1e-4 * abs(b), (f.name, a, b)
    assert tm[0].n_dead == jm[0].n_dead and 0 < tm[0].l0 <= 4 + 1e-6
    # Every SAE file reads bit for bit in both packages.
    for fpath, params_i in [(f, {k: v[i] for k, v in tp_.items()}) for i, f in enumerate(tfiles)] + \
                           [(f, {k: v[i] for k, v in jp.items()}) for i, f in enumerate(jfiles)]:
        jcfg, jparams, _ = jser.load(fpath)
        cfg, params, _ = serialize.load(fpath, device="cpu")
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        for k in params:
            np.testing.assert_array_equal(params[k].numpy().view(np.int32), np.asarray(jparams[k]).view(np.int32))
            np.testing.assert_array_equal(params[k].numpy().view(np.int32), params_i[k].view(np.int32))


SWEEP = """
def make_cfgs():
    out = []
    for lr in [1e-4, 3e-4]:
        for top_k in [4, 8]:
            out.append({"lr": lr, "sae": {"activation": {"top_k": top_k}}})
    out.append({"lr": 1e-3, "n_train": 1024})
    out.append({"lr": 2e-3, "sae": {"d_sae": 512}})
    out.append({"lr": 3e-3, "objective": {"n_prefixes": 5}, "train_data": {"seed": 99}})
    return out
"""


def test_sweep_groups_match_jax(tmp_path):
    path = tmp_path / "sweep.py"
    path.write_text(SWEEP)
    got = {}
    for pkg, p in PKGS.items():
        conf = jconfigs if pkg == "jax" else configs
        base = _cfgs(pkg, tmp_path / "t", tmp_path / "v", tmp_path / "r")[0]
        dcts = conf.load_sweep(path)
        # The base as its own default: no field counts as set on the command line.
        cfgs, errs = conf.load_cfgs(base, default=base, sweep_dcts=dcts)
        assert not errs
        groups = p["train"].split_cfgs(cfgs)

        def key(c):
            return (c.lr, c.seed, c.n_train, c.sae.d_sae, c.sae.activation.top_k, c.objective.n_prefixes,
                    c.train_data.seed, c.val_data.seed)

        got[pkg] = [
            [[key(g[i]) for i in cohort.indices] for cohort in p["train"].make_cohorts(g)] for g in groups
        ]
        got[pkg + "-split"] = [len(sub) for g in groups for sub in p["train"]._split_by_cap(g, 3)]
    assert got["torch"] == got["jax"] and got["torch-split"] == got["jax-split"]
    assert len(got["torch"]) == 3 and sorted(len(c) for c in got["torch"][0]) == [1, 2, 2]


def _field_tree(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _field_tree(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    return obj


def test_config_fields_and_defaults_match_jax():
    got, want = _field_tree(train.Config()), _field_tree(jtrain.Config())
    assert list(got) == list(want)
    assert (got.pop("device"), want.pop("device")) == ("cuda", "tpu")
    # The nested ShuffledConfig and SAE configs compare by their fields too.
    got["train_data"]["shards"] = str(got["train_data"]["shards"])
    want["train_data"]["shards"] = str(want["train_data"]["shards"])
    got["val_data"]["shards"] = str(got["val_data"]["shards"])
    want["val_data"]["shards"] = str(want["val_data"]["shards"])
    assert got == want
    assert train.CANNOT_PARALLELIZE == jtrain.CANNOT_PARALLELIZE


def _write_shards(root, n_examples, seed):
    md = _md("torch", n_examples)
    md.dump(root)
    rng = np.random.default_rng(seed)
    basis = rng.normal(size=(8, D_MODEL))
    with shards.ShardWriter(root, md) as w:
        for start in range(0, n_examples, 4):
            a = rng.normal(size=(4, 1, TOKENS, 8)) @ basis + 0.1 * rng.normal(size=(4, 1, TOKENS, D_MODEL))
            w.write_batch(a.astype(np.float32), start)
    return root / md.hash


def test_worker_fn_on_real_shards_and_cross_load(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    shards_root, runs_root = _roots(tmp_path)
    train_dir, val_dir = _write_shards(shards_root, 48, 0), _write_shards(shards_root, 8, 1)
    cfgs = _cfgs("torch", train_dir, val_dir, runs_root, ckpt_every=4, n_train=12 * BATCH)
    ids = train.worker_fn(cfgs)
    assert len(ids) == 2
    for run_id in ids:
        fpath = runs_root / run_id / "checkpoint" / "sae.pt"
        header = json.loads(fpath.read_bytes().split(b"\n", 1)[0])
        assert header["schema"] == 5
        jcfg, jparams, _ = jser.load(fpath)
        cfg, params, _ = serialize.load(fpath, device="cpu")
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg) == dataclasses.asdict(cfgs[0].sae)
        for k in params:
            np.testing.assert_array_equal(params[k].numpy().view(np.int32), np.asarray(jparams[k]).view(np.int32))
        assert json.loads((runs_root / run_id / "checkpoint" / "config.json").read_text())["device"] == "cpu"
    (group,) = (runs_root / ".train_state").iterdir()
    assert sorted(p.name for p in group.iterdir()) == ["step_00000012"]

    # The reverse: a JAX-written file reads bit for bit in the port.
    rng = np.random.default_rng(2)
    jcfg = jmod.SparseAutoencoderConfig(d_model=D_MODEL, d_sae=D_SAE, activation=jmod.BatchTopK(top_k=3))
    jparams = {"W_enc": rng.normal(size=(D_MODEL, D_SAE)), "b_enc": rng.normal(size=D_SAE),
               "W_dec": rng.normal(size=(D_SAE, D_MODEL)), "b_dec": rng.normal(size=D_MODEL)}
    jparams = {k: v.astype(np.float32) for k, v in jparams.items()}
    jser.dump(tmp_path / "jax.pt", jcfg, jparams, {"threshold": np.float32(0.25)})
    cfg, params, state = serialize.load(tmp_path / "jax.pt", device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for k in params:
        np.testing.assert_array_equal(params[k].numpy().view(np.int32), jparams[k].view(np.int32))
    assert float(state["threshold"]) == 0.25


HEADERS = {
    "pre-schema": {"d_vit": 4, "exp_factor": 2, "sparsity_coeff": 4e-4, "seed": 3},
    "schema-1a": {"schema": 1, "cls": "TopK", "cfg": {"d_model": 4, "d_sae": 8, "top_k": 3, "momentum": 0.1}},
    "schema-1b": {"schema": 1, "cfg": {"d_model": 4, "d_sae": 8, "activation": {
        "cls": "Relu", "params": {"kind": "relu", "sparsity": {"coeff": 0.002}}}}},
    "schema-2": {"schema": 2, "cfg": {"d_model": 4, "d_sae": 8, "activation": {
        "cls": "Relu", "params": {"kind": "relu", "sparsity": {"coeff": 0.001}}}}},
    "schema-3": {"schema": 3, "cfg": {"d_model": 4, "exp_factor": 4, "activation": {
        "cls": "BatchTopK", "params": {"key": "batch-top-k", "top_k": 5, "sparsity": {}}}}},
    "schema-4": {"schema": 4, "cfg": {"d_model": 4, "d_sae": 8, "seed": 1, "n_reinit_samples": 9, "activation": {
        "cls": "TopK", "params": {"key": "top-k", "top_k": 2, "sparsity": {}}}}},
    "schema-5": {"schema": 5, "cfg": {"d_model": 4, "d_sae": 8, "reinit_blend": 0.5, "activation": {
        "cls": "TopK", "params": {"key": "top-k", "top_k": 2, "sparsity": {"cls": "NoSparsity", "params": {
            "key": "no-sparsity"}}, "aux": {"cls": "AuxK", "params": {"key": "auxk", "k_aux": 7, "alpha": 0.5}}}}}},
}


@pytest.mark.parametrize("header", HEADERS.values(), ids=HEADERS.keys())
def test_cfg_from_header_matches_jax(header):
    got, want = serialize.cfg_from_header(header), jser.cfg_from_header(header)
    assert type(got.activation).__name__ == type(want.activation).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_crash_between_cohort_saves_resumes_from_common_step(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    shards_root, runs_root = _roots(tmp_path)
    train_dir = _write_shards(shards_root, 16, 0)
    base = _cfgs("torch", train_dir, train_dir, runs_root, ckpt_every=4, n_train=320, n_lr_warmup=2)[0]
    base = dataclasses.replace(base, train_data=dataclasses.replace(base.train_data, batch_size=32))
    # A second cohort: top_k splits cohorts, not training groups.
    cfgs = [base, dataclasses.replace(base, sae=dataclasses.replace(base.sae, activation=modeling.TopK(top_k=8)))]
    assert len(train.make_cohorts(cfgs)) == 2

    real_save = checkpoints.save
    calls = {"n": 0}

    def crashing_save(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 4:  # step 8: after cohort 0's save, before cohort 1's
            raise RuntimeError("simulated preemption between cohort saves")
        return real_save(*args, **kwargs)

    monkeypatch.setattr(checkpoints, "save", crashing_save)
    with pytest.raises(RuntimeError, match="simulated preemption"):
        train.train(cfgs)
    monkeypatch.setattr(checkpoints, "save", real_save)

    state_root = runs_root / ".train_state"
    groups = sorted(p.name for p in state_root.iterdir())
    steps_per_group = {g: [int(p.name.split("_")[1]) for p in sorted((state_root / g).iterdir())] for g in groups}
    assert sorted(map(tuple, steps_per_group.values())) == [(4,), (4, 8)]

    restore_steps = []
    real_restore = checkpoints.restore

    def spy_restore(root, gk, step, template):
        restore_steps.append(step)
        return real_restore(root, gk, step, template)

    monkeypatch.setattr(checkpoints, "restore", spy_restore)
    runtimes, run, steps = train.train([dataclasses.replace(c, resume=True) for c in cfgs])
    run.finish()
    assert restore_steps == [4, 4], restore_steps
    # 11 batches in all (BatchLimiter's partial-epoch drift) less the 4 done.
    assert steps in (10, 11), steps
    assert all(int(rt.ts.step) == steps for rt in runtimes)
    for g in groups:
        assert [int(p.name.split("_")[1]) for p in (state_root / g).iterdir()] == [8]


def test_multi_gpu_options_raise(tmp_path):
    base = _cfgs("torch", tmp_path, tmp_path, tmp_path)[0]
    for bad in (dict(sweep_parallel=2), dict(feature_parallel=2),
                dict(train_data=dataclasses.replace(base.train_data, world=2))):
        with pytest.raises(NotImplementedError, match="item 9"):
            train.train([dataclasses.replace(base, **bad)])


def test_prefetch_to_device_fetches_ahead_in_a_thread():
    """The loop's batch fetcher: batches in order, each array wrapped without
    a copy on the CPU; a source's exception raised in the caller; a caller
    that stops early closes the source (its loader shuts down)."""
    import threading
    import time

    from saev_tpu_torch import parallel

    batches = _batches(5, seed=4)
    threads = []

    def source(fail_at=None):
        threads.append(threading.current_thread())
        for i, b in enumerate(batches):
            if i == fail_at:
                raise RuntimeError("loader crashed")
            yield b

    got = list(parallel.prefetch_to_device(source(), "cpu"))
    assert [b["example_idx"][0] for _, b in got] == [b["example_idx"][0] for b in batches]
    assert all(np.shares_memory(x.numpy(), b["act"]) for x, b in got)
    assert threads[-1] is not threading.current_thread()

    with pytest.raises(RuntimeError, match="loader crashed"):
        list(parallel.prefetch_to_device(source(fail_at=3), "cpu"))

    closed = threading.Event()

    def endless():
        try:
            while True:
                yield batches[0]
        finally:
            closed.set()

    it = parallel.prefetch_to_device(endless(), "cpu", depth=2)
    next(it)
    it.close()
    deadline = time.monotonic() + 5
    while not closed.is_set() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert closed.is_set()
