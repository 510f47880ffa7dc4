"""The port's inference (saev_tpu_torch.framework.inference) and the modules it
runs, against the JAX package's, on the CPU, from the same numpy inputs:

- `Metrics`: `from_accumulators(...).to_dict()` equal in both packages, and
  `from_dict` rejects the same corrupted records;
- the ordered loader: both packages' `OrderedDataLoader` read the same shards
  (written by the port's `ShardWriter`) and give the same batches bit for bit,
  with and without labels.bin, drop_last True and False, a batch that divides
  neither the examples nor a shard, several shards; `n_samples`, `len` and
  `make_ordered_config` equal; a producer's error surfaces as RuntimeError in
  both; breaking off an iteration joins the producer thread. Every loader
  here waits at most `batch_timeout_s` (2 s) for a batch and its join at
  most 5 s, so no test can hang;
- `compact_rows` + `csr_block` equal `scipy.sparse.csr_array` of the dense
  batch, index for index and value for value, on batches with negative kept
  values, exact zeros (-0.0 too), empty rows and a masked row;
- `worker_fn` of both packages on the same shards and the same SAE file
  (dumped by the JAX package), for a TopK SAE (as a Matryoshka job trains
  it), a Relu SAE and a BatchTopK SAE: token_acts' indptr, indices and their
  dtypes equal, its data to rel-norm 1e-5; sparsity equal; mean_values
  (where finite) and distributions to rel-norm 1e-5; every metrics.json
  value to rel 1e-5; with `ignore_labels` over a labels.bin too. Also
  `save=False` writing only metrics.json, `need_compute`'s idempotency, and
  a d_model mismatch raising `GuardError`.

The f32 products of torch and XLA differ in their last bits. A latent's
selection could differ between the packages where a pre-activation lies
within that of its cut: the k-th value of its row (TopK), 0 (Relu) or the
threshold (BatchTopK's JumpReLU). Among the 164k pre-activations of a
Gaussian input some do: the closest to 0 lies within a few times the
products' error. So the SAE tests' activations are multiples of 2^-6 in
[-4, 4] and the encoder's weights and biases multiples of 2^-8: every
product is then a multiple of 2^-14 and every sum below 2^10, exact in f32
in any order, and `_assert_exact_encoder` holds both packages' encoder
products to the float64 one bit for bit. Both select the same latents, ties
included, and the index arrays can be held equal; the decoder's products
are not on the grid and are held to rel-norm 1e-5.
"""

import dataclasses
import json
import math
import pathlib
import threading
import time

import numpy as np
import pytest
import scipy.sparse
import torch

from saev_tpu import disk as jdisk
from saev_tpu import metrics as jmetrics
from saev_tpu import nn as jnn
from saev_tpu.data import OrderedConfig as JOrderedConfig
from saev_tpu.data import make_ordered_config as j_make_ordered_config
from saev_tpu.data import ordered as jordered
from saev_tpu.data import shuffled as jshuffled
from saev_tpu.framework import inference as jinference
from saev_tpu.nn import modeling as jmod
from saev_tpu_torch import disk, guards, metrics
from saev_tpu_torch.data import OrderedConfig, make_ordered_config, ordered, shards, shuffled
from saev_tpu_torch.framework import inference

D_MODEL, D_SAE, TOKENS, N_EXAMPLES, K = 32, 256, 16, 40, 4


def rel_norm(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# --- Metrics ---------------------------------------------------------------


def test_metrics_from_accumulators_match_jax():
    kw = dict(sse_recon=12.5, sse_baseline=40.25, n_tokens=640, d_model=32)
    got = metrics.Metrics.from_accumulators(**kw).to_dict()
    want = jmetrics.Metrics.from_accumulators(**kw).to_dict()
    assert got == want and list(got) == list(want)
    assert metrics.Metrics.from_dict(got).to_dict() == got


def _corrupt(name):
    good = jmetrics.Metrics.from_accumulators(sse_recon=3.0, sse_baseline=6.0, n_tokens=10, d_model=4).to_dict()
    bad = dict(good)
    if name == "missing":
        del bad["mse_per_dim"]
    elif name == "bool":
        bad["n_tokens"] = True
    elif name == "float-int":
        bad["d_model"] = 4.0
    elif name == "inconsistent":
        bad["normalized_mse"] = 0.75
    elif name == "negative":
        bad["sse_recon"] = -1.0
    elif name == "non-finite":
        bad["sse_baseline"] = math.inf
    elif name == "n_elements":
        bad["n_elements"] = 41
    elif name == "string":
        bad["mse_per_token"] = "0.3"
    return bad


@pytest.mark.parametrize(
    "name", ["missing", "bool", "float-int", "inconsistent", "negative", "non-finite", "n_elements", "string"]
)
def test_metrics_from_dict_rejects_what_jax_rejects(name):
    bad = _corrupt(name)
    for mod in (jmetrics, metrics):
        with pytest.raises(AssertionError):
            mod.Metrics.from_dict(bad)


# --- the ordered loader ----------------------------------------------------


def _md(n_examples=N_EXAMPLES, examples_per_shard=8, cls=True, d_model=D_MODEL):
    return shards.Metadata(
        family="clip", ckpt="random", layers=(0, 3), content_tokens_per_example=TOKENS, cls_token=cls,
        d_model=d_model, n_examples=n_examples, max_tokens_per_shard=(TOKENS + int(cls)) * 2 * examples_per_shard,
        data="e30=", dataset=pathlib.Path("/data/images"),
    )


def _write_shards(tmp_path, md, *, labels=False, seed=0, name="s", grid=False):
    """Shards of Gaussian rows (the port's ShardWriter), on the 2^-6 grid in
    [-4, 4] with `grid` (module doc), with a labels.bin of uint8 labels in
    0..3 when asked. Returns (shards dir, acts, labels)."""
    root = tmp_path / name / "saev" / "shards"
    root.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    acts = rng.normal(size=(md.n_examples, len(md.layers), md.tokens_per_example, md.d_model))
    if grid:
        acts = np.clip(np.round(acts * 64) / 64, -4, 4)
    acts = acts.astype(np.float32)
    labs = rng.integers(0, 4, size=(md.n_examples, TOKENS)).astype(np.uint8) if labels else None
    md.dump(root)
    with shards.ShardWriter(root, md) as w:
        for start in range(0, md.n_examples, 6):
            w.write_batch(acts[start:start + 6], start, None if labs is None else labs[start:start + 6])
    return root / md.hash, acts, labs


def _batches(dl):
    try:
        return [dict(b) for b in dl]
    finally:
        dl.shutdown()


LOADER_CASES = {
    "labels": dict(labels=True, drop_last=False, batch_size=32),
    "no-labels": dict(labels=False, drop_last=False, batch_size=32),
    "drop-last": dict(labels=True, drop_last=True, batch_size=32),
    "ragged-batch": dict(labels=False, drop_last=False, batch_size=37),  # divides neither 40*16 nor 8*16
    "ragged-drop-last": dict(labels=True, drop_last=True, batch_size=37),
    "one-shard": dict(labels=False, drop_last=False, batch_size=50, examples_per_shard=64),
}


@pytest.mark.parametrize("case", LOADER_CASES.values(), ids=LOADER_CASES.keys())
def test_ordered_loader_matches_jax(tmp_path, case):
    case = dict(case)
    md = _md(examples_per_shard=case.pop("examples_per_shard", 8))
    shards_dir, acts, labs = _write_shards(tmp_path, md, labels=case.pop("labels"))
    assert (md.n_shards > 1) == (md.examples_per_shard < N_EXAMPLES)
    kw = dict(shards=shards_dir, layer=3, batch_timeout_s=2.0, **case)
    dl, jdl = ordered.DataLoader(ordered.Config(**kw)), jordered.DataLoader(jordered.Config(**kw))
    assert (dl.n_samples, len(dl)) == (jdl.n_samples, len(jdl))
    got, want = _batches(dl), _batches(jdl)
    assert len(got) == len(want) == len(dl)
    for b, jb in zip(got, want):
        assert sorted(b) == sorted(jb) == sorted(["act", "example_idx", "token_idx"] + (
            ["token_labels"] if labs is not None else []))
        for key in jb:
            assert b[key].dtype == jb[key].dtype and b[key].shape == jb[key].shape, key
            np.testing.assert_array_equal(b[key].view(np.uint8), jb[key].view(np.uint8), err_msg=key)
    # In global order, each row the shard's value and each label labels.bin's.
    ex = np.concatenate([b["example_idx"] for b in got])
    tok = np.concatenate([b["token_idx"] for b in got])
    assert len(ex) == dl.n_samples
    np.testing.assert_array_equal(ex * TOKENS + tok, np.arange(dl.n_samples))
    rows = np.concatenate([b["act"] for b in got])
    np.testing.assert_array_equal(rows, acts[ex, 1, tok + 1])
    if labs is not None:
        np.testing.assert_array_equal(np.concatenate([b["token_labels"] for b in got]), labs[ex, tok])


def test_make_ordered_config_matches_jax(tmp_path):
    kw = dict(shards=tmp_path, layer=3, batch_size=77, drop_last=True, batch_timeout_s=9.0, buffer_size=5,
              debug=True, log_every_s=3.0, n_threads=7, seed=1)
    for over in ({}, {"batch_size": 12, "drop_last": False}):
        got = make_ordered_config(shuffled.Config(**kw), **over)
        want = j_make_ordered_config(jshuffled.Config(**kw), **over)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(OrderedConfig()) == dataclasses.asdict(JOrderedConfig())


def test_ordered_producer_error_raises_in_both(tmp_path):
    md = _md()
    shards_dir, _, _ = _write_shards(tmp_path, md)
    kw = dict(shards=shards_dir, layer=3, batch_size=32, batch_timeout_s=2.0)
    loaders = [ordered.DataLoader(ordered.Config(**kw)), jordered.DataLoader(jordered.Config(**kw))]
    for f in sorted(shards_dir.glob("acts*.bin")):  # after the loaders' checks: the producer's memmap fails
        with open(f, "r+b") as fd:
            fd.truncate(16)
    for dl in loaders:
        with pytest.raises(RuntimeError, match="producer crashed"):
            _batches(dl)
        assert dl.producer_thread is None


def _producers_alive() -> int:
    return sum(t.name == "ordered-producer" and t.is_alive() for t in threading.enumerate())


def test_ordered_break_joins_the_producer(tmp_path):
    md = _md()
    shards_dir, _, _ = _write_shards(tmp_path, md)
    # A queue of one batch: the producer blocks on its put when the caller stops.
    dl = ordered.DataLoader(ordered.Config(shards=shards_dir, layer=3, batch_size=16, buffer_size=1,
                                           batch_timeout_s=2.0))
    before = _producers_alive()
    for _ in dl:
        assert _producers_alive() == before + 1
        break
    deadline = time.monotonic() + 6.0
    while _producers_alive() > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert _producers_alive() == before and dl.producer_thread is None
    # And the loader runs again from the start.
    assert sum(len(b["act"]) for b in _batches(dl)) == dl.n_samples


# --- the compaction --------------------------------------------------------


COMPACT_CASES = {
    "negative-kept": lambda rng: np.where(rng.random((6, 10)) < 0.4, rng.normal(size=(6, 10)) - 2.0, 0.0),
    "zeros-and-empty-rows": lambda rng: np.stack([
        np.zeros(10), [0.0, -0.0, 1.5, 0.0, -2.0, 0.0, 0.0, 3.0, -0.0, 0.0], np.zeros(10),
        np.arange(10) - 4.5, -np.zeros(10),
    ]),
    "dense": lambda rng: rng.normal(size=(5, 7)),
    "no-rows": lambda rng: np.zeros((0, 4)),
}


@pytest.mark.parametrize("make", COMPACT_CASES.values(), ids=COMPACT_CASES.keys())
def test_compaction_matches_scipy(make):
    f = make(np.random.default_rng(3)).astype(np.float32)
    got = inference.csr_block(*(t.numpy() for t in inference.compact_rows(torch.from_numpy(f))), f.shape[1])
    _assert_same_csr(got, scipy.sparse.csr_array(f))


def test_compaction_of_a_masked_batch_matches_scipy():
    """infer_batch's f with a row masked out: the row is empty, the others
    keep their nonzeros (TopK 3 on rows whose k-th value is negative)."""
    rng = np.random.default_rng(4)
    cfg = inference.modeling.SparseAutoencoderConfig(d_model=8, d_sae=12, activation=inference.modeling.TopK(top_k=3))
    params = {"W_enc": torch.from_numpy(rng.normal(size=(8, 12)).astype(np.float32)),
              "b_enc": torch.full((12,), -4.0), "W_dec": torch.from_numpy(rng.normal(size=(12, 8)).astype(np.float32)),
              "b_dec": torch.zeros(8)}
    x = torch.from_numpy(rng.normal(size=(6, 8)).astype(np.float32))
    mask = torch.tensor([True, True, False, True, True, True])
    f, _ = inference.infer_batch(cfg, params, {"threshold": torch.zeros(())}, x, mask)
    assert bool((f[2] == 0).all()) and bool((f < 0).any())
    got = inference.csr_block(*(t.numpy() for t in inference.compact_rows(f)), 12)
    _assert_same_csr(got, scipy.sparse.csr_array(f.numpy()))
    assert got.indptr[3] == got.indptr[2]


def _assert_same_csr(got, want) -> None:
    assert got.shape == want.shape and got.format == want.format == "csr"
    for name in ("indptr", "indices"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.data.dtype == want.data.dtype
    np.testing.assert_array_equal(got.data.view(np.int32), want.data.view(np.int32))


# --- worker_fn against the JAX package -------------------------------------


# name -> (activation, BatchTopK threshold, encoder bias offset). The TopK
# SAE's bias sits low enough that many rows keep negative values.
ACTIVATIONS = {
    "topk-matryoshka": (lambda m: m.TopK(top_k=K), 0.0, -2.5),
    "relu": (lambda m: m.Relu(), 0.0, -0.2),
    "batch-topk": (lambda m: m.BatchTopK(top_k=K), 0.35, -0.2),
}


def _runs(tmp_path, shards_dir, name, threshold, *, d_model=D_MODEL, seed=5):
    """One JAX-written SAE file in two run directories, one a package."""
    jcfg = jmod.SparseAutoencoderConfig(d_model=d_model, d_sae=D_SAE, activation=ACTIVATIONS[name][0](jmod))
    rng = np.random.default_rng(seed)
    on_grid = lambda a: np.round(a * 256) / 256  # noqa: E731  (module doc)
    params = {
        "W_enc": on_grid(rng.normal(size=(d_model, D_SAE)) / np.sqrt(d_model)),
        "b_enc": on_grid(rng.normal(size=D_SAE) * 0.1 + ACTIVATIONS[name][2]),
        "W_dec": rng.normal(size=(D_SAE, d_model)) / np.sqrt(D_SAE),
        "b_dec": rng.normal(size=d_model) * 0.1,
    }
    params = {k: v.astype(np.float32) for k, v in params.items()}
    runs_root = tmp_path / "saev" / "runs"
    runs_root.mkdir(parents=True, exist_ok=True)
    out = {}
    for pkg, mod in (("jax", jdisk), ("torch", disk)):
        run = mod.Run.new(f"{name}-{pkg}", train_shards_dir=shards_dir, val_shards_dir=shards_dir,
                          runs_root=runs_root)
        jnn.dump(run.ckpt, jcfg, params, {"threshold": np.float32(threshold)})
        out[pkg] = run
    return params, out


def _assert_exact_encoder(x: np.ndarray, params: dict) -> None:
    """Both packages' encoder products equal the float64 one (module doc)."""
    import jax
    import jax.numpy as jnp

    h64 = x.astype(np.float64) @ params["W_enc"].astype(np.float64) + params["b_enc"]
    with torch.no_grad():
        h_t = inference.modeling._linear_bias(
            torch.from_numpy(x), torch.from_numpy(params["W_enc"]), torch.from_numpy(params["b_enc"]), "highest")
    h_j = jnp.dot(x, params["W_enc"], precision=jax.lax.Precision.HIGHEST) + params["b_enc"]
    np.testing.assert_array_equal(h_t.numpy(), h64)
    np.testing.assert_array_equal(np.asarray(h_j), h64)


def _run_both(tmp_path, name, **cfg_kw):
    md = _md(cls=False)
    shards_dir, acts, labs = _write_shards(tmp_path, md, labels=True, grid=True)
    params, runs = _runs(tmp_path, shards_dir, name, ACTIVATIONS[name][1])
    _assert_exact_encoder(acts[:, 1].reshape(-1, D_MODEL), params)
    data = dict(shards=shards_dir, layer=3, batch_size=100, batch_timeout_s=2.0)  # rounded to 96
    fpaths = {}
    for pkg, mod, cfg_mod, dev in (("jax", jinference, jordered, "cpu"), ("torch", inference, ordered, "cpu")):
        cfg = mod.Config(run=runs[pkg].run_dir, data=cfg_mod.Config(**data), n_dists=5, device=dev, **cfg_kw)
        mod.worker_fn(cfg)
        fpaths[pkg] = mod.Filepaths.from_run(runs[pkg], md)
    return fpaths, md, labs


def _assert_artifacts_match(fp, jfp, save=True) -> None:
    got, want = json.loads(fp.metrics.read_text()), json.loads(jfp.metrics.read_text())
    assert list(got) == list(want)
    for key in want:
        assert type(got[key]) is type(want[key]), key
        assert abs(got[key] - want[key]) <= 1e-5 * abs(want[key]), (key, got[key], want[key])
    metrics.Metrics.from_dict(got)
    if not save:
        return
    ta, ja = scipy.sparse.load_npz(fp.token_acts), scipy.sparse.load_npz(jfp.token_acts)
    assert ta.shape == ja.shape and ta.format == ja.format == "csr"
    for key in ("indptr", "indices"):
        a, b = getattr(ta, key), getattr(ja, key)
        assert a.dtype == b.dtype, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    assert ta.data.dtype == ja.data.dtype == np.float32
    assert rel_norm(ta.data, ja.data) <= 1e-5
    load = lambda p: torch.load(p, weights_only=True).numpy()  # noqa: E731
    np.testing.assert_array_equal(load(fp.sparsity), load(jfp.sparsity))
    mv, jmv = load(fp.mean_values), load(jfp.mean_values)
    np.testing.assert_array_equal(np.isfinite(mv), np.isfinite(jmv))
    assert rel_norm(mv[np.isfinite(jmv)], jmv[np.isfinite(jmv)]) <= 1e-5
    d, jd = load(fp.distributions), load(jfp.distributions)
    assert d.shape == jd.shape and d.dtype == jd.dtype
    assert rel_norm(d, jd) <= 1e-5


@pytest.mark.parametrize("name", ACTIVATIONS)
def test_worker_fn_matches_jax(tmp_path, name):
    fpaths, md, _ = _run_both(tmp_path, name)
    _assert_artifacts_match(fpaths["torch"], fpaths["jax"])
    ta = scipy.sparse.load_npz(fpaths["torch"].token_acts)
    assert ta.shape == (N_EXAMPLES * TOKENS, D_SAE)
    row_nnz = np.diff(ta.indptr)
    if name == "topk-matryoshka":
        assert (row_nnz >= K).all() and (ta.data < 0).any()  # negative kept values stay in the CSR
    else:
        assert (ta.data > 0).all() and 0 < row_nnz.mean() < D_SAE
    assert (torch.load(fpaths["torch"].sparsity, weights_only=True) > 0).any()


def test_worker_fn_ignore_labels_matches_jax(tmp_path):
    fpaths, md, labs = _run_both(tmp_path, "relu", ignore_labels=(0, 2))
    _assert_artifacts_match(fpaths["torch"], fpaths["jax"])
    m = json.loads(fpaths["torch"].metrics.read_text())
    assert m["n_tokens"] == int(np.isin(labs, (0, 2), invert=True).sum()) < N_EXAMPLES * TOKENS
    ta = scipy.sparse.load_npz(fpaths["torch"].token_acts)
    ignored = np.isin(labs.reshape(-1), (0, 2))
    assert (np.diff(ta.indptr)[ignored] == 0).all() and (np.diff(ta.indptr)[~ignored] > 0).all()


def test_worker_fn_metrics_only_and_idempotent(tmp_path, monkeypatch):
    fpaths, md, _ = _run_both(tmp_path, "topk-matryoshka", save=False)
    _assert_artifacts_match(fpaths["torch"], fpaths["jax"], save=False)
    fp = fpaths["torch"]
    assert sorted(p.name for p in fp.metrics.parent.iterdir()) == ["config.json", "metrics.json"]

    run_dir = fp.metrics.parent.parent.parent
    data = ordered.Config(shards=disk.Run(run_dir).train_shards, layer=3, batch_size=96, batch_timeout_s=2.0)
    cfg = inference.Config(run=run_dir, data=data, n_dists=5, device="cpu", save=False)
    do, reason, _ = inference.need_compute(cfg)
    assert not do and "metrics only" in reason
    mtime = fp.metrics.stat().st_mtime_ns
    assert inference.worker_fn(cfg) is None and fp.metrics.stat().st_mtime_ns == mtime
    # The full artifacts are still missing; forcing recomputes metrics only.
    do, reason, _ = inference.need_compute(dataclasses.replace(cfg, save=True))
    assert do and "Missing files" in reason
    do, reason, _ = inference.need_compute(dataclasses.replace(cfg, force_recompute=True))
    assert do and "Force" in reason
    out = inference.worker_fn(dataclasses.replace(cfg, save=True))
    assert out["batches"] == math.ceil(N_EXAMPLES * TOKENS / 96) and out["tokens"] == N_EXAMPLES * TOKENS
    assert all(p.exists() for p in fp)
    assert inference.worker_fn(dataclasses.replace(cfg, save=True)) is None
    assert jinference.need_compute(dataclasses.replace(cfg, save=True))[0] is False


def test_worker_fn_d_model_mismatch_raises(tmp_path):
    md = _md(cls=False)
    shards_dir, _, _ = _write_shards(tmp_path, md)
    _, runs = _runs(tmp_path, shards_dir, "relu", 0.0, d_model=D_MODEL + 8)
    cfg = inference.Config(run=runs["torch"].run_dir, data=ordered.Config(shards=shards_dir, layer=3),
                           device="cpu")
    with pytest.raises(guards.GuardError, match="d_model"):
        inference.worker_fn(cfg)


def test_config_fields_and_defaults_match_jax():
    def tree(obj):
        if dataclasses.is_dataclass(obj):
            return {f.name: tree(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
        return str(obj) if isinstance(obj, pathlib.Path) else obj

    got, want = tree(inference.Config()), tree(jinference.Config())
    assert list(got) == list(want)
    assert (got.pop("device"), want.pop("device")) == ("cuda", "tpu")
    assert got == want


def test_cli_parses_the_jax_flags(tmp_path, monkeypatch):
    """`python -m saev_tpu_torch.framework.inference` parses the JAX
    package's flags into the port's Config and runs worker_fn on it."""
    from saev_tpu_torch.utils import cli

    seen = []
    monkeypatch.setattr(inference, "worker_fn", seen.append)
    cli.run({"inference": inference.main}, [
        "inference", "--run", str(tmp_path / "r"), "--data.shards", str(tmp_path / "s"), "--data.layer", "3",
        "--n-dists", "7", "--ignore-labels", "0,2", "--device", "cpu", "--no-save",
    ])
    (cfg,) = seen
    assert cfg.run == tmp_path / "r" and cfg.data.shards == tmp_path / "s"
    assert (cfg.data.layer, cfg.n_dists, cfg.ignore_labels, cfg.device, cfg.save) == (3, 7, (0, 2), "cpu", False)
