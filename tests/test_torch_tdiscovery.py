"""The port's trait discovery (saev_tpu_torch.tdiscovery), its Slurm helpers
and its activations sweep launcher against the JAX package's
(contrib/trait_discovery/src/tdiscovery, saev_tpu.helpers,
scripts/activations.py), on the CPU, from the same numpy inputs:

- `Sparse1DProbe`: `fit`'s intercept_ and coef_, and `loss_matrix`, at rtol
  1e-5 and atol 1e-6 (the tolerance at which tests/test_probe1d.py holds a
  change of summation order), `n_iter_` equal or within one, tp, fp, tn and
  fn exact; at two slab sizes, a chunk size that leaves padding, an empty
  latent. The port's events go to the device sorted by latent and each
  chunk's sums are one `segment_reduce`: two fits give the same bits, and
  the chunks are in latent order with the padding at the scratch latent;
- `plan_memory`: the same `MemoryPlan`, field for field;
- the baselines: k-means centres after several `partial_fit`s on
  well-separated blobs at rtol 1e-5 (counts equal), through the tiled
  start, resurrection and the collapsed-centre split; semi-NMF's `D_` and
  codes at rel-norm SEMI_NMF_REL; PCA and random vectors bit for bit;
  `dump` and `load` in both directions, bit for bit; `train_worker_fn` then
  `inference_worker_fn` on shards written by the port's writer, each
  package's shuffled loader replaced by the same fixed batches (its order
  is not deterministic across threads): the five artifacts agree;
- `SparseAutoencoderScorer.transform` on one checkpoint (TopK, BatchTopK):
  relative MSE under 1e-4 and the same support (inputs on a grid that makes
  every product exact, as tests/test_torch_inference.py does);
- `probe1d.worker_fn` of both packages on the same artifacts:
  probe1d_metrics.npz agreeing; the port's `metrics.worker_fn` on them;
- the FishVista `worker_fn` for random (AP within 1e-6), kmeans (fitted in
  the pipeline from fixed batches) and sae (AP within FISHVISTA_AP); PCA's
  scorer, which the JAX package's `get_scorer` refuses with a TypeError
  (`MiniBatchPCA(..., seed=)`, ROADMAP §3), fits in the port;
- the Slurm helpers with `subprocess.run` monkeypatched and a fake executor;
- the TOML expansion of the activations launcher: the same configs.
"""

import contextlib
import dataclasses
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "contrib" / "trait_discovery" / "src"))

from tdiscovery import baselines as jbaselines  # noqa: E402
from tdiscovery import metrics as jmetrics  # noqa: E402
from tdiscovery import probe1d as jprobe  # noqa: E402
from tdiscovery import saes as jsaes  # noqa: E402
from tdiscovery.fishvista import evaluation as jevaluation  # noqa: E402

import saev_tpu.configs as jconfigs  # noqa: E402
import saev_tpu.data as jdata  # noqa: E402
from saev_tpu import disk as jdisk  # noqa: E402
from saev_tpu import helpers as jhelpers  # noqa: E402
from saev_tpu import nn as jnn  # noqa: E402
from saev_tpu.framework import shards as jfshards  # noqa: E402
from saev_tpu.nn import modeling as jmod  # noqa: E402
from saev_tpu_torch import disk, helpers  # noqa: E402
from saev_tpu_torch.data import OrderedConfig, ShuffledConfig, shards  # noqa: E402
from saev_tpu_torch.scripts import activations  # noqa: E402
from saev_tpu_torch.tdiscovery import baselines, metrics, probe1d, saes  # noqa: E402
from saev_tpu_torch.tdiscovery.fishvista import evaluation  # noqa: E402

PROBE_RTOL, PROBE_ATOL = 1e-5, 1e-6
# Semi-NMF's codes and dictionary: the two packages' f32 products and ridge
# solves differ in their last bits, which the multiplicative updates carry.
SEMI_NMF_REL = 1e-4
# The FishVista AP of kmeans and sae: scores from f32 products of either
# package rank the same patches.
FISHVISTA_AP = 1e-5
D_MODEL, TOKENS, N_CLASSES = 16, 16, 4


def rel_norm(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# --- Sparse1DProbe -----------------------------------------------------------


def _probe_data(n=384, n_latents=6, n_classes=3, density=0.3, seed=0, empty=()):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, n_latents)).astype(np.float32)
    x = np.where(rng.uniform(size=x.shape) < density, np.abs(x), 0.0).astype(np.float32)
    x[:, list(empty)] = 0.0
    y = np.zeros((n, n_classes), dtype=np.float32)
    for c in range(n_classes):
        logits = 2.0 * x[:, c % n_latents] - 0.5
        y[:, c] = (rng.uniform(size=n) < jprobe.sigmoid(logits)).astype(np.float32)
    return scipy.sparse.csr_matrix(x), y


PROBE_CASES = {
    "slab-2": dict(data=dict(), probe=dict(class_slab_size=2)),
    "slab-3-one-slab": dict(data=dict(), probe=dict(class_slab_size=3)),
    "padded-chunks": dict(data=dict(seed=1), probe=dict(class_slab_size=2, event_chunk_size=37)),
    "empty-latent": dict(data=dict(seed=2, n_latents=7, empty=(3,)), probe=dict(class_slab_size=2, event_chunk_size=64)),
    "pieces": dict(data=dict(seed=4), probe=dict(class_slab_size=3, event_chunk_size=300), piece=7),
}


@pytest.mark.parametrize("case", PROBE_CASES.values(), ids=PROBE_CASES.keys())
def test_sparse_probe_matches_jax(case, monkeypatch):
    monkeypatch.setattr(probe1d, "PIECE", case.get("piece", probe1d.PIECE))
    x, y = _probe_data(**case["data"])
    kw = dict(n_latents=x.shape[1], n_classes=y.shape[1], max_iter=60, **case["probe"])
    want = jprobe.Sparse1DProbe(**kw).fit(x, y)
    got = probe1d.Sparse1DProbe(device="cpu", **kw).fit(x, y)
    np.testing.assert_allclose(got.intercept_, want.intercept_, rtol=PROBE_RTOL, atol=PROBE_ATOL)
    np.testing.assert_allclose(got.coef_, want.coef_, rtol=PROBE_RTOL, atol=PROBE_ATOL)
    assert np.abs(got.n_iter_ - want.n_iter_).max() <= 1, (got.n_iter_, want.n_iter_)
    np.testing.assert_allclose(got.loss_matrix(x, y), want.loss_matrix(x, y), rtol=PROBE_RTOL, atol=PROBE_ATOL)
    # The confusion counts from the same params: a token whose logit lies
    # within the two fits' rounding of 0 would otherwise count on either side.
    got.intercept_, got.coef_ = want.intercept_.copy(), want.coef_.copy()
    loss, *counts = got.loss_matrix_with_aux(x, y)
    jloss, *jcounts = want.loss_matrix_with_aux(x, y)
    np.testing.assert_allclose(loss, jloss, rtol=PROBE_RTOL, atol=PROBE_ATOL)
    for name, a, b in zip(("tp", "fp", "tn", "fn"), counts, jcounts):
        np.testing.assert_array_equal(a, b, err_msg=name)
        assert (a == np.round(a)).all(), name
    if "empty" in case["data"]:
        for p in (got, want):
            assert (p.coef_[3] == 0).all()
    np.testing.assert_allclose(got.predict_proba(x, 1), want.predict_proba(x, 1), rtol=PROBE_RTOL, atol=PROBE_ATOL)


def test_sparse_probe_event_order_is_fixed(monkeypatch):
    """The events go to the device in pieces of one latent each, latents
    ascending and rows ascending within one, each piece at most PIECE
    events padded with row 0 and value 0; the chunks cover the pieces in
    order with each latent's count of pieces; two fits give the same bits
    (the deterministic route the card takes too)."""
    monkeypatch.setattr(probe1d, "PIECE", 16)
    x, y = _probe_data(seed=3, n_latents=7, empty=(5,))
    kw = dict(n_latents=7, n_classes=3, class_slab_size=2, event_chunk_size=50, max_iter=20, device="cpu")
    probe = probe1d.Sparse1DProbe(**kw)
    ev = probe._events(x, 50)
    rows, vals, latent, length = (t.numpy() for t in (ev.rows, ev.vals, ev.latent, ev.length))
    assert rows.shape == vals.shape == (len(latent), 16) and (np.diff(latent) >= 0).all() and 5 not in latent
    assert length.min() >= 1 and length.max() <= 16 and length.sum() == x.nnz
    valid = np.arange(16) < length[:, None]
    assert (rows[~valid] == 0).all() and (vals[~valid] == 0).all()
    csc = x.tocsc()
    np.testing.assert_array_equal(rows[valid], csc.indices)
    np.testing.assert_array_equal(vals[valid], csc.data)
    np.testing.assert_array_equal(np.bincount(latent, weights=length, minlength=7), np.diff(csc.indptr))
    assert [c[0] for c in ev.chunks] == list(range(0, len(latent), 3)) and ev.chunks[-1][1] == len(latent)
    for p0, p1, lo, hi, pieces in ev.chunks:
        assert (lo, hi) == (latent[p0], latent[p1 - 1] + 1)
        np.testing.assert_array_equal(np.repeat(np.arange(lo, hi), pieces.numpy()), latent[p0:p1])
    a, b = probe.fit(x, y), probe1d.Sparse1DProbe(**kw).fit(x, y)
    for p, q in ((a.intercept_, b.intercept_), (a.coef_, b.coef_)):
        np.testing.assert_array_equal(p.view(np.int32), q.view(np.int32))


def test_sparse_probe_matches_dense_reference():
    x, y = _probe_data(n=256, n_latents=4, n_classes=2, seed=1)
    dense = np.asarray(x.todense())
    got = probe1d.Sparse1DProbe(n_latents=4, n_classes=2, class_slab_size=2, max_iter=100, device="cpu").fit(x, y)
    for latent in range(4):
        for c in range(2):
            ref = probe1d.Reference1DProbe(max_iter=100).fit(dense[:, latent], y[:, c])
            np.testing.assert_allclose(got.intercept_[latent, c], ref.intercept_, rtol=1e-3, atol=1e-4)
            np.testing.assert_allclose(got.coef_[latent, c], ref.coef_, rtol=1e-3, atol=1e-4)


PLAN_SHAPES = {
    "production": dict(n_latents=16384, n_classes=2000, nnz=100_000_000, n_samples=1_000_000),
    "tight": dict(n_latents=16384, n_classes=200, nnz=10_000_000, n_samples=1_000_000, budget_bytes=300 << 20),
    "chunk-shrinks": dict(n_latents=1024, n_classes=4, nnz=1 << 22, n_samples=1 << 20, budget_bytes=80 << 20,
                          max_class_slab=4),
    "trait-phase": dict(n_latents=16384, n_classes=10, nnz=1 << 25, n_samples=1 << 20, max_class_slab=8),
}


@pytest.mark.parametrize("shape", PLAN_SHAPES.values(), ids=PLAN_SHAPES.keys())
def test_plan_memory_matches_jax(shape):
    got, want = probe1d.plan_memory(**shape), jprobe.plan_memory(**shape)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.total_bytes == want.total_bytes
    for mod in (probe1d, jprobe):
        with pytest.raises(AssertionError):
            mod.plan_memory(n_latents=16, n_classes=2, nnz=1 << 30, n_samples=10, budget_bytes=1 << 30)


# --- the baselines -------------------------------------------------------------


def _blobs(rng, n=256, d=D_MODEL, k=4, spread=0.05):
    centers = rng.normal(size=(k, d)).astype(np.float32) * 3
    assign = rng.integers(0, k, size=n)
    return (centers[assign] + rng.normal(size=(n, d)).astype(np.float32) * spread).astype(np.float32)


KMEANS_CASES = {
    "k-4": dict(k=4, sizes=(128, 128, 96)),
    "k-8-splits": dict(k=8, sizes=(128, 128, 128, 64)),
    "tiled-start": dict(k=12, sizes=(8, 128, 128)),
}


@pytest.mark.parametrize("case", KMEANS_CASES.values(), ids=KMEANS_CASES.keys())
def test_kmeans_matches_jax(case):
    rng = np.random.default_rng(0)
    batches = [_blobs(rng, n=n) for n in case["sizes"]]
    km = baselines.MiniBatchKMeans(k=case["k"], seed=5, device="cpu")
    jkm = jbaselines.MiniBatchKMeans(k=case["k"], seed=5)
    # Distances are the product form |x|^2 - 2 x c + |c|^2, which cancels
    # near a centre: they agree to float32 rounding of |x|^2 + |c|^2.
    scale = 2 * max(float((b**2).sum(1).max()) for b in batches)
    for b in batches:
        km.partial_fit(b)
        jkm.partial_fit(b)
        np.testing.assert_allclose(km.cluster_centers_, jkm.cluster_centers_, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(km.cluster_counts_, jkm.cluster_counts_)
        assert km.last_batch_inertia_ == pytest.approx(jkm.last_batch_inertia_, rel=1e-5, abs=1e-6 * scale)
    assert km.n_steps_ == jkm.n_steps_ == len(batches)
    x = batches[0][:8]
    np.testing.assert_allclose(km.transform(x) ** 2, jkm.transform(x) ** 2, rtol=1e-5, atol=1e-6 * scale)


def test_semi_nmf_matches_jax():
    rng = np.random.default_rng(1)
    x = np.abs(_blobs(rng, n=192, k=3))
    kw = dict(z_iters=5, encode_iters=20, d_update_every=2, seed=3)
    nmf = baselines.MiniBatchSemiNMF(n_concepts=3, device="cpu", **kw)
    jnmf = jbaselines.MiniBatchSemiNMF(n_concepts=3, **kw)
    for i in range(0, 192, 48):
        nmf.partial_fit(x[i : i + 48])
        jnmf.partial_fit(x[i : i + 48])
    assert rel_norm(nmf.D_, jnmf.D_) < SEMI_NMF_REL
    assert nmf.last_batch_nmse_ == pytest.approx(jnmf.last_batch_nmse_, rel=SEMI_NMF_REL)
    z, jz = nmf.transform(x[:32]), jnmf.transform(x[:32])
    assert (z >= 0).all() and rel_norm(z, jz) < SEMI_NMF_REL


def test_pca_and_random_vectors_bit_for_bit():
    rng = np.random.default_rng(2)
    x = _blobs(rng, n=160)
    pca, jpca = baselines.MiniBatchPCA(3), jbaselines.MiniBatchPCA(3)
    for i in range(0, 160, 64):
        pca.partial_fit(x[i : i + 64])
        jpca.partial_fit(x[i : i + 64])
    for k in ("components_", "mean_", "explained_variance_"):
        np.testing.assert_array_equal(getattr(pca, k), getattr(jpca, k))
    np.testing.assert_array_equal(pca.transform(x[:5]), jpca.transform(x[:5]))
    rv, jrv = baselines.RandomVectors(7, seed=4), jbaselines.RandomVectors(7, seed=4)
    np.testing.assert_array_equal(rv.transform(x[:5]), jrv.transform(x[:5]))
    np.testing.assert_array_equal(rv.vectors_, jrv.vectors_)


def _runs(tmp_path, name):
    root = tmp_path / name / "saev" / "runs"
    root.mkdir(parents=True)
    sh = tmp_path / name / "saev" / "shards" / "deadbeef"
    sh.mkdir(parents=True)
    return root, sh


def _fitted(method, pkg, x):
    mod = baselines if pkg == "torch" else jbaselines
    kw = {"device": "cpu"} if pkg == "torch" and method in ("kmeans", "semi-nmf") else {}
    model = {"kmeans": lambda: mod.MiniBatchKMeans(k=4, seed=0, **kw),
             "pca": lambda: mod.MiniBatchPCA(3),
             "semi-nmf": lambda: mod.MiniBatchSemiNMF(3, z_iters=3, d_update_every=1, **kw),
             "random": lambda: mod.RandomVectors(5, seed=1)}[method]()
    model.partial_fit(x)
    return model


@pytest.mark.parametrize("method", ["kmeans", "pca", "semi-nmf", "random"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_load_in_both_packages(tmp_path, method, writer):
    x = np.abs(_blobs(np.random.default_rng(3), n=64))
    root, sh = _runs(tmp_path, "r")
    run = (disk if writer == "torch" else jdisk).Run.new("b1", train_shards_dir=sh, val_shards_dir=sh, runs_root=root)
    model = _fitted(method, writer, x)
    (baselines if writer == "torch" else jbaselines).dump(run, method, model, extra={"k": 4})
    loaded = {"torch": baselines.load(disk.Run(run.run_dir), device="cpu"), "jax": jbaselines.load(jdisk.Run(run.run_dir))}
    want = model.state_dict()
    for pkg, m in loaded.items():
        assert type(m).method == method, pkg
        sd = m.state_dict()
        assert sorted(sd) == sorted(want), pkg
        for k in want:
            np.testing.assert_array_equal(np.asarray(sd[k], np.float32), np.asarray(want[k], np.float32), err_msg=k)
    header = json.loads(open(run.run_dir / "checkpoint" / "baseline.pt", "rb").readline())
    assert header == {"schema": 1, "method": method, "k": 4}


# --- shards, fixed loaders ----------------------------------------------------------


def _write_labelled_shards(tmp_path, name, n_examples, seed, centers):
    """Shards of blob rows (the port's ShardWriter) with a labels.bin whose
    label is each row's blob mod N_CLASSES."""
    md = shards.Metadata(
        family="clip", ckpt="random", layers=(0,), content_tokens_per_example=TOKENS, cls_token=False,
        d_model=D_MODEL, n_examples=n_examples, max_tokens_per_shard=TOKENS * 8, data="e30=",
        dataset=pathlib.Path("/data/images"),
    )
    root = tmp_path / name / "saev" / "shards"
    root.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    blob = rng.integers(0, len(centers), size=(n_examples, TOKENS))
    acts = centers[blob] + 0.3 * rng.normal(size=(n_examples, TOKENS, D_MODEL))
    acts = acts[:, None].astype(np.float32)
    labels = (blob % N_CLASSES).astype(np.uint8)
    md.dump(root)
    with shards.ShardWriter(root, md) as w:
        for start in range(0, n_examples, 5):
            w.write_batch(acts[start : start + 5], start, labels[start : start + 5])
    return root / md.hash, acts[:, 0].reshape(-1, D_MODEL), labels.reshape(-1)


@pytest.fixture(scope="module")
def labelled(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("td")
    centers = np.random.default_rng(7).normal(size=(6, D_MODEL)) * 3
    train = _write_labelled_shards(tmp, "train", 24, 0, centers)
    test = _write_labelled_shards(tmp, "test", 12, 1, centers)
    return train, test


class FixedLoader:
    """Stands in for a ShuffledDataLoader: the same batches, in the same
    order, every epoch."""

    drop_last = False

    def __init__(self, cfg, acts):
        self.batch_size = cfg.batch_size
        self.batches = [acts[i : i + cfg.batch_size] for i in range(0, len(acts), cfg.batch_size)]
        self.n_samples = len(acts)

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        for b in self.batches:
            yield {"act": b.copy()}

    def shutdown(self):
        pass


@contextlib.contextmanager
def fixed_loaders(monkeypatch, acts):
    with monkeypatch.context() as m:
        m.setattr(baselines, "ShuffledDataLoader", lambda cfg: FixedLoader(cfg, acts))
        m.setattr(evaluation, "ShuffledDataLoader", lambda cfg: FixedLoader(cfg, acts))
        m.setattr(jdata, "ShuffledDataLoader", lambda cfg: FixedLoader(cfg, acts))
        m.setattr(jevaluation, "ShuffledDataLoader", lambda cfg: FixedLoader(cfg, acts))
        yield


def _artifacts(art_dir):
    out = {"token_acts": scipy.sparse.load_npz(art_dir / "token_acts.npz").tocsr(),
           "metrics": json.loads((art_dir / "metrics.json").read_text())}
    for k in ("mean_values", "sparsity", "distributions"):
        out[k] = torch.load(art_dir / f"{k}.pt", weights_only=True).numpy()
    return out


@pytest.mark.parametrize("method", ["kmeans", "pca", "semi-nmf"])
def test_train_and_inference_workers_match_jax(tmp_path, monkeypatch, labelled, method):
    (train_dir, train_acts, _), (test_dir, _, _) = labelled
    arts = {}
    for pkg in ("jax", "torch"):
        runs_root, _ = _runs(tmp_path, pkg)
        mod = baselines if pkg == "torch" else jbaselines
        data_cls = ShuffledConfig if pkg == "torch" else jdata.ShuffledConfig
        data = data_cls(shards=train_dir, layer=0, batch_size=96)
        kw = {"device": "cpu"} if pkg == "torch" else {}
        cfg = mod.TrainConfig(method=method, train_data=data, val_data=data, n_train=384, n_val=192, k=5,
                              runs_root=runs_root, seed=0, z_iters=3, d_update_every=2, **kw)
        with fixed_loaders(monkeypatch, train_acts):
            run_id = mod.train_worker_fn(cfg)
        run_dir = runs_root / run_id
        ordered = (OrderedConfig if pkg == "torch" else jdata.OrderedConfig)(shards=test_dir, layer=0, batch_size=64)
        mod.inference_worker_fn(mod.InferenceConfig(run=run_dir, data=ordered, n_dists=3, n_iters=20, **kw))
        arts[pkg] = (_artifacts(run_dir / "inference" / test_dir.name),
                     json.loads((run_dir / "metrics.json").read_text()))
    (got, got_train), (want, want_train) = arts["torch"], arts["jax"]
    assert sorted(got_train) == sorted(want_train)
    for k, v in want_train.items():
        assert got_train[k] == pytest.approx(v, rel=SEMI_NMF_REL), k
    rel = 1e-5 if method == "kmeans" else SEMI_NMF_REL if method == "semi-nmf" else 0.0
    a, b = got["token_acts"], want["token_acts"]
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    assert rel_norm(a.data, b.data) <= rel
    for k in ("mean_values", "sparsity", "distributions"):
        fin = np.isfinite(want[k])
        np.testing.assert_array_equal(np.isfinite(got[k]), fin, err_msg=k)
        assert rel_norm(got[k][fin], want[k][fin]) <= rel, k
    assert sorted(got["metrics"]) == sorted(want["metrics"])
    for k, v in want["metrics"].items():
        assert got["metrics"][k] == pytest.approx(v, rel=max(rel, 1e-12)), k


# --- the SAE scorer ----------------------------------------------------------------


def _grid_sae(tmp_path, activation):
    """A JAX-dumped SAE whose encoder is on the 2^-8 grid (module doc)."""
    cfg = jmod.SparseAutoencoderConfig(d_model=D_MODEL, d_sae=48, activation=activation)
    import jax

    params, state = jmod.init(cfg, jax.random.key(0))
    rng = np.random.default_rng(9)
    params = dict(params)
    params["W_enc"] = np.round(rng.normal(size=(D_MODEL, 48)) * 64).clip(-128, 128).astype(np.float32) / 256
    params["b_enc"] = np.round(rng.normal(size=(48,)) * 16).astype(np.float32) / 256
    if isinstance(activation, jmod.BatchTopK):
        state = {**state, "threshold": np.float32(0.25)}
    fpath = tmp_path / "sae.pt"
    jnn.dump(fpath, cfg, params, state)
    return fpath


@pytest.mark.parametrize("activation", [jmod.TopK(top_k=6), jmod.BatchTopK(top_k=6)], ids=["topk", "batch-topk"])
def test_sae_scorer_matches_jax(tmp_path, activation):
    fpath = _grid_sae(tmp_path, activation)
    x = np.clip(np.round(np.random.default_rng(4).normal(size=(64, D_MODEL)) * 64) / 64, -4, 4).astype(np.float32)
    got = saes.SparseAutoencoderScorer(str(fpath), device="cpu")
    want = jsaes.SparseAutoencoderScorer(str(fpath))
    assert got.n_prototypes == want.n_prototypes == 48 and got.kwargs == want.kwargs
    f, jf = got.transform(x), want.transform(x)
    np.testing.assert_array_equal(f != 0, jf != 0)
    assert ((f - jf) ** 2).sum() / max((jf**2).sum(), 1e-30) < 1e-4
    assert (f != 0).sum() > 0


# --- the probe and metrics workers ---------------------------------------------------


def test_probe_worker_matches_jax(tmp_path, labelled):
    """Both packages' probe1d.worker_fn on the same inference artifacts,
    then the port's metrics.worker_fn on the port's."""
    (train_dir, _, train_labels), (test_dir, _, test_labels) = labelled
    runs_root, _ = _runs(tmp_path, "probe")
    run = disk.Run.new("p1", train_shards_dir=train_dir, val_shards_dir=test_dir, runs_root=runs_root)
    rng = np.random.default_rng(5)
    for d, labels in ((train_dir, train_labels), (test_dir, test_labels)):
        x = np.where(rng.uniform(size=(len(labels), 9)) < 0.25, rng.exponential(size=(len(labels), 9)), 0.0)
        x[:, :N_CLASSES] += (labels[:, None] == np.arange(N_CLASSES)) * rng.uniform(0.5, 1.5, size=(len(labels), 1))
        x[:, 7] = 0.0
        (run.inference / d.name).mkdir(parents=True)
        scipy.sparse.save_npz(run.inference / d.name / "token_acts.npz", scipy.sparse.csr_matrix(x.astype(np.float32)))
    kw = dict(run=run.run_dir, train_shards=train_dir, test_shards=test_dir, class_slab_size=3, max_iter=40)
    outs = {}
    for pkg, mod, extra in (("jax", jprobe, {}), ("torch", probe1d, {"device": "cpu"})):
        assert mod.worker_fn(mod.Config(**kw, **extra)) == 0
        outs[pkg] = [dict(np.load(run.inference / d.name / "probe1d_metrics.npz")) for d in (train_dir, test_dir)]
    for d, got, want in zip((train_dir, test_dir), outs["torch"], outs["jax"]):
        assert sorted(got) == sorted(want) == ["biases", "fn", "fp", "loss", "tn", "tp", "weights"]
        for k in ("loss", "weights", "biases"):
            np.testing.assert_allclose(got[k], want[k], rtol=PROBE_RTOL, atol=PROBE_ATOL, err_msg=k)
        # The counts exact against the JAX package's on the port's params.
        x = scipy.sparse.load_npz(run.inference / d.name / "token_acts.npz").tocsr()
        labels = train_labels if d == train_dir else test_labels
        ref = jprobe.Sparse1DProbe(n_latents=9, n_classes=N_CLASSES)
        ref.intercept_, ref.coef_ = got["biases"], got["weights"]
        _, *counts = ref.loss_matrix_with_aux(x, np.eye(N_CLASSES, dtype=np.float32)[labels])
        for k, want_k in zip(("tp", "fp", "tn", "fn"), counts):
            np.testing.assert_array_equal(got[k], want_k, err_msg=k)
    # Both packages' metrics workers on the port's probe1d_metrics.npz.
    art = run.inference / test_dir.name
    saved = {}
    for mod in (jmetrics, metrics):
        res = mod.worker_fn(mod.Config(run=run.run_dir, train_shards=train_dir, test_shards=test_dir, max_k=64))
        saved[mod] = (res, json.loads((art / "trait_metrics.json").read_text()),
                      dict(np.load(art / f"probe1d_metrics__train-{train_dir.name}.npz")))
    (got, got_json, got_npz), (want, want_json, want_npz) = saved[metrics], saved[jmetrics]
    assert got == want and got_json == want_json and len(got["ap_per_class"]) == N_CLASSES
    assert sorted(got_npz) == sorted(want_npz)
    for k in want_npz:
        np.testing.assert_array_equal(got_npz[k], want_npz[k], err_msg=k)
    assert got_npz["top_labels"].shape == (9, 64)


# --- FishVista ----------------------------------------------------------------------


@pytest.mark.parametrize("method", ["random", "kmeans", "sae"])
def test_fishvista_worker_matches_jax(tmp_path, monkeypatch, labelled, method):
    (train_dir, train_acts, _), (test_dir, _, _) = labelled
    sae = _grid_sae(tmp_path, jmod.TopK(top_k=6)) if method == "sae" else ""
    results = {}
    for pkg in ("jax", "torch"):
        mod = evaluation if pkg == "torch" else jevaluation
        ordered = OrderedConfig if pkg == "torch" else jdata.OrderedConfig
        kw = {"device": "cpu"} if pkg == "torch" else {}
        cfg = mod.Config(method=method, n_prototypes=8, sae_ckpt=str(sae), n_classes=N_CLASSES, n_fit=192,
                         train_acts=ordered(shards=train_dir, layer=0, batch_size=64),
                         test_acts=ordered(shards=test_dir, layer=0, batch_size=64),
                         dump_to=tmp_path / pkg, output_format="both", ap_chunk=5, n_train=300, **kw)
        with fixed_loaders(monkeypatch, train_acts):
            results[pkg] = mod.worker_fn(cfg)
    got, want = results["torch"].to_dict(), results["jax"].to_dict()
    tol = 1e-6 if method == "random" else FISHVISTA_AP
    assert got["best_prototype_per_class"] == want["best_prototype_per_class"]
    for k in ("train_ap_per_class", "test_ap_per_class"):
        np.testing.assert_allclose(got[k], want[k], atol=tol, err_msg=k)
    assert got["mean_ap"] == pytest.approx(want["mean_ap"], abs=tol)
    assert {k: v for k, v in got.items() if "ap" not in k and "best" not in k} == {
        k: v for k, v in want.items() if "ap" not in k and "best" not in k}
    stem = f"fishvista_{method}_{got['n_prototypes']}"
    assert (tmp_path / "torch" / f"{stem}.json").exists() and (tmp_path / "torch" / f"{stem}.csv").exists()


def test_fishvista_pca_scorer_fits_where_jax_raises(monkeypatch, labelled):
    """The JAX package's get_scorer builds MiniBatchPCA(n, seed=...), which
    MiniBatchPCA's signature refuses (ROADMAP §3); the port's fits PCA."""
    (train_dir, train_acts, _), _ = labelled
    cfgs = {pkg: mod.Config(method="pca", n_prototypes=3, n_fit=96,
                            train_acts=ordered(shards=train_dir, layer=0, batch_size=48))
            for pkg, mod, ordered in (("jax", jevaluation, jdata.OrderedConfig),
                                      ("torch", evaluation, OrderedConfig))}
    with fixed_loaders(monkeypatch, train_acts):
        with pytest.raises(TypeError, match="seed"):
            jevaluation.get_scorer(cfgs["jax"], D_MODEL)
        pca = evaluation.get_scorer(dataclasses.replace(cfgs["torch"], device="cpu"), D_MODEL)
    want = jbaselines.MiniBatchPCA(3)
    for i in range(0, 96, 48):
        want.partial_fit(train_acts[i : i + 48])
    np.testing.assert_array_equal(pca.components_, want.components_)


# --- the Slurm helpers and the activations launcher ------------------------------------


class FakeJob:
    def __init__(self, value):
        self.value, self.job_id = value, str(value)

    def result(self):
        if self.value == 3:
            raise RuntimeError("boom")
        return self.value * 10


class FakeExecutor:
    _saev_sleep_s = 0.0

    def __init__(self):
        self.batches = []

    def batch(self):
        self.batches.append([])
        return contextlib.nullcontext()

    def submit(self, fn, arg):
        self.batches[-1].append(arg)
        return FakeJob(fn(arg))


SLURM_CASES = {
    "max-array": dict(stdout="MaxArraySize            = 5\nMaxJobCount = 9\n"),
    "no-max-array": dict(stdout="MaxJobCount = 9\n"),
    "squeue": dict(stdout="  1 gpu a\n\n  2 gpu b\n  3 gpu c\n"),
    "not-found": dict(raises=FileNotFoundError),
    "failed": dict(raises=subprocess.CalledProcessError),
}


@pytest.mark.parametrize("case", SLURM_CASES.values(), ids=SLURM_CASES.keys())
def test_slurm_helpers_match_jax(monkeypatch, case):
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        if "raises" in case:
            raise case["raises"](1, cmd) if case["raises"] is subprocess.CalledProcessError else case["raises"](cmd[0])
        return subprocess.CompletedProcess(cmd, 0, stdout=case["stdout"], stderr="")

    monkeypatch.setattr(subprocess, "run", fake_run)
    got = (helpers.get_slurm_max_array_size(default=7), helpers.get_slurm_job_count())
    want = (jhelpers.get_slurm_max_array_size(default=7), jhelpers.get_slurm_job_count())
    assert got == want
    assert calls[0] == ["scontrol", "show", "config"] and calls[1][:2] == ["squeue", "-r"]
    batches = {}
    for name, mod in (("torch", helpers), ("jax", jhelpers)):
        ex = FakeExecutor()
        batches[name] = (list(mod.submit_job_array(ex, lambda v: v, [0, 1, 2, 4, 5, 6], margin=0.8)), ex.batches)
    assert batches["torch"] == batches["jax"]
    for mod in (helpers, jhelpers):
        with pytest.raises(RuntimeError, match="boom"):
            list(mod.submit_job_array(FakeExecutor(), lambda v: v, [2, 3], margin=0.8))


def test_activations_sweep_expands_as_jax(tmp_path):
    sweep = tmp_path / "sweep.toml"
    sweep.write_text(
        'family = "fake-clip"\nckpt = "hf-hub:hf-internal-testing/tiny-open-clip-model"\n'
        "d_model = 128\nlayers = [[0], [0, 2]]\n[data]\nn_examples = [6, 8]\n"
    )
    argv = ["--batch-size", "4", "--content-tokens-per-example", "16"]
    got, errs = activations.load_cfgs(activations.cli.parse(activations.fshards.Config, argv), sweep)
    import tomllib

    from saev_tpu.utils import cli as jcli

    override = jcli.parse(jfshards.Config, argv)
    want, jerrs = jconfigs.load_cfgs(override, default=jfshards.Config(),
                                     sweep_dcts=list(jconfigs.expand(tomllib.loads(sweep.read_text()))))
    assert errs == jerrs == [] and len(got) == len(want) == 4
    for g, w in zip(got, want):
        gd, wd = (json.loads(json.dumps(dataclasses.asdict(c), default=lambda v: getattr(v, "value", str(v))))
                  for c in (g, w))
        gd.pop("device"), wd.pop("device", None)
        assert gd == wd
        assert type(g.data).__name__ == type(w.data).__name__


def test_launchers_list_their_subcommands(capsys):
    from saev_tpu_torch import __main__ as top
    from saev_tpu_torch.mimics import __main__ as mimics
    from saev_tpu_torch.tdiscovery import __main__ as td

    for main, names in ((td.main, ("probe1d", "baseline::train", "baseline::inference", "metrics", "cls::train",
                                   "cls::eval", "cls::audit", "visuals")),
                        (top.main, ("shards", "train", "inference")),
                        (mimics.main, ("score", "render", "consistency", "viewer", "scores"))):
        with pytest.raises(SystemExit) as exit_:
            main(["--help"])
        assert exit_.value.code == 0
        out = capsys.readouterr().out
        assert all(n in out for n in names), out
    assert sorted(td.COMMANDS) == ["baseline::inference", "baseline::train", "cls::audit", "cls::eval", "cls::train",
                                   "metrics", "probe1d", "visuals"]
    assert sorted(mimics.COMMANDS) == ["consistency", "render", "score", "scores", "viewer"]
