"""The port's interactive interpretability (saev_tpu_torch.interactive_interp)
and FishVista's supervised skyline (saev_tpu_torch.tdiscovery.fishvista.
supervised) against contrib's JAX modules (contrib/interactive_interp,
contrib/trait_discovery/src/tdiscovery/fishvista/supervised.py), on the CPU,
from the same numpy inputs:

- semseg `train`: both packages start from the JAX package's `make_models`
  and take the same fixed batches (each package's ShuffledDataLoader is
  replaced by them: its order is not deterministic across threads); `w` and
  `b` within rel-norm 1e-5 after 8 steps, each step's losses at rtol 1e-5;
  `dump` / `load` / `load_latest` in both directions;
- on a dyadic grid (activations, the SAE's encoder and decoder, the probe's
  weights: every product and sum is exact in float32 in both packages):
  `latent_class_stats`' f1 and top values, `quantify`'s counts and
  results.csv for every method, `visuals`' proposed_latents.json,
  `validate`'s validation.csv, the `interactive` page (payload and template)
  and semprobe's semprobe_scores.json, each equal;
- `_count_fn`'s specificity case of tests/test_interactive_interp_extras.py;
- classification `train` from the same initial draws (rel-norm 1e-5),
  `evaluate`'s accuracies equal, `grid`'s configs, the CLI's subcommands,
  the transforms and the figure assets;
- FishVista `supervised`: per-class AP within 1e-6 on fixed batches;
- every tensor entry point defaults to the card and raises without one.
"""

import contextlib
import dataclasses
import json
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "contrib" / "trait_discovery" / "src"))

from contrib.interactive_interp.classification import __main__ as jcls_main  # noqa: E402
from contrib.interactive_interp.classification import training as jcls  # noqa: E402
from contrib.interactive_interp.classification import transforms as jtransforms  # noqa: E402
from contrib.interactive_interp.scripts import make_figures as jfigures  # noqa: E402
from contrib.interactive_interp.semprobe import scoring as jscoring  # noqa: E402
from contrib.interactive_interp.semseg import interactive as jinteractive  # noqa: E402
from contrib.interactive_interp.semseg import quantitative as jquant  # noqa: E402
from contrib.interactive_interp.semseg import training as jtraining  # noqa: E402
from contrib.interactive_interp.semseg import validation as jvalidation  # noqa: E402
from contrib.interactive_interp.semseg import visuals as jvisuals  # noqa: E402
from tdiscovery.fishvista import supervised as jsupervised  # noqa: E402

import saev_tpu.data as jdata  # noqa: E402
from saev_tpu import nn as jnn  # noqa: E402
from saev_tpu.nn import modeling as jmod  # noqa: E402
from saev_tpu_torch import nn  # noqa: E402
from saev_tpu_torch.data import OrderedConfig, datasets, shards  # noqa: E402
from saev_tpu_torch.interactive_interp.classification import __main__ as cls_main  # noqa: E402
from saev_tpu_torch.interactive_interp.classification import training as cls  # noqa: E402
from saev_tpu_torch.interactive_interp.classification import transforms  # noqa: E402
from saev_tpu_torch.interactive_interp.scripts import make_figures  # noqa: E402
from saev_tpu_torch.interactive_interp.semprobe import scoring  # noqa: E402
from saev_tpu_torch.interactive_interp.semseg import __main__ as semseg_main  # noqa: E402
from saev_tpu_torch.interactive_interp.semseg import interactive, quantitative, training, validation, visuals  # noqa: E402
from saev_tpu_torch.nn import modeling  # noqa: E402
from saev_tpu_torch.tdiscovery.fishvista import supervised  # noqa: E402

D_MODEL, TOKENS, N_CLASSES, D_SAE = 16, 16, 5, 32
TRAIN_REL = 1e-5  # params after 8 steps; the losses at this rtol
FISHVISTA_AP = 1e-6


def rel_norm(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _grid(rng, shape, lo, hi, scale):
    """Integers in [lo, hi] over `scale`: values every f32 sum and product
    of these tests holds exactly."""
    return (rng.integers(lo, hi + 1, size=shape) / scale).astype(np.float32)


def _write_shards(root: pathlib.Path, n_examples: int, seed: int, centers: np.ndarray, *,
                  cls_token: bool = False, data: str = "e30=") -> tuple[pathlib.Path, np.ndarray, np.ndarray]:
    """Shards (the port's ShardWriter) with a labels.bin: each token a
    centre plus noise on a 2^-3 grid, its label its centre mod N_CLASSES."""
    tokens = TOKENS + int(cls_token)
    md = shards.Metadata(
        family="clip", ckpt="random", layers=(0,), content_tokens_per_example=TOKENS, cls_token=cls_token,
        d_model=D_MODEL, n_examples=n_examples, max_tokens_per_shard=tokens * 8, data=data,
        dataset=pathlib.Path("/data/images"),
    )
    root.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    blob = rng.integers(0, len(centers), size=(n_examples, tokens))
    acts = np.clip(centers[blob] + _grid(rng, blob.shape + (D_MODEL,), -2, 2, 8), -1, 1).astype(np.float32)
    labels = (blob[:, int(cls_token):] % N_CLASSES).astype(np.uint8)
    md.dump(root)
    with shards.ShardWriter(root, md) as w:
        for start in range(0, n_examples, 5):
            w.write_batch(acts[start : start + 5, None], start, labels[start : start + 5])
    return root / md.hash, acts, labels


def _sae_file(fpath: pathlib.Path) -> None:
    """A TopK SAE file whose encoder, bias and decoder lie on a 2^-3 grid."""
    cfg = jmod.SparseAutoencoderConfig(d_model=D_MODEL, d_sae=D_SAE, activation=jmod.TopK(top_k=4))
    params, state = jmod.init(cfg, __import__("jax").random.key(0))
    rng = np.random.default_rng(3)
    params = {
        "W_enc": _grid(rng, (D_MODEL, D_SAE), -4, 4, 8), "b_enc": _grid(rng, (D_SAE,), -2, 2, 8),
        "W_dec": _grid(rng, (D_SAE, D_MODEL), -4, 4, 8), "b_dec": _grid(rng, (D_MODEL,), -2, 2, 8),
    }
    jnn.dump(fpath, cfg, params, state)


def _probe_dir(root: pathlib.Path, cfgs) -> pathlib.Path:
    """probes.npz of two probes on a 2^-3 grid, with cfgs.json."""
    rng = np.random.default_rng(4)
    params = {"w": _grid(rng, (len(cfgs), D_MODEL, N_CLASSES), -4, 4, 8),
              "b": _grid(rng, (len(cfgs), N_CLASSES), -2, 2, 8)}
    jtraining.dump(root, cfgs, params)
    return root


@pytest.fixture(scope="module")
def seg(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ii")
    centers = _grid(np.random.default_rng(7), (8, D_MODEL), -6, 6, 8)
    train_dir, train_acts, train_labels = _write_shards(tmp / "train" / "saev" / "shards", 24, 0, centers)
    val_dir, _, _ = _write_shards(tmp / "val" / "saev" / "shards", 12, 1, centers)
    _sae_file(tmp / "sae.pt")
    cfgs = [jtraining.Train(shards=train_dir, layer=0, n_classes=N_CLASSES, learning_rate=lr, weight_decay=wd,
                            n_train=256, batch_size=32, seed=1)
            for lr, wd in ((1e-2, 1e-3), (3e-3, 1e-4))]
    probes = _probe_dir(tmp / "probes", cfgs)
    return {"tmp": tmp, "train": train_dir, "val": val_dir, "sae": tmp / "sae.pt", "probes": probes,
            "cfgs": cfgs, "train_rows": train_acts[:, :].reshape(-1, D_MODEL), "train_labels": train_labels}


def _ordered(pkg: str, shards_dir, batch_size: int = 64):
    return (OrderedConfig if pkg == "torch" else jdata.OrderedConfig)(shards=shards_dir, layer=0,
                                                                       batch_size=batch_size)


# --- semseg training -----------------------------------------------------------------


class FixedLoader:
    """Stands in for a ShuffledDataLoader: the same batches of (act,
    example_idx, token_idx), in the same order, every epoch."""

    drop_last = False

    def __init__(self, cfg, acts, ex, tok, metadata):
        self.batch_size = cfg.batch_size
        self.metadata = metadata
        n = len(acts)
        self.batches = [(acts[i : i + self.batch_size], ex[i : i + self.batch_size], tok[i : i + self.batch_size])
                        for i in range(0, n, self.batch_size)]

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        for a, e, t in self.batches:
            yield {"act": a.copy(), "example_idx": e.copy(), "token_idx": t.copy()}

    def shutdown(self):
        pass


def _fixed_batches(shards_dir, n: int, seed: int):
    """n rows of the shards in a seeded order: (acts, example_idx, token_idx)."""
    md = shards.Metadata.load(shards_dir)
    rng = np.random.default_rng(seed)
    ex = rng.integers(0, md.n_examples, size=n)
    tok = rng.integers(0, md.content_tokens_per_example, size=n)
    ds = jdata.IndexedDataset(jdata.IndexedConfig(shards=shards_dir, layer=0))
    acts = ds.take(ex * md.content_tokens_per_example + tok)["act"].astype(np.float32)
    return acts, ex.astype(np.int64), tok.astype(np.int64), md


@contextlib.contextmanager
def fixed_loaders(monkeypatch, shards_dir, n: int = 256, seed: int = 5):
    acts, ex, tok, md = _fixed_batches(shards_dir, n, seed)
    loader = lambda cfg: FixedLoader(cfg, acts, ex, tok, md)  # noqa: E731
    with monkeypatch.context() as m:
        m.setattr(training, "ShuffledDataLoader", loader)
        m.setattr(jtraining, "ShuffledDataLoader", loader)
        yield


@contextlib.contextmanager
def loss_spies(monkeypatch):
    """Each package's step losses, step by step."""
    seen = {"jax": [], "torch": []}
    real_j, real_t = jtraining._make_step, training._make_step

    def jstep(n_classes):
        step = real_j(n_classes)

        def spy(*a):
            out = step(*a)
            seen["jax"].append(np.asarray(out[2]))
            return out
        return spy

    def tstep(n_classes):
        step = real_t(n_classes)

        def spy(*a):
            out = step(*a)
            seen["torch"].append(out[2].numpy())
            return out
        return spy

    with monkeypatch.context() as m:
        m.setattr(jtraining, "_make_step", jstep)
        m.setattr(training, "_make_step", tstep)
        yield seen


def _port_cfgs(cfgs):
    return [training.Train(**dataclasses.asdict(c), device="cpu") for c in cfgs]


def test_semseg_train_matches_jax(seg, monkeypatch):
    cfgs = seg["cfgs"]
    init = {k: np.asarray(v) for k, v in jtraining.make_models(cfgs, D_MODEL).items()}
    with fixed_loaders(monkeypatch, seg["train"]), loss_spies(monkeypatch) as losses:
        want = {k: np.asarray(v) for k, v in jtraining.train(cfgs).items()}
        got = training.train(_port_cfgs(cfgs), init=init)
    assert len(losses["jax"]) == len(losses["torch"]) == 8
    np.testing.assert_allclose(np.stack(losses["torch"]), np.stack(losses["jax"]), rtol=TRAIN_REL)
    assert losses["torch"][-1][0] < losses["torch"][0][0]  # the faster probe learns in 8 steps
    for k in ("w", "b"):
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
        assert rel_norm(got[k], want[k]) <= TRAIN_REL, (k, rel_norm(got[k], want[k]))
    assert rel_norm(got["w"], init["w"]) > 1e-2  # the probes moved


def test_semseg_make_models_is_seeded():
    cfgs = _port_cfgs([jtraining.Train(n_classes=N_CLASSES, seed=3)] * 2)
    a, b = training.make_models(cfgs, D_MODEL), training.make_models(cfgs, D_MODEL)
    assert a["w"].shape == (2, D_MODEL, N_CLASSES) and torch.equal(a["w"], b["w"]) and not a["b"].any()
    assert abs(float(a["w"].std()) * np.sqrt(D_MODEL) - 1) < 0.2


def test_semseg_dump_load_round_trip(seg, tmp_path):
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(2, D_MODEL, N_CLASSES)).astype(np.float32),
              "b": rng.normal(size=(2, N_CLASSES)).astype(np.float32)}
    cfgs = seg["cfgs"]
    training.dump(tmp_path / "port" / "probe_step3", _port_cfgs(cfgs), {k: torch.from_numpy(v) for k, v in params.items()})
    jtraining.dump(tmp_path / "jax" / "probe_step3", cfgs, params)
    for loader in (training.load, jtraining.load):
        for side in ("port", "jax"):
            got = loader(tmp_path / side / "probe_step3")
            assert all(np.array_equal(got[k], params[k]) for k in params)
    for latest in (training.load_latest, jtraining.load_latest):
        for side in ("port", "jax"):
            got = latest(tmp_path / side)
            assert all(np.array_equal(got[k], params[k]) for k in params)
    assert [c["learning_rate"] for c in json.loads((tmp_path / "port" / "probe_step3" / "cfgs.json").read_text())] \
        == [c.learning_rate for c in cfgs]
    x = rng.normal(size=(64, D_MODEL)).astype(np.float32)
    labels = rng.integers(0, N_CLASSES, size=64)
    preds = training.predict(params, x, probe_i=1)
    assert np.array_equal(preds, jtraining.predict(params, x, probe_i=1))
    np.testing.assert_array_equal(training.get_class_ious(preds, labels, N_CLASSES),
                                  jtraining.get_class_ious(preds, labels, N_CLASSES))


# --- on the dyadic grid --------------------------------------------------------------


def test_latent_class_stats_match_jax(seg):
    cfg, params, state = nn.load(seg["sae"], device="cpu")
    f1, top = quantitative.latent_class_stats(cfg, params, state, _ordered("torch", seg["val"]), n_classes=N_CLASSES)
    jcfg, jparams, jstate = jnn.load(seg["sae"])
    jf1, jtop = jquant.latent_class_stats(jcfg, jparams, jstate, _ordered("jax", seg["val"]), n_classes=N_CLASSES)
    assert f1.dtype == jf1.dtype and top.dtype == jtop.dtype
    assert np.array_equal(f1, jf1) and np.array_equal(top, jtop)
    assert f1.max() > 0.2 and (quantitative.get_latent_lookup(f1) == jquant.get_latent_lookup(jf1)).all()


@pytest.mark.parametrize("probe_i,scale", [(0, -1.0), (1, 2.0)])
def test_quantify_matches_jax(seg, tmp_path, probe_i, scale):
    kw = dict(sae_ckpt=seg["sae"], probe_ckpt=seg["probes"], probe_i=probe_i, n_classes=N_CLASSES, scale=scale,
              seed=3)
    want = jquant.worker_fn(jquant.Config(acts=_ordered("jax", seg["val"]), dump_to=tmp_path / "jax", **kw))
    got = quantitative.worker_fn(quantitative.Config(acts=_ordered("torch", seg["val"]), dump_to=tmp_path / "port",
                                                     device="cpu", **kw))
    assert [r.method for r in got] == [r.method for r in want] == ["auto-feat", "rand-feat", "rand-vec"]
    for a, b in zip(got, want):
        assert [dataclasses.astuple(c) for c in a.class_results] == [dataclasses.astuple(c) for c in b.class_results]
        assert a.class_results
    assert any(c.n_changed_patches for r in got for c in r.class_results)
    assert (tmp_path / "port" / "results.csv").read_text() == (tmp_path / "jax" / "results.csv").read_text()


def test_quantify_runs_twice_alike(seg, tmp_path):
    for name in ("a", "b"):
        quantitative.worker_fn(quantitative.Config(sae_ckpt=seg["sae"], probe_ckpt=seg["probes"], n_classes=N_CLASSES,
                                                   acts=_ordered("torch", seg["val"], 48), dump_to=tmp_path / name,
                                                   device="cpu"))
    assert (tmp_path / "a" / "results.csv").read_text() == (tmp_path / "b" / "results.csv").read_text()


def test_count_fn_shows_specificity():
    """tests/test_interactive_interp_extras.py::test_count_fn_shows_specificity
    through the port: a latent aligned with one class's probe direction flips
    that class's patches and leaves the others alone."""
    d_model, d_sae, n_classes = 2, 2, 3
    sae_cfg = modeling.SparseAutoencoderConfig(d_model=d_model, d_sae=d_sae, activation=modeling.TopK(top_k=1))
    params = {
        "W_enc": torch.eye(d_model, d_sae), "b_enc": torch.zeros(d_sae),
        "W_dec": torch.eye(d_sae, d_model), "b_dec": torch.zeros(d_model),
    }
    state = modeling.init_state(sae_cfg, "cpu")
    probe_w = np.array([[0.0, 10.0, 0.0], [0.0, 0.0, 10.0]], np.float32)
    probe_b = np.zeros((n_classes,), np.float32)
    run = quantitative._count_fn(sae_cfg, params, state, probe_w, probe_b, scale=-5.0, n_classes=n_classes)
    x = np.array([[1.0, 0.0]] * 4 + [[0.0, 1.0]] * 4, np.float32)
    lookup = np.array([-1, 0, 1], np.int32)
    counts = np.stack([np.asarray(c) for c in run(x, lookup, np.ones(d_sae, np.float32), None)], axis=1)
    assert tuple(counts[1]) == (4, 4, 4, 0)
    assert tuple(counts[2]) == (4, 4, 4, 0)
    assert counts[0][1] == 0 and counts[0][3] == 0


@pytest.mark.parametrize("chunk", [1, 2, 1 << 26])
def test_count_chunks_agree(seg, monkeypatch, chunk):
    """The counts do not depend on how many classes a chunk holds."""
    cfg, params, state = nn.load(seg["sae"], device="cpu")
    probe = training.load(seg["probes"])
    run = quantitative._count_fn(cfg, params, state, probe["w"][0], probe["b"][0], -1.0, N_CLASSES)
    x = np.asarray(seg["train_rows"][:96])
    lookup = np.array([-1, 3, 7, 0, 31])
    rand = np.random.default_rng(0).normal(size=D_MODEL).astype(np.float32)
    top = np.full(D_SAE, 2.0, np.float32)
    want = [np.stack(run(x, lookup, top, r)) for r in (None, rand)]
    monkeypatch.setattr(quantitative, "CHUNK_ELEMENTS", chunk * 96 * N_CLASSES)
    got = [np.stack(run(x, lookup, top, r)) for r in (None, rand)]
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert (want[0][0] + want[0][2] == 96).all()


def test_visuals_match_jax(seg, tmp_path):
    kw = dict(sae_ckpt=seg["sae"], n_classes=N_CLASSES, top_k=3)
    want = jvisuals.worker_fn(jvisuals.Config(acts=_ordered("jax", seg["val"]), dump_to=tmp_path / "jax", **kw))
    got = visuals.worker_fn(visuals.Config(acts=_ordered("torch", seg["val"]), dump_to=tmp_path / "port",
                                           device="cpu", **kw))
    assert got == want and len(got) >= 2
    assert (tmp_path / "port" / "proposed_latents.json").read_bytes() == \
        (tmp_path / "jax" / "proposed_latents.json").read_bytes()


def test_validation_matches_jax(seg, tmp_path):
    kw = dict(probe_ckpt=seg["probes"], n_classes=N_CLASSES)
    want = jvalidation.worker_fn(jvalidation.Config(acts=_ordered("jax", seg["val"]), dump_to=tmp_path / "jax", **kw))
    got = validation.worker_fn(validation.Config(acts=_ordered("torch", seg["val"]), dump_to=tmp_path / "port", **kw))
    assert got == want
    assert (tmp_path / "port" / "validation.csv").read_text() == (tmp_path / "jax" / "validation.csv").read_text()


@pytest.mark.parametrize("max_agg_tokens,sparsity_max", [(8192, 1.1), (64, 0.3)])
def test_interactive_page_matches_jax(seg, tmp_path, max_agg_tokens, sparsity_max):
    kw = dict(sae_ckpt=seg["sae"], head_ckpt=seg["probes"], n_classes=N_CLASSES, n_examples=4, n_features=2,
              n_random=2, max_agg_tokens=max_agg_tokens, sparsity_max=sparsity_max, probe_i=1)
    want = jinteractive.worker_fn(jinteractive.Config(acts=_ordered("jax", seg["val"], 32),
                                                      out=tmp_path / "jax.html", **kw))
    got = interactive.worker_fn(interactive.Config(acts=_ordered("torch", seg["val"], 32), out=tmp_path / "port.html",
                                                   device="cpu", **kw))
    page, want_page = got.read_text(), want.read_text()
    payload = json.loads(re.search(r"const D = (\{.*?\});\n", page, re.S).group(1))
    assert len(payload["examples"]) == 4 and payload["candidates"] and payload["perClass"]
    assert page == want_page
    assert interactive._HTML == jinteractive._HTML


def test_semprobe_scores_match_jax(seg, tmp_path):
    md = shards.Metadata.load(seg["val"])
    labels = tuple(f"{task}-{'positive' if (i * 7 + len(task)) % 3 else 'negative'}"
                   for i in range(md.n_examples) for task in ["stripes" if i % 2 else "spots"])
    kw = dict(sae_ckpt=seg["sae"], shards=seg["val"], labels=labels, batch_size=48, threshold=1.5,
              include_latents=(2,))
    want = jscoring.score(jscoring.Score(dump_to=tmp_path / "jax", **kw))
    got = scoring.score(scoring.Score(dump_to=tmp_path / "port", device="cpu", **kw))
    assert got == want and set(got) == {"spots", "stripes"}
    assert (tmp_path / "port" / "semprobe_scores.json").read_bytes() == \
        (tmp_path / "jax" / "semprobe_scores.json").read_bytes()
    cfg, params, state = nn.load(seg["sae"], device="cpu")
    jcfg, jparams, jstate = jnn.load(seg["sae"])
    sums = scoring.image_latent_sums(cfg, params, state, seg["val"], 48)
    jsums = jscoring.image_latent_sums(jcfg, jparams, jstate, seg["val"], 48)
    assert sums.dtype == np.float64 and np.array_equal(sums, jsums)


# --- classification ------------------------------------------------------------------


@pytest.fixture(scope="module")
def cls_shards(tmp_path_factory):
    """[CLS] shards over an image folder of three classes (tiny PNGs): the
    targets come from the dataset the metadata names."""
    from PIL import Image

    tmp = tmp_path_factory.mktemp("cls")
    out = {}
    for split, n_per, seed in (("train", 8, 10), ("val", 4, 11)):
        root = tmp / "images" / split
        for c in range(3):
            (root / f"class{c}").mkdir(parents=True)
            for i in range(n_per):
                Image.new("RGB", (4, 4), (c * 80, i, 0)).save(root / f"class{c}" / f"{i}.png")
        data = shards.encode_dataset_cfg(datasets.ImgFolder(root=root))
        centers = _grid(np.random.default_rng(12), (3, D_MODEL), -6, 6, 8)
        n = 3 * n_per
        shards_dir, acts, _ = _write_shards(tmp / split / "saev" / "shards", n, seed, centers, cls_token=True,
                                            data=data)
        # Each image's [CLS] row its class's centre plus noise (images are in
        # class-folder order).
        rng = np.random.default_rng(seed + 100)
        md = shards.Metadata.load(shards_dir)
        cls_rows = np.repeat(centers, n_per, axis=0) + _grid(rng, (n, D_MODEL), -3, 3, 8)
        info = shards.ShardInfo.load(shards_dir)
        start = 0
        for s in info:
            mm = np.memmap(shards_dir / s.name, mode="r+", dtype=np.float32, shape=md.shard_shape)
            mm[: s.n_examples, 0, 0] = cls_rows[start : start + s.n_examples]
            mm.flush()
            start += s.n_examples
        out[split] = shards_dir
    return out


def _cls_cfgs(cls_shards, tmp_path, pkg: str):
    mod = cls if pkg == "torch" else jcls
    base = mod.Train(train_shards=cls_shards["train"], val_shards=cls_shards["val"], layer=0, n_epochs=3,
                     batch_size=8, ckpt_path=tmp_path / pkg, **({"device": "cpu"} if pkg == "torch" else {}))
    cfgs, errs = mod.grid(base, {"learning_rate": [1e-2, 1e-3], "weight_decay": [1e-4, 1e-3]})
    assert not errs
    return cfgs


def test_classification_grid_matches_jax(cls_shards, tmp_path):
    got, want = (_cls_cfgs(cls_shards, tmp_path, pkg) for pkg in ("torch", "jax"))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        a = dataclasses.asdict(a)
        assert a.pop("device") == "cpu" and a | {"ckpt_path": None} == dataclasses.asdict(b) | {"ckpt_path": None}


def test_classification_train_matches_jax(cls_shards, tmp_path):
    import jax

    cfgs, jcfgs = _cls_cfgs(cls_shards, tmp_path, "torch"), _cls_cfgs(cls_shards, tmp_path, "jax")
    assert np.array_equal(cls.load_targets(cls_shards["train"]), jcls.load_targets(cls_shards["train"]))
    assert np.array_equal(cls.load_cls_features(cls_shards["train"], 0), jcls.load_cls_features(cls_shards["train"], 0))
    want, want_classes = jcls.train(jcfgs)
    # The JAX package's initial draws (training.py's `train`).
    keys = jax.random.split(jax.random.key(jcfgs[0].seed), len(jcfgs))
    init = {"w": np.stack([np.asarray(jax.random.normal(k, (D_MODEL, 3), jax.numpy.float32)) / np.sqrt(D_MODEL)
                           for k in keys]),
            "b": np.zeros((len(jcfgs), 3), np.float32)}
    got, classes = cls.train(cfgs, init=init)
    assert classes == want_classes == ["0", "1", "2"]
    for k in ("w", "b"):
        assert rel_norm(got[k], want[k]) <= TRAIN_REL, (k, rel_norm(got[k], want[k]))
    accs = cls.evaluate(got, cls_shards["val"], 0)
    assert np.array_equal(accs, jcls.evaluate(want, cls_shards["val"], 0)) and accs.max() > 0.5
    cls.dump(tmp_path / "port", cfgs, got, accs)
    report = json.loads((tmp_path / "port" / "report.json").read_text())
    assert [r["val_accuracy"] for r in report] == accs.tolist()


def test_classification_main_writes_the_jax_files(cls_shards, tmp_path):
    accs = cls.main(_cls_cfgs(cls_shards, tmp_path, "torch")[:2])
    assert accs.shape == (2,)
    with np.load(tmp_path / "torch" / "probes.npz") as fd:
        assert fd["w"].shape == (2, D_MODEL, 3) and fd["b"].shape == (2, 3)
    assert len(json.loads((tmp_path / "torch" / "report.json").read_text())) == 2


def test_classification_cli_lists_the_same_commands(capsys):
    assert sorted(cls_main.COMMANDS) == ["caltech101", "cub", "flowers", "train"]
    from saev_tpu.utils import cli as jcli
    from saev_tpu_torch.utils import cli

    with pytest.raises(SystemExit):
        jcli.run({"train": jcls_main.train, "flowers": jcls_main.download.flowers, "cub": jcls_main.download.cub,
                  "caltech101": jcls_main.download.caltech101}, argv=["--help"])
    want = capsys.readouterr().out
    with pytest.raises(SystemExit):
        cli.run(cls_main.COMMANDS, argv=["--help"])
    assert capsys.readouterr().out == want
    assert sorted(semseg_main.COMMANDS) == ["interactive", "quantify", "train", "validate", "visuals"]


def test_transforms_match_jax():
    from PIL import Image

    rng = np.random.default_rng(0)
    for size in [(800, 600), (600, 800), (512, 512), (449, 2000)]:
        img = Image.fromarray(rng.integers(0, 255, (size[1], size[0], 3), dtype=np.uint8))
        got = transforms.for_webapp(img)
        assert got.size == (448, 448)
        assert np.array_equal(np.asarray(got), np.asarray(jtransforms.for_webapp(img)))
        assert np.array_equal(transforms.for_figures(img), jtransforms.for_figures(img))


def test_figures_match_jax(tmp_path):
    from PIL import Image

    img = Image.fromarray(np.random.default_rng(0).integers(0, 255, (300, 400, 3), dtype=np.uint8))
    img.save(tmp_path / "in.png")
    for mod, name in ((make_figures, "port"), (jfigures, "jax")):
        mod.overview(mod.Overview(image=tmp_path / "in.png", out=tmp_path / name, size=64, grid=4, patches=(0, 5)))
    files = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "jax").iterdir()) and len(files) == 3
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()


# --- FishVista's supervised skyline ---------------------------------------------------


def test_fishvista_supervised_matches_jax(seg, tmp_path, monkeypatch):
    kw = dict(learning_rates=(1e-2, 3e-3), weight_decays=(1e-3,), n_train=256, batch_size=32, n_classes=N_CLASSES,
              seed=1)
    jcfg = jsupervised.Config(train_acts=jdata.OrderedConfig(shards=seg["train"], layer=0, batch_size=64),
                              test_acts=jdata.OrderedConfig(shards=seg["val"], layer=0, batch_size=64),
                              dump_to=tmp_path / "jax", **kw)
    tcfg = supervised.Config(train_acts=_ordered("torch", seg["train"]), test_acts=_ordered("torch", seg["val"]),
                             dump_to=tmp_path / "port", device="cpu", **kw)
    real = training.make_models
    with fixed_loaders(monkeypatch, seg["train"]):
        want = jsupervised.worker_fn(jcfg)
        # The port's heads start from the JAX package's draw.
        monkeypatch.setattr(training, "make_models", lambda cfgs, d: {
            k: torch.tensor(np.asarray(v)) for k, v in jtraining.make_models(cfgs, d).items()})
        got = supervised.worker_fn(tcfg)
        monkeypatch.setattr(training, "make_models", real)
    assert got["n_probes"] == want["n_probes"] == 2 and got["d_model"] == want["d_model"]
    for a, b in zip(got["results"], want["results"]):
        assert (a["learning_rate"], a["weight_decay"]) == (b["learning_rate"], b["weight_decay"])
        np.testing.assert_allclose(a["ap_per_class"], b["ap_per_class"], rtol=0, atol=FISHVISTA_AP)
    assert json.loads((tmp_path / "port" / "fishvista_supervised.json").read_text())["method"] == "supervised-linear"


def test_probe_scorer_is_the_numpy_product():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, D_MODEL, 4)).astype(np.float32)
    b = rng.normal(size=(3, 4)).astype(np.float32)
    x = rng.normal(size=(50, D_MODEL)).astype(np.float32)
    got = supervised._ProbeScorer(w, b, "cpu").transform(x)
    want = jsupervised._ProbeScorer(w, b).transform(x)
    assert got.shape == (50, 12) and supervised._ProbeScorer(w, b, "cpu").n_prototypes == 12
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# --- the card by default -------------------------------------------------------------


ENTRY_POINTS = {
    "semseg train": lambda s: training.train([training.Train(**dataclasses.asdict(c)) for c in s["cfgs"]]),
    "semseg make_models": lambda s: training.make_models([training.Train()], D_MODEL),
    "quantify": lambda s: quantitative.worker_fn(quantitative.Config(sae_ckpt=s["sae"], probe_ckpt=s["probes"])),
    "visuals": lambda s: visuals.worker_fn(visuals.Config(sae_ckpt=s["sae"])),
    "interactive": lambda s: interactive.worker_fn(interactive.Config(sae_ckpt=s["sae"], head_ckpt=s["probes"])),
    "semprobe score": lambda s: scoring.score(scoring.Score(sae_ckpt=s["sae"], shards=s["val"])),
    "classification train": lambda s: cls.train([cls.Train(train_shards=s["train"])]),
    "fishvista supervised": lambda s: supervised.worker_fn(supervised.Config(
        train_acts=_ordered("torch", s["train"]), test_acts=_ordered("torch", s["val"]))),
    "probe scorer": lambda s: supervised._ProbeScorer(np.zeros((1, 2, 3), np.float32), np.zeros((1, 3), np.float32)),
}


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal where torch sees no card")
@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_default_to_the_card(seg, name):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name](seg)
