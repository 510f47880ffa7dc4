"""The port's shard protocol and shuffled loader (saev_tpu_torch.data) against
the JAX package's (saev_tpu.data), from the same numpy activations:

- `Metadata.hash` is the same for the same fields, so both packages look for
  the same shard directory;
- shards written by the two `ShardWriter`s are byte-identical (metadata.json,
  shards.json, acts*.bin, labels.bin), and each package's loader reads the
  other's;
- over one epoch the port's loader (row sampling and descriptor sampling,
  native and numpy shard I/O) yields the same multiset of (example_idx,
  token_idx) as JAX's, each row bit for bit the shard's value; scale_norm
  raises in both;
- n_batches, n_samples and BatchLimiter's batch counts are equal, and both
  refusals (world > n_shards; drop_last with fewer samples than a batch)
  raise in both;
- the loader's fault paths, as tests/test_loader_faults.py holds the JAX
  package's: a worker's crash re-raised with its traceback, a dead manager
  raising rather than waiting, a bad layer, reuse after a fault.

Every loader here reads a tiny shard set with an explicit batch_timeout_s and
is shut down in a `finally`.
"""

import collections
import dataclasses
import pathlib

import numpy as np
import pytest

from saev_tpu.data import shards as jshards
from saev_tpu.data import shuffled as jshuffled
from saev_tpu.utils import scheduling as jscheduling
from saev_tpu_torch.data import _native, shards, shuffled
from saev_tpu_torch.utils import scheduling

D, TOKENS, LAYERS = 16, 8, (3, 7)


def _md(mod, n_examples=24, **kw):
    fields = dict(
        family="clip", ckpt="random", layers=LAYERS, content_tokens_per_example=TOKENS,
        cls_token=True, d_model=D, n_examples=n_examples, max_tokens_per_shard=(TOKENS + 1) * 2 * 5,
        data="eyJrZXkiOiAidmFsdWUifQ==", dataset=pathlib.Path("/data/images"),
    )
    fields.update(kw)
    if "pixel_agg" in fields:
        fields["pixel_agg"] = mod.PixelAgg(fields["pixel_agg"])
    return mod.Metadata(**fields)


def _acts(md, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(md.n_examples, len(md.layers), md.tokens_per_example, md.d_model)).astype(np.float32)


def _root(tmp_path: pathlib.Path, name: str) -> pathlib.Path:
    root = tmp_path / name / "saev" / "shards"
    root.mkdir(parents=True)
    return root


def _write(mod, root, md, acts, labels=None, batch=5) -> pathlib.Path:
    md.dump(root)
    with mod.ShardWriter(root, md) as w:
        for start in range(0, md.n_examples, batch):
            w.write_batch(
                acts[start : start + batch], start,
                None if labels is None else labels[start : start + batch],
            )
    return root / md.hash


def _loader_cfg(mod, shards_dir, **kw):
    fields = dict(shards=shards_dir, layer=LAYERS[1], batch_size=32, n_threads=2, buffer_size=4,
                  batch_timeout_s=5.0, seed=11)
    fields.update(kw)
    return mod.Config(**fields)


def _epoch(dl):
    """Every batch of one epoch: (example_idx, token_idx) pairs and rows."""
    pairs, rows = [], []
    try:
        for b in dl:
            pairs.extend(zip(b["example_idx"].tolist(), b["token_idx"].tolist()))
            rows.append(np.asarray(b["act"]))
    finally:
        dl.shutdown()
    return pairs, np.concatenate(rows) if rows else np.zeros((0, D), np.float32)


def _assert_rows_are_shards(pairs, rows, acts, layer_i, cls=True):
    idx = np.asarray(pairs)
    want = acts[idx[:, 0], layer_i, idx[:, 1] + int(cls)]
    assert rows.dtype == np.float32
    np.testing.assert_array_equal(rows.view(np.int32), want.view(np.int32))


HASH_CASES = {
    "default": {},
    "no-cls": dict(cls_token=False),
    "prefer-fg": dict(pixel_agg="prefer-fg"),
    "unicode-ckpt": dict(ckpt="hf-hub:org/modèle-ü", family="dinov3"),
    "one-layer": dict(layers=(11,), max_tokens_per_shard=1000, n_examples=1),
}


@pytest.mark.parametrize("fields", HASH_CASES.values(), ids=HASH_CASES.keys())
def test_metadata_hash_matches_jax(fields):
    jmd, md = _md(jshards, **fields), _md(shards, **fields)
    assert md.hash == jmd.hash
    assert (md.examples_per_shard, md.n_shards, md.shard_shape) == (
        jmd.examples_per_shard, jmd.n_shards, jmd.shard_shape
    )


@pytest.mark.parametrize("with_labels", [False, True], ids=["acts", "acts+labels"])
def test_shard_writers_are_byte_identical(tmp_path, with_labels):
    jmd, md = _md(jshards), _md(shards)
    acts = _acts(md)
    labels = (
        np.random.default_rng(1).integers(0, 5, size=(md.n_examples, TOKENS)).astype(np.uint8)
        if with_labels else None
    )
    jdir = _write(jshards, _root(tmp_path, "jax"), jmd, acts, labels)
    tdir = _write(shards, _root(tmp_path, "torch"), md, acts, labels)
    assert jdir.name == tdir.name
    jfiles = sorted(p.name for p in jdir.iterdir())
    assert jfiles == sorted(p.name for p in tdir.iterdir())
    assert ("labels.bin" in jfiles) == with_labels and len([f for f in jfiles if f.startswith("acts")]) == md.n_shards
    for name in jfiles:
        assert (jdir / name).read_bytes() == (tdir / name).read_bytes(), name
    # The port reads what it wrote as the JAX package reads it.
    assert shards.Metadata.load(tdir) == md
    assert [dataclasses.asdict(s) for s in shards.ShardInfo.load(tdir)] == [
        dataclasses.asdict(s) for s in jshards.ShardInfo.load(jdir)
    ]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_loader_reads_the_others_shards(tmp_path, writer):
    mods = {"jax": jshards, "torch": shards}
    md = _md(mods[writer])
    acts = _acts(md, seed=3)
    shards_dir = _write(mods[writer], _root(tmp_path, writer), md, acts)
    for loader in (jshuffled, shuffled):
        pairs, rows = _epoch(loader.DataLoader(_loader_cfg(loader, shards_dir)))
        assert len(pairs) == md.n_examples * TOKENS == len(set(pairs))
        _assert_rows_are_shards(pairs, rows, acts, layer_i=1)


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("descriptors", [False, True], ids=["rows", "descriptors"])
def test_epoch_matches_jax(tmp_path, monkeypatch, descriptors, route):
    md = _md(shards, n_examples=30)
    acts = _acts(md, seed=5)
    shards_dir = _write(shards, _root(tmp_path, "s"), md, acts)
    if route == "numpy":
        monkeypatch.setattr(_native, "_LIB", None)
        monkeypatch.setattr(_native, "_TRIED", True)
    assert _native.route() == route or route == "native" and _native.route() == "numpy"
    got = _epoch(shuffled.DataLoader(_loader_cfg(shuffled, shards_dir, descriptor_sampling=descriptors)))
    want = _epoch(jshuffled.DataLoader(_loader_cfg(jshuffled, shards_dir, descriptor_sampling=descriptors)))
    assert collections.Counter(got[0]) == collections.Counter(want[0])
    assert len(got[0]) == md.n_examples * TOKENS == len(set(got[0]))
    _assert_rows_are_shards(*got, acts, layer_i=1)
    _assert_rows_are_shards(*want, acts, layer_i=1)


def test_scale_norm_raises_in_both(tmp_path):
    shards_dir = _write(shards, _root(tmp_path, "s"), _md(shards), _acts(_md(shards)))
    for loader in (jshuffled, shuffled):
        with pytest.raises(NotImplementedError, match="scale_norm"):
            loader.DataLoader(_loader_cfg(loader, shards_dir, scale_norm=True))


COUNT_CASES = {
    "keep-last": dict(batch_size=50),
    "drop-last": dict(batch_size=50, drop_last=True),
    "ignore-labels": dict(batch_size=16, ignore_labels=[0, 2]),
    "rank-1-of-2": dict(batch_size=16, rank=1, world=2),
}


@pytest.mark.parametrize("kw", COUNT_CASES.values(), ids=COUNT_CASES.keys())
def test_counts_match_jax(tmp_path, kw):
    md = _md(shards)
    labels = np.random.default_rng(2).integers(0, 4, size=(md.n_examples, TOKENS)).astype(np.uint8)
    shards_dir = _write(shards, _root(tmp_path, "s"), md, _acts(md), labels)
    dl = shuffled.DataLoader(_loader_cfg(shuffled, shards_dir, **kw))
    jdl = jshuffled.DataLoader(_loader_cfg(jshuffled, shards_dir, **kw))
    assert (dl.n_batches, dl.n_samples, len(dl)) == (jdl.n_batches, jdl.n_samples, len(jdl))
    for n in (10, 100, 1000):
        lim, jlim = scheduling.BatchLimiter(dl, n), jscheduling.BatchLimiter(jdl, n)
        assert len(lim) == len(jlim)
    # One limited pass of the port's loader against its expected count.
    lim = scheduling.BatchLimiter(dl, 3 * dl.batch_size + 1)
    try:
        sizes = [len(b["act"]) for b in lim]
    finally:
        dl.shutdown()
    assert len(sizes) == len(lim) == 4 and sum(sizes) >= 3 * dl.batch_size + 1


def test_refusals_raise_in_both(tmp_path):
    md = _md(shards)
    shards_dir = _write(shards, _root(tmp_path, "s"), md, _acts(md))
    for loader in (jshuffled, shuffled):
        with pytest.raises(ValueError, match="world="):
            loader.DataLoader(_loader_cfg(loader, shards_dir, rank=0, world=md.n_shards + 1))
        with pytest.raises(ValueError, match="drop_last"):
            loader.DataLoader(_loader_cfg(loader, shards_dir, drop_last=True, batch_size=md.n_examples * TOKENS + 1))


# --- fault paths (tests/test_loader_faults.py, for the port) ---


def _fault_loader(tmp_path, **kw):
    md = _md(shards, n_examples=8)
    shards_dir = _write(shards, _root(tmp_path, "s"), md, _acts(md))
    fields = dict(batch_size=8, buffer_size=4, batch_timeout_s=1.0, seed=7)
    fields.update(kw)
    return shards_dir, shuffled.DataLoader(_loader_cfg(shuffled, shards_dir, **fields))


def _truncate_all_shards(shards_dir: pathlib.Path) -> None:
    """Corrupt every shard after the loader's checks, so the worker's memmap fails."""
    files = sorted(shards_dir.glob("acts*.bin"))
    assert files
    for f in files:
        with open(f, "r+b") as fd:
            fd.truncate(16)


@pytest.mark.parametrize("min_buffer_fill", [0.0, 0.9], ids=["streaming", "warm-up"])
def test_worker_exception_reraised_with_remote_traceback(tmp_path, min_buffer_fill):
    shards_dir, dl = _fault_loader(tmp_path, min_buffer_fill=min_buffer_fill)
    _truncate_all_shards(shards_dir)
    try:
        with pytest.raises(RuntimeError, match="crashed") as excinfo:
            for _ in dl:
                pass
    finally:
        dl.shutdown()
    assert "Traceback" in str(excinfo.value)


@pytest.mark.parametrize("min_buffer_fill,match", [(0.0, "Manager thread died"),
                                                   (0.5, "Manager thread died while waiting")],
                         ids=["streaming", "warm-up"])
def test_dead_manager_raises_not_waits(tmp_path, monkeypatch, min_buffer_fill, match):
    _, dl = _fault_loader(tmp_path, min_buffer_fill=min_buffer_fill)
    monkeypatch.setattr(shuffled, "_manager_main", lambda *a, **k: None)
    try:
        with pytest.raises(RuntimeError, match=match):
            for _ in dl:
                pass
    finally:
        dl.shutdown()


def test_invalid_layer_propagates_from_manager(tmp_path):
    _, dl = _fault_loader(tmp_path, layer=5)
    try:
        with pytest.raises(RuntimeError, match="manager crashed"):
            for _ in dl:
                pass
    finally:
        dl.shutdown()


def test_loader_reusable_after_fault(tmp_path, monkeypatch):
    _, dl = _fault_loader(tmp_path)
    real_manager = shuffled._manager_main
    monkeypatch.setattr(shuffled, "_manager_main", lambda *a, **k: None)
    try:
        with pytest.raises(RuntimeError):
            for _ in dl:
                pass
        monkeypatch.setattr(shuffled, "_manager_main", real_manager)
        batches = list(dl)
    finally:
        dl.shutdown()
    assert sum(len(b["act"]) for b in batches) == dl.n_samples
