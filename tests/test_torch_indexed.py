"""Random access to shard rows in the port (saev_tpu_torch/data/indexed.py,
`shards.Index` and `shards.IndexMap`) against the JAX package's, on shards
written by the port's `ShardWriter` (3 shards of 4, 4 and 2 examples, a CLS
token, layers 0 and 2), with and without labels.bin:

- `IndexMap.from_global` for every global index and `len`, for `tokens`
  special, content and all and `layer` an int: equal `Index` fields;
- `Dataset.__getitem__` for every index and `take` on a shuffled sample:
  every array bit for bit, every int equal, `token_label` where the JAX
  package gives one;
- `layer="all"`: equal lengths, and `from_global` raises NotImplementedError
  in both;
- the errors: a root with no activations (RuntimeError), an index out of
  range (IndexError), "special" without a CLS token (AssertionError),
  raised alike.
"""

import dataclasses
import pathlib

import numpy as np
import pytest

from saev_tpu.data import indexed as jindexed
from saev_tpu.data import shards as jshards
from saev_tpu_torch.data import IndexedConfig, IndexedDataset, indexed, shards

D_MODEL, TOKENS, N_EXAMPLES, LAYERS = 8, 6, 10, (0, 2)


def _write(tmp_path: pathlib.Path, *, labels: bool, cls_token: bool = True) -> pathlib.Path:
    root = tmp_path / "saev" / "shards"
    root.mkdir(parents=True)
    md = shards.Metadata(
        family="clip", ckpt="random", layers=LAYERS, content_tokens_per_example=TOKENS, cls_token=cls_token,
        d_model=D_MODEL, n_examples=N_EXAMPLES, max_tokens_per_shard=4 * (TOKENS + cls_token) * len(LAYERS),
        data="e30=", dataset=pathlib.Path("/data/images"),
    )
    md.dump(root)
    rng = np.random.default_rng(0)
    with shards.ShardWriter(root, md) as w:
        for start in range(0, N_EXAMPLES, 3):
            n = min(3, N_EXAMPLES - start)
            acts = rng.normal(size=(n, len(LAYERS), TOKENS + cls_token, D_MODEL)).astype(np.float32)
            lab = rng.integers(0, 200, size=(n, TOKENS), dtype=np.uint8) if labels else None
            w.write_batch(acts, start, patch_labels=lab)
    assert md.n_shards == 3
    return root / md.hash


CASES = [(tokens, 2, labels) for tokens in ("special", "content", "all") for labels in (False, True)]


@pytest.mark.parametrize("tokens,layer,labels", CASES)
def test_indexed_dataset_matches_jax(tmp_path, tokens, layer, labels):
    shards_dir = _write(tmp_path, labels=labels)
    assert (shards_dir / "labels.bin").exists() == labels
    ds = IndexedDataset(IndexedConfig(shards=shards_dir, tokens=tokens, layer=layer))
    jds = jindexed.Dataset(jindexed.Config(shards=shards_dir, tokens=tokens, layer=layer))
    assert len(ds) == len(jds) > 0 and ds.d_model == jds.d_model == D_MODEL
    for i in range(len(jds)):
        assert dataclasses.asdict(ds.index_map.from_global(i)) == dataclasses.asdict(jds.index_map.from_global(i))
        got, want = ds[i], jds[i]
        assert got.keys() == want.keys()
        assert got["act"].dtype == np.float32
        np.testing.assert_array_equal(got["act"].view(np.int32), want["act"].view(np.int32))
        for k in want.keys() - {"act"}:
            assert got[k] == want[k], (i, k)
    idx = np.random.default_rng(1).permutation(len(jds))[: max(1, len(jds) // 2)]
    got, want = ds.take(idx), jds.take(idx)
    assert got.keys() == want.keys() == ({"act", "example_idx", "token_idx"} | ({"token_label"} if labels else set()))
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(ds._mmaps) == 3  # one memmap a shard, opened once


@pytest.mark.parametrize("tokens", ["special", "content", "all"])
def test_index_map_all_layers_matches_jax(tmp_path, tokens):
    shards_dir = _write(tmp_path, labels=False)
    md, jmd = shards.Metadata.load(shards_dir), jshards.Metadata.load(shards_dir)
    im, jim = shards.IndexMap(md, tokens, "all"), jshards.IndexMap(jmd, tokens, "all")
    assert len(im) == len(jim) > 0
    for m in (im, jim):
        with pytest.raises(NotImplementedError, match="from_global"):
            m.from_global(0)


def test_indexed_errors_match_jax(tmp_path):
    empty = tmp_path / "missing"
    for pkg in (indexed, jindexed):
        with pytest.raises(RuntimeError, match="Activations are not saved"):
            pkg.Dataset(pkg.Config(shards=empty))
    shards_dir = _write(tmp_path, labels=False)
    for pkg in (indexed, jindexed):
        ds = pkg.Dataset(pkg.Config(shards=shards_dir, tokens="content", layer=0))
        for bad in (-1, len(ds)):
            with pytest.raises(IndexError, match="out of range"):
                ds[bad]
            with pytest.raises(IndexError, match="out of range"):
                ds.take(np.array([0, bad]))
        with pytest.raises(AssertionError, match="No match for layer"):
            pkg.Dataset(pkg.Config(shards=shards_dir, tokens="content", layer=1))
    no_cls = _write(tmp_path / "no_cls", labels=False, cls_token=False)
    for pkg in (indexed, jindexed):
        with pytest.raises(AssertionError):
            pkg.Dataset(pkg.Config(shards=no_cls, tokens="special", layer=0))
