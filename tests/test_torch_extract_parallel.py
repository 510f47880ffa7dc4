"""Data-parallel extraction of the port (saev_tpu_torch.data.extract's
`worker_fn` in a process group, `framework.shards` under torchrun) on the CPU.

Ranks are processes spawned with torch.multiprocessing over gloo
(tests/torch_ranks.py `extract_rank`), one spawn a world, each running every
case of its world; each collective waits at most 60 s. The one-rank runs
run in this process under the ranks' thread count (one), so that the CPU's
products see the same blocking.

- At 2 and 3 ranks, fake-clip over FakeImg and FakeImgSeg (21 examples,
  batches of 8: a ragged last batch, and batches that straddle the 5-example
  shards), and at 2 ranks Bird-MAE over a BirdCLEF fixture: the directory is
  byte for byte the port's one-rank directory (metadata.json, shards.json,
  every acts*.bin, labels.bin or its absence, the file list), and each rank
  ran the forwards of its batches (`parallel.batch_spans`).
- The same fake-clip directories against the JAX package's `worker_fn` on
  its data-parallel path (the 8 virtual devices of tests/conftest.py shard
  each batch of 8; the last batch of 5 runs unsharded): metadata.json and
  shards.json equal as bytes, labels.bin bit for bit, the activations
  within tests/test_torch_extract.py's rtol 2e-4, atol 2e-5 (float32
  products in both), with the JAX package's fake-clip params in both.
- 3 ranks over 2 batches: the rank with none takes part in every
  agreement.
- A rank whose forward raises fails every rank, and no shards.json is
  written.
- `torchrun --nproc-per-node 2 -m saev_tpu_torch.framework.shards ...
  --device cpu` writes the single-process command's directory.
"""

import dataclasses
import json
import os
import pathlib
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch_ranks

from saev_tpu.data import datasets as jdatasets
from saev_tpu.data import extract as jextract
from saev_tpu.data import fake_vit as jfake
from saev_tpu.data import shards as jshards
from saev_tpu_torch import parallel
from saev_tpu_torch.data import datasets as tdatasets
from saev_tpu_torch.data import extract as textract
from saev_tpu_torch.data import fake_vit as tfake
from saev_tpu_torch.data import shards as tshards
from saev_tpu_torch.models import bird_mae as tbird
from saev_tpu_torch.models import vit as tvit
from saev_tpu_torch.scripts import vit_route

ROOT = pathlib.Path(__file__).resolve().parent.parent
RTOL, ATOL = 2e-4, 2e-5  # tests/test_torch_extract.py's

# Fake-clip: 21 examples in batches of 8 (8, 8, 5); 17 tokens (CLS and 16
# patches) at 2 layers, 5 examples a shard: 5 acts files, the last holding 1.
N_FAKE, FAKE_BATCH, FAKE_PER_SHARD = 21, 8, 5
FAKE_KW = dict(family="fake-clip", ckpt=jfake.CKPT, content_tokens_per_example=16, cls_token=True,
               d_model=jfake.D_MODEL, layers=[0, 2], batch_size=FAKE_BATCH, n_workers=2,
               max_tokens_per_shard=FAKE_PER_SHARD * 17 * 2)
# Bird-MAE at d_model 64, 2 layers: 5 Aves clips of 7 in batches of 4, 2
# examples a shard (257 tokens at 2 layers).
BIRD_SPEC = dict(d_model=64, n_layers=2, n_heads=4)
BIRD_LABELS = {"1139490": "Aves", "abethr1": "Aves", "41663": "Insecta", "amekes": "Aves"}
BIRD_KW = dict(family="bird-mae", content_tokens_per_example=256, cls_token=True, d_model=64, layers=[0, 1],
               batch_size=4, n_workers=2, max_tokens_per_shard=2 * 257 * 2)

WORLD_CASES = {2: ("plain", "seg", "bird", "fail"), 3: ("plain", "seg", "few")}
DIRS = [(w, c) for w, cases in WORLD_CASES.items() for c in cases if c != "fail"]


def _write_birdclef(root: pathlib.Path) -> None:
    """taxonomy.csv, train.csv and 7 clips of 2 s (one not Aves), int16 at
    32 kHz."""
    import scipy.io.wavfile

    rng = np.random.default_rng(5)
    rows = [list(BIRD_LABELS)[i % len(BIRD_LABELS)] for i in range(7)]
    root.mkdir(parents=True)
    with open(root / "taxonomy.csv", "w") as fd:
        fd.write("primary_label,inat_taxon_id,scientific_name,common_name,class_name\n")
        for i, (label, cls) in enumerate(BIRD_LABELS.items()):
            fd.write(f"{label},{1000 + i},Genus species{i},Name {i},{cls}\n")
    with open(root / "train.csv", "w") as fd:
        fd.write("primary_label,secondary_labels,type,filename,collection,rating\n")
        for n, label in enumerate(rows):
            (root / "train_audio" / label).mkdir(parents=True, exist_ok=True)
            scipy.io.wavfile.write(root / "train_audio" / label / f"XC{n}.wav", 32_000,
                                   vit_route.synth_clip(rng, n=64_000))
            fd.write(f"{label},[],['call'],{label}/XC{n}.wav,XC,4.0\n")


def _case(name: str, files: pathlib.Path) -> dict:
    """worker_fn's arguments for a case (all but shards_root and device),
    and what the ranks load."""
    params = {"params": str(files / "fake_params.pkl")}
    if name in ("plain", "fail"):
        return dict(name=name, kw=dict(FAKE_KW, data=tdatasets.FakeImg(n_examples=N_FAKE)), **params)
    if name == "seg":
        return dict(name=name, kw=dict(FAKE_KW, data=tdatasets.FakeImgSeg(n_examples=N_FAKE),
                                       pixel_agg=tshards.PixelAgg.PREFER_FG), **params)
    if name == "few":  # 2 batches for 3 ranks
        return dict(name=name, kw=dict(FAKE_KW, data=tdatasets.FakeImg(n_examples=7), batch_size=4), **params)
    assert name == "bird"
    return dict(name=name, bird_spec=BIRD_SPEC,
                kw=dict(BIRD_KW, ckpt=f"Bird-MAE-Base={files / 'bird.pt'}",
                        data=tdatasets.BirdClef2025(root=files / "birdclef")))


@pytest.fixture(scope="module")
def files(tmp_path_factory) -> pathlib.Path:
    """The JAX package's fake-clip params (pickled numpy), a small Bird-MAE
    checkpoint and a BirdCLEF fixture."""
    root = tmp_path_factory.mktemp("extract_parallel")
    params = jax.tree.map(np.asarray, jfake._make_params(0))
    (root / "fake_params.pkl").write_bytes(pickle.dumps(params))
    spec = dataclasses.replace(tbird.PRETRAINED_SPECS["Bird-MAE-Base"], **BIRD_SPEC)
    torch.save(vit_route.bird_mae_state_dict(spec, torch.Generator().manual_seed(0)), root / "bird.pt")
    _write_birdclef(root / "birdclef")
    return root


@pytest.fixture(scope="module")
def ranks(files, tmp_path_factory):
    """world -> the directory its spawn wrote into (one spawn a world, on
    first use)."""
    done = {}

    def run(world: int) -> pathlib.Path:
        if world not in done:
            out = tmp_path_factory.mktemp(f"ranks{world}")
            cases = [dict(_case(c, files), **({"fail_rank": 1} if c == "fail" else {}))
                     for c in WORLD_CASES[world]]
            torch_ranks.spawn(torch_ranks.extract_rank, world, out, cases, limit=120.0)
            done[world] = out
        return done[world]

    return run


@pytest.fixture(scope="module")
def one_rank(files, tmp_path_factory):
    """case -> the port's one-process directory, run here at one thread
    with the ranks' params and spec."""
    done = {}

    def run(name: str) -> pathlib.Path:
        if name not in done:
            case = _case(name, files)
            root = tmp_path_factory.mktemp(f"one_{name}") / "saev" / "shards"
            root.mkdir(parents=True)
            params = pickle.loads((files / "fake_params.pkl").read_bytes())
            threads = torch.get_num_threads()
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(tfake, "_make_params", lambda seed: tvit.to_device(params, "cpu"))
                mp.setitem(tbird.PRETRAINED_SPECS, "Bird-MAE-Base",
                           dataclasses.replace(tbird.PRETRAINED_SPECS["Bird-MAE-Base"], **BIRD_SPEC))
                torch.set_num_threads(1)
                try:
                    done[name] = textract.worker_fn(**case["kw"], shards_root=root, device="cpu")
                finally:
                    torch.set_num_threads(threads)
        return done[name]

    return run


def _shard_dir(root: pathlib.Path) -> pathlib.Path:
    (d,) = [p for p in (root / "saev" / "shards").iterdir() if p.is_dir()]
    return d


def _same_bytes(got: pathlib.Path, want: pathlib.Path) -> None:
    names = sorted(p.name for p in want.iterdir())
    assert got.name == want.name
    assert sorted(p.name for p in got.iterdir()) == names
    for name in names:
        assert (got / name).read_bytes() == (want / name).read_bytes(), name


@pytest.mark.parametrize("world,case", DIRS, ids=[f"{w}-{c}" for w, c in DIRS])
def test_ranks_write_the_one_rank_directory(ranks, one_rank, world, case):
    got, want = _shard_dir(ranks(world) / case), one_rank(case)
    _same_bytes(got, want)
    md = tshards.Metadata.load(got)
    info = tshards.ShardInfo.load(got)
    info.validate(got)
    assert sum(s.n_examples for s in info) == md.n_examples
    if case in ("plain", "seg"):
        assert len(info) == 5 and [s.n_examples for s in info] == [5, 5, 5, 5, 1]
        assert (got / "labels.bin").exists() == (case == "seg")


@pytest.mark.parametrize("world,case", DIRS, ids=[f"{w}-{c}" for w, c in DIRS])
def test_each_rank_runs_its_batches(files, ranks, world, case):
    """Rank r ran batches r, r + W, ...: their sizes, in order."""
    kw = _case(case, files)["kw"]
    for r in range(world):
        sizes = json.loads((ranks(world) / f"{case}_rank{r}.json").read_text())
        want = [e - s for s, e in parallel.batch_spans(kw["data"].n_examples, kw["batch_size"], r, world)]
        assert sizes == want, (r, sizes, want)
    if case == "few":
        assert json.loads((ranks(world) / "few_rank2.json").read_text()) == []


@pytest.fixture(scope="module")
def jax_dirs(files, tmp_path_factory):
    """The JAX package's directories for "plain" and "seg", its batches of 8
    sharded over the 8 virtual devices."""
    assert len(jax.devices()) == 8 and FAKE_BATCH % 8 == 0 and N_FAKE % FAKE_BATCH
    out = {}
    for name, data, agg in (("plain", jdatasets.FakeImg(n_examples=N_FAKE), "majority"),
                            ("seg", jdatasets.FakeImgSeg(n_examples=N_FAKE), "prefer-fg")):
        root = tmp_path_factory.mktemp(f"jax_{name}") / "saev" / "shards"
        root.mkdir(parents=True)
        out[name] = jextract.worker_fn(data=data, shards_root=root, pixel_agg=jshards.PixelAgg(agg), **FAKE_KW)
    return out


def _acts(shards_dir: pathlib.Path) -> np.ndarray:
    md, info = tshards.Metadata.load(shards_dir), tshards.ShardInfo.load(shards_dir)
    return np.concatenate([np.array(np.memmap(shards_dir / s.name, mode="r", dtype=np.float32,
                                              shape=md.shard_shape)[: s.n_examples]) for s in info])


@pytest.mark.parametrize("world,case", [(2, "plain"), (2, "seg"), (3, "plain"), (3, "seg")])
def test_ranks_match_jax_data_parallel(ranks, jax_dirs, world, case):
    got, want = _shard_dir(ranks(world) / case), jax_dirs[case]
    assert got.name == want.name
    assert sorted(p.name for p in got.iterdir()) == sorted(p.name for p in want.iterdir())
    for name in ("metadata.json", "shards.json") + (("labels.bin",) if case == "seg" else ()):
        assert (got / name).read_bytes() == (want / name).read_bytes(), name
    np.testing.assert_allclose(_acts(got), _acts(want), rtol=RTOL, atol=ATOL)


def test_a_failed_rank_fails_every_rank(ranks):
    """Rank 1's forward raises: it raises that, rank 0 (whose rows are
    written) an error that counts it, and no shards.json is written."""
    out = ranks(2)
    assert (out / "fail_error1.txt").read_text() == "Injected: rank 1: injected failure"
    assert (out / "fail_error0.txt").read_text().startswith("RuntimeError: extraction: 1 other rank(s) failed")
    shards_dir = _shard_dir(out / "fail")
    assert (shards_dir / "metadata.json").exists() and not (shards_dir / "shards.json").exists()


def test_batch_spans_deal_the_batches_round_robin():
    every = [(0, 8), (8, 16), (16, 21)]
    for world in (1, 2, 3, 5):
        got = [parallel.batch_spans(21, 8, r, world) for r in range(world)]
        assert sorted(s for spans in got for s in spans) == every
        assert all(spans == every[r::world] for r, spans in enumerate(got))
    assert parallel.batch_spans(21, 8) == every  # single process: every batch
    assert parallel.batch_spans(7, 4, 2, 3) == []


def test_torchrun_writes_the_one_process_directory(tmp_path):
    """The CLI under torchrun (2 processes, gloo) and alone, both at one
    thread: the same directory, byte for byte."""
    args = ["data:fake-img", "--data.n-examples", "9", "--family", "fake-clip", "--ckpt", jfake.CKPT,
            "--layers", "0,2", "--d-model", "128", "--content-tokens-per-example", "16",
            "--max-tokens-per-shard", str(4 * 17 * 2), "--batch-size", "3", "--n-workers", "2", "--device", "cpu"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    dirs = {}
    for name, launch in (("one", [sys.executable, "-m"]),
                         ("two", [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
                                  "--master-port", str(torch_ranks._free_port()), "-m"])):
        root = tmp_path / name / "saev" / "shards"
        root.mkdir(parents=True)
        proc = subprocess.run([*launch, "saev_tpu_torch.framework.shards", *args, "--shards-root", str(root)],
                              cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-4000:]
        dirs[name] = _shard_dir(tmp_path / name)
    assert "Rank 1 of 2: 1 batches" in proc.stderr
    _same_bytes(dirs["two"], dirs["one"])
