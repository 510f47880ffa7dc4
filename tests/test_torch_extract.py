"""The port's extraction path (saev_tpu_torch.data.{datasets,extract,shards},
saev_tpu_torch.framework.shards) against the JAX package's, from the same
fixture files, JAX on the CPU:

- every dataset on fixture directories gives the same samples, BirdCLEF's
  CSVs read without pandas included (labels typed as pandas types them);
- `pixel_to_patch_labels` is exactly the JAX package's for every PixelAgg;
- `encode_dataset_cfg` is byte for byte the JAX package's for every config
  class, and each package decodes the other's;
- end to end, both packages' `worker_fn` on FakeImg and FakeImgSeg (fake-clip
  weights carried across) and on a BirdCLEF fixture (a small Bird-MAE
  checkpoint) write the same shard directory name and metadata.json bytes,
  labels.bin bit for bit, and acts*.bin within rtol 2e-4, atol 2e-5 (both run
  float32 products on the CPU);
- the entry point runs on "cuda" unless device="cpu" is given, and raises
  without a card.
"""

import dataclasses
import inspect
import io
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from saev_tpu.data import datasets as jdatasets
from saev_tpu.data import extract as jextract
from saev_tpu.data import fake_vit as jfake
from saev_tpu.data import shards as jshards
from saev_tpu.models import bird_mae as jbird
from saev_tpu_torch.data import datasets as tdatasets
from saev_tpu_torch.data import extract as textract
from saev_tpu_torch.data import fake_vit as tfake
from saev_tpu_torch.data import shards as tshards
from saev_tpu_torch.framework import shards as tframework
from saev_tpu_torch.models import bird_mae as tbird
from saev_tpu_torch.models import dinov3 as tdinov3
from saev_tpu_torch.models import families as tfamilies
from saev_tpu_torch.models import vit as tvit
from saev_tpu_torch.scripts import vit_route

ROOT = pathlib.Path(__file__).resolve().parent.parent
RTOL, ATOL = 2e-4, 2e-5
CONFIGS = ("Imagenet", "Cifar10", "ImgFolder", "ImgSegFolder", "FakeImg", "FakeImgSeg", "BirdClef2025")


def _shards_root(tmp_path: pathlib.Path, name: str) -> pathlib.Path:
    root = tmp_path / name / "saev" / "shards"
    root.mkdir(parents=True)
    return root


def _same_samples(jds, tds, n=None):
    assert len(tds) == len(jds)
    for i in range(len(jds) if n is None else n):
        a, b = jds[i], tds[i]
        assert sorted(a) == sorted(b), (sorted(a), sorted(b))
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype, k
            else:
                assert a[k] == b[k], (k, a[k], b[k])


def _to_arrays():
    from saev_tpu.data import transforms

    return lambda img: transforms.to_chw_float(img.resize((8, 8)))


# ---------------------------------------------------------------------------
# Datasets
# ---------------------------------------------------------------------------


def test_fake_datasets_match_jax():
    tr = _to_arrays()
    _same_samples(jdatasets.get_dataset(jdatasets.FakeImg(n_examples=3), data_transform=tr),
                  tdatasets.get_dataset(tdatasets.FakeImg(n_examples=3), data_transform=tr))

    def mask(seg):
        return np.asarray(seg)[::16, ::16].reshape(-1)

    jcfg, tcfg = jdatasets.FakeImgSeg(n_examples=5), tdatasets.FakeImgSeg(n_examples=5)
    _same_samples(jdatasets.get_dataset(jcfg, data_transform=tr, mask_transform=mask),
                  tdatasets.get_dataset(tcfg, data_transform=tr, mask_transform=mask))
    assert tdatasets.is_img_seg_dataset(tcfg) and not tdatasets.is_img_seg_dataset(tdatasets.FakeImg())


def _write_images(root: pathlib.Path, names: list[str], rng, mode="RGB"):
    from PIL import Image

    for name in names:
        path = root / name
        path.parent.mkdir(parents=True, exist_ok=True)
        shape = (12, 10, 3) if mode == "RGB" else (12, 10)
        Image.fromarray(rng.integers(0, 4 if mode == "L" else 256, size=shape, dtype=np.uint8), mode=mode).save(path)


def test_img_folder_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    for split in ("a", "b"):
        _write_images(tmp_path / split, ["cat/1.png", "cat/0.jpg", "dog/x/2.png", "dog/3.bmp"], rng)
    (tmp_path / "a" / "stray.png").write_bytes(b"")  # not in a class directory
    tr = _to_arrays()
    for root in (tmp_path / "a", tmp_path / "*"):
        jcfg, tcfg = jdatasets.ImgFolder(root=root), tdatasets.ImgFolder(root=root)
        assert tcfg.n_examples == jcfg.n_examples
        jds, tds = jdatasets.get_dataset(jcfg, data_transform=tr), tdatasets.get_dataset(tcfg, data_transform=tr)
        assert type(tds).__name__ == type(jds).__name__
        _same_samples(jds, tds)


def test_img_seg_folder_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    _write_images(tmp_path / "images" / "training", ["b.png", "a.png", "c.jpg"], rng)
    _write_images(tmp_path / "annotations" / "training", ["a.png", "b.png", "c.png"], rng, mode="L")
    (tmp_path / "labels.csv").write_text("stem,habitat,diet\na,reef,algae\nb,river\n")
    jcfg, tcfg = jdatasets.ImgSegFolder(root=tmp_path), tdatasets.ImgSegFolder(root=tmp_path)
    assert tcfg.n_examples == jcfg.n_examples == 3
    tr = _to_arrays()

    def mask(seg):
        return np.asarray(seg)[::3, ::2].reshape(-1)

    jds = jdatasets.get_dataset(jcfg, data_transform=tr, mask_transform=mask)
    tds = tdatasets.get_dataset(tcfg, data_transform=tr, mask_transform=mask)
    _same_samples(jds, tds)
    assert tds.sample_labels == jds.sample_labels and tds.label_cols == jds.label_cols


def _write_birdclef(root: pathlib.Path, labels: dict[str, str], rows: list[str], rng, seconds: float = 1.0):
    """taxonomy.csv (label → class), train.csv (one row per label in `rows`)
    and train_audio/<label>/<n>.wav, int16 at 32 kHz."""
    import scipy.io.wavfile

    root.mkdir(parents=True, exist_ok=True)
    with open(root / "taxonomy.csv", "w") as fd:
        fd.write("primary_label,inat_taxon_id,scientific_name,common_name,class_name\n")
        for i, (label, cls) in enumerate(labels.items()):
            fd.write(f"{label},{1000 + i},Genus species{i},Name {i},{cls}\n")
    with open(root / "train.csv", "w") as fd:
        fd.write("primary_label,secondary_labels,type,filename,collection,rating\n")
        for n, label in enumerate(rows):
            fname = f"{label}/XC{n}.wav"
            (root / "train_audio" / label).mkdir(parents=True, exist_ok=True)
            clip = vit_route.synth_clip(rng, n=int(32_000 * seconds))
            scipy.io.wavfile.write(root / "train_audio" / fname, 32_000, clip)
            fd.write(f"{label},['x'],['call'],{fname},XC,{n % 5}.0\n")


BIRDCLEF_LABELS = {
    "mixed": {"1139490": "Aves", "abethr1": "Aves", "41663": "Insecta", "amekes": "Aves", "22333": "Aves"},
    "numeric": {"1139490": "Aves", "0417": "Aves", "41663": "Insecta", "22333": "Aves"},
}


@pytest.mark.parametrize("case", sorted(BIRDCLEF_LABELS))
def test_birdclef_matches_jax(tmp_path, case):
    """BirdCLEF's CSVs through the stdlib reader: the same labels, targets,
    sample order and filtering (non-Aves rows dropped) as pandas gives."""
    labels = BIRDCLEF_LABELS[case]
    rows = [list(labels)[i % len(labels)] for i in range(11)]
    _write_birdclef(tmp_path, labels, rows, np.random.default_rng(2), seconds=0.1)
    jcfg, tcfg = jdatasets.BirdClef2025(root=tmp_path), tdatasets.BirdClef2025(root=tmp_path)
    assert tcfg.n_examples == jcfg.n_examples == sum(labels[r] == "Aves" for r in rows)
    jds, tds = jdatasets.get_dataset(jcfg), tdatasets.get_dataset(tcfg)
    assert tds.label_to_idx == jds.label_to_idx
    assert tds.samples == jds.samples
    _same_samples(jds, tds)
    if case == "numeric":
        assert "417" in tds.label_to_idx  # pandas reads the column as int64


def test_birdclef_soundscapes_match_jax(tmp_path):
    _write_birdclef(tmp_path, {"abethr1": "Aves"}, ["abethr1"], np.random.default_rng(3), seconds=0.1)
    (tmp_path / "train_soundscapes").mkdir()
    for name in ("b.ogg", "a.ogg", "c.wav"):
        (tmp_path / "train_soundscapes" / name).write_bytes(b"")
    jcfg = jdatasets.BirdClef2025(root=tmp_path, split="train_soundscapes")
    tcfg = tdatasets.BirdClef2025(root=tmp_path, split="train_soundscapes")
    assert tcfg.n_examples == jcfg.n_examples == 2
    assert tdatasets.get_dataset(tcfg).samples == jdatasets.get_dataset(jcfg).samples


COLUMNS = {
    "codes": ["abethr1", "amekes", "x"],
    "ints": ["007", "12", "-3", "+4"],
    "mixed": ["1139490", "41663", "abethr1"],
    "floats": ["1.5", "2", "1e3"],
    "ints-with-missing": ["1", "", "3"],
    "bools": ["True", "false", "TRUE"],
    "strings-with-missing": ["a", "NA", "b"],
    "spaces": [" 5", "6"],
    "underscore": ["1_000", "2"],
}


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_csv_column_strings_match_pandas(tmp_path, name):
    pd = pytest.importorskip("pandas")
    cells = COLUMNS[name]
    text = "col,other\n" + "".join(f"{c},z\n" for c in cells)
    (tmp_path / "t.csv").write_text(text)
    want = ["nan" if v is None or v != v else v
            for v in pd.read_csv(io.StringIO(text))["col"].astype(str).tolist()]
    assert tdatasets._pandas_strings(tdatasets._read_csv(tmp_path / "t.csv")["col"]) == want


def test_concat_dataset_matches_jax():
    jds = jdatasets.ConcatDataset([jdatasets.FakeImgDataset(jdatasets.FakeImg(2)),
                                   jdatasets.FakeImgDataset(jdatasets.FakeImg(3))])
    tds = tdatasets.ConcatDataset([tdatasets.FakeImgDataset(tdatasets.FakeImg(2)),
                                   tdatasets.FakeImgDataset(tdatasets.FakeImg(3))])
    assert len(tds) == len(jds) == 5
    assert [tds[i]["index"] for i in range(5)] == [jds[i]["index"] for i in range(5)] == [0, 1, 0, 1, 2]


# ---------------------------------------------------------------------------
# Shard protocol additions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("agg", list(tshards.PixelAgg))
def test_pixel_to_patch_labels_matches_jax(agg):
    rng = np.random.default_rng(4)
    seg = rng.integers(0, 5, size=(32, 48), dtype=np.uint8)
    seg[:8] = 0
    jagg = jshards.PixelAgg(agg.value)
    for bg in (0, 3):
        got = tshards.pixel_to_patch_labels(seg, 24, 8, agg, bg_label=bg)
        want = jshards.pixel_to_patch_labels(seg, 24, 8, jagg, bg_label=bg)
        assert got.dtype == np.uint8 and np.array_equal(got, want)
    with pytest.raises(AssertionError):
        tshards.pixel_to_patch_labels(seg, 25, 8, agg)


def _cfgs(name: str, tmp_path: pathlib.Path):
    jcls, tcls = getattr(jdatasets, name), getattr(tdatasets, name)
    kw = {}
    names = [f.name for f in dataclasses.fields(jcls)]
    if "root" in names:
        kw["root"] = tmp_path / "data" / name
    if "split" in names and name in ("Imagenet", "Cifar10"):
        kw["split"] = "validation"
    if "n_examples" in names:
        kw["n_examples"] = 7
    return jcls(**kw), tcls(**kw)


@pytest.mark.parametrize("name", CONFIGS)
def test_encode_dataset_cfg_matches_jax(tmp_path, name):
    """The same pickle bytes (module `saev_tpu.data.datasets`), and each
    package decodes the other's into its own class."""
    jcfg, tcfg = _cfgs(name, tmp_path)
    t_b64, j_b64 = tshards.encode_dataset_cfg(tcfg), jshards.encode_dataset_cfg(jcfg)
    assert t_b64 == j_b64
    from_j, from_t = tshards.decode_dataset_cfg(j_b64), jshards.decode_dataset_cfg(t_b64)
    assert type(from_j) is type(tcfg) and from_j == tcfg
    assert type(from_t) is type(jcfg) and from_t == jcfg


def test_decode_takes_every_module_name_and_refuses_others(monkeypatch):
    cfg = tdatasets.ImgFolder(root=pathlib.Path("/x/y"))
    for module in ("saev.data.datasets", "saev_tpu_torch.data.datasets"):
        monkeypatch.setattr(tshards, "CONFIG_MODULE", module)
        b64 = tshards.encode_dataset_cfg(cfg)
        assert module.encode() in __import__("base64").b64decode(b64)
        assert tshards.decode_dataset_cfg(b64) == cfg
    evil = __import__("base64").b64encode(pickle.dumps(print)).decode()
    with pytest.raises(pickle.UnpicklingError):
        tshards.decode_dataset_cfg(evil)


def test_metadata_make_data_cfg(tmp_path):
    jcfg, tcfg = _cfgs("BirdClef2025", tmp_path)
    kw = dict(family="bird-mae", ckpt="Bird-MAE-Large", layers=(11, 23), content_tokens_per_example=256,
              cls_token=True, d_model=1024, n_examples=256, max_tokens_per_shard=51_400,
              dataset=tcfg.root)
    tmd = tshards.Metadata(data=tshards.encode_dataset_cfg(tcfg), **kw)
    jmd = jshards.Metadata(data=jshards.encode_dataset_cfg(jcfg), **kw)
    assert tmd.hash == jmd.hash
    assert tmd.make_data_cfg() == tcfg and jmd.make_data_cfg() == jcfg


# ---------------------------------------------------------------------------
# End to end: worker_fn in both packages
# ---------------------------------------------------------------------------


def _read_acts(shards_dir: pathlib.Path) -> np.ndarray:
    md = tshards.Metadata.load(shards_dir)
    info = tshards.ShardInfo.load(shards_dir)
    info.validate(shards_dir)
    parts = [np.array(np.memmap(shards_dir / s.name, mode="r", dtype=np.float32, shape=md.shard_shape)[: s.n_examples])
             for s in info]
    return np.concatenate(parts)


def _compare_dirs(j_dir: pathlib.Path, t_dir: pathlib.Path) -> None:
    assert t_dir.name == j_dir.name
    assert (t_dir / "metadata.json").read_bytes() == (j_dir / "metadata.json").read_bytes()
    assert (t_dir / "shards.json").read_bytes() == (j_dir / "shards.json").read_bytes()
    assert sorted(p.name for p in t_dir.iterdir()) == sorted(p.name for p in j_dir.iterdir())
    if (j_dir / "labels.bin").exists():
        assert (t_dir / "labels.bin").read_bytes() == (j_dir / "labels.bin").read_bytes()
    np.testing.assert_allclose(_read_acts(t_dir), _read_acts(j_dir), rtol=RTOL, atol=ATOL)
    assert jshards.Metadata.load(t_dir).make_data_cfg() == jshards.Metadata.load(j_dir).make_data_cfg()


@pytest.mark.parametrize("seg", [False, True])
def test_worker_fn_matches_jax_on_fake_images(tmp_path, monkeypatch, seg):
    jparams = jfake._make_params(0)
    monkeypatch.setattr(tfake, "_make_params", lambda seed: tvit.to_device(jparams, "cpu"))
    kw = dict(family="fake-clip", ckpt=jfake.CKPT, content_tokens_per_example=16, cls_token=True,
              d_model=jfake.D_MODEL, layers=[0, 2], batch_size=3, n_workers=2, max_tokens_per_shard=102,
              pixel_agg=tshards.PixelAgg.PREFER_FG if seg else tshards.PixelAgg.MAJORITY)
    jdata = jdatasets.FakeImgSeg(n_examples=7) if seg else jdatasets.FakeImg(n_examples=7)
    tdata = tdatasets.FakeImgSeg(n_examples=7) if seg else tdatasets.FakeImg(n_examples=7)
    j_dir = jextract.worker_fn(data=jdata, shards_root=_shards_root(tmp_path, "j"),
                               **dict(kw, pixel_agg=jshards.PixelAgg(kw["pixel_agg"].value)))
    t_dir = textract.worker_fn(data=tdata, shards_root=_shards_root(tmp_path, "t"), device="cpu", **kw)
    assert len(tshards.ShardInfo.load(t_dir)) == 3  # 3 examples a shard
    assert (t_dir / "labels.bin").exists() == seg
    _compare_dirs(j_dir, t_dir)


def test_worker_fn_matches_jax_on_birdclef(tmp_path, monkeypatch):
    """A small Bird-MAE checkpoint (timm layout, torch.save) over a BirdCLEF
    fixture with a non-Aves label: the audio path end to end."""
    d, layers = 64, 2
    jspec = dataclasses.replace(jbird.PRETRAINED_SPECS["Bird-MAE-Base"], d_model=d, n_layers=layers, n_heads=4)
    tspec = dataclasses.replace(tbird.PRETRAINED_SPECS["Bird-MAE-Base"], d_model=d, n_layers=layers, n_heads=4)
    monkeypatch.setitem(jbird.PRETRAINED_SPECS, "Bird-MAE-Base", jspec)
    monkeypatch.setitem(tbird.PRETRAINED_SPECS, "Bird-MAE-Base", tspec)
    torch.save(vit_route.bird_mae_state_dict(tspec, torch.Generator().manual_seed(0)), tmp_path / "b.pt")
    labels = BIRDCLEF_LABELS["mixed"]
    rows = [list(labels)[i % len(labels)] for i in range(7)]
    _write_birdclef(tmp_path / "birdclef", labels, rows, np.random.default_rng(5), seconds=2.0)
    kw = dict(family="bird-mae", ckpt=f"Bird-MAE-Base={tmp_path / 'b.pt'}", content_tokens_per_example=256,
              cls_token=True, d_model=d, layers=[0, 1], batch_size=2, n_workers=2, max_tokens_per_shard=2 * 514)
    j_dir = jextract.worker_fn(data=jdatasets.BirdClef2025(root=tmp_path / "birdclef"),
                               shards_root=_shards_root(tmp_path, "j"), **kw)
    t_dir = textract.worker_fn(data=tdatasets.BirdClef2025(root=tmp_path / "birdclef"),
                               shards_root=_shards_root(tmp_path, "t"), device="cpu", **kw)
    assert tshards.Metadata.load(t_dir).n_examples == sum(labels[r] == "Aves" for r in rows) == 6
    _compare_dirs(j_dir, t_dir)


def test_cli_runs_the_entry_point(tmp_path):
    """`python -m saev_tpu_torch.framework.shards ... --device cpu` writes the
    directory the JAX package's worker_fn writes for the same config."""
    root = _shards_root(tmp_path, "t")
    args = ["data:fake-img", "--data.n-examples", "5", "--family", "fake-clip", "--ckpt", jfake.CKPT,
            "--layers", "1", "--d-model", "128", "--content-tokens-per-example", "16",
            "--shards-root", str(root), "--max-tokens-per-shard", "200", "--batch-size", "2",
            "--n-workers", "1", "--device", "cpu"]
    proc = subprocess.run([sys.executable, "-m", "saev_tpu_torch.framework.shards", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    (t_dir,) = [p for p in root.iterdir() if p.is_dir()]
    j_dir = jextract.worker_fn(
        family="fake-clip", ckpt=jfake.CKPT, content_tokens_per_example=16, cls_token=True, d_model=128,
        layers=[1], data=jdatasets.FakeImg(n_examples=5), batch_size=2, n_workers=1, max_tokens_per_shard=200,
        shards_root=_shards_root(tmp_path, "j"))
    assert t_dir.name == j_dir.name
    assert (t_dir / "metadata.json").read_bytes() == (j_dir / "metadata.json").read_bytes()
    tshards.ShardInfo.load(t_dir).validate(t_dir)


def test_config_covers_worker_fn():
    kwargs = tframework._worker_kwargs(tframework.Config())
    assert set(kwargs) == set(inspect.signature(textract.worker_fn).parameters)
    assert kwargs["layers"] == [-2] and kwargs["device"] == "cuda"
    from saev_tpu.framework import shards as jframework

    t_fields = {f.name: f.default for f in dataclasses.fields(tframework.Config) if f.name not in ("data", "device")}
    j_fields = {f.name: f.default for f in dataclasses.fields(jframework.Config) if f.name not in ("data", "device")}
    assert t_fields.keys() == j_fields.keys()
    assert {k: v for k, v in t_fields.items() if k != "pixel_agg"} == {
        k: v for k, v in j_fields.items() if k != "pixel_agg"}


# ---------------------------------------------------------------------------
# The card is the default
# ---------------------------------------------------------------------------


def test_entry_point_defaults_to_the_card(tmp_path, monkeypatch):
    """Without device="cpu" the worker and every family build on "cuda"; with
    no card the worker raises rather than running on the CPU."""
    assert inspect.signature(textract.worker_fn).parameters["device"].default == "cuda"
    assert tframework.Config().device == "cuda"
    for cls in (tfamilies.Clip, tdinov3.Vit, tbird.Transformer, tfake.Vit):
        assert inspect.signature(cls.__init__).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = dict(family="fake-clip", ckpt=jfake.CKPT, content_tokens_per_example=16, cls_token=True,
              d_model=128, layers=[0], data=tdatasets.FakeImg(n_examples=2), batch_size=2, n_workers=1,
              max_tokens_per_shard=100, shards_root=_shards_root(tmp_path, "t"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        textract.worker_fn(**kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tframework.cli(tframework.Config(**{k: v for k, v in kw.items()}))
    assert not any((tmp_path / "t" / "saev" / "shards").iterdir())


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal on a machine with no card")
def test_model_on_the_card_raises_without_one():
    with pytest.raises((RuntimeError, AssertionError)):
        tfake.Vit(tfake.CKPT)
