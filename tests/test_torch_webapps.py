"""The port's host apps (saev_tpu_torch.web, saev_tpu_torch.scripts.export_demo,
saev_tpu_torch.interactive) against the JAX package's (saev_tpu.web,
scripts/export_demo.py, saev_tpu.interactive), on the CPU, over one set of
artifacts built as tests/test_web_backend.py, tests/test_export_demo.py and
tests/test_interactive.py build them: fake-clip shards written by the JAX
package's extraction, an SAE file dumped by the JAX package, and inference
artifacts written by the JAX package's `framework.inference`.

- Every endpoint of the three web apps answers the same JSON (and the same
  status) from both backends over HTTP, with the same seeds and probes.
- A second case serves artifacts written by the port's own
  `framework.inference` (device "cpu") from the same shards and SAE file:
  the same JSON again. torch's and XLA's float32 products differ in their
  last bits, so this case's shard activations are rewritten onto multiples
  of 2^-6 in [-4, 4] and the encoder's weights and biases onto multiples of
  2^-8 (as tests/test_torch_inference.py does): every encoder product is
  then exact in float32, both packages select the same latents and the two
  token_acts files are the same bits (asserted first).
- `export_demo`'s `export`, `classification` and `comparison` write equal
  `demo.json` files and the same templates; `export` also on the port's
  artifacts.
- The interactive reports write the same HTML (shards, metrics from the
  local tracker and from a recorded wandb payload, features with embedded
  and relative images).
"""

import importlib.util
import json
import pathlib
import shutil
import sys
import types
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import scipy.sparse

from saev_tpu import disk as jdisk
from saev_tpu import nn as jnn
from saev_tpu.data import Metadata as JMetadata
from saev_tpu.data import OrderedConfig as JOrderedConfig
from saev_tpu.data import fake_vit as jfake
from saev_tpu.framework import inference as jinference
from saev_tpu.interactive import features as jfeatures
from saev_tpu.interactive import metrics as jmetrics
from saev_tpu.interactive import shards as jishards
from saev_tpu.nn import modeling as jmod
from saev_tpu.web import backend as jbackend
from saev_tpu_torch import disk
from saev_tpu_torch.data import OrderedConfig
from saev_tpu_torch.framework import inference
from saev_tpu_torch.interactive import features, metrics
from saev_tpu_torch.interactive import shards as ishards
from saev_tpu_torch.scripts import export_demo
from saev_tpu_torch.web import backend

from conftest import FAKE_CKPT
from conftest import _Helpers as helpers

ROOT = pathlib.Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.filterwarnings("ignore::sklearn.exceptions.ConvergenceWarning")


def _load_jax_export_demo():
    path = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location("_jax_scripts_export_demo", ROOT / "scripts" / "export_demo.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
    return mod


jexport = _load_jax_export_demo()


# ---------------------------------------------------------------------------
# Artifacts
# ---------------------------------------------------------------------------


def _quantize_shards(shards_dir: pathlib.Path) -> None:
    """Every activation onto a multiple of 2^-6 in [-4, 4], in place."""
    for fpath in sorted(shards_dir.glob("acts*.bin")):
        acts = np.fromfile(fpath, dtype=np.float32)
        np.clip(np.round(acts * 64) / 64, -4, 4).astype(np.float32).tofile(fpath)


def _sae_file(fpath: pathlib.Path, d_model: int, *, relu: bool = False, grid: bool = False, seed: int = 0) -> None:
    act = jmod.Relu() if relu else jmod.TopK(top_k=4)
    cfg = jmod.SparseAutoencoderConfig(d_model=d_model, d_sae=32, activation=act)
    params, state = jmod.init(cfg, jax.random.key(seed))
    if grid:
        rng = np.random.default_rng(seed)
        params = dict(params)
        params["W_enc"] = np.round(np.asarray(params["W_enc"]) * 256) / 256
        params["b_enc"] = (rng.integers(-16, 17, size=32) / 256).astype(np.float32)
    fpath.parent.mkdir(parents=True, exist_ok=True)
    jnn.dump(fpath, cfg, params, state)


def _run_dir(runs_root: pathlib.Path, run_id: str, shards_dir: pathlib.Path, sae: pathlib.Path) -> pathlib.Path:
    run = jdisk.Run.new(run_id, train_shards_dir=shards_dir, val_shards_dir=shards_dir, runs_root=runs_root)
    shutil.copy(sae, run.ckpt)
    return run.run_dir


def _jax_inference(run_dir: pathlib.Path, shards_dir: pathlib.Path, batch: int, n_dists: int) -> None:
    jinference.worker_fn(jinference.Config(
        run=run_dir, data=JOrderedConfig(shards=shards_dir, layer=0, batch_size=batch), n_dists=n_dists,
        device="cpu",
    ))


def _port_inference(run_dir: pathlib.Path, shards_dir: pathlib.Path, batch: int, n_dists: int) -> None:
    inference.worker_fn(inference.Config(
        run=run_dir, data=OrderedConfig(shards=shards_dir, layer=0, batch_size=batch), n_dists=n_dists,
        device="cpu",
    ))


def _token_acts(run_dir: pathlib.Path, shards_dir: pathlib.Path):
    return scipy.sparse.load_npz(disk.Run(run_dir).inference / JMetadata.load(shards_dir).hash / "token_acts.npz")


@pytest.fixture(scope="module")
def seg(tmp_path_factory):
    """Seg shards (quantized), one TopK SAE file on the encoder's grid, and
    two runs named alike under two roots: "jax" with the JAX package's
    inference artifacts, "port" with the port's."""
    tmp = tmp_path_factory.mktemp("webapps")
    shards_dir = helpers.write_shards(tmp, n_examples=10, layers=(0,), seg=True, batch_size=5)
    _quantize_shards(shards_dir)
    _sae_file(tmp / "sae.pt", jfake.D_MODEL, grid=True)
    runs = {}
    for name, infer in (("jax", _jax_inference), ("port", _port_inference)):
        runs[name] = _run_dir(helpers.tmp_runs_root(tmp / name), "webrun", shards_dir, tmp / "sae.pt")
        infer(runs[name], shards_dir, 10, 2)
    a, b = (_token_acts(runs[k], shards_dir) for k in ("jax", "port"))
    assert a.shape == b.shape and np.array_equal(a.indptr, b.indptr) and np.array_equal(a.indices, b.indices)
    assert np.array_equal(a.data.view(np.int32), b.data.view(np.int32)) and a.nnz > 0
    return {"tmp": tmp, "shards": shards_dir, **runs}


def _apps(mod, run_dir, shards_dir, **kw):
    return {
        "semseg": mod.SemsegApp(run_dir, shards_dir, layer=0, **kw),
        "classification": mod.ClassificationApp(run_dir, shards_dir, layer=0, **kw),
        "comparison": mod.ComparisonApp([run_dir], [shards_dir], layer=0, **kw),
    }


@pytest.fixture(scope="module")
def servers(seg):
    """The JAX backend and the port's over the JAX package's artifacts, and
    the port's over its own."""
    out = {
        "jax": jbackend.make_server(_apps(jbackend, seg["jax"], seg["shards"])),
        "port": backend.make_server(_apps(backend, seg["jax"], seg["shards"], device="cpu")),
        "port-own": backend.make_server(_apps(backend, seg["port"], seg["shards"], device="cpu")),
    }
    for server in out.values():
        backend.run_server(server)
    yield out
    for server in out.values():
        server.shutdown()


def _post(server, app: str, endpoint: str, args) -> tuple[int, dict]:
    host, port = server.server_address
    req = urllib.request.Request(
        f"http://{host}:{port}/api/{app}/{endpoint}", data=json.dumps({"data": args}).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


# (app, endpoint, args): every endpoint, with the probes of tests/test_web_backend.py.
CALLS = [
    ("semseg", "meta", []),
    ("semseg", "get-img", [0]),
    ("semseg", "get-orig-preds", [1]),
    ("semseg", "get-mod-preds", [1, {}]),
    ("semseg", "get-mod-preds", [1, {"3": 1e4}]),
    ("semseg", "get-sae-latents", [0, [0, 1, 2]]),
    ("semseg", "get-sae-latents", [4, []]),
    ("classification", "meta", []),
    ("classification", "get-img", [2]),
    ("classification", "get-preds", [2]),
    ("classification", "get-modified", [2, {}]),
    ("classification", "get-modified", [2, {"5": 1e4}]),
    ("classification", "get-sae-latents", [2, []]),
    ("classification", "get-random-class-img", [0, 0]),
    ("classification", "get-random-class-img", [1, 3]),
    ("comparison", "meta", []),
    ("comparison", "get-image", [3]),
    ("comparison", "get-sae-activations", [3, None]),
    ("comparison", "get-sae-activations", [3, {"0": [1, 2]}]),
    ("semseg", "no-such-endpoint", []),
    ("semseg", "get-img", []),
]


@pytest.mark.parametrize("app,endpoint,args", CALLS, ids=[f"{a}-{e}-{i}" for i, (a, e, _) in enumerate(CALLS)])
def test_endpoint_answers_the_same_json(servers, app, endpoint, args):
    want = _post(servers["jax"], app, endpoint, args)
    assert _post(servers["port"], app, endpoint, args) == want
    assert _post(servers["port-own"], app, endpoint, args) == want


def test_routes_and_static_files_match_jax(tmp_path):
    assert backend._ROUTES == jbackend._ROUTES
    assert backend.WEB_ROOT == ROOT / "src" / "web" and backend.WEB_ROOT.is_dir()
    server = backend.make_server({}, port=0, web_root=backend.WEB_ROOT)
    backend.run_server(server)
    try:
        host, port = server.server_address
        for page in ("live/semseg/index.html", "live/lib.js?v=2", "semseg/app.js"):
            with urllib.request.urlopen(f"http://{host}:{port}/{page}", timeout=30) as resp:
                assert resp.read() == (backend.WEB_ROOT / page.split("?")[0]).read_bytes()
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"http://{host}:{port}/../../etc/hostname", timeout=30)
        assert err.value.code == 404
    finally:
        server.shutdown()


def test_layer_mismatch_rejected_as_jax_does(seg):
    errs = []
    for load, kw in ((jbackend._load_run_data, {}), (backend._load_run_data, {"device": "cpu"})):
        with pytest.raises(ValueError, match="not in the shards' recorded") as err:
            load(seg["jax"], seg["shards"], 3, 1.0, **kw)
        errs.append(str(err.value))
    assert errs[0] == errs[1]


# ---------------------------------------------------------------------------
# export_demo
# ---------------------------------------------------------------------------


def _same_site(a: pathlib.Path, b: pathlib.Path) -> None:
    assert sorted(p.name for p in a.iterdir()) == sorted(p.name for p in b.iterdir()) == [
        "app.js", "demo.json", "index.html"]
    for name in ("app.js", "index.html"):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    assert json.loads((a / "demo.json").read_text()) == json.loads((b / "demo.json").read_text())


def _relu_run(tmp: pathlib.Path, shards_dir: pathlib.Path, run_id: str = "demorun1") -> pathlib.Path:
    md = JMetadata.load(shards_dir)
    _sae_file(tmp / f"{run_id}.pt", md.d_model, relu=True)
    run_dir = _run_dir(helpers.tmp_runs_root(tmp), run_id, shards_dir, tmp / f"{run_id}.pt")
    _jax_inference(run_dir, shards_dir, 16, 4)
    return run_dir


def test_export_matches_jax(tmp_path, seg):
    shards_dir = helpers.write_shards(tmp_path, n_examples=6, layers=(0,))
    run_dir = _relu_run(tmp_path, shards_dir)
    kw = dict(run=run_dir, shards=shards_dir, n_images=4, n_latents=8)
    export_demo.export(export_demo.Args(**kw, out=tmp_path / "port", device="cpu"))
    jexport.export(jexport.Args(**kw, out=tmp_path / "jax"))
    _same_site(tmp_path / "port", tmp_path / "jax")
    # The port's export over the port's inference artifacts.
    kw = dict(shards=seg["shards"], n_images=5, n_latents=6)
    export_demo.export(export_demo.Args(**kw, run=seg["port"], out=tmp_path / "port-own", device="cpu"))
    jexport.export(jexport.Args(**kw, run=seg["jax"], out=tmp_path / "jax-seg"))
    _same_site(tmp_path / "port-own", tmp_path / "jax-seg")


def test_export_classification_matches_jax(tmp_path):
    from PIL import Image

    from saev_tpu.data import datasets, extract

    rng = np.random.default_rng(0)
    folder = tmp_path / "imgs"
    for cls, base in (("dark", 32), ("light", 224)):
        (folder / cls).mkdir(parents=True)
        for i in range(4):
            arr = np.clip(base + rng.integers(-30, 30, size=(16, 16, 3)), 0, 255).astype(np.uint8)
            Image.fromarray(arr).save(folder / cls / f"{cls}{i}.png")
    shards_dir = extract.worker_fn(
        family="fake-clip", ckpt=FAKE_CKPT, content_tokens_per_example=jfake.N_PATCHES, cls_token=True,
        d_model=jfake.D_MODEL, layers=[0], data=datasets.ImgFolder(root=folder), batch_size=4, n_workers=2,
        max_tokens_per_shard=512, shards_root=helpers.tmp_shards_root(tmp_path), device="cpu",
    )
    run_dir = _relu_run(tmp_path, shards_dir)
    kw = dict(run=run_dir, shards=shards_dir, n_images=4, n_latents=8)
    export_demo.export_classification(export_demo.Args(**kw, out=tmp_path / "port", device="cpu"))
    jexport.export_classification(jexport.Args(**kw, out=tmp_path / "jax"))
    _same_site(tmp_path / "port", tmp_path / "jax")
    demo = json.loads((tmp_path / "port" / "demo.json").read_text())
    assert sorted(demo["class_names"]) == ["dark", "light"]
    # A single-class dataset is refused with the JAX package's message.
    one = helpers.write_shards(tmp_path / "one", n_examples=6, layers=(0,))
    one_run = _relu_run(tmp_path / "one", one)
    for mod, kw in ((export_demo, {"device": "cpu"}), (jexport, {})):
        with pytest.raises(ValueError, match="2 classes"):
            mod.export_classification(mod.Args(run=one_run, shards=one, out=tmp_path / "x", **kw))


def test_export_comparison_matches_jax(tmp_path):
    shards = [helpers.write_shards(tmp_path / s, n_examples=6, layers=(0,)) for s in "ab"]
    runs = [_relu_run(tmp_path / s, d, f"run{s}0001") for s, d in zip("ab", shards)]
    kw = dict(runs=runs, shards_list=shards, n_images=3, n_latents=6)
    export_demo.export_comparison(export_demo.ComparisonArgs(**kw, out=tmp_path / "port", device="cpu"))
    jexport.export_comparison(jexport.ComparisonArgs(**kw, out=tmp_path / "jax"))
    _same_site(tmp_path / "port", tmp_path / "jax")


# ---------------------------------------------------------------------------
# interactive
# ---------------------------------------------------------------------------


def test_shards_report_matches_jax(seg, tmp_path):
    root = seg["shards"].parent
    rows = ishards.scan(root)
    assert rows == jishards.scan(root) and rows[0]["family"] == "fake-clip"
    assert ishards.format_table(rows) == jishards.format_table(rows)
    ishards.cli(ishards.Config(root=root, out=tmp_path / "port.html"))
    jishards.cli(jishards.Config(root=root, out=tmp_path / "jax.html"))
    assert (tmp_path / "port.html").read_text() == (tmp_path / "jax.html").read_text()


def _tracker_run(tracker, rid, lr, l0, nmse, freqs=None):
    d = tracker / rid
    d.mkdir(parents=True)
    metadata = {"family": "clip", "ckpt": "ViT-B-16/openai", "data": "!!notb64!!"}
    (d / "config.json").write_text(json.dumps({
        "config": {"lr": lr, "train_data": {"layer": 3, "metadata": metadata}, "val_data": {"layer": 3},
                   "sae": {"d_sae": 64}, "objective": {"sparsity_coeff": 4e-4}},
        "tags": ["sweepX"],
    }))
    with open(d / "metrics.jsonl", "w") as fd:
        for step in range(3):
            fd.write(json.dumps({"step": step, "loss/mse": 1.0 / (step + 1)}) + "\n")
        final = {"step": 3, "eval/l0": l0, "eval/normalized_mse": nmse}
        if freqs is not None:
            final["eval/freqs"], final["eval/mean_values"] = freqs, [f * 2 for f in freqs]
        fd.write(json.dumps(final) + "\n")


class _RecordedRun:
    def __init__(self, rid, config, history):
        self.id, self.config, self._history = rid, config, history

    def scan_history(self):
        return iter(self._history)


class _RecordedApi:
    calls: list = []

    def runs(self, path, filters=None):
        _RecordedApi.calls.append((path, filters))
        if filters and "config.tag" in filters:
            return []
        config = {"lr": 1e-3, "train_data": {"layer": 3, "metadata": {"family": "clip", "ckpt": "ViT-B-16/openai"}},
                  "sae": {"d_sae": 64}}
        history = [{"_step": s, "loss/mse": 1.0 / (s + 1)} for s in range(3)]
        return [_RecordedRun(rid, dict(config, lr=lr), history + [{"_step": 3, "eval/l0": l0,
                                                                    "eval/normalized_mse": m}])
                for rid, lr, l0, m in (("aaaa", 1e-3, 10, 0.5), ("bbbb", 3e-3, 30, 0.2), ("cccc", 1e-4, 40, 0.3))]


@pytest.mark.parametrize("source", ["tracker", "tracker-tag", "wandb", "wandb-tag"])
def test_metrics_report_matches_jax(tmp_path, monkeypatch, source):
    tracker = tmp_path / "tracker"
    _tracker_run(tracker, "aaaa", 1e-3, 10, 0.5, freqs=[0.1, 0.01, 1e-6])
    _tracker_run(tracker, "bbbb", 3e-3, 30, 0.2)
    _tracker_run(tracker, "cccc", 1e-4, 40, 0.3)
    kw = {"tag": "sweepX"} if source.endswith("tag") else {}
    if source.startswith("wandb"):
        fake = types.ModuleType("wandb")
        fake.Api = _RecordedApi
        monkeypatch.setitem(sys.modules, "wandb", fake)
        kw |= {"wandb_entity": "me", "wandb_project": "saev"}
    else:
        kw |= {"tracker_dir": tracker}
    _RecordedApi.calls = []
    metrics.generate(metrics.Config(**kw, out=tmp_path / "port.html"))
    port_calls = list(_RecordedApi.calls)
    _RecordedApi.calls = []
    jmetrics.generate(jmetrics.Config(**kw, out=tmp_path / "jax.html"))
    assert port_calls == _RecordedApi.calls
    html = (tmp_path / "port.html").read_text()
    assert html == (tmp_path / "jax.html").read_text() and "copyPareto" in html


@pytest.mark.parametrize("embed", [True, False])
def test_features_report_matches_jax(tmp_path, embed):
    import pandas as pd
    from PIL import Image

    run_dir = tmp_path / "saev" / "runs" / "r1"
    for sub in ("checkpoint", "links"):
        (run_dir / sub).mkdir(parents=True)
    art = run_dir / "inference" / "shardhash"
    art.mkdir(parents=True)
    rng = np.random.default_rng(1)
    pd.DataFrame({"feature": range(10), "log10_freq": [-9.0 + i for i in range(10)],
                  "log10_value": rng.normal(size=10)}).to_parquet(art / "var.parquet")
    for f in range(10):
        d = art / "images" / str(f)
        d.mkdir(parents=True)
        for j in range(3):
            Image.fromarray(rng.integers(0, 256, (4, 4, 3), dtype=np.uint8)).save(d / f"{j}_sae_img.png")
    kw = dict(run=run_dir, shards=tmp_path / "shards" / "shardhash", n_features=4, max_imgs_per_feature=2,
              embed_images=embed)
    features.generate(features.Config(**kw, out=art / "port.html"))
    jfeatures.generate(jfeatures.Config(**kw, out=art / "jax.html"))
    html = (art / "port.html").read_text()
    assert html == (art / "jax.html").read_text() and "Latent feature browser" in html
