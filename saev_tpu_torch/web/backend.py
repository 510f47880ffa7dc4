"""Live HTTP backend for the three browser demos (semseg, classification,
comparison): the counterpart of saev_tpu/web/backend.py, with the same
endpoints, payloads and probe algebra, reading a run with the port's
`nn.load`, `disk`, `data.shards`, `data.datasets` and `data.models`. The SAE
file and the family's model are loaded on `device` (the card unless the
caller asks for the CPU, `--device cpu`); every endpoint then works in numpy
on the host, as the JAX package's does. scikit-learn and Pillow are
imported where they are used.

The reference ships Elm apps (reference src/web/src/{Semseg,Classification,
Comparison}.elm) that call hosted Gradio spaces; the endpoint names and
payload shapes live in the Elm request code (Semseg.elm:560-601,
Classification.elm:585-712, Comparison.elm:470-495). This module serves the
same capability surface over a trained run's OWN artifacts, with a stdlib
`http.server` JSON API — no Gradio dependency, works air-gapped:

    POST /api/<app>/<endpoint>   body {"data": [...]}  ->  {"data": [result]}
    GET  /<app>/...              static files from src/web/

Endpoints (1:1 with the Elm apps' `Gradio.get` calls):

    semseg          get-img, get-orig-preds, get-mod-preds, get-sae-latents
    classification  get-img, get-preds, get-modified, get-sae-latents,
                    get-random-class-img
    comparison      get-image, get-sae-activations

Everything is computed from framework artifacts: images come from the shard
dataset (Metadata.make_data_cfg), SAE codes from the run's inference
`token_acts.npz` CSR, probe heads are linear models fit at startup on the raw
shard activations, and latent interventions use the exact decoder linearity
    probe(x + (f' - f) @ W_dec) = probe(x) + (f' - f) @ W_dec @ W_p
(the same algebra as contrib/interactive_interp/semseg/interactive.py, which
recomputes reference-grade logit shifts in the browser).
"""

import argparse
import base64
import dataclasses
import io
import json
import logging
import pathlib
import threading
import typing as tp
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .. import disk, viz
from ..data import shards as shards_mod

logger = logging.getLogger("web.backend")

# The browser apps, at the repo's root (saev_tpu_torch/web/ is two levels down).
WEB_ROOT = pathlib.Path(__file__).resolve().parents[2] / "src" / "web"

# Deterministic 6-value RGB-cube class palette (matches the contrib semseg
# interactive app so both front ends render identical class colors).
_CUBE = (0, 51, 102, 153, 204, 255)


def class_color(c: int) -> tuple[int, int, int]:
    return (_CUBE[c % 6], _CUBE[(c // 6) % 6], _CUBE[(c // 36) % 6])


def png_b64(img) -> str:
    buf = io.BytesIO()
    img.convert("RGB").save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


def _seg_image(labels: np.ndarray, grid_hw: tuple[int, int], patch_size: int):
    """(tokens,) uint8 patch labels -> class-colored PIL image."""
    from PIL import Image

    gh, gw = grid_hw
    grid = labels.reshape(gh, gw)
    rgb = np.zeros((gh, gw, 3), np.uint8)
    for c in np.unique(grid):
        rgb[grid == c] = class_color(int(c))
    rgb = np.repeat(np.repeat(rgb, patch_size, axis=0), patch_size, axis=1)
    return Image.fromarray(rgb)


@dataclasses.dataclass
class _RunData:
    """Everything the apps derive from one (run, shards) pair."""

    run: disk.Run
    md: shards_mod.Metadata
    shards_dir: pathlib.Path
    layer: int
    token_acts: tp.Any  # scipy CSR (n_tokens, d_sae)
    token_acts_csc: tp.Any
    w_dec: np.ndarray  # (d_sae, d_model)
    dataset: tp.Any
    grid_hw: tuple[int, int]
    patch_size: int
    shard_info: tp.Any = None  # cached ShardInfo (parsed once)
    _memmaps: dict = dataclasses.field(default_factory=dict)

    @property
    def ctpe(self) -> int:
        return self.md.content_tokens_per_example


# One _RunData per (run, shards, layer, scale, device): main() builds up to three
# apps over the same pair, and each holds multi-GB CSR/CSC artifacts plus a
# model instantiation — sharing removes a 3x memory and startup multiple.
_RUN_DATA_CACHE: dict[tuple, _RunData] = {}


def _check_inference_layer(art: pathlib.Path, layer: int) -> None:
    """The SAE codes in token_acts.npz came from ONE layer (recorded in the
    inference config); probes fit on a different --layer would silently mix
    layers in the intervention algebra."""
    cfg_fpath = art / "config.json"
    if not cfg_fpath.exists():
        return
    try:
        inf_layer = json.loads(cfg_fpath.read_text())["data"]["layer"]
    except (json.JSONDecodeError, KeyError, TypeError):
        return
    if int(inf_layer) != int(layer):
        raise ValueError(
            f"--layer {layer} does not match the inference artifacts at "
            f"{art} (computed with layer={inf_layer}); the SAE codes and the "
            "probe activations must come from the same layer."
        )


def _load_run_data(
    run_dir: pathlib.Path, shards_dir: pathlib.Path, layer: int, img_scale: float,
    device: str = "cuda",
) -> _RunData:
    import scipy.sparse

    from .. import nn
    from ..data import datasets, models

    key = (
        pathlib.Path(run_dir).resolve(), pathlib.Path(shards_dir).resolve(),
        int(layer), float(img_scale), device,
    )
    if key in _RUN_DATA_CACHE:
        return _RUN_DATA_CACHE[key]

    run = disk.Run(run_dir)
    md = shards_mod.Metadata.load(shards_dir)
    if layer not in md.layers:
        raise ValueError(
            f"--layer {layer} is not in the shards' recorded layers "
            f"{list(md.layers)}."
        )
    art = run.inference / md.hash
    acts_fpath = art / "token_acts.npz"
    if not acts_fpath.exists():
        raise FileNotFoundError(
            f"{acts_fpath} missing - run `launch.py inference` for this "
            "(run, shards) pair first; the backend serves live probes over "
            "those artifacts."
        )
    _check_inference_layer(art, layer)
    token_acts = scipy.sparse.load_npz(acts_fpath).tocsr()
    _, params, _ = nn.load(run.ckpt, device=device)
    w_dec = params["W_dec"].cpu().numpy().astype(np.float32)

    model_cls = models.load_model_cls(md.family)
    model = model_cls(md.ckpt, device=device)
    resize_tr = model_cls.make_resize(md.ckpt, md.content_tokens_per_example, scale=img_scale)
    dataset = datasets.get_dataset(md.make_data_cfg(), data_transform=resize_tr)
    patch_size = int(model.patch_size * img_scale)

    sample = dataset[0]["data"]
    grid_hw = (sample.height // patch_size, sample.width // patch_size)
    assert grid_hw[0] * grid_hw[1] == md.content_tokens_per_example, (
        grid_hw, md.content_tokens_per_example,
    )
    rd = _RunData(
        run=run, md=md, shards_dir=shards_dir, layer=layer,
        token_acts=token_acts, token_acts_csc=token_acts.tocsc(),
        w_dec=w_dec, dataset=dataset, grid_hw=grid_hw, patch_size=patch_size,
        shard_info=shards_mod.ShardInfo.load(shards_dir),
    )
    _RUN_DATA_CACHE[key] = rd
    return rd


def _raw_patch_acts(rd: _RunData, i: int) -> np.ndarray:
    """(tokens, d_model) raw ViT activations of example i from the shard
    memmaps (one contiguous read; the probes' input space). ShardInfo and the
    memmap handles are cached on the _RunData — this runs per request and
    thousands of times in the startup fit loops."""
    md = rd.md
    layer_idx = md.layers.index(rd.layer)
    start = 1 if md.cls_token else 0
    n = 0
    for shard in rd.shard_info:
        if i < n + shard.n_examples:
            mm = rd._memmaps.get(shard.name)
            if mm is None:
                mm = np.memmap(
                    rd.shards_dir / shard.name, mode="r", dtype=np.float32,
                    shape=md.shard_shape,
                )
                rd._memmaps[shard.name] = mm
            return np.asarray(
                mm[i - n, layer_idx, start : start + rd.ctpe], np.float32
            )
        n += shard.n_examples
    raise IndexError(f"example {i} beyond {n} examples")


def _image_b64(rd: _RunData, i: int) -> str:
    from PIL import Image

    img = rd.dataset[int(i)]["data"]
    if not isinstance(img, Image.Image):
        img = Image.fromarray(np.asarray(img))
    return png_b64(img)


def _sae_rows(rd: _RunData, i: int) -> np.ndarray:
    """(tokens, d_sae) dense SAE codes of example i from the CSR artifact."""
    lo = int(i) * rd.ctpe
    return np.asarray(rd.token_acts[lo : lo + rd.ctpe].todense(), np.float32)


def _latent_shift(rd: _RunData, f_rows: np.ndarray, sliders: dict) -> np.ndarray:
    """(tokens, d_model) activation shift from setting latent l to value v on
    every patch: (v - f_l) @ W_dec[l] — exact by decoder linearity."""
    shift = np.zeros((f_rows.shape[0], rd.w_dec.shape[1]), np.float32)
    for latent, value in sliders.items():
        l = int(latent)
        shift += np.outer(float(value) - f_rows[:, l], rd.w_dec[l])
    return shift


def _top_latents_for_patches(
    rd: _RunData, i: int, patches: list[int], k: int
) -> list[int]:
    f_rows = _sae_rows(rd, i)
    sel = f_rows[patches] if patches else f_rows
    score = sel.mean(axis=0)
    top = np.argsort(-score)[:k]
    return [int(l) for l in top if score[l] > 0]


def _latent_examples(rd: _RunData, latent: int, n: int) -> list[dict]:
    """Top-activating examples of one latent with heatmap overlays (the
    SaeLatent.examples payload, Semseg.elm highlightedExampleDecoder).

    Per-example peaks come from the CSC column's NONZEROS (scatter-max over
    nnz entries) — densifying the full column is ~n_examples x ctpe floats
    per latent, multi-GB transients at ImageNet scale."""
    col = rd.token_acts_csc[:, int(latent)].tocoo()
    n_examples = rd.md.n_examples
    peak = np.zeros(n_examples, np.float32)
    if col.nnz:
        np.maximum.at(peak, col.row // rd.ctpe, col.data)
    order = np.argsort(-peak)[:n]
    out = []
    from PIL import Image

    for ex in order:
        if peak[ex] <= 0:
            break
        img = rd.dataset[int(ex)]["data"]
        if not isinstance(img, Image.Image):
            img = Image.fromarray(np.asarray(img))
        # Only the selected example's token vector is densified (ctpe floats).
        tokens = _sae_rows(rd, int(ex))[:, int(latent)]
        highlighted = viz.add_highlights(
            img.convert("RGB"), tokens, rd.patch_size, upper=float(peak[ex])
        )
        out.append({
            "example": int(ex),
            "orig_url": png_b64(img),
            "highlighted_url": png_b64(highlighted),
            "value": float(peak[ex]),
        })
    return out


class SemsegApp:
    """Semantic-segmentation probing demo (reference Semseg.elm).

    A per-patch linear head fit on raw shard activations vs labels.bin stands
    in for the reference space's trained seg head; interventions move the
    activations along decoder rows before the head."""

    name = "semseg"

    def __init__(
        self,
        run_dir: pathlib.Path,
        shards_dir: pathlib.Path,
        layer: int = 0,
        img_scale: float = 1.0,
        max_fit_tokens: int = 100_000,
        seed: int = 0,
        device: str = "cuda",
    ):
        from sklearn.linear_model import LogisticRegression

        self.rd = _load_run_data(run_dir, shards_dir, layer, img_scale, device)
        labels_fpath = shards_dir / "labels.bin"
        if not labels_fpath.exists():
            raise FileNotFoundError(
                f"{labels_fpath} missing - the semseg app needs patch labels "
                "(extract with an ImgSegFolder/FakeImgSeg dataset)."
            )
        md = self.rd.md
        self.labels = np.array(
            np.memmap(
                labels_fpath, mode="r", dtype=np.uint8,
                shape=(md.n_examples, md.content_tokens_per_example),
            )
        )
        rng = np.random.default_rng(seed)
        n_fit = min(max_fit_tokens // self.rd.ctpe, md.n_examples)
        fit_examples = rng.choice(md.n_examples, size=n_fit, replace=False)
        xs = np.concatenate([_raw_patch_acts(self.rd, i) for i in fit_examples])
        ys = self.labels[fit_examples].reshape(-1)
        self.head = LogisticRegression(max_iter=200).fit(xs, ys)
        logger.info(
            "semseg head fit on %d tokens: %d classes, train acc %.3f",
            len(ys), len(self.head.classes_), self.head.score(xs, ys),
        )

    def _pred_image(self, acts: np.ndarray) -> str:
        pred = self.head.predict(acts).astype(np.uint8)
        return png_b64(_seg_image(pred, self.rd.grid_hw, self.rd.patch_size))

    # -- endpoints (names from Semseg.elm:560-601) --------------------------

    def meta(self) -> dict:
        rd = self.rd
        return {
            "n_examples": rd.md.n_examples,
            "grid_h": rd.grid_hw[0],
            "grid_w": rd.grid_hw[1],
            "patch_size": rd.patch_size,
            "d_sae": int(rd.w_dec.shape[0]),
            "classes": sorted(int(c) for c in np.unique(self.labels)),
        }

    def get_img(self, i: int) -> dict:
        seg = self.labels[int(i)]
        return {
            "orig_url": _image_b64(self.rd, i),
            "seg_url": png_b64(
                _seg_image(seg, self.rd.grid_hw, self.rd.patch_size)
            ),
            "classes": sorted(int(c) for c in np.unique(seg)),
        }

    def get_orig_preds(self, i: int) -> dict:
        acts = _raw_patch_acts(self.rd, int(i))
        pred = self.head.predict(acts).astype(np.uint8)
        return {
            "orig_url": _image_b64(self.rd, i),
            "seg_url": png_b64(_seg_image(pred, self.rd.grid_hw, self.rd.patch_size)),
            "classes": sorted(int(c) for c in np.unique(pred)),
        }

    def get_mod_preds(self, i: int, sliders: dict) -> dict:
        acts = _raw_patch_acts(self.rd, int(i))
        acts = acts + _latent_shift(self.rd, _sae_rows(self.rd, int(i)), sliders)
        pred = self.head.predict(acts).astype(np.uint8)
        return {
            "orig_url": _image_b64(self.rd, i),
            "seg_url": png_b64(_seg_image(pred, self.rd.grid_hw, self.rd.patch_size)),
            "classes": sorted(int(c) for c in np.unique(pred)),
        }

    def get_sae_latents(self, i: int, patches: list) -> list:
        latents = _top_latents_for_patches(
            self.rd, int(i), [int(p) for p in patches], k=4
        )
        return [
            {"latent": l, "examples": _latent_examples(self.rd, l, n=4)}
            for l in latents
        ]


def _dataset_targets(dataset, n: int) -> np.ndarray:
    """Per-example integer targets WITHOUT decoding images when the dataset
    exposes them structurally (ImgFolderDataset.samples holds (fpath, target,
    label)); falls back to per-sample reads otherwise."""
    samples = getattr(dataset, "samples", None)
    if samples is not None and len(samples) >= n:
        try:
            return np.array([int(samples[i][1]) for i in range(n)])
        except (TypeError, ValueError, IndexError):
            pass
    return np.array([int(dataset[i].get("target", 0)) for i in range(n)])


class ClassificationApp:
    """Image-classification probing demo (reference Classification.elm).

    Linear head on mean-pooled raw activations vs the dataset's targets;
    interventions shift every patch before re-pooling."""

    name = "classification"

    def __init__(
        self,
        run_dir: pathlib.Path,
        shards_dir: pathlib.Path,
        layer: int = 0,
        img_scale: float = 1.0,
        max_fit_examples: int = 10_000,
        seed: int = 0,
        device: str = "cuda",
    ):
        from sklearn.linear_model import LogisticRegression

        self.rd = _load_run_data(run_dir, shards_dir, layer, img_scale, device)
        md = self.rd.md
        self.targets = _dataset_targets(self.rd.dataset, md.n_examples)
        # Sample the fit subset (ImgFolder datasets are ordered grouped by
        # class — the first n examples can be single-class and crash fit()).
        rng = np.random.default_rng(seed)
        n_fit = min(max_fit_examples, md.n_examples)
        fit_examples = np.sort(rng.choice(md.n_examples, size=n_fit, replace=False))
        xs = np.stack([
            _raw_patch_acts(self.rd, int(i)).mean(axis=0) for i in fit_examples
        ])
        degenerate = len(np.unique(self.targets)) < 2
        if degenerate:
            # Degenerate image targets: the fake test datasets pin target=0
            # (as does the reference's FakeImg, datasets.py:568) and every
            # fake image is identical, so no class signal exists anywhere.
            # Demo mode: assign balanced synthetic targets and a seeded
            # random linear head, so the full endpoint path (probs, logits,
            # exact decoder-row interventions) still runs; real datasets
            # never hit this branch.
            logger.warning(
                "image targets are single-class; using balanced synthetic "
                "targets and a random demo head (no class signal in this data)"
            )
            self.targets = np.arange(md.n_examples) % 2
        ys = self.targets[fit_examples]
        self.head = LogisticRegression(max_iter=500).fit(xs, ys)
        if degenerate or not np.any(self.head.coef_):
            rng = np.random.default_rng(0)
            coef = rng.standard_normal(self.head.coef_.shape)
            self.head.coef_ = coef / np.linalg.norm(coef)
        self.class_names = sorted(int(c) for c in np.unique(ys))
        logger.info(
            "classification head fit on %d examples: %d classes, acc %.3f",
            n_fit, len(self.class_names), self.head.score(xs, ys),
        )

    def _probs(self, pooled: np.ndarray) -> dict:
        raw = self.head.predict_proba(pooled[None])[0]
        logit = self.head.decision_function(pooled[None])[0]
        logits = np.atleast_1d(np.asarray(logit, np.float64))
        if len(self.head.classes_) == 2 and logits.shape == (1,):
            logits = np.array([-logits[0], logits[0]])
        probs = {int(c): float(p) for c, p in zip(self.head.classes_, raw)}
        lgts = {int(c): float(v) for c, v in zip(self.head.classes_, logits)}
        return {
            "probs": {str(c): probs.get(c, 0.0) for c in self.class_names},
            "logits": {str(c): lgts.get(c, 0.0) for c in self.class_names},
        }

    # -- endpoints (names from Classification.elm:585-712) ------------------

    def meta(self) -> dict:
        rd = self.rd
        return {
            "n_examples": rd.md.n_examples,
            "grid_h": rd.grid_hw[0],
            "grid_w": rd.grid_hw[1],
            "patch_size": rd.patch_size,
            "d_sae": int(rd.w_dec.shape[0]),
            "classes": self.class_names,
        }

    def get_img(self, i: int) -> dict:
        return {
            "orig_url": _image_b64(self.rd, i),
            "target": int(self.targets[int(i)]),
        }

    def get_preds(self, i: int) -> dict:
        pooled = _raw_patch_acts(self.rd, int(i)).mean(axis=0)
        return self._probs(pooled)

    def get_modified(self, i: int, sliders: dict) -> dict:
        acts = _raw_patch_acts(self.rd, int(i))
        acts = acts + _latent_shift(self.rd, _sae_rows(self.rd, int(i)), sliders)
        return self._probs(acts.mean(axis=0))

    def get_sae_latents(self, i: int, patches: list) -> list:
        latents = _top_latents_for_patches(
            self.rd, int(i), [int(p) for p in patches], k=4
        )
        return [
            {"latent": l, "examples": _latent_examples(self.rd, l, n=4)}
            for l in latents
        ]

    def get_random_class_img(self, cls: int, seed: int = 0) -> dict:
        pool = np.flatnonzero(self.targets == int(cls))
        if len(pool) == 0:
            raise ValueError(f"no examples with target {cls}")
        i = int(np.random.default_rng(seed).choice(pool))
        return {"index": i, **self.get_img(i)}


class ComparisonApp:
    """Side-by-side model comparison (reference Comparison.elm): the same
    example through N (run, shards) pairs, each reporting its own top latents
    and patch grids."""

    name = "comparison"

    def __init__(
        self,
        run_dirs: list[pathlib.Path],
        shards_dirs: list[pathlib.Path],
        layer: int = 0,
        img_scale: float = 1.0,
        device: str = "cuda",
    ):
        assert len(run_dirs) == len(shards_dirs) >= 1
        self.rds = [
            _load_run_data(r, s, layer, img_scale, device)
            for r, s in zip(run_dirs, shards_dirs)
        ]
        n = {rd.md.n_examples for rd in self.rds}
        assert len(n) == 1, f"shard sets disagree on n_examples: {n}"

    # -- endpoints (names from Comparison.elm:470-495) ----------------------

    def meta(self) -> dict:
        return {
            "n_examples": self.rds[0].md.n_examples,
            "models": [
                {
                    "model": rd.run.run_id,
                    "grid_h": rd.grid_hw[0],
                    "grid_w": rd.grid_hw[1],
                    "patch_size": rd.patch_size,
                    "d_sae": int(rd.w_dec.shape[0]),
                }
                for rd in self.rds
            ],
        }

    def get_image(self, i: int) -> dict:
        return {
            "orig_url": _image_b64(self.rds[0], i),
            "index": int(i),
        }

    def get_sae_activations(self, i: int, latents: dict | None = None) -> list:
        """Per model: requested (or top) latents with their patch grids."""
        out = []
        for mi, rd in enumerate(self.rds):
            f_rows = _sae_rows(rd, int(i))
            if latents and str(mi) in latents:
                ls = [int(l) for l in latents[str(mi)]]
            else:
                ls = _top_latents_for_patches(rd, int(i), [], k=4)
            out.append({
                "model": rd.run.run_id,
                "latents": [
                    {
                        "latent": l,
                        "activations": f_rows[:, l].round(4).tolist(),
                        "examples": _latent_examples(rd, l, n=3),
                    }
                    for l in ls
                ],
                "grid_h": rd.grid_hw[0],
                "grid_w": rd.grid_hw[1],
                "patch_size": rd.patch_size,
            })
        return out


# ---------------------------------------------------------------------------
# HTTP plumbing
# ---------------------------------------------------------------------------

# endpoint -> (method name, positional arg names); mirrors the Elm apps' call
# signatures (args arrive as the "data" list, Gradio-style).
_ROUTES: dict[str, dict[str, tuple[str, int]]] = {
    "semseg": {
        "meta": ("meta", 0),
        "get-img": ("get_img", 1),
        "get-orig-preds": ("get_orig_preds", 1),
        "get-mod-preds": ("get_mod_preds", 2),
        "get-sae-latents": ("get_sae_latents", 2),
    },
    "classification": {
        "meta": ("meta", 0),
        "get-img": ("get_img", 1),
        "get-preds": ("get_preds", 1),
        "get-modified": ("get_modified", 2),
        "get-sae-latents": ("get_sae_latents", 2),
        "get-random-class-img": ("get_random_class_img", 2),
    },
    "comparison": {
        "meta": ("meta", 0),
        "get-image": ("get_image", 1),
        "get-sae-activations": ("get_sae_activations", 2),
    },
}


def make_server(
    apps: dict[str, object],
    host: str = "127.0.0.1",
    port: int = 0,
    web_root: pathlib.Path | None = None,
) -> ThreadingHTTPServer:
    """HTTP server exposing each app's endpoints under /api/<app>/<endpoint>
    and (optionally) static files from `web_root`. Caller starts it with
    serve_forever (or `run_server` below)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            logger.debug("%s " + fmt, self.client_address[0], *args)

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            parts = self.path.strip("/").split("/")
            if len(parts) != 3 or parts[0] != "api":
                return self._json(404, {"error": f"no such route: {self.path}"})
            _, app_name, endpoint = parts
            app = apps.get(app_name)
            route = _ROUTES.get(app_name, {}).get(endpoint)
            if app is None or route is None:
                return self._json(
                    404, {"error": f"no endpoint {endpoint!r} on {app_name!r}"}
                )
            method, n_args = route
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
                args = payload.get("data", [])
                if len(args) < n_args:
                    raise ValueError(
                        f"{endpoint} needs {n_args} args, got {len(args)}"
                    )
                result = getattr(app, method)(*args[:n_args])
                self._json(200, {"data": [result]})
            except Exception as err:  # surfaced to the client, not swallowed
                logger.exception("%s/%s failed", app_name, endpoint)
                self._json(500, {"error": f"{type(err).__name__}: {err}"})

        def do_GET(self):
            if self.path.startswith("/api/"):
                return self._json(
                    405, {"error": "endpoints are POST {\"data\": [...]}"}
                )
            if web_root is None:
                return self._json(404, {"error": "static serving disabled"})
            # Cache-busting/query parameters must not 404 the asset.
            path = self.path.split("?", 1)[0].split("#", 1)[0]
            rel = path.strip("/") or "index.html"
            fpath = (web_root / rel).resolve()
            if fpath.is_dir():
                fpath = fpath / "index.html"
            if web_root.resolve() not in fpath.parents or not fpath.is_file():
                return self._json(404, {"error": f"not found: {self.path}"})
            ctype = {
                ".html": "text/html", ".js": "text/javascript",
                ".css": "text/css", ".json": "application/json",
            }.get(fpath.suffix, "application/octet-stream")
            body = fpath.read_bytes()
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return ThreadingHTTPServer((host, port), Handler)


def run_server(server: ThreadingHTTPServer) -> threading.Thread:
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return thread


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--run", type=pathlib.Path, action="append", default=[],
                        help="run dir (repeat for comparison)")
    parser.add_argument("--shards", type=pathlib.Path, action="append",
                        default=[], help="shards dir (one per --run)")
    parser.add_argument("--layer", type=int, default=0)
    parser.add_argument("--apps", default="semseg,classification,comparison")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--img-scale", type=float, default=1.0)
    parser.add_argument("--device", default="cuda",
                        help="where the SAE file and the model load (cpu on request)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    if not args.run or len(args.run) != len(args.shards):
        parser.error("need matching --run/--shards pairs")

    apps: dict[str, object] = {}
    wanted = set(args.apps.split(","))
    if "semseg" in wanted:
        apps["semseg"] = SemsegApp(
            args.run[0], args.shards[0], args.layer, args.img_scale, device=args.device
        )
    if "classification" in wanted:
        apps["classification"] = ClassificationApp(
            args.run[0], args.shards[0], args.layer, args.img_scale, device=args.device
        )
    if "comparison" in wanted:
        apps["comparison"] = ComparisonApp(
            args.run, args.shards, args.layer, args.img_scale, device=args.device
        )

    web_root = WEB_ROOT
    server = make_server(apps, args.host, args.port, web_root=web_root)
    logger.info(
        "serving %s on http://%s:%d (apps: %s)",
        web_root, *server.server_address, ", ".join(apps),
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
