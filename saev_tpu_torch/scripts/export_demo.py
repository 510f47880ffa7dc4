"""Export static web demo bundles from trained runs (the counterpart of
scripts/export_demo.py, reading a run with the port's `disk`, `nn.load` and
`data`; the SAE file and the family's model load on `device`, the card unless
the caller asks for the CPU with `--device cpu`; scikit-learn and Pillow are
imported where they are used).

Capability mirror of reference scripts/deploy.py + the three Elm/Gradio web
demos (reference src/web/src/{Semseg,Classification,Comparison}.elm): instead
of a live Gradio backend, activations for a sample of images and latents are
precomputed into `demo.json`, and the static apps under src/web/ render them
interactively in any browser.

Subcommands:
    export          latent explorer (semseg-style heatmap toggles)
    classification  patch-select -> slider intervention -> prediction deltas
                    (the linear head + SAE decoder rows ship in demo.json so
                    the intervention math runs client-side)
    comparison      the same images through N (model, run) pairs side by side

Usage:
    python -m saev_tpu_torch.scripts.export_demo export --run runs/<id> --shards <dir> \\
        --out ./demo_site
    python -m saev_tpu_torch.scripts.export_demo classification --run runs/<id> \\
        --shards <dir> --out ./demo_cls
    python -m saev_tpu_torch.scripts.export_demo comparison --runs runs/a runs/b \\
        --shards-list <dir-a> <dir-b> --out ./demo_cmp
    python -m http.server -d ./demo_site   # then open http://localhost:8000
"""

import base64
import dataclasses
import io
import json
import logging
import pathlib
import shutil

import numpy as np

logger = logging.getLogger("export_demo")


@dataclasses.dataclass(frozen=True)
class Args:
    run: pathlib.Path = pathlib.Path("./runs/abcdefg")
    shards: pathlib.Path = pathlib.Path("./shards/abcdef01")
    n_images: int = 16
    n_latents: int = 24
    """Most-frequent in-band latents exported."""
    img_scale: float = 1.0
    layer_idx: int = 0
    """Which recorded layer to pool for the classification head (index into
    metadata.layers)."""
    max_fit_examples: int = 50_000
    """Cap on examples used to fit the classification head (reading targets
    walks the image dataset sample by sample)."""
    out: pathlib.Path = pathlib.Path("./demo_site")
    device: str = "cuda"
    """Where the SAE file and the family's model load ("cpu" on request)."""


# The static apps' templates, at the repo's root (this file is two levels down).
WEB_ROOT = pathlib.Path(__file__).resolve().parents[2] / "src" / "web"


def _collect(
    run_dir: pathlib.Path,
    shards_dir: pathlib.Path,
    n_images: int,
    n_latents: int,
    img_scale: float,
    device: str = "cuda",
) -> dict:
    """Gather everything the static apps need for one (run, shards) pair:
    sampled images (as data: URLs), the most frequently firing latents, and
    their per-image patch activation grids."""
    import scipy.sparse
    from PIL import Image

    from .. import disk
    from ..data import Metadata, datasets, models

    run = disk.Run(run_dir)
    md = Metadata.load(shards_dir)
    art = run.inference / md.hash
    token_acts = scipy.sparse.load_npz(art / "token_acts.npz").tocsr()
    ctpe = md.content_tokens_per_example

    model_cls = models.load_model_cls(md.family)
    model = model_cls(md.ckpt, device=device)
    resize_tr = model_cls.make_resize(md.ckpt, ctpe, scale=img_scale)
    ds = datasets.get_dataset(md.make_data_cfg(), data_transform=resize_tr)

    n_images = min(n_images, md.n_examples)
    # Pick latents by firing frequency over the sampled images.
    sub = token_acts[: n_images * ctpe]
    freq = np.asarray((sub > 0).sum(axis=0)).reshape(-1)
    latents = np.argsort(-freq)[:n_latents]
    latents = [int(l) for l in latents if freq[l] > 0]

    patch_size = int(model.patch_size * img_scale)
    images, targets, labels, grid_hw = [], [], [], None
    for i in range(n_images):
        sample = ds[i]
        img = sample["data"]
        if not isinstance(img, Image.Image):
            img = Image.fromarray(np.asarray(img))
        if grid_hw is None:
            grid_hw = (img.height // patch_size, img.width // patch_size)
        targets.append(int(sample.get("target", 0)))
        labels.append(str(sample.get("label", "")))
        buf = io.BytesIO()
        img.convert("RGB").save(buf, format="PNG")
        images.append(
            "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()
        )

    activations = {}
    for latent in latents:
        col = np.asarray(sub[:, latent].todense()).reshape(n_images, ctpe)
        activations[str(latent)] = [row.round(4).tolist() for row in col]

    return {
        "run": run,
        "md": md,
        "n_images": n_images,
        "images": images,
        "targets": targets,
        "labels": labels,
        "latents": latents,
        "activations": activations,
        "grid_hw": grid_hw,
        "patch_size": patch_size,
    }


def _write_site(out: pathlib.Path, app: str, demo: dict) -> pathlib.Path:
    out.mkdir(parents=True, exist_ok=True)
    template = WEB_ROOT / app
    for fname in ("index.html", "app.js"):
        shutil.copy(template / fname, out / fname)
    with open(out / "demo.json", "w") as fd:
        json.dump(demo, fd)
    return out


def export(args: Args) -> pathlib.Path:
    c = _collect(args.run, args.shards, args.n_images, args.n_latents, args.img_scale, args.device)
    out = _write_site(
        args.out,
        "semseg",
        {
            "run_id": c["run"].run_id,
            "grid_h": c["grid_hw"][0],
            "grid_w": c["grid_hw"][1],
            "patch_size": c["patch_size"],
            "images": c["images"],
            "latents": c["latents"],
            "activations": c["activations"],
        },
    )
    logger.info(
        "Exported %d images x %d latents to %s.", c["n_images"], len(c["latents"]), out
    )
    return out


def _pooled_acts(shards_dir: pathlib.Path, layer: int, n_images: int) -> np.ndarray:
    """Mean-pooled raw ViT activations per image, (n_images, d_model) f32.

    Reads each shard memmap once and mean-reduces the content-token axis in a
    single vectorized pass per shard (the per-token indexed-dataset path is
    O(n_images x tokens) random 4 KB reads — hours at ImageNet scale)."""
    from ..data import shards as shards_mod

    md = shards_mod.Metadata.load(shards_dir)
    layer_idx = md.layers.index(layer)
    start = 1 if md.cls_token else 0
    out = np.zeros((n_images, md.d_model), np.float32)
    done = 0
    for shard in shards_mod.ShardInfo.load(shards_dir):
        if done >= n_images:
            break
        take = min(shard.n_examples, n_images - done)
        mm = np.memmap(
            shards_dir / shard.name, mode="r", dtype=np.float32, shape=md.shard_shape
        )
        out[done : done + take] = mm[
            :take, layer_idx, start : start + md.content_tokens_per_example
        ].mean(axis=1)
        done += take
        del mm
        logger.info("Pooled %d/%d examples.", done, n_images)
    assert done == n_images, f"shards hold {done} examples, need {n_images}"
    return out


def export_classification(args: Args) -> pathlib.Path:
    """Static intervention demo (reference Classification.elm): fits a linear
    head on mean-pooled ViT activations, then ships the head (W, b), each
    exported latent's decoder row, and per-image pooled activations so the app
    can recompute predictions after latent interventions entirely client-side.
    """
    from sklearn.linear_model import LogisticRegression

    from .. import nn
    from ..data import Metadata

    c = _collect(args.run, args.shards, args.n_images, args.n_latents, args.img_scale, args.device)
    md: "Metadata" = c["md"]
    layer = md.layers[0] if len(md.layers) == 1 else md.layers[args.layer_idx]

    # Fit the linear head on ALL examples (not just the exported sample).
    from ..data import datasets

    ds = datasets.get_dataset(md.make_data_cfg())
    n_fit = min(md.n_examples, args.max_fit_examples)
    if n_fit < md.n_examples:
        logger.info(
            "Fitting head on %d of %d examples (--max-fit-examples).",
            n_fit, md.n_examples,
        )
    all_targets, class_names = [], {}
    for i in range(n_fit):
        s = ds[i]
        t = int(s.get("target", 0))
        all_targets.append(t)
        class_names.setdefault(t, str(s.get("label", "")))
        if (i + 1) % 10_000 == 0:
            logger.info("Read targets for %d/%d examples.", i + 1, n_fit)
    classes = sorted(set(all_targets))
    if len(classes) < 2:
        raise ValueError(
            "classification demo needs a dataset with >= 2 classes; "
            f"got targets {classes}. Use an ImgFolder/Imagenet-style dataset."
        )
    x_all = _pooled_acts(args.shards, layer, n_fit)
    clf = LogisticRegression(max_iter=1000).fit(x_all, all_targets)
    coef = clf.coef_.astype(np.float32)
    intercept = clf.intercept_.astype(np.float32)
    if coef.shape[0] == 1:
        # Binary sklearn head: p(c1) = sigmoid(w.x + b). Same distribution as
        # softmax over logits [0, w.x + b].
        coef = np.concatenate([np.zeros_like(coef), coef], axis=0)
        intercept = np.concatenate([np.zeros_like(intercept), intercept])
    names = [class_names.get(cl, str(cl)) for cl in clf.classes_]

    # Decoder rows of the exported latents (for client-side intervention).
    sae_cfg, params, _state = nn.load(c["run"].ckpt, device=args.device)
    w_dec = params["W_dec"].cpu().numpy().astype(np.float32)
    assert w_dec.shape[1] == md.d_model

    x_pool = x_all[: c["n_images"]]
    demo = {
        "run_id": c["run"].run_id,
        "grid_h": c["grid_hw"][0],
        "grid_w": c["grid_hw"][1],
        "patch_size": c["patch_size"],
        "images": c["images"],
        "latents": c["latents"],
        "activations": c["activations"],
        "x_pool": [row.round(5).tolist() for row in x_pool],
        "head_w": [row.round(6).tolist() for row in coef],
        "head_b": intercept.round(6).tolist(),
        "class_names": names,
        "w_dec": {
            str(l): w_dec[l].round(5).tolist() for l in c["latents"]
        },
    }
    out = _write_site(args.out, "classification", demo)
    logger.info(
        "Exported classification demo: %d images, %d latents, %d classes -> %s",
        c["n_images"], len(c["latents"]), len(names), out,
    )
    return out


@dataclasses.dataclass(frozen=True)
class ComparisonArgs:
    runs: list[pathlib.Path] = dataclasses.field(default_factory=list)
    shards_list: list[pathlib.Path] = dataclasses.field(default_factory=list)
    """One shards dir per run, over the SAME underlying image dataset."""
    n_images: int = 8
    n_latents: int = 24
    img_scale: float = 1.0
    out: pathlib.Path = pathlib.Path("./demo_cmp")
    device: str = "cuda"
    """Where the SAE files and the families' models load ("cpu" on request)."""


def export_comparison(args: ComparisonArgs) -> pathlib.Path:
    """Static multi-ViT comparison demo (reference Comparison.elm): the same
    images through N (model, run) pairs; each model block keeps its own patch
    grid and top latents."""
    assert len(args.runs) == len(args.shards_list) and args.runs, (
        "need matching --runs and --shards-list"
    )
    # Each model exports its OWN resized images: resize semantics differ
    # across families (SigLIP squash vs shortest-edge+crop), so reusing one
    # model's pixels would geometrically misalign the other models' per-patch
    # heatmaps.
    models_out, images = [], None
    for run_dir, shards_dir in zip(args.runs, args.shards_list):
        c = _collect(
            run_dir, shards_dir, args.n_images, args.n_latents, args.img_scale, args.device,
        )
        if images is None:
            images = c["images"]
        models_out.append({
            "family": c["md"].family,
            "ckpt": c["md"].ckpt,
            "run_id": c["run"].run_id,
            "grid_h": c["grid_hw"][0],
            "grid_w": c["grid_hw"][1],
            "patch_size": c["patch_size"],
            "latents": c["latents"],
            "activations": c["activations"],
            "images": c["images"],
        })
    demo = {"images": images, "models": models_out}
    out = _write_site(args.out, "comparison", demo)
    logger.info(
        "Exported comparison demo: %d models x %d images -> %s",
        len(models_out), len(images), out,
    )
    return out


if __name__ == "__main__":
    from ..utils import cli as cli_mod

    logging.basicConfig(level=logging.INFO)
    cli_mod.run({
        "export": export,
        "classification": export_classification,
        "comparison": export_comparison,
    })
