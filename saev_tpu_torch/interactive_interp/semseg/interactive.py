"""Interactive latent-intervention explorer for semantic segmentation.

Counterpart of contrib/interactive_interp/semseg/interactive.py, the
reference's marimo dashboard (contrib/interactive_interp/semseg/
interactive.py:1-698) in the repo's single-file-HTML form factor. Per
reference capability:

- example selection: number input + random button (:117-143, :176-189)
- N class dropdowns proposing features per class (:192-213)
- feature proposal = top-`n_features` latents by aggregate activation on the
  class's patches, restricted to sparse latents (sparsity < 1e-2)
  (:216-220, :515-552), plus optional random features (:39)
- per-feature sliders in [-10, 10], value mapped by `x * max_obs`
  (Feature.scaled/unscaled, :352-392); setting a slider REPLACES the latent's
  activation, exactly like `modified_f_x[..., latents] = values` (:468-497)
- live re-prediction: the linear head means
  `head(err + modified_decode(f_x))` equals
  `head(acts) + sum_i (v_i - f_x_i) * (W_dec[i] @ W_head)` per patch, so the
  browser recomputes EXACT modified logits with a few hundred mul-adds —
  no backend needed (reference `modify` + `head`, :236-242, :468-497)
- panels: true labels, predicted labels, predicted-after-manipulation, each
  nearest-upsampled, with a bilinear "interpolated" toggle
  (:308-347, :566-601); deterministic 6-value RGB-cube class colors (:604-629)
- per-feature top-activating examples rendered as activation mini-heatmaps
  over the embedded examples (:266-304; the reference shows ImageNet photos,
  which the hermetic pipeline doesn't ship)

The aggregate pass (an encode a batch, the one-hot product of f_x, the
firing counts, the per-latent max) and each embedded example's encode (256
tokens x d_sae, TopK's threshold by kernel K6) run on the card unless
`device` is "cpu"; the payload and the page are the JAX package's.

Usage:
    python -m saev_tpu_torch.interactive_interp.semseg interactive --sae-ckpt ... --head-ckpt ... \
        --acts.shards <labeled shards> --out app.html
"""

import dataclasses
import json
import logging
import pathlib
import typing as tp

import numpy as np
import torch

from ... import nn
from ...data import IndexedConfig, IndexedDataset, Metadata, OrderedConfig, OrderedDataLoader
from ...nn import modeling
from .. import device_of
from . import quantitative, training

logger = logging.getLogger("semseg.interactive")


@dataclasses.dataclass(frozen=True)
class Config:
    """The JAX package's fields and defaults but for `device`."""

    sae_ckpt: pathlib.Path = pathlib.Path("./checkpoint/sae.pt")
    head_ckpt: pathlib.Path = pathlib.Path("./checkpoints/semseg")
    """Directory with probes.npz from semseg.training.dump."""
    acts: OrderedConfig = dataclasses.field(default_factory=OrderedConfig)
    """Labeled shards (labels.bin required)."""
    n_classes: int = 151
    n_examples: int = 8
    """Examples embedded into the app."""
    n_features: int = 3
    """Features proposed per class."""
    n_random: int = 2
    """Extra random (control) features."""
    n_dropdowns: int = 3
    """Simultaneous class dropdowns."""
    max_agg_tokens: int = 8192
    """Token budget for the aggregate-activation proposal pass."""
    sparsity_max: float = 1e-2
    """Only latents firing less often than this are proposed."""
    class_names: pathlib.Path | None = None
    """Optional CSV of `idx,name` rows."""
    probe_i: int = 0
    """Which trained probe head to drive."""
    seed: int = 17
    out: pathlib.Path = pathlib.Path("./semseg_interactive.html")
    device: tp.Literal["cuda", "cpu"] = "cuda"
    """Where the encodes and the aggregate pass run: the card unless "cpu" is
    asked for."""


@torch.no_grad()
def _aggregate_pass(cfg: Config, sae_cfg, params, state):
    """One bounded ordered pass: per-class aggregate latent activation, firing
    frequency, and per-latent max (reference get_aggregate_features +
    sparsity mask), on the device of `params`. The aggregate is an f32
    one-hot product (TF32 off) added up in f32, as the JAX package adds it;
    the firing counts add up as int64."""
    device = params["W_enc"].device
    d_sae = sae_cfg.d_sae
    agg = torch.zeros((cfg.n_classes, d_sae), dtype=torch.float32, device=device)
    fired = torch.zeros((d_sae,), dtype=torch.int64, device=device)
    top = torch.zeros((d_sae,), dtype=torch.float32, device=device)
    classes = torch.arange(cfg.n_classes, device=device)
    seen = 0
    dl = OrderedDataLoader(cfg.acts)
    try:
        for batch in dl:
            assert "token_labels" in batch, (
                f"{cfg.acts.shards} has no labels.bin; the intervention app "
                "needs per-patch labels."
            )
            f_x = quantitative.encode_f(sae_cfg, params, state, quantitative.batch_acts(batch, device))
            labels = torch.from_numpy(batch["token_labels"].astype(np.int64)).to(device)
            onehot = (labels[:, None] == classes).to(torch.float32)  # (B, C)
            with modeling._f32_products():
                agg += onehot.T @ f_x
            fired += (f_x > 0).sum(dim=0)
            top = torch.maximum(top, f_x.max(dim=0).values)
            seen += len(batch["act"])
            if seen >= cfg.max_agg_tokens:
                break
    finally:
        dl.shutdown()
    fired_np = fired.cpu().numpy().astype(np.float32)
    return agg.cpu().numpy(), fired_np / max(seen, 1), top.cpu().numpy()


def _propose(cfg: Config, agg, freq, rng) -> tuple[dict[int, list[int]], list[int]]:
    """Per-class top latents (sparsity-masked) + random controls."""
    sparse_ok = freq < cfg.sparsity_max
    per_class: dict[int, list[int]] = {}
    for c in range(1, cfg.n_classes):
        if not np.any(agg[c] > 0):
            continue
        order = np.argsort(-agg[c])
        picks = [int(s) for s in order if sparse_ok[s] and agg[c, s] > 0]
        if picks:
            per_class[c] = picks[: cfg.n_features]
    # Random controls must be DISJOINT from every class proposal, or a
    # colliding latent would appear twice in the slider list and its
    # replacement delta would be applied twice.
    proposed = {s for picks in per_class.values() for s in picks}
    pool = np.array([s for s in np.where(sparse_ok)[0] if s not in proposed])
    randoms = (
        [int(s) for s in rng.choice(pool, size=min(cfg.n_random, len(pool)), replace=False)]
        if len(pool)
        else []
    )
    return per_class, randoms


def _grid_shape(n_tokens: int) -> tuple[int, int]:
    """Closest-to-square (gw, gh) factorization of the token count."""
    best = (1, n_tokens)
    for w in range(1, int(np.sqrt(n_tokens)) + 1):
        if n_tokens % w == 0:
            best = (w, n_tokens // w)
    return best[1], best[0]


def _round(a: np.ndarray, digits: int = 4) -> list:
    return np.round(np.asarray(a, np.float64), digits).tolist()


def worker_fn(cfg: Config) -> pathlib.Path:
    device = device_of(cfg.device)
    sae_cfg, params, state = nn.load(cfg.sae_ckpt, device=device)
    head = training.load(cfg.head_ckpt)
    w_head = np.asarray(head["w"][cfg.probe_i], np.float32)  # (D, C)
    b_head = np.asarray(head["b"][cfg.probe_i], np.float32)  # (C,)

    md = Metadata.load(cfg.acts.shards)
    p = md.content_tokens_per_example
    rng = np.random.default_rng(cfg.seed)

    agg, freq, top = _aggregate_pass(cfg, sae_cfg, params, state)
    per_class, randoms = _propose(cfg, agg, freq, rng)
    candidates = sorted(
        {s for picks in per_class.values() for s in picks} | set(randoms)
    )
    if not candidates:
        raise RuntimeError(
            "No proposable latents: every latent is dense or inactive. "
            "Train the SAE longer or raise sparsity_max."
        )
    cand_pos = {s: i for i, s in enumerate(candidates)}

    # Per-candidate head direction: replacing latent s by value v shifts every
    # patch's logits by (v - f_x[s]) * (W_dec[s] @ W_head).
    w_dec = params["W_dec"].cpu().numpy()
    directions = w_dec[candidates] @ w_head  # (n_cand, C)

    # Embed the first n_examples examples.
    ds = IndexedDataset(
        IndexedConfig(shards=cfg.acts.shards, layer=cfg.acts.layer)
    )
    n_examples = min(cfg.n_examples, md.n_examples)
    cand_t = torch.tensor(candidates, dtype=torch.int64, device=device)
    examples = []
    for ex in range(n_examples):
        batch = ds.take(np.arange(ex * p, (ex + 1) * p))
        acts = batch["act"]
        with torch.no_grad():
            f_x = quantitative.encode_f(sae_cfg, params, state, quantitative.batch_acts(batch, device))
            fx_cand = f_x[:, cand_t].cpu().numpy()
        examples.append({
            "logits": _round(acts @ w_head + b_head),  # (P, C)
            "fx": _round(fx_cand),  # (P, n_cand)
            # The dataset already attaches aligned per-token labels; a second
            # hand-rolled labels.bin memmap would just duplicate the protocol.
            "labels": np.asarray(batch["token_label"]).astype(int).tolist(),
        })

    names = {i: f"class {i}" for i in range(cfg.n_classes)}
    if cfg.class_names and pathlib.Path(cfg.class_names).exists():
        import csv

        with open(cfg.class_names) as fd:
            for row in csv.reader(fd):
                if len(row) >= 2 and row[0].strip().isdigit():
                    names[int(row[0])] = row[1].strip()

    gw, gh = _grid_shape(p)
    payload = {
        "gw": gw,
        "gh": gh,
        "nClasses": cfg.n_classes,
        "nFeatures": cfg.n_features,
        "nDropdowns": cfg.n_dropdowns,
        "candidates": candidates,
        "maxObs": _round(top[candidates]),
        "directions": _round(directions),
        "perClass": {str(c): [cand_pos[s] for s in picks] for c, picks in per_class.items()},
        "randoms": [cand_pos[s] for s in randoms],
        "classNames": {str(c): names[c] for c in range(cfg.n_classes)},
        "examples": examples,
        "seed": cfg.seed,
    }
    html_doc = _HTML.replace("/*__PAYLOAD__*/", json.dumps(payload))

    out = pathlib.Path(cfg.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(html_doc)
    logger.info(
        "Wrote intervention app: %d examples, %d classes with proposals, "
        "%d candidate latents -> %s",
        n_examples, len(per_class), len(candidates), out,
    )
    return out


def cli(cfg: Config) -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s",
    )
    worker_fn(cfg)


_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>SAE semseg interventions</title>
<style>
body { font-family: system-ui, sans-serif; margin: 1.5rem; background: #fafafa; }
h1 { font-size: 1.2rem; }
.row { display: flex; gap: 1rem; flex-wrap: wrap; align-items: flex-start; }
.panel { text-align: center; }
.panel canvas { image-rendering: pixelated; border: 1px solid #ccc; width: 224px; height: 224px; }
.caption { font-size: .8rem; color: #444; margin-top: .25rem; }
.feature { background: #fff; border: 1px solid #ddd; border-radius: 6px; padding: .5rem; margin: .35rem 0; }
.feature .mini { display: flex; gap: .3rem; margin-top: .3rem; }
.feature canvas { image-rendering: pixelated; border: 1px solid #eee; width: 48px; height: 48px; }
.controls { margin: .75rem 0; display: flex; gap: .75rem; align-items: center; flex-wrap: wrap; }
select, input[type=number] { padding: .2rem; }
.cls-col { min-width: 300px; }
.legend { font-size: .75rem; display: flex; flex-wrap: wrap; gap: .4rem; margin: .5rem 0; }
.legend span { display: inline-flex; align-items: center; gap: .2rem; }
.swatch { width: 12px; height: 12px; display: inline-block; border: 1px solid #999; }
</style></head><body>
<h1>SAE latent interventions on semantic segmentation</h1>
<p>Pick classes; each proposes its top sparse latents. Sliders REPLACE the
latent's activation with <code>slider &times; max_obs</code> (0 = ablate); the
head re-predicts live. Random features are precision controls.</p>
<div class="controls">
  <button id="randomBtn">Random Example</button>
  <label>Example: <input id="exampleNum" type="number" min="1" step="1"></label>
  <label><input id="interp" type="checkbox"> interpolated (bilinear)</label>
</div>
<div class="row" id="dropdowns"></div>
<div class="row" id="features"></div>
<div class="row" id="panels">
  <div class="panel"><canvas id="cvTrue"></canvas><div class="caption">True labels</div></div>
  <div class="panel"><canvas id="cvPred"></canvas><div class="caption">Predicted</div></div>
  <div class="panel"><canvas id="cvMod"></canvas><div class="caption">Predicted after manipulation</div></div>
</div>
<div class="legend" id="legend"></div>
<script>
const D = /*__PAYLOAD__*/;
const P = D.gw * D.gh, C = D.nClasses;

// Deterministic 6-value RGB-cube palette, shuffled with a seeded PRNG
// (reference make_colors, seed 42 -> here seeded LCG for determinism).
function makeColors() {
  const vals = [0, 51, 102, 153, 204, 255], colors = [];
  for (const r of vals) for (const g of vals) for (const b of vals) colors.push([r, g, b]);
  let s = 42 >>> 0;
  const rand = () => (s = (1664525 * s + 1013904223) >>> 0) / 4294967296;
  for (let i = colors.length - 1; i > 0; i--) {
    const j = Math.floor(rand() * (i + 1));
    [colors[i], colors[j]] = [colors[j], colors[i]];
  }
  return colors;
}
const COLORS = makeColors();
const colorOf = c => (c === 0 ? [0, 0, 0] : COLORS[(c - 1) % COLORS.length]);

let exampleIdx = 0;
const activeClasses = [];   // class ids per dropdown
let featureRows = [];       // {cand, value} across dropdowns + randoms

function presentClasses() {
  const s = new Set();
  for (const ex of D.examples) for (const l of ex.labels) s.add(l);
  return [...s].filter(c => String(c) in D.perClass).sort((a, b) => a - b);
}

function proposeFeatures() {
  // Each candidate latent appears AT MOST ONCE (the same class picked in two
  // dropdowns, or a random control, must not double-apply its delta).
  featureRows = [];
  const seen = new Set();
  const push = (pos, cls) => {
    if (seen.has(pos)) return;
    seen.add(pos);
    featureRows.push({ cand: pos, value: 0, cls });
  };
  for (const c of activeClasses)
    for (const pos of (D.perClass[String(c)] || [])) push(pos, c);
  for (const pos of D.randoms) push(pos, null);
}

function modifiedLogits() {
  const ex = D.examples[exampleIdx];
  const out = new Float32Array(P * C);
  for (let p = 0; p < P; p++)
    for (let c = 0; c < C; c++) out[p * C + c] = ex.logits[p][c];
  for (const f of featureRows) {
    const v = f.value * D.maxObs[f.cand];        // unscaled slider value
    const dir = D.directions[f.cand];
    for (let p = 0; p < P; p++) {
      const delta = v - ex.fx[p][f.cand];
      for (let c = 0; c < C; c++) out[p * C + c] += delta * dir[c];
    }
  }
  return out;
}

function argmaxGrid(logits) {
  const g = new Uint8Array(P);
  for (let p = 0; p < P; p++) {
    let best = 0, bv = -Infinity;
    for (let c = 0; c < C; c++) { const v = logits[p * C + c]; if (v > bv) { bv = v; best = c; } }
    g[p] = best;
  }
  return g;
}

function drawGrid(canvas, grid) {
  canvas.width = D.gw; canvas.height = D.gh;
  const ctx = canvas.getContext("2d"), img = ctx.createImageData(D.gw, D.gh);
  for (let p = 0; p < grid.length; p++) {
    const [r, g, b] = colorOf(grid[p]);
    img.data.set([r, g, b, 255], p * 4);
  }
  ctx.putImageData(img, 0, 0);
}

// Bilinear interpolation of the logit grid at SxS, then argmax (reference
// make_interpolated_pred).
function drawInterp(canvas, logits, S) {
  canvas.width = S; canvas.height = S;
  const ctx = canvas.getContext("2d"), img = ctx.createImageData(S, S);
  for (let y = 0; y < S; y++) {
    const gy = (y + 0.5) / S * D.gh - 0.5, y0 = Math.max(0, Math.floor(gy)),
          y1 = Math.min(D.gh - 1, y0 + 1), wy = gy - y0;
    for (let x = 0; x < S; x++) {
      const gx = (x + 0.5) / S * D.gw - 0.5, x0 = Math.max(0, Math.floor(gx)),
            x1 = Math.min(D.gw - 1, x0 + 1), wx = gx - x0;
      let best = 0, bv = -Infinity;
      for (let c = 0; c < C; c++) {
        const v00 = logits[(y0 * D.gw + x0) * C + c], v01 = logits[(y0 * D.gw + x1) * C + c],
              v10 = logits[(y1 * D.gw + x0) * C + c], v11 = logits[(y1 * D.gw + x1) * C + c];
        const v = (1 - wy) * ((1 - wx) * v00 + wx * v01) + wy * ((1 - wx) * v10 + wx * v11);
        if (v > bv) { bv = v; best = c; }
      }
      const [r, g, b] = colorOf(best);
      img.data.set([r, g, b, 255], (y * S + x) * 4);
    }
  }
  ctx.putImageData(img, 0, 0);
}

function baseLogitsFlat() {
  const ex = D.examples[exampleIdx], out = new Float32Array(P * C);
  for (let p = 0; p < P; p++) for (let c = 0; c < C; c++) out[p * C + c] = ex.logits[p][c];
  return out;
}

function render() {
  const ex = D.examples[exampleIdx];
  drawGrid(document.getElementById("cvTrue"), Uint8Array.from(ex.labels));
  const base = baseLogitsFlat(), mod = modifiedLogits();
  const interp = document.getElementById("interp").checked;
  if (interp) {
    drawInterp(document.getElementById("cvPred"), base, 112);
    drawInterp(document.getElementById("cvMod"), mod, 112);
  } else {
    drawGrid(document.getElementById("cvPred"), argmaxGrid(base));
    drawGrid(document.getElementById("cvMod"), argmaxGrid(mod));
  }
  renderLegend(ex);
}

function renderLegend(ex) {
  const el = document.getElementById("legend");
  const present = [...new Set([...ex.labels, ...argmaxGrid(modifiedLogits())])].sort((a, b) => a - b);
  el.innerHTML = present.map(c => {
    const [r, g, b] = colorOf(c);
    return `<span><span class="swatch" style="background: rgb(${r},${g},${b})"></span>${D.classNames[String(c)] || c}</span>`;
  }).join("");
}

function renderFeatures() {
  const el = document.getElementById("features");
  el.innerHTML = "";
  featureRows.forEach((f, i) => {
    const latent = D.candidates[f.cand];
    const div = document.createElement("div");
    div.className = "feature";
    const who = f.cls === null ? "random control" : (D.classNames[String(f.cls)] || f.cls);
    div.innerHTML = `<div><strong>Latent ${latent}</strong> <small>(${who},
      max_obs ${D.maxObs[f.cand].toPrecision(3)})</small></div>
      <input type="range" min="-10" max="10" step="0.1" value="${f.value}" data-i="${i}">
      <span class="val">${f.value.toFixed(1)}</span>
      <div class="mini" title="top activating embedded examples"></div>`;
    const slider = div.querySelector("input");
    slider.addEventListener("input", e => {
      featureRows[i].value = parseFloat(e.target.value);
      div.querySelector(".val").textContent = featureRows[i].value.toFixed(1);
      render();
    });
    // Mini heatmaps: top-3 embedded examples by this latent's max activation.
    const ranked = D.examples.map((ex, j) => [Math.max(...ex.fx.map(r => r[f.cand])), j])
      .sort((a, b) => b[0] - a[0]).slice(0, 3);
    const mini = div.querySelector(".mini");
    for (const [mx, j] of ranked) {
      const cv = document.createElement("canvas");
      cv.width = D.gw; cv.height = D.gh;
      const ctx = cv.getContext("2d"), img = ctx.createImageData(D.gw, D.gh);
      for (let p = 0; p < P; p++) {
        const a = mx > 0 ? D.examples[j].fx[p][f.cand] / mx : 0;
        img.data.set([255, Math.round(255 * (1 - a)), 0, Math.round(255 * a)], p * 4);
      }
      ctx.putImageData(img, 0, 0);
      cv.title = `example ${j + 1}, max ${mx.toPrecision(3)}`;
      mini.appendChild(cv);
    }
    el.appendChild(div);
  });
}

function renderDropdowns() {
  const el = document.getElementById("dropdowns");
  el.innerHTML = "";
  const options = presentClasses();
  for (let d = 0; d < Math.min(D.nDropdowns, options.length); d++) {
    if (activeClasses[d] === undefined) activeClasses[d] = options[d % options.length];
    const sel = document.createElement("select");
    sel.className = "cls-col";
    for (const c of options) {
      const o = document.createElement("option");
      o.value = c; o.textContent = `Class ${d + 1}: ${D.classNames[String(c)] || c}`;
      if (c === activeClasses[d]) o.selected = true;
      sel.appendChild(o);
    }
    sel.addEventListener("change", e => {
      activeClasses[d] = parseInt(e.target.value);
      proposeFeatures(); renderFeatures(); render();
    });
    el.appendChild(sel);
  }
}

const num = document.getElementById("exampleNum");
num.max = D.examples.length; num.value = 1;
num.addEventListener("change", () => {
  const parsed = parseInt(num.value);
  if (Number.isNaN(parsed)) { num.value = exampleIdx + 1; return; }
  exampleIdx = Math.min(Math.max(parsed - 1, 0), D.examples.length - 1);
  render();
});
document.getElementById("randomBtn").addEventListener("click", () => {
  exampleIdx = Math.floor(Math.random() * D.examples.length);
  num.value = exampleIdx + 1;
  render();
});
document.getElementById("interp").addEventListener("change", render);

renderDropdowns();
proposeFeatures();
renderFeatures();
render();
</script></body></html>
"""
