"""Feature browser: an interactive single-file HTML app over precomputed visuals
(the counterpart of saev_tpu/interactive/features.py: the same payload and
HTML).

Capability mirror of reference `src/saev/interactive/features.py` (marimo
notebook, 686 LoC) in an HTML form factor. Feature parity:

- Checkpoint dropdown over multiple runs' visuals dirs (reference
  make_ckpt_dropdown, features.py:26-35).
- Sort by frequency / value / latent id buttons (:63-79).
- Neuron navigation: prev/next buttons + slider, per-latent detail with
  log10(freq) / log10(value) info line (:122-186).
- Top-k activating image grid per latent with a columns slider (:187-275).
- Log-frequency histogram over all latents (plot_hist, :287-301).
- Frequency/value scatter with range sliders that FILTER the browsable latent
  list (plot_dist + sparsity/value sliders, :314-392).

Usage:
    python -m saev_tpu_torch.interactive.features --runs runs/<id> [runs/<id2> ...] --shards <dir>
"""

import base64
import dataclasses
import html
import json
import logging
import pathlib

logger = logging.getLogger("interactive.features")


@dataclasses.dataclass(frozen=True)
class Config:
    runs: tuple[pathlib.Path, ...] = ()
    """Run directories (each becomes a checkpoint in the dropdown)."""
    run: pathlib.Path | None = None
    """Single run directory (legacy alias for --runs with one entry)."""
    shards: pathlib.Path = pathlib.Path("./shards/abcdef01")
    """Shards dir whose inference artifacts to browse."""
    n_features: int = 200
    """Max features to include per run."""
    max_imgs_per_feature: int = 16
    """Images per feature."""
    sort_by: str = "log10_freq"
    """var.parquet column that ranks which n_features latents are KEPT
    (the in-app sort buttons then reorder within that set)."""
    descending: bool = True
    """Keep the highest (True) or lowest values of sort_by."""
    embed_images: bool = True
    """Inline images as base64 (single self-contained file)."""
    out: pathlib.Path | None = None
    """Output HTML path (defaults to <first run inference dir>/features.html)."""


def _img_src(fpath: pathlib.Path, embed: bool, base: pathlib.Path) -> str:
    if embed:
        data = base64.b64encode(fpath.read_bytes()).decode()
        return f"data:image/png;base64,{data}"
    # Browsers resolve srcs against the HTML file's directory, not the CLI's
    # cwd — paths must be relative to where the page lands.
    import os

    return os.path.relpath(fpath, base)


def load_ckpt(
    run_dir: pathlib.Path, shards_name: str, cfg: Config, base: pathlib.Path
) -> dict:
    """One run's latents: [{f, lf, lv, imgs}] from var.parquet + images/."""
    import pandas as pd

    from .. import disk

    run = disk.Run(run_dir)
    art = run.inference / shards_name
    var = pd.read_parquet(art / "var.parquet")
    img_root = art / "images"
    assert img_root.exists(), f"No images at {img_root}; run tdiscovery.visuals first."

    have_imgs = {int(p.name) for p in img_root.iterdir() if p.name.isdigit()}
    # Sort BEFORE truncating: var.parquet is ordered by latent id, so a bare
    # .head() would keep the lowest-id latents instead of the top-n by
    # frequency/value (reference features.py sorts then pages).
    var = (
        var[var["feature"].isin(have_imgs)]
        .sort_values(cfg.sort_by, ascending=not cfg.descending)
        .head(cfg.n_features)
    )

    latents = []
    for _, row in var.iterrows():
        f = int(row["feature"])
        # Visuals dirs write 4 variants per example ({j}_img/{j}_sae_img/
        # {j}_seg/{j}_sae_seg); the gallery wants the HIGHLIGHTED image per
        # example, in example order, falling back to any pngs for older dirs.
        feature_dir = img_root / str(f)
        imgs = sorted(
            feature_dir.glob("*_sae_img.png"),
            key=lambda p: int(p.name.split("_")[0]),
        )
        if not imgs:
            imgs = sorted(feature_dir.glob("*.png"))
        imgs = imgs[: cfg.max_imgs_per_feature]
        latents.append({
            "f": f,
            "lf": round(float(row["log10_freq"]), 4),
            "lv": round(float(row["log10_value"]), 4),
            "imgs": [_img_src(p, cfg.embed_images, base) for p in imgs],
        })
    return {"id": run.run_id, "latents": latents}


_APP_JS = r"""
'use strict';
const S = window.SAEV; // {ckpts: [{id, latents:[{f,lf,lv,imgs}]}]}
const $ = (id) => document.getElementById(id);
const state = { ckpt: 0, sort: 'lf', desc: true, i: 0, cols: 4, fmin: -8, fmax: 0, vmin: -3, vmax: 2 };

function latents() {
  const all = S.ckpts[state.ckpt].latents;
  const vis = all.filter((n) => n.lf >= state.fmin && n.lf <= state.fmax && n.lv >= state.vmin && n.lv <= state.vmax);
  vis.sort((a, b) => (a[state.sort] - b[state.sort]) * (state.desc ? -1 : 1));
  return vis;
}

function renderHist() {
  const svg = $('hist'); svg.innerHTML = '';
  const all = S.ckpts[state.ckpt].latents.map((n) => n.lf);
  if (!all.length) return;
  const lo = Math.min(...all), hi = Math.max(...all), nb = 30;
  const bins = new Array(nb).fill(0);
  all.forEach((v) => bins[Math.min(nb - 1, Math.floor((v - lo) / ((hi - lo) || 1) * nb))]++);
  const W = 420, H = 140, mx = Math.max(...bins);
  const NS = 'http://www.w3.org/2000/svg';
  bins.forEach((c, i) => {
    const r = document.createElementNS(NS, 'rect');
    const bw = (W - 40) / nb;
    r.setAttribute('x', 34 + i * bw); r.setAttribute('width', bw - 1);
    const h = c / (mx || 1) * (H - 30);
    r.setAttribute('y', H - 18 - h); r.setAttribute('height', h);
    r.setAttribute('fill', '#1b9e77');
    svg.appendChild(r);
  });
  const t = document.createElementNS(NS, 'text');
  t.setAttribute('x', 34); t.setAttribute('y', 12); t.setAttribute('font-size', 11);
  t.textContent = `log10 frequency histogram [${lo.toFixed(2)}, ${hi.toFixed(2)}]`;
  svg.appendChild(t);
}

function renderScatter() {
  const svg = $('scatter'); svg.innerHTML = '';
  const all = S.ckpts[state.ckpt].latents;
  const W = 420, H = 260, ML = 40, MB = 28;
  const xs = all.map((n) => n.lf), ys = all.map((n) => n.lv);
  const x0 = Math.min(...xs), x1 = Math.max(...xs) || 1, y0 = Math.min(...ys), y1 = Math.max(...ys) || 1;
  const px = (v) => ML + (v - x0) / ((x1 - x0) || 1) * (W - ML - 8);
  const py = (v) => H - MB - (v - y0) / ((y1 - y0) || 1) * (H - MB - 10);
  const NS = 'http://www.w3.org/2000/svg';
  let shown = 0;
  all.forEach((n) => {
    const ok = n.lf >= state.fmin && n.lf <= state.fmax && n.lv >= state.vmin && n.lv <= state.vmax;
    if (ok) shown++;
    const c = document.createElementNS(NS, 'circle');
    c.setAttribute('cx', px(n.lf)); c.setAttribute('cy', py(n.lv)); c.setAttribute('r', 2);
    c.setAttribute('fill', ok ? '#1f77b4' : '#d62728'); c.setAttribute('opacity', 0.35);
    svg.appendChild(c);
  });
  [[state.fmin, 'v'], [state.fmax, 'v'], [state.vmin, 'h'], [state.vmax, 'h']].forEach(([v, o]) => {
    const l = document.createElementNS(NS, 'line');
    if (o === 'v') { l.setAttribute('x1', px(v)); l.setAttribute('x2', px(v)); l.setAttribute('y1', 8); l.setAttribute('y2', H - MB); }
    else { l.setAttribute('y1', py(v)); l.setAttribute('y2', py(v)); l.setAttribute('x1', ML); l.setAttribute('x2', W - 8); }
    l.setAttribute('stroke', '#d62728'); l.setAttribute('stroke-width', 0.7);
    svg.appendChild(l);
  });
  $('scattercounts').textContent = `Shown ${shown} · Filtered ${all.length - shown} (freq vs mean value, log10)`;
}

function renderDetail() {
  const vis = latents();
  if (!vis.length) { $('detail').innerHTML = '<p>No latents in the selected ranges.</p>'; $('gallery').innerHTML = ''; return; }
  state.i = Math.max(0, Math.min(state.i, vis.length - 1));
  const n = vis[state.i];
  $('slider').max = vis.length - 1; $('slider').value = state.i;
  $('detail').innerHTML = `<b>Latent ${n.f}</b> — log10(freq) = ${n.lf.toFixed(2)}, log10(value) = ${n.lv.toFixed(2)} · ${state.i + 1}/${vis.length}`;
  $('gallery').style.gridTemplateColumns = `repeat(${state.cols}, 1fr)`;
  $('gallery').innerHTML = n.imgs.map((src) => `<img src="${src}" loading="lazy">`).join('');
}

function renderList() {
  const vis = latents();
  $('latlist').innerHTML = vis.slice(0, 400).map((n, i) =>
    `<tr class="${i === state.i ? 'sel' : ''}" data-i="${i}"><td>#${n.f}</td><td>${n.lf.toFixed(2)}</td><td>${n.lv.toFixed(2)}</td><td class="thumbs">${n.imgs.slice(0, 4).map((s) => `<img src="${s}">`).join('')}</td></tr>`
  ).join('');
  $('latlist').querySelectorAll('tr').forEach((tr) => tr.onclick = () => { state.i = +tr.dataset.i; render(); });
}

function render() { renderHist(); renderScatter(); renderDetail(); renderList(); }

window.addEventListener('load', () => {
  const dd = $('ckpt');
  S.ckpts.forEach((c, i) => { const o = document.createElement('option'); o.value = i; o.textContent = c.id; dd.appendChild(o); });
  dd.onchange = () => { state.ckpt = +dd.value; state.i = 0; render(); };
  document.querySelectorAll('[data-sort]').forEach((b) => b.onclick = () => {
    const k = b.dataset.sort;
    if (state.sort === k) state.desc = !state.desc; else { state.sort = k; state.desc = k !== 'f'; }
    state.i = 0; render();
  });
  $('prev').onclick = () => { state.i--; render(); };
  $('next').onclick = () => { state.i++; render(); };
  $('slider').oninput = (e) => { state.i = +e.target.value; render(); };
  $('cols').oninput = (e) => { state.cols = +e.target.value; render(); };
  [['fmin', 'fmin'], ['fmax', 'fmax'], ['vmin', 'vmin'], ['vmax', 'vmax']].forEach(([id, k]) =>
    $(id).oninput = (e) => { state[k] = +e.target.value; state.i = 0; render(); });
  render();
});
"""

_CSS = """
body { font-family: system-ui, sans-serif; margin: 1rem; color: #222; }
#bar { display: flex; gap: 14px; align-items: center; flex-wrap: wrap; margin-bottom: 10px; }
#bar button { cursor: pointer; }
#layout { display: grid; grid-template-columns: 440px 1fr; gap: 24px; align-items: start; }
#gallery { display: grid; gap: 4px; margin-top: 8px; }
#gallery img { width: 100%; image-rendering: pixelated; }
#latlist { border-collapse: collapse; font-size: 12px; margin-top: 10px; }
#latlist td { border-bottom: 1px solid #eee; padding: 2px 8px; cursor: pointer; }
#latlist tr.sel td { background: #fff3d6; }
#latlist td.thumbs img { height: 32px; margin-right: 2px; image-rendering: pixelated; }
#ranges label { font-size: 12px; margin-right: 10px; }
#ranges input { width: 60px; }
#scattercounts { font-size: 12px; color: #555; }
"""


def generate(cfg: Config) -> pathlib.Path:
    from .. import disk

    run_dirs = list(cfg.runs) or ([cfg.run] if cfg.run else [])
    assert run_dirs, "Pass at least one run via --runs or --run."
    out = cfg.out
    if out is None:
        run = disk.Run(run_dirs[0])
        out = run.inference / cfg.shards.name / "features.html"
    ckpts = [
        load_ckpt(pathlib.Path(r), cfg.shards.name, cfg, out.parent)
        for r in run_dirs
    ]

    payload = {"ckpts": ckpts}
    doc = f"""<!doctype html><meta charset="utf-8">
<title>saev features — {html.escape(ckpts[0]["id"])}</title>
<style>{_CSS}</style>
<h1>Latent feature browser</h1>
<div id="bar">
  <label>Checkpoint: <select id="ckpt"></select></label>
  <button data-sort="lf">Sort by frequency</button>
  <button data-sort="lv">Sort by value</button>
  <button data-sort="f">Sort by latent</button>
  <button id="prev">&larr; prev</button>
  <button id="next">next &rarr;</button>
  <label>Latent <input id="slider" type="range" min="0" max="0" value="0"></label>
  <label>Columns <input id="cols" type="range" min="1" max="8" value="4"></label>
</div>
<div id="ranges">
  <label>log10 freq ≥ <input id="fmin" type="number" step="0.5" value="-8"></label>
  <label>≤ <input id="fmax" type="number" step="0.5" value="0"></label>
  <label>log10 value ≥ <input id="vmin" type="number" step="0.5" value="-3"></label>
  <label>≤ <input id="vmax" type="number" step="0.5" value="2"></label>
  <span id="scattercounts"></span>
</div>
<div id="layout">
  <div>
    <svg id="hist" width="420" height="140"></svg>
    <svg id="scatter" width="420" height="260"></svg>
    <table id="latlist"></table>
  </div>
  <div>
    <div id="detail"></div>
    <div id="gallery"></div>
  </div>
</div>
<script>window.SAEV = {json.dumps(payload)};</script>
<script>{_APP_JS}</script>
"""

    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(doc)
    n = sum(len(c["latents"]) for c in ckpts)
    logger.info("Wrote %d latents (%d ckpts) to '%s'.", n, len(ckpts), out)
    return out


def cli(cfg: Config) -> None:
    logging.basicConfig(level=logging.INFO)
    generate(cfg)


if __name__ == "__main__":
    from ..utils import cli as cli_mod

    cli_mod.run({"features": cli})
