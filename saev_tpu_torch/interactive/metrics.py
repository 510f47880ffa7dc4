"""Sweep metrics explorer: an interactive single-file HTML app over tracked runs
(the counterpart of saev_tpu/interactive/metrics.py: the same rows, flags and
HTML).

Capability mirror of reference `src/saev/interactive/metrics.py` (marimo wandb
sweep explorer, 1475 LoC) in an HTML form factor. Feature parity:

- Run loading from the local JSONL tracker (ParallelWandbRun's offline backend)
  AND the wandb API when available (`--wandb-entity/--wandb-project`), with a
  tag filter (reference make_df, metrics.py:567-700).
- Flattened config/summary table per run incl. `model_key` (friendly model
  names from shard metadata, reference get_model_key :711-744) and `data_key`
  (decoded base64-pickled dataset config, reference get_data_key :747-765).
- Pareto-frontier computation per (model, layer, data) group: sorted by L0,
  `is_pareto` = running-min MSE, LR-edge flags `is_lr_min`/`is_lr_max`
  (reference :656-696).
- Interactive app: per-(model, layer) pair toggles, show-non-frontier and
  annotate-ids switches, log-log pareto scatter with frontier lines, hover
  tooltips, red rings on LR-edge points (reference plot_layerwise :142-309),
  a sortable/filterable run table, copy-pareto-ids export (:948-952), and a
  per-run drill-down with training curves and the frequency/mean-value
  distribution scatter with range filters (reference plot_dist :471-520).

Usage:
    python -m saev_tpu_torch.interactive.metrics --tracker-dir .wandb/saev
    python -m saev_tpu_torch.interactive.metrics --wandb-entity me --wandb-project saev --tag sweep3
"""

import dataclasses
import json
import logging
import pathlib

logger = logging.getLogger("interactive.metrics")


@dataclasses.dataclass(frozen=True)
class Config:
    tracker_dir: pathlib.Path = pathlib.Path(".wandb/saev")
    """Directory of local-tracker runs (each <id>/metrics.jsonl + config.json)."""
    wandb_entity: str = ""
    """wandb entity; when set (with wandb_project), runs load from the API."""
    wandb_project: str = ""
    """wandb project for API loading."""
    tag: str = ""
    """Only include runs carrying this tag (empty = all runs)."""
    x_key: str = "eval/l0"
    """X axis metric (last logged value per run)."""
    y_key: str = "eval/normalized_mse"
    """Y axis metric."""
    curve_keys: tuple[str, ...] = ("loss/mse", "loss/l0")
    """Per-step metrics for the drill-down training curves."""
    max_curve_points: int = 200
    """Training curves downsample to at most this many points per run."""
    max_dist_latents: int = 4096
    """Freq/value scatter subsamples to at most this many latents per run."""
    out: pathlib.Path = pathlib.Path("metrics_report.html")
    """Output HTML file (self-contained)."""


# ---------------------------------------------------------------------------
# Run loading
# ---------------------------------------------------------------------------


def load_runs_local(tracker_dir: pathlib.Path, tag: str = "") -> list[dict]:
    """Load every run's config + metric history from the JSONL tracker."""
    runs = []
    root = pathlib.Path(tracker_dir)
    if not root.exists():
        return runs
    for run_dir in sorted(root.iterdir()):
        metrics_f = run_dir / "metrics.jsonl"
        if not metrics_f.exists():
            continue
        history = [
            json.loads(line) for line in metrics_f.read_text().splitlines() if line
        ]
        config, tags = {}, []
        cfg_f = run_dir / "config.json"
        if cfg_f.exists():
            raw = json.loads(cfg_f.read_text())
            config = raw.get("config") or {}
            tags = raw.get("tags") or []
        if tag and tag not in tags and config.get("tag") != tag:
            continue
        runs.append({"id": run_dir.name, "config": config, "history": history})
    return runs


def load_runs_wandb(entity: str, project: str, tag: str = "") -> list[dict]:
    """Load runs through the wandb API (reference metrics.py:590-596)."""
    import wandb

    path = f"{entity}/{project}"
    api = wandb.Api()
    runs = list(api.runs(path=path, filters={"config.tag": tag})) if tag else []
    if not runs:
        filters = {"tags": {"$in": [tag]}} if tag else None
        runs = list(api.runs(path=path, filters=filters))
    out = []
    for run in runs:
        history = [
            {"step": row.get("_step", i), **row}
            for i, row in enumerate(run.scan_history())
        ]
        out.append({"id": run.id, "config": dict(run.config), "history": history})
    return out


# ---------------------------------------------------------------------------
# Tabulation (reference make_df)
# ---------------------------------------------------------------------------

_MODEL_NAMES = {
    ("dinov2", "dinov2_vitb14_reg"): "DINOv2 ViT-B/14 (reg)",
    ("dinov2", "dinov2_vitl14_reg"): "DINOv2 ViT-L/14 (reg)",
    ("clip", "ViT-B-16/openai"): "CLIP ViT-B/16",
    ("clip", "hf-hub:imageomics/bioclip"): "BioCLIP ViT-B/16",
    ("clip", "hf-hub:imageomics/bioclip-2"): "BioCLIP 2 ViT-L/14",
    ("siglip", "hf-hub:timm/ViT-L-16-SigLIP2-256"): "SigLIP2 ViT-L/16",
}


def model_key(metadata: dict) -> str:
    """Friendly model name from shard metadata (reference get_model_key)."""
    family = next(
        (metadata[k] for k in ("family", "vit_family", "model_family") if k in metadata),
        "?",
    )
    ckpt = next(
        (metadata[k] for k in ("ckpt", "vit_ckpt", "model_ckpt") if k in metadata), "?"
    )
    if (family, ckpt) in _MODEL_NAMES:
        return _MODEL_NAMES[(family, ckpt)]
    if family == "dinov3":
        for size in ("s", "b", "l", "h", "7b"):
            if f"vit{size}" in str(ckpt):
                return f"DINOv3 ViT-{size.upper()}/16"
    return f"{family}/{ckpt}"


def data_key(metadata: dict) -> str | None:
    """Friendly dataset name from the base64-pickled config (reference
    get_data_key). Returns None when undecodable. Decoded with the protocol's
    restricted unpickler — run configs can come from a shared wandb project,
    and a plain pickle.loads on them would be arbitrary code execution."""
    from ..data import shards as shards_mod

    try:
        data_cfg = shards_mod.decode_dataset_cfg(metadata["data"])
    except Exception:
        return None
    name = type(data_cfg).__name__
    split = getattr(data_cfg, "split", None)
    root = str(getattr(data_cfg, "root", ""))
    if name == "Imagenet":
        return f"IN1K/{split}"
    if name == "ImgSegFolder" and "ADE" in root:
        return f"ADE20K/{split}"
    if split:
        return f"{name}/{split}"
    return name


def _is_scalar(v) -> bool:
    return v is None or isinstance(v, (bool, str, int, float))


def flatten_config(cfg: dict) -> dict:
    """Flatten nested config dicts to `config/...` scalar columns
    (reference metrics.py:617-640)."""
    row = {}
    cfg = dict(cfg)
    for key in ("train_data", "val_data", "sae", "objective"):
        nested = cfg.pop(key, {})
        if not isinstance(nested, dict):
            continue
        for k, v in nested.items():
            if _is_scalar(v):
                row[f"config/{key}/{k}"] = v
    for k, v in cfg.items():
        if _is_scalar(v):
            row[f"config/{k}"] = v
    return row


def last_value(history: list[dict], key: str):
    for entry in reversed(history):
        v = entry.get(key)
        if isinstance(v, (int, float)):
            return v
    return None


def build_rows(runs: list[dict], x_key: str, y_key: str) -> list[dict]:
    """One row per run: flattened config + summary + model/data keys + pareto
    and LR-edge flags per (model_key, layer, data_key) group."""
    rows = []
    for run in runs:
        cfg = run["config"] or {}
        row = {"id": run["id"], **flatten_config(cfg)}
        # Final value of every scalar metric.
        seen = set()
        for entry in reversed(run["history"]):
            for k, v in entry.items():
                if k not in seen and isinstance(v, (int, float)) and k != "step":
                    row[f"summary/{k}"] = v
                    seen.add(k)
        metadata = (cfg.get("train_data") or {}).get("metadata") or {}
        row["model_key"] = model_key(metadata) if metadata else "unknown"
        row["data_key"] = (data_key(metadata) or "unknown") if metadata else "unknown"
        row["layer"] = row.get("config/val_data/layer", row.get("config/train_data/layer"))
        if row.get(f"summary/{x_key}") is None or row.get(f"summary/{y_key}") is None:
            logger.info("Run %s missing %s/%s; skipping.", run["id"], x_key, y_key)
            continue
        rows.append(row)

    # Pareto + lr-edge flags per group (reference :656-696).
    groups: dict[tuple, list[dict]] = {}
    for row in rows:
        groups.setdefault(
            (row["model_key"], row["layer"], row["data_key"]), []
        ).append(row)
    for group in groups.values():
        lrs = [r.get("config/lr") for r in group if r.get("config/lr") is not None]
        lr_min, lr_max = (min(lrs), max(lrs)) if lrs else (None, None)
        best = float("inf")
        for r in sorted(group, key=lambda r: (r[f"summary/{x_key}"], r[f"summary/{y_key}"])):
            y = r[f"summary/{y_key}"]
            r["is_pareto"] = y <= best
            best = min(best, y)
            r["is_lr_min"] = r.get("config/lr") == lr_min and lr_min is not None
            r["is_lr_max"] = r.get("config/lr") == lr_max and lr_max is not None
    return rows


def _downsample(xs: list, n: int) -> list:
    if len(xs) <= n:
        return xs
    step = len(xs) / n
    out = [xs[int(i * step)] for i in range(n)]
    # Always keep the FINAL point: the drill-down annotates "final <value>"
    # from the last kept sample.
    out[-1] = xs[-1]
    return out


def build_drilldowns(runs: list[dict], cfg: Config) -> dict[str, dict]:
    """Per-run drill-down payloads: training curves + freq/value distribution
    (reference plot_dist inputs: load_freqs/load_mean_values, :771-805)."""
    out = {}
    for run in runs:
        curves = {}
        for key in cfg.curve_keys:
            pts = [
                [e.get("step", i), e[key]]
                for i, e in enumerate(run["history"])
                if isinstance(e.get(key), (int, float))
            ]
            if pts:
                curves[key] = _downsample(pts, cfg.max_curve_points)
        dist = None
        freqs = last_value_list(run["history"], "eval/freqs")
        values = last_value_list(run["history"], "eval/mean_values")
        if freqs and values and len(freqs) == len(values):
            idx = range(len(freqs))
            if len(freqs) > cfg.max_dist_latents:
                stride = len(freqs) / cfg.max_dist_latents
                idx = [int(i * stride) for i in range(cfg.max_dist_latents)]
            dist = {
                "freqs": [freqs[i] for i in idx],
                "values": [values[i] for i in idx],
                "d_sae": len(freqs),
            }
        out[run["id"]] = {"curves": curves, "dist": dist}
    return out


def last_value_list(history: list[dict], key: str) -> list | None:
    for entry in reversed(history):
        v = entry.get(key)
        if isinstance(v, list) and v and isinstance(v[0], (int, float)):
            return v
    return None


# ---------------------------------------------------------------------------
# HTML app
# ---------------------------------------------------------------------------

_APP_JS = r"""
'use strict';
const S = window.SAEV; // {rows, drill, xKey, yKey}
const fmt = (v) => (v == null ? '—' : (typeof v === 'number' ? (Math.abs(v) >= 1e4 || (Math.abs(v) < 1e-3 && v !== 0) ? v.toExponential(2) : +v.toPrecision(5)) : String(v)));
const $ = (id) => document.getElementById(id);
// Pareto flags are computed per (model, layer, data) in Python; the JS
// grouping must match or frontiers from different datasets zigzag into
// one polyline.
const groupKey = (r) => `${r.model_key} / layer ${r.layer} / ${r.data_key}`;

// --- state ---
const state = { pairs: {}, showRest: true, showIds: true, sortCol: null, sortAsc: true, textFilter: '', selected: null };
[...new Set(S.rows.map(groupKey))].sort().forEach((k, i) => { state.pairs[k] = i < 8; });

function filteredRows() {
  const t = state.textFilter.toLowerCase();
  return S.rows.filter((r) => state.pairs[groupKey(r)])
    .filter((r) => !t || JSON.stringify(r).toLowerCase().includes(t));
}

// --- pair toggles ---
function renderPairs() {
  const div = $('pairs');
  div.innerHTML = '';
  Object.keys(state.pairs).sort().forEach((k) => {
    const lbl = document.createElement('label');
    const cb = document.createElement('input');
    cb.type = 'checkbox'; cb.checked = state.pairs[k];
    cb.onchange = () => { state.pairs[k] = cb.checked; render(); };
    lbl.appendChild(cb); lbl.appendChild(document.createTextNode(' ' + k));
    div.appendChild(lbl);
  });
}

// --- pareto SVG (log-log) ---
function renderPareto() {
  const rows = filteredRows();
  const svg = $('pareto');
  const W = svg.clientWidth || 720, H = 420, ML = 64, MB = 44, MT = 12, MR = 12;
  const xs = rows.map((r) => r['summary/' + S.xKey]).filter((v) => v > 0);
  const ys = rows.map((r) => r['summary/' + S.yKey]).filter((v) => v > 0);
  svg.innerHTML = '';
  if (!xs.length) { svg.innerHTML = '<text x="40" y="40">No runs match the current filters.</text>'; return; }
  const lx = Math.log10, pad = 0.05;
  let x0 = lx(Math.min(...xs)), x1 = lx(Math.max(...xs)), y0 = lx(Math.min(...ys)), y1 = lx(Math.max(...ys));
  if (x0 === x1) { x0 -= 0.5; x1 += 0.5; } if (y0 === y1) { y0 -= 0.5; y1 += 0.5; }
  x0 -= (x1 - x0) * pad; x1 += (x1 - x0) * pad; y0 -= (y1 - y0) * pad; y1 += (y1 - y0) * pad;
  const px = (v) => ML + (lx(v) - x0) / (x1 - x0) * (W - ML - MR);
  const py = (v) => H - MB - (lx(v) - y0) / (y1 - y0) * (H - MB - MT);
  const NS = 'http://www.w3.org/2000/svg';
  const el = (tag, attrs, parent) => { const e = document.createElementNS(NS, tag); for (const k in attrs) e.setAttribute(k, attrs[k]); (parent || svg).appendChild(e); return e; };
  // axes + gridlines at decades
  for (let d = Math.ceil(x0); d <= Math.floor(x1); d++) {
    const x = ML + (d - x0) / (x1 - x0) * (W - ML - MR);
    el('line', { x1: x, y1: MT, x2: x, y2: H - MB, stroke: '#eee' });
    el('text', { x, y: H - MB + 16, 'text-anchor': 'middle', 'font-size': 11 }).textContent = '1e' + d;
  }
  for (let d = Math.ceil(y0); d <= Math.floor(y1); d++) {
    const y = H - MB - (d - y0) / (y1 - y0) * (H - MB - MT);
    el('line', { x1: ML, y1: y, x2: W - MR, y2: y, stroke: '#eee' });
    el('text', { x: ML - 6, y: y + 4, 'text-anchor': 'end', 'font-size': 11 }).textContent = '1e' + d;
  }
  el('text', { x: (W + ML) / 2, y: H - 6, 'text-anchor': 'middle', 'font-size': 12 }).textContent = S.xKey + ' (lower is better)';
  el('text', { x: 14, y: (H - MB) / 2, 'font-size': 12, transform: `rotate(-90 14 ${(H - MB) / 2})`, 'text-anchor': 'middle' }).textContent = S.yKey + ' (lower is better)';
  const palette = ['#1b9e77', '#d95f02', '#7570b3', '#e7298a', '#66a61e', '#e6ab02', '#a6761d', '#666666'];
  const groups = {};
  rows.forEach((r) => { (groups[groupKey(r)] = groups[groupKey(r)] || []).push(r); });
  Object.keys(groups).sort().forEach((g, gi) => {
    const color = palette[gi % palette.length];
    const pareto = groups[g].filter((r) => r.is_pareto).sort((a, b) => a['summary/' + S.xKey] - b['summary/' + S.xKey]);
    if (pareto.length > 1) {
      el('polyline', { points: pareto.map((r) => `${px(r['summary/' + S.xKey])},${py(r['summary/' + S.yKey])}`).join(' '), fill: 'none', stroke: color, 'stroke-width': 1.5, opacity: 0.8 });
    }
    groups[g].forEach((r) => {
      if (!state.showRest && !r.is_pareto) return;
      const x = px(r['summary/' + S.xKey]), y = py(r['summary/' + S.yKey]);
      if (r.is_pareto && (r.is_lr_min || r.is_lr_max)) {
        el('circle', { cx: x, cy: y, r: 8, fill: 'none', stroke: '#d62728', 'stroke-width': 1.4 });
      }
      const c = el('circle', { cx: x, cy: y, r: r.is_pareto ? 4.5 : 3, fill: color, opacity: r.is_pareto ? 0.95 : 0.4, cursor: 'pointer', 'data-id': r.id });
      c.addEventListener('mousemove', (ev) => showTip(ev, r));
      c.addEventListener('mouseleave', hideTip);
      c.addEventListener('click', () => { state.selected = r.id; render(); });
      if (state.showIds && r.is_pareto) {
        const edges = [r.is_lr_min ? 'LR min' : '', r.is_lr_max ? 'LR max' : ''].filter(Boolean).join(', ');
        const t = el('text', { x: x + 5, y: y - 5, 'font-size': 9, fill: edges ? '#d62728' : '#333' });
        t.textContent = edges ? `${r.id} (${edges})` : r.id;
      }
    });
    const ly = MT + 14 + gi * 14;
    el('circle', { cx: W - MR - 150, cy: ly - 4, r: 4, fill: color });
    el('text', { x: W - MR - 142, y: ly, 'font-size': 11 }).textContent = g;
  });
}

function showTip(ev, r) {
  const tip = $('tip');
  tip.style.display = 'block';
  tip.style.left = (ev.pageX + 12) + 'px';
  tip.style.top = (ev.pageY + 12) + 'px';
  tip.innerHTML = `<b>${r.id}</b><br>${S.xKey}: ${fmt(r['summary/' + S.xKey])}<br>${S.yKey}: ${fmt(r['summary/' + S.yKey])}<br>lr: ${fmt(r['config/lr'])}<br>λ: ${fmt(r['config/objective/sparsity_coeff'])}<br>pareto: ${r.is_pareto}`;
}
function hideTip() { $('tip').style.display = 'none'; }

// --- run table ---
const COLS = ['id', 'model_key', 'layer', 'data_key', 'config/lr', 'config/objective/sparsity_coeff', 'config/sae/d_sae', 'is_pareto'];
function renderTable() {
  const rows = filteredRows().slice();
  const cols = COLS.concat(['summary/' + S.xKey, 'summary/' + S.yKey]);
  if (state.sortCol) rows.sort((a, b) => { const va = a[state.sortCol], vb = b[state.sortCol]; return (va > vb ? 1 : va < vb ? -1 : 0) * (state.sortAsc ? 1 : -1); });
  const head = cols.map((c) => `<th data-col="${c}">${c.replace('summary/', '').replace('config/', '')}${state.sortCol === c ? (state.sortAsc ? ' ▲' : ' ▼') : ''}</th>`).join('');
  const body = rows.map((r) => `<tr class="${r.id === state.selected ? 'sel' : ''}${r.is_pareto ? ' pareto' : ''}" data-id="${r.id}">` + cols.map((c) => `<td>${fmt(r[c])}</td>`).join('') + '</tr>').join('');
  $('runs').innerHTML = `<tr>${head}</tr>${body}`;
  $('runs').querySelectorAll('th').forEach((th) => th.onclick = () => { const c = th.dataset.col; if (state.sortCol === c) state.sortAsc = !state.sortAsc; else { state.sortCol = c; state.sortAsc = true; } render(); });
  $('runs').querySelectorAll('tr[data-id]').forEach((tr) => tr.onclick = () => { state.selected = tr.dataset.id; render(); });
  $('count').textContent = `${rows.length} runs (${rows.filter((r) => r.is_pareto).length} on frontier)`;
}

// --- drill-down ---
function lineSVG(pts, w, h, label) {
  if (!pts || !pts.length) return '';
  const xs = pts.map((p) => p[0]), ys = pts.map((p) => p[1]);
  const x0 = Math.min(...xs), x1 = Math.max(...xs) || 1, y0 = Math.min(...ys), y1 = Math.max(...ys) || 1;
  const P = pts.map((p) => `${8 + (p[0] - x0) / (x1 - x0 || 1) * (w - 16)},${h - 18 - (p[1] - y0) / (y1 - y0 || 1) * (h - 30)}`).join(' ');
  return `<svg width="${w}" height="${h}"><polyline points="${P}" fill="none" stroke="#1b9e77" stroke-width="1.4"/><text x="8" y="12" font-size="11">${label} (final ${fmt(ys[ys.length - 1])})</text></svg>`;
}
function renderDrill() {
  const div = $('drill');
  if (!state.selected) { div.innerHTML = '<p>Click a point or row to inspect a run.</p>'; return; }
  const r = S.rows.find((r) => r.id === state.selected);
  if (!r) { state.selected = null; div.innerHTML = ''; return; }
  const d = S.drill[state.selected] || {};
  let html = `<h3>Run ${state.selected}</h3>`;
  html += Object.entries(d.curves || {}).map(([k, pts]) => lineSVG(pts, 320, 130, k)).join(' ');
  if (d.dist) {
    html += `<div id="distwrap"><h4>Latent frequency vs mean value (${d.dist.d_sae} latents, ${d.dist.freqs.length} shown)</h4>
      <label>log10 freq ≥ <input id="fmin" type="number" step="0.5" value="-6"></label>
      <label>≤ <input id="fmax" type="number" step="0.5" value="0"></label>
      <label>log10 value ≥ <input id="vmin" type="number" step="0.5" value="-3"></label>
      <label>≤ <input id="vmax" type="number" step="0.5" value="2"></label>
      <div id="distcounts"></div><svg id="dist" width="420" height="300"></svg></div>`;
  }
  html += '<h4>Config</h4><table class="cfg">' + Object.keys(r).filter((k) => k.startsWith('config/')).sort().map((k) => `<tr><td>${k}</td><td>${fmt(r[k])}</td></tr>`).join('') + '</table>';
  div.innerHTML = html;
  if (d.dist) {
    const redraw = () => renderDist(d.dist);
    ['fmin', 'fmax', 'vmin', 'vmax'].forEach((id) => $(id).oninput = redraw);
    redraw();
  }
}
function renderDist(dist) {
  const svg = $('dist'); svg.innerHTML = '';
  const W = 420, H = 300, ML = 46, MB = 34;
  const lf = dist.freqs.map((f) => Math.log10(f + 1e-9)), lv = dist.values.map((v) => Math.log10(v + 1e-9));
  const x0 = Math.min(...lf), x1 = Math.max(...lf) || 1, y0 = Math.min(...lv), y1 = Math.max(...lv) || 1;
  const px = (v) => ML + (v - x0) / (x1 - x0 || 1) * (W - ML - 8), py = (v) => H - MB - (v - y0) / (y1 - y0 || 1) * (H - MB - 8);
  const fmin = +$('fmin').value, fmax = +$('fmax').value, vmin = +$('vmin').value, vmax = +$('vmax').value;
  let shown = 0;
  const NS = 'http://www.w3.org/2000/svg';
  lf.forEach((f, i) => {
    const ok = f >= fmin && f <= fmax && lv[i] >= vmin && lv[i] <= vmax;
    if (ok) shown++;
    const c = document.createElementNS(NS, 'circle');
    c.setAttribute('cx', px(f)); c.setAttribute('cy', py(lv[i])); c.setAttribute('r', 1.6);
    c.setAttribute('fill', ok ? '#1f77b4' : '#d62728'); c.setAttribute('opacity', 0.25);
    svg.appendChild(c);
  });
  [[fmin, 'v'], [fmax, 'v'], [vmin, 'h'], [vmax, 'h']].forEach(([v, o]) => {
    const l = document.createElementNS(NS, 'line');
    if (o === 'v') { l.setAttribute('x1', px(v)); l.setAttribute('x2', px(v)); l.setAttribute('y1', 8); l.setAttribute('y2', H - MB); }
    else { l.setAttribute('y1', py(v)); l.setAttribute('y2', py(v)); l.setAttribute('x1', ML); l.setAttribute('x2', W - 8); }
    l.setAttribute('stroke', '#d62728'); l.setAttribute('stroke-width', 0.7);
    svg.appendChild(l);
  });
  const tx = document.createElementNS(NS, 'text');
  tx.setAttribute('x', ML); tx.setAttribute('y', H - 8); tx.setAttribute('font-size', 11);
  tx.textContent = 'log10 feature frequency'; svg.appendChild(tx);
  $('distcounts').textContent = `Shown ${shown} · Filtered ${lf.length - shown}`;
}

// --- export ---
function copyParetoIds() {
  const ids = filteredRows().filter((r) => r.is_pareto).map((r) => r.id);
  navigator.clipboard && navigator.clipboard.writeText(ids.join(' '));
  $('copied').textContent = ids.length + ' ids: ' + ids.join(' ');
}

function render() { renderPairs(); renderPareto(); renderTable(); renderDrill(); }
window.addEventListener('load', () => {
  $('showRest').onchange = (e) => { state.showRest = e.target.checked; render(); };
  $('showIds').onchange = (e) => { state.showIds = e.target.checked; render(); };
  $('filter').oninput = (e) => { state.textFilter = e.target.value; render(); };
  $('copyPareto').onclick = copyParetoIds;
  render();
});
"""

_CSS = """
body { font-family: system-ui, sans-serif; margin: 1rem; color: #222; }
#pairs { display: grid; grid-template-columns: repeat(3, minmax(180px, 1fr)); gap: 2px 14px; margin: 8px 0; }
#pairs label { font-size: 13px; white-space: nowrap; }
#controls { margin: 6px 0; display: flex; gap: 18px; align-items: center; flex-wrap: wrap; }
#tip { position: absolute; display: none; background: #fff; border: 1px solid #999; padding: 6px 8px; font-size: 12px; pointer-events: none; box-shadow: 2px 2px 6px rgba(0,0,0,.15); }
table#runs { border-collapse: collapse; font-size: 12px; margin-top: 8px; }
table#runs th { cursor: pointer; background: #f3f3f3; position: sticky; top: 0; }
table#runs td, table#runs th { border: 1px solid #ddd; padding: 2px 7px; font-variant-numeric: tabular-nums; }
table#runs tr.pareto td { background: #f4fbf7; }
table#runs tr.sel td { background: #fff3d6; }
table.cfg td { border-bottom: 1px solid #eee; padding: 1px 8px; font-size: 12px; }
#layout { display: grid; grid-template-columns: 1fr 460px; gap: 20px; align-items: start; }
#drill { border-left: 1px solid #ddd; padding-left: 16px; }
svg#pareto { width: 100%; height: 420px; }
#copied { font-size: 11px; color: #555; word-break: break-all; }
"""


def render_html(rows: list[dict], drill: dict, cfg: Config) -> str:
    payload = {
        "rows": rows,
        "drill": drill,
        "xKey": cfg.x_key,
        "yKey": cfg.y_key,
    }
    return f"""<!doctype html><meta charset="utf-8"><title>SAE metrics explorer</title>
<style>{_CSS}</style>
<h1>SAE Metrics Explorer</h1>
<p>{len(rows)} runs{f" (tag: {cfg.tag})" if cfg.tag else ""}. Toggle (model, layer) pairs,
inspect the L0/MSE pareto frontier, click any point or row for per-run drill-down.</p>
<div id="pairs"></div>
<div id="controls">
  <label><input type="checkbox" id="showRest" checked> Show non-frontier points</label>
  <label><input type="checkbox" id="showIds" checked> Annotate Pareto points</label>
  <label>Filter: <input id="filter" placeholder="substring match"></label>
  <button id="copyPareto">Copy Pareto run ids</button>
  <span id="count"></span>
</div>
<div id="copied"></div>
<div id="layout">
  <div>
    <svg id="pareto" xmlns="http://www.w3.org/2000/svg"></svg>
    <table id="runs"></table>
  </div>
  <div id="drill"></div>
</div>
<div id="tip"></div>
<script>window.SAEV = {json.dumps(payload)};</script>
<script>{_APP_JS}</script>
"""


def generate(cfg: Config) -> pathlib.Path:
    if cfg.wandb_entity and cfg.wandb_project:
        runs = load_runs_wandb(cfg.wandb_entity, cfg.wandb_project, cfg.tag)
    else:
        runs = load_runs_local(cfg.tracker_dir, cfg.tag)
    assert runs, (
        f"No runs found (tracker_dir={cfg.tracker_dir}, "
        f"wandb={cfg.wandb_entity}/{cfg.wandb_project}, tag={cfg.tag!r})."
    )
    rows = build_rows(runs, cfg.x_key, cfg.y_key)
    assert rows, f"No runs carry both {cfg.x_key} and {cfg.y_key}."
    drill = build_drilldowns(
        [r for r in runs if any(row["id"] == r["id"] for row in rows)], cfg
    )
    cfg.out.parent.mkdir(parents=True, exist_ok=True)
    cfg.out.write_text(render_html(rows, drill, cfg))
    logger.info("Wrote explorer for %d runs to '%s'.", len(rows), cfg.out)
    return cfg.out


def cli(cfg: Config) -> None:
    logging.basicConfig(level=logging.INFO)
    generate(cfg)


if __name__ == "__main__":
    from ..utils import cli as cli_mod

    cli_mod.run({"metrics": cli})
