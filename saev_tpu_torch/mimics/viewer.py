"""Cambridge Mimicry viewer: one self-contained HTML page over rendered strips
(counterpart of contrib/mimics/scripts/viewer.py; reference
exps/001-heliconius/viewer.py, a 600-line marimo app, in the repo's
single-file-HTML form factor). Capability map: run picker, task filter,
feature order by AUROC or consistency, prev/next feature navigation, strip
selector (class side), columns slider, image gallery. Data comes from
`render`'s index.json (+ optional mimic_consistency.json); images are
base64-inlined so the page is portable. `build_scores` is the cross-run
mimic_scores.json browser. Host-only.

    python -m saev_tpu_torch.mimics viewer --runs runs/<id> [--runs runs/<id2>] --shards <dir> --out viewer.html
"""

import base64
import dataclasses
import json
import logging
import pathlib

from .. import disk

logger = logging.getLogger("mimics.viewer")


@dataclasses.dataclass(frozen=True)
class Config:
    runs: tuple[pathlib.Path, ...] = ()
    shards: pathlib.Path = pathlib.Path("./shards/abcdef01")
    task_contains: str = ""
    """Only include tasks whose name contains this substring."""
    out: pathlib.Path = pathlib.Path("./mimics_viewer.html")


def _b64(fpath: pathlib.Path) -> str:
    return "data:image/png;base64," + base64.b64encode(fpath.read_bytes()).decode()


def load_payload(cfg: Config) -> dict:
    runs_payload = {}
    for run_dir in cfg.runs:
        run = disk.Run(run_dir)
        art = run.inference / pathlib.Path(cfg.shards).name
        mim_root = art / "mimics"
        if not mim_root.is_dir():
            logger.warning("No rendered mimics under %s; skipping.", mim_root)
            continue
        consistency = {}
        cons_fpath = art / "mimic_consistency.json"
        if cons_fpath.exists():
            consistency = json.loads(cons_fpath.read_text())

        tasks = {}
        for task_dir in sorted(p for p in mim_root.iterdir() if p.is_dir()):
            if cfg.task_contains and cfg.task_contains not in task_dir.name:
                continue
            index = json.loads((task_dir / "index.json").read_text())
            cons_for_task = {
                e["latent"]: e["consistency"]
                for e in consistency.get(task_dir.name, [])
            }
            features = []
            for feat in index["features"]:
                strips = {
                    side: [_b64(task_dir / str(feat["latent"]) / name) for name in names]
                    for side, names in feat["strips"].items()
                }
                features.append({
                    "latent": feat["latent"],
                    "auroc": feat["auroc"],
                    "consistency": cons_for_task.get(feat["latent"]),
                    "strips": strips,
                })
            tasks[task_dir.name] = {"sides": index["sides"], "features": features}
        if tasks:
            runs_payload[run.run_id] = tasks
    assert runs_payload, "No rendered mimic tasks found for the given runs."
    return {"runs": runs_payload}


def build(cfg: Config) -> pathlib.Path:
    payload = load_payload(cfg)
    out = pathlib.Path(cfg.out)
    out.write_text(_HTML.replace("/*__PAYLOAD__*/", json.dumps(payload)))
    n_feats = sum(
        len(t["features"]) for r in payload["runs"].values() for t in r.values()
    )
    logger.info(
        "Wrote %s (%d runs, %d features).", out, len(payload["runs"]), n_feats
    )
    return out


_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>Cambridge Mimicry Viewer</title>
<style>
body { font-family: system-ui, sans-serif; margin: 1.2rem; background: #fafafa; }
.controls { display: flex; gap: .8rem; align-items: center; flex-wrap: wrap; margin-bottom: .8rem; }
select, button, input[type=range] { padding: .25rem; }
.meta { font-size: .85rem; color: #555; margin: .4rem 0; }
#gallery { display: grid; gap: 6px; }
#gallery img { width: 100%; border-radius: 4px; border: 1px solid #ddd; }
</style></head><body>
<h1>Cambridge Mimicry Viewer</h1>
<div class="controls">
  <label>Run: <select id="run"></select></label>
  <label>Task: <select id="task"></select></label>
  <label>Feature order: <select id="order">
    <option value="auroc" selected>auroc</option>
    <option value="consistency">consistency</option>
  </select></label>
  <button id="prev">&#8592; Prev</button>
  <span id="featLabel"></span>
  <button id="next">Next &#8594;</button>
  <label>Strip: <select id="strip"></select></label>
  <label>Columns: <input id="cols" type="range" min="2" max="8" value="4"></label>
</div>
<div class="meta" id="meta"></div>
<div id="gallery"></div>
<script>
const D = /*__PAYLOAD__*/;
const runSel = document.getElementById("run"), taskSel = document.getElementById("task"),
      orderSel = document.getElementById("order"), stripSel = document.getElementById("strip"),
      colsInput = document.getElementById("cols");
let featIdx = 0;

function fill(sel, options, keep) {
  const prev = keep ? sel.value : null;
  sel.innerHTML = "";
  for (const o of options) {
    const el = document.createElement("option");
    el.value = o; el.textContent = o;
    sel.appendChild(el);
  }
  if (prev && options.includes(prev)) sel.value = prev;
}

function currentTask() {
  return D.runs[runSel.value][taskSel.value];
}

function orderedFeatures() {
  const feats = [...currentTask().features];
  if (orderSel.value === "consistency")
    feats.sort((a, b) => (b.consistency ?? -2) - (a.consistency ?? -2));
  else feats.sort((a, b) => b.auroc - a.auroc);
  return feats;
}

function render() {
  const feats = orderedFeatures();
  featIdx = Math.min(Math.max(featIdx, 0), feats.length - 1);
  const f = feats[featIdx];
  document.getElementById("featLabel").textContent =
    `Feature ${f.latent} (${featIdx + 1}/${feats.length})`;
  const cons = f.consistency == null ? "n/a" : f.consistency.toFixed(3);
  document.getElementById("meta").textContent =
    `AUROC ${f.auroc.toFixed(3)} | consistency ${cons} | strip ${stripSel.value}`;
  const g = document.getElementById("gallery");
  g.style.gridTemplateColumns = `repeat(${colsInput.value}, 1fr)`;
  g.innerHTML = "";
  for (const src of (f.strips[stripSel.value] || [])) {
    const img = document.createElement("img");
    img.src = src;
    g.appendChild(img);
  }
}

function refreshTasks() {
  fill(taskSel, Object.keys(D.runs[runSel.value]), true);
  refreshStrips();
}
function refreshStrips() {
  fill(stripSel, currentTask().sides, true);
  featIdx = 0;
  render();
}

fill(runSel, Object.keys(D.runs));
refreshTasks();
runSel.addEventListener("change", refreshTasks);
taskSel.addEventListener("change", refreshStrips);
orderSel.addEventListener("change", () => { featIdx = 0; render(); });
stripSel.addEventListener("change", render);
colsInput.addEventListener("input", render);
document.getElementById("prev").addEventListener("click", () => { featIdx--; render(); });
document.getElementById("next").addEventListener("click", () => { featIdx++; render(); });
</script></body></html>
"""


# ---------------------------------------------------------------------------
# Scores browser (reference exps/002-wider-saes/viewer.py: browse
# mimic_scores.json ACROSS runs: per-task tables of best separation and the
# top-10 features per run, no rendered strips required)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ScoresConfig:
    runs: tuple[pathlib.Path, ...] = ()
    shards: pathlib.Path = pathlib.Path("./shards/abcdef01")
    task_contains: str = ""
    out: pathlib.Path = pathlib.Path("./mimics_scores.html")


def load_scores_payload(cfg: ScoresConfig) -> dict:
    by_task: dict[str, list[dict]] = {}
    for run_dir in cfg.runs:
        run = disk.Run(run_dir)
        fpath = run.inference / pathlib.Path(cfg.shards).name / "mimic_scores.json"
        if not fpath.exists():
            logger.warning("No mimic_scores.json under %s; skipping.", fpath.parent)
            continue
        d_sae = (run.config.get("sae") or {}).get("d_sae") if (
            run.run_dir / "checkpoint" / "config.json"
        ).exists() else None
        for task, result in json.loads(fpath.read_text()).items():
            if cfg.task_contains and cfg.task_contains not in task:
                continue
            by_task.setdefault(task, []).append({
                "run_id": run.run_id,
                "d_sae": d_sae,
                "best_latent": result["best_latent"],
                "best_separation": result["best_separation"],
                "n_pos": result["n_pos"],
                "n_neg": result["n_neg"],
                "top10": result["top10"],
            })
    assert by_task, "No mimic_scores.json found for the given runs."
    for rows in by_task.values():
        rows.sort(key=lambda r: -r["best_separation"])
    return {"tasks": by_task}


_SCORES_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>mimic scores</title><style>
body{font-family:system-ui;margin:1.5rem;background:#fafafa}
h2{margin:1.2em 0 .3em}table{border-collapse:collapse;background:#fff}
td,th{border:1px solid #ddd;padding:.25rem .6rem;font-size:.85rem}
th{background:#f0f0f0;cursor:default}.top10{color:#666;font-size:.75rem}
</style></head><body>
<h1>Mimic-pair scores across runs</h1>
<div id="root"></div>
<script>
const payload = /*__PAYLOAD__*/;
const root = document.getElementById("root");
for (const [task, rows] of Object.entries(payload.tasks)) {
  const h = document.createElement("h2"); h.textContent = task;
  root.appendChild(h);
  const info = document.createElement("div");
  info.textContent = `${rows[0].n_pos} erato / ${rows[0].n_neg} melpomene`;
  info.className = "top10"; root.appendChild(info);
  const t = document.createElement("table");
  t.innerHTML = "<tr><th>run</th><th>d_sae</th><th>best sep</th>" +
                "<th>best latent</th><th>top-10 (latent:auroc)</th></tr>";
  for (const r of rows) {
    const tr = document.createElement("tr");
    const tops = r.top10.map(f => `${f.latent}:${f.auroc.toFixed(3)}`).join(" ");
    tr.innerHTML = `<td>${r.run_id}</td><td>${r.d_sae ?? "?"}</td>` +
      `<td>${r.best_separation.toFixed(3)}</td><td>${r.best_latent}</td>` +
      `<td class="top10">${tops}</td>`;
    t.appendChild(tr);
  }
  root.appendChild(t);
}
</script></body></html>
"""


def build_scores(cfg: ScoresConfig) -> pathlib.Path:
    payload = load_scores_payload(cfg)
    out = pathlib.Path(cfg.out)
    out.write_text(_SCORES_HTML.replace("/*__PAYLOAD__*/", json.dumps(payload)))
    logger.info("Wrote %s (%d tasks).", out, len(payload["tasks"]))
    return out
