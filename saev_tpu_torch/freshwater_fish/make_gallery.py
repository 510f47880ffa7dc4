"""Species-labelled, paginated HTML gallery of SAE features over fish images
(counterpart of contrib/freshwater_fish/scripts/make_gallery.py).

Capability mirror of reference contrib/freshwater_fish/scripts/make_gallery.py
(:1-327): reads a run's pre-rendered visuals (`images/<latent>/{j}_sae_img.png`
from tdiscovery.visuals) plus `var.parquet`, converts PNGs to inline JPEG
base64, captions each image with its species label, and emits one
self-contained HTML file with client-side sorting (frequency / mean value /
feature id, direction toggles) and pagination (10/20/50 per page) so thousands
of images stay browsable.

Species labels come from a `stem -> label` CSV or from the dataset's
`labels.csv` (reference pulls them from the FishVista HF dataset, which needs
egress; `--stem-labels` accepts the same mapping from disk).

Usage:
    python -m saev_tpu_torch.freshwater_fish.make_gallery gallery \\
        --run runs/<id> --shards <dir> --out fish_gallery.html
"""

import base64
import dataclasses
import io
import json
import logging
import pathlib

from .. import helpers

logger = logging.getLogger("fish.gallery")


@dataclasses.dataclass(frozen=True)
class Config:
    run: pathlib.Path = pathlib.Path("./runs/abcdefg")
    shards: pathlib.Path = pathlib.Path("./shards/abcdef01")
    dataset: pathlib.Path | None = None
    """Dataset root whose images/<split>/ ordering defines example indices."""
    split: str = "validation"
    stem_labels: pathlib.Path | None = None
    """CSV of stem,label rows mapping image stems to species labels."""
    jpeg_quality: int = 80
    title: str = ""
    out: pathlib.Path = pathlib.Path("./gallery.html")


def png_to_jpeg_b64(fpath: pathlib.Path, quality: int) -> str:
    image = helpers.optional_import("PIL.Image", "freshwater_fish.make_gallery")
    img = image.open(fpath).convert("RGB")
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=quality)
    return "data:image/jpeg;base64," + base64.b64encode(buf.getvalue()).decode()


def load_species(cfg: Config) -> list[str] | None:
    """Index-aligned species labels mapped through the stem->label CSV
    (reference load_species_labels :58-66).

    Image order MUST be the extraction dataset's own walk
    (datasets._walk_images: recursive, extension-filtered, filename-sorted) —
    a bare iterdir over stems silently misaligns every caption after any
    non-image file, subdirectory, or stem-vs-filename sort divergence."""
    if cfg.dataset is None:
        return None
    from ..data import datasets as ds_mod

    img_dir = cfg.dataset / "images" / cfg.split
    assert img_dir.is_dir(), f"No images directory at '{img_dir}'"
    stems = [p.stem for p in ds_mod._walk_images(img_dir)]

    mapping: dict[str, str] = {}
    csv_fpath = cfg.stem_labels or (cfg.dataset / "labels.csv")
    if csv_fpath.exists():
        import csv

        with open(csv_fpath, newline="") as fd:
            reader = csv.reader(fd)
            header = next(reader, None)
            for row in reader:
                if len(row) >= 2:
                    mapping[row[0]] = row[1]
    return [mapping.get(stem, "?") for stem in stems]


def build_features(
    images_dpath: pathlib.Path, var_df, species: list[str] | None, quality: int
) -> list[dict]:
    """Feature cards from pre-rendered visuals dirs, species-captioned
    (reference build_features :69-126)."""
    available = {
        int(d.name) for d in images_dpath.iterdir() if d.is_dir() and d.name.isdigit()
    }
    cards = []
    for row in var_df.to_dict("records"):
        fid = int(row["feature"])
        if fid not in available:
            continue
        feature_dpath = images_dpath / str(fid)

        # visuals.worker_fn dedupes examples before writing {j}_* files, so the
        # j-th image corresponds to the j-th UNIQUE top example index.
        deduped, seen = [], set()
        for ex in list(row["topk_example_idx"]):
            if ex not in seen:
                seen.add(ex)
                deduped.append(int(ex))

        imgs = []
        for j in range(100):
            fpath = feature_dpath / f"{j}_sae_img.png"
            if not fpath.exists():
                break
            label = "?"
            if species is not None and j < len(deduped) and 0 <= deduped[j] < len(species):
                label = species[deduped[j]]
            imgs.append({"src": png_to_jpeg_b64(fpath, quality), "label": label})
        if not imgs:
            continue

        lf, lv = float(row["log10_freq"]), float(row["log10_value"])
        cards.append({
            "id": fid,
            "log10_freq": round(lf, 3),
            "log10_value": round(lv, 3),
            "freq_pct": f"{10 ** lf * 100:.4f}",
            "mean_val": f"{10 ** lv:.2f}",
            "images": imgs,
        })
    cards.sort(key=lambda c: c["log10_freq"])
    return cards


def gallery(cfg: Config) -> pathlib.Path:
    pd = helpers.optional_import("pandas", "freshwater_fish.make_gallery")

    art = pathlib.Path(cfg.run) / "inference" / pathlib.Path(cfg.shards).name
    images_dpath = art / "images"
    assert images_dpath.is_dir(), f"No images directory at '{images_dpath}'"
    var_df = pd.read_parquet(art / "var.parquet")
    logger.info("Loaded var.parquet with %d features.", len(var_df))

    species = load_species(cfg)
    cards = build_features(images_dpath, var_df, species, cfg.jpeg_quality)
    n_imgs = sum(len(c["images"]) for c in cards)
    logger.info("Packaged %d features, %d images.", len(cards), n_imgs)

    title = cfg.title or (
        f"SAE run {pathlib.Path(cfg.run).name}, shards "
        f"{pathlib.Path(cfg.shards).name} | {len(cards)} features, {n_imgs} images"
    )
    html = (
        _HTML.replace("/*__FEATURES__*/", json.dumps(cards))
        .replace("__TITLE__", title)
        .replace("__RUN_ID__", pathlib.Path(cfg.run).name)
    )
    out = pathlib.Path(cfg.out)
    out.write_text(html)
    logger.info("Wrote %s (%.1f MB)", out, out.stat().st_size / 1e6)
    return out


_HTML = """<!DOCTYPE html>
<html lang="en"><head><meta charset="utf-8"><title>SAE Feature Gallery</title>
<style>
body { font-family: system-ui, sans-serif; background: #f5f5f5; color: #333; padding: 20px; margin: 0; }
h1 { margin: 0 0 6px; }
.subtitle { color: #666; margin-bottom: 14px; font-size: 14px; }
.howto { background: #e8f4fd; border: 1px solid #b8daef; border-radius: 6px; padding: 10px 14px; margin-bottom: 14px; font-size: 13px; }
.controls { display: flex; gap: 10px; align-items: center; margin-bottom: 10px; flex-wrap: wrap; }
.controls button { padding: 5px 12px; border: 1px solid #ccc; border-radius: 4px; background: #fff; cursor: pointer; }
.controls button.active { background: #333; color: #fff; }
.card { background: #fff; border: 1px solid #ddd; border-radius: 8px; padding: 14px; margin-bottom: 14px; }
.card h2 { font-size: 15px; margin: 0 0 2px; }
.meta { font-size: 12px; color: #888; margin-bottom: 8px; }
.grid { display: grid; grid-template-columns: repeat(auto-fill, minmax(170px, 1fr)); gap: 8px; }
.grid figure { margin: 0; text-align: center; }
.grid img { width: 100%; border-radius: 4px; display: block; }
.grid figcaption { font-size: 11px; color: #666; font-style: italic; overflow: hidden; text-overflow: ellipsis; white-space: nowrap; }
.nav { display: flex; gap: 8px; justify-content: center; margin: 10px 0; }
.nav button { padding: 7px 18px; border: 1px solid #ccc; border-radius: 4px; background: #fff; cursor: pointer; }
.info { font-size: 13px; color: #666; }
</style></head><body>
<h1>SAE Feature Gallery</h1>
<p class="subtitle">__TITLE__</p>
<div class="howto"><strong>How to read this:</strong> each card is one SAE
feature; brighter highlights mark the patches that activate it. Captions show
the species of each top-activating image. Run: <code>__RUN_ID__</code></div>
<div class="controls">
  Sort:
  <button id="s-freq" class="active" onclick="sortBy('freq')">Frequency <span id="d-freq" onclick="event.stopPropagation(); flip('freq')">&#9650;</span></button>
  <button id="s-value" onclick="sortBy('value')">Mean value <span id="d-value" onclick="event.stopPropagation(); flip('value')">&#9660;</span></button>
  <button id="s-id" onclick="sortBy('id')">Feature ID <span id="d-id" onclick="event.stopPropagation(); flip('id')">&#9650;</span></button>
  Per page:
  <select onchange="setPerPage(this.value)"><option>10</option><option selected>20</option><option>50</option></select>
  <span class="info" id="info-top"></span>
</div>
<div class="nav"><button onclick="move(-1)">&#8592; Previous</button><button onclick="move(1)">Next &#8594;</button></div>
<div id="gallery"></div>
<div class="nav"><button onclick="move(-1)">&#8592; Previous</button><button onclick="move(1)">Next &#8594;</button></div>
<script>
const FEATURES = /*__FEATURES__*/;
let sortKey = "freq", page = 0, perPage = 20;
let dirs = { freq: true, value: false, id: true };
let sorted = [...FEATURES];
const field = k => k === "freq" ? "log10_freq" : k === "value" ? "log10_value" : "id";
function sortBy(k) {
  sortKey = k; page = 0;
  const f = field(k), asc = dirs[k];
  sorted.sort((a, b) => asc ? a[f] - b[f] : b[f] - a[f]);
  document.querySelectorAll(".controls > button").forEach(b => b.classList.remove("active"));
  document.getElementById("s-" + k).classList.add("active");
  render();
}
function flip(k) {
  dirs[k] = !dirs[k];
  document.getElementById("d-" + k).innerHTML = dirs[k] ? "&#9650;" : "&#9660;";
  if (sortKey === k) sortBy(k);
}
function setPerPage(n) { perPage = parseInt(n); page = 0; render(); }
function move(d) {
  const np = page + d;
  if (np >= 0 && np * perPage < sorted.length) { page = np; render(); window.scrollTo(0, 0); }
}
function render() {
  const start = page * perPage, end = Math.min(start + perPage, sorted.length);
  document.getElementById("info-top").textContent =
    `Showing ${start + 1}–${end} of ${sorted.length} features ` +
    `(page ${page + 1}/${Math.ceil(sorted.length / perPage)})`;
  const el = document.getElementById("gallery");
  el.innerHTML = "";
  for (let i = start; i < end; i++) {
    const f = sorted[i], div = document.createElement("div");
    div.className = "card";
    div.innerHTML = `<h2>Feature ${f.id}</h2>
      <div class="meta">Fires on ${f.freq_pct}% of patches | mean activation ${f.mean_val}</div>
      <div class="grid">` + f.images.map(im =>
        `<figure><img src="${im.src}" loading="lazy"><figcaption>${im.label}</figcaption></figure>`
      ).join("") + `</div>`;
    el.appendChild(div);
  }
}
render();
</script></body></html>
"""


def main(argv: list[str] | None = None) -> None:
    from ..utils import cli

    logging.basicConfig(level=logging.INFO)
    cli.run({"gallery": gallery}, argv)


if __name__ == "__main__":
    main()
