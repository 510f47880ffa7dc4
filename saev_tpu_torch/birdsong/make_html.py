"""Static HTML browser over birdsong latent clips (counterpart of
contrib/birdsong/scripts/make_html.py; reference :67-229): per-latent cards
with the original and SAE-highlighted spectrograms (captioned) and the time
and time+frequency filtered audio players. `--embed` base64-inlines every
asset into one self-contained file (the reference's default); without it
assets are referenced relatively. `--notes` points at a JSON file of
{latent: "curator notes"} rendered under the matching card, and `--latents`
restricts the page to a curated list. Host-only, stdlib.

    python -m saev_tpu_torch.birdsong make_html --run runs/<id> --shards <dir> --embed --notes notes.json
"""

import base64
import dataclasses
import html
import json
import logging
import os
import pathlib

from .. import disk

logger = logging.getLogger("birdsong.html")


@dataclasses.dataclass(frozen=True)
class Config:
    run: pathlib.Path = pathlib.Path("./runs/abcdefg")
    shards: pathlib.Path = pathlib.Path("./shards/abcdef01")
    embed: bool = False
    """Base64-inline every spectrogram/clip into one self-contained file."""
    notes: pathlib.Path | None = None
    """JSON mapping latent id -> curator notes."""
    latents: tuple[int, ...] = ()
    """Restrict to these latents (empty = all with clips)."""
    out: pathlib.Path | None = None


def _src(fpath: pathlib.Path, rel_root: pathlib.Path, embed: bool, mime: str) -> str:
    if embed:
        return f"data:{mime};base64,{base64.b64encode(fpath.read_bytes()).decode()}"
    # Relative to the page's directory (a browser resolves srcs against the
    # page, not the artifact dir), which may lie outside the inference tree.
    return os.path.relpath(fpath, rel_root)


def _example_card(latent_dir: pathlib.Path, j: str, rel_root, embed: bool) -> str:
    cells = ['<div class="example">', f"<h4>Example {int(j) + 1}</h4>", '<div class="specs">']
    for suffix, caption in (("spectrogram", "Original Spectrogram"),
                            ("sae_spectrogram", "SAE Highlighted Spectrogram")):
        png = latent_dir / f"{j}_{suffix}.png"
        if png.exists():
            cells.append(f'<figure><img src="{_src(png, rel_root, embed, "image/png")}">'
                         f"<figcaption>{caption}</figcaption></figure>")
    cells.append("</div>")
    for kind, label in (("time_clip", "Time-Clipped Audio"), ("time_freq_clip", "Time+Freq-Clipped Audio")):
        for ext, mime in ((".ogg", "audio/ogg"), (".wav", "audio/wav")):
            clip = latent_dir / f"{j}_{kind}{ext}"
            if clip.exists():
                cells.append(f'<div class="audio"><label>{label}</label>'
                             f'<audio controls src="{_src(clip, rel_root, embed, mime)}"></audio></div>')
                break
    cells.append("</div>")
    return "".join(cells)


def make(cfg: Config) -> pathlib.Path:
    run = disk.Run(cfg.run)
    art = run.inference / cfg.shards.name
    clips_root = art / "clips"
    assert clips_root.exists(), f"No clips at {clips_root}; run birdsong.visuals."

    notes: dict[str, str] = {}
    if cfg.notes and pathlib.Path(cfg.notes).exists():
        notes = {str(k): str(v) for k, v in json.loads(pathlib.Path(cfg.notes).read_text()).items()}

    latent_dirs = sorted((d for d in clips_root.iterdir() if d.is_dir() and d.name.isdigit()),
                         key=lambda p: int(p.name))
    if cfg.latents:
        wanted = {str(latent) for latent in cfg.latents}
        latent_dirs = [d for d in latent_dirs if d.name in wanted]

    out = cfg.out or (art / "birdsong.html")
    sections = []
    for latent_dir in latent_dirs:
        js = sorted({p.name.split("_")[0] for p in latent_dir.glob("*_spectrogram.png")}, key=int)
        cards = [_example_card(latent_dir, j, out.parent, cfg.embed) for j in js]
        note_html = (f'<p class="notes"><strong>Notes:</strong> {html.escape(notes[latent_dir.name])}</p>'
                     if latent_dir.name in notes else "")
        sections.append(f"<section><h2>Latent {html.escape(latent_dir.name)}</h2>{note_html}"
                        f'<div class="grid">{"".join(cards)}</div></section>')

    doc = f"""<!doctype html><html><head><meta charset="utf-8">
<title>SAE Feature Examples — Birdsong</title>
<style>
body {{ font-family: system-ui, sans-serif; max-width: 1400px; margin: 0 auto;
       padding: 20px; background: #f5f5f5; }}
section {{ background: #fff; border-radius: 8px; padding: 16px; margin-bottom: 24px;
           box-shadow: 0 2px 4px rgba(0,0,0,.1); }}
.grid {{ display: grid; grid-template-columns: repeat(2, 1fr); gap: 16px; }}
.example {{ background: #fafafa; border: 1px solid #eee; border-radius: 6px; padding: 12px; }}
.specs {{ display: flex; gap: 8px; }}
.specs figure {{ flex: 1; margin: 0; }}
.specs img {{ width: 100%; image-rendering: pixelated; border-radius: 4px; }}
.specs figcaption {{ font-size: 11px; color: #888; text-align: center; }}
.audio label {{ display: block; font-size: 12px; color: #666; margin: 6px 0 2px; }}
audio {{ width: 100%; }}
.notes {{ font-size: 13px; color: #444; }}
</style></head><body>
<h1>SAE Feature Examples — Birdsong Spectrograms ({html.escape(run.run_id)})</h1>
{"".join(sections)}</body></html>"""

    out.write_text(doc)
    logger.info("Wrote %s (%d latents, embed=%s).", out, len(sections), cfg.embed)
    return out
