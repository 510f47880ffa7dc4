"""Audio latent visuals: per-latent spectrograms and SAE-filtered audio clips
(counterpart of contrib/birdsong/src/birdsong/visuals.py; reference Config
:31, cli :79-334): for each selected latent, find its top-activating clips,
save the log-mel spectrogram, the SAE-highlighted spectrogram, and the time
and time+frequency filtered audio (`models.bird_mae.filter_audio`).

Clips are Ogg/Vorbis where the codec's libraries load (`utils.vorbis`), else
16-bit WAV through the stdlib `wave` module. Host-only: it reads the
`token_acts.npz` that inference wrote; Pillow is imported where an image is
drawn, and pandas (with its parquet engine) for the `var.parquet` table,
which is skipped, as in contrib, where either is missing.

    python -m saev_tpu_torch.birdsong visuals --run runs/<id> --shards <dir>
"""

import dataclasses
import logging
import pathlib
import random
import wave

import numpy as np
import scipy.sparse

from .. import disk, helpers, viz
from ..data import Metadata, datasets
from ..models import bird_mae

logger = logging.getLogger("birdsong.visuals")


@dataclasses.dataclass(frozen=True)
class Config:
    """Latent audio visualization config (reference birdsong/visuals.py:31-58)."""

    run: pathlib.Path = pathlib.Path("./runs/abcdefg")
    """Run directory."""
    shards: pathlib.Path = pathlib.Path("./shards/abcdef01")
    """Activations (Bird-MAE family)."""
    latents: tuple[int, ...] = ()
    """Latents to always include."""
    n_latents: int = 100
    """Number of (additional, random in-band) latents to save clips for."""
    top_k: int = 8
    """Top examples ranked per latent."""
    n_clips: int = 4
    """Clips saved per latent (<= 4)."""
    log_freq_range: tuple[float, float] = (-6.0, 1.0)
    log_value_range: tuple[float, float] = (-3.0, 3.0)
    act_threshold: float = 0.0
    """Patch activation > threshold counts as active for filtering."""
    seed: int = 42


def write_wav(fpath: pathlib.Path, waveform: np.ndarray, sample_rate: int) -> None:
    """float waveform (-1..1) -> 16-bit PCM WAV via the stdlib."""
    pcm = np.clip(np.asarray(waveform, np.float64), -1.0, 1.0)
    pcm = (pcm * 32767).astype("<i2")
    with wave.open(str(fpath), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def write_clip(fpath_base: pathlib.Path, waveform: np.ndarray, sample_rate: int) -> pathlib.Path:
    """Save a clip as .ogg (the reference's format, through the ctypes Vorbis
    encoder) where the codec libraries load, else as 16-bit WAV."""
    from ..utils import vorbis

    if vorbis.available():
        out = fpath_base.with_suffix(".ogg")
        vorbis.write_ogg(out, waveform, sample_rate)
        return out
    out = fpath_base.with_suffix(".wav")
    write_wav(out, waveform, sample_rate)
    return out


def spectrogram_image(fb_tm: np.ndarray, *, scale: int = 1):
    """(512, 128) normalized log-mel -> an RGB PIL image of its gray levels
    (time on x, mel on y, low frequencies at the bottom)."""
    image = helpers.optional_import("PIL.Image", "birdsong.visuals")
    lo, hi = float(fb_tm.min()), float(fb_tm.max())
    norm = (fb_tm - lo) / max(hi - lo, 1e-9)
    img = (norm.T[::-1] * 255).astype(np.uint8)  # (mel, time), flipped
    out = image.fromarray(img).convert("RGB")
    if scale != 1:
        out = out.resize((out.width * scale, out.height * scale), image.NEAREST)
    return out


def sae_spectrogram_image(fb_tm: np.ndarray, patch_acts: np.ndarray, *, scale: int = 1):
    """The spectrogram with SAE patch activations overlaid as a heatmap.

    Patch i is (time_patch=i//8, mel_patch=i%8); the displayed image has time
    on x and mel on y (flipped), so the highlight grid is rearranged to match.
    """
    base = spectrogram_image(fb_tm, scale=scale)
    grid = patch_acts.reshape(bird_mae.N_TIME_PATCHES, bird_mae.N_MEL_PATCHES)  # (time, mel)
    display = grid.T[::-1].reshape(-1)  # (mel, time) flipped, row-major
    return viz.add_highlights(base, display.astype(np.float64), patch_size=16 * scale,
                              upper=max(float(patch_acts.max()), 1e-9))


def _write_var(art: pathlib.Path, d_sae: int, lf: np.ndarray, lv: np.ndarray, topk_example_idx: np.ndarray) -> None:
    """The per-latent stats table (reference birdsong/visuals.py:121-130),
    shared with the gallery and HTML tools; skipped where pandas or its
    parquet engine cannot be imported."""
    try:
        import pandas as pd

        pd.DataFrame({
            "feature": np.arange(d_sae),
            "log10_freq": lf,
            "log10_value": lv,
            "topk_example_idx": list(topk_example_idx),
        }).to_parquet(art / "var.parquet")
        logger.info("Saved var.parquet with %d rows.", d_sae)
    except ImportError as err:
        logger.info("Skipping var.parquet: %s", err)


def worker_fn(cfg: Config) -> None:
    import torch

    run = disk.Run(cfg.run)
    art = run.inference / cfg.shards.name
    token_acts = scipy.sparse.load_npz(art / "token_acts.npz").tocsr()
    d_sae = token_acts.shape[1]
    sparsity = torch.load(art / "sparsity.pt", weights_only=True).numpy()
    mean_values = torch.load(art / "mean_values.pt", weights_only=True).numpy()

    md = Metadata.load(cfg.shards)
    assert md.family == "bird-mae", f"Birdsong visuals need bird-mae shards, got {md.family}"
    audio_ds = datasets.get_dataset(md.make_data_cfg())

    topk = helpers.csr_topk(token_acts, k=cfg.top_k, axis=0)
    topk_example_idx = (topk.indices // md.content_tokens_per_example).T  # (d_sae, k)

    with np.errstate(divide="ignore"):
        lf, lv = np.log10(sparsity), np.log10(mean_values)
    _write_var(art, d_sae, lf, lv, topk_example_idx)
    band = ((cfg.log_freq_range[0] < lf) & (lf < cfg.log_freq_range[1])
            & (cfg.log_value_range[0] < lv) & (lv < cfg.log_value_range[1]))
    features = list(cfg.latents)
    pool = np.arange(d_sae)[band].tolist()
    random.seed(cfg.seed)
    random.shuffle(pool)
    features += pool[: cfg.n_latents]

    ctpe = md.content_tokens_per_example
    for f in helpers.progress(features, desc="saving clips", every=1):
        feature_dir = art / "clips" / str(f)
        feature_dir.mkdir(exist_ok=True, parents=True)
        ex_idx = topk_example_idx[f]
        token_idx = ex_idx[:, None] * ctpe + np.arange(ctpe)[None, :]
        token_values = np.asarray(token_acts[token_idx.ravel()][:, f].todense()).reshape(cfg.top_k, ctpe)

        seen = set()
        j = 0
        for example_idx, acts_p in zip(ex_idx.tolist(), token_values):
            if j >= min(cfg.n_clips, 4) or example_idx in seen:
                continue
            seen.add(example_idx)
            sample = audio_ds[example_idx]
            waveform = np.asarray(sample["data"], dtype=np.float32)
            sr = int(sample.get("sample_rate", bird_mae.SR_HZ))

            fb = bird_mae.transform(waveform)
            spectrogram_image(fb, scale=2).save(feature_dir / f"{j}_spectrogram.png")
            sae_spectrogram_image(fb, acts_p, scale=2).save(feature_dir / f"{j}_sae_spectrogram.png")
            patches = acts_p > cfg.act_threshold
            for mode, name in (("time", "time_clip"), ("time+freq", "time_freq_clip")):
                clip = (bird_mae.filter_audio(waveform, sr, patches, mode=mode) if patches.any()
                        else np.zeros(0, np.float32))
                if clip.size == 0:
                    # As the reference (birdsong/visuals.py:305-333): an
                    # audible placeholder rather than no file, so the
                    # browser's layout per example stays aligned.
                    logger.warning("Empty %s for latent %d example %d.", name, f, example_idx)
                    clip = np.zeros(1, np.float32)
                write_clip(feature_dir / f"{j}_{name}", clip, sr)
            j += 1

    logger.info("Saved clips for %d latents under %s.", len(features), art / "clips")


def cli(cfg: Config) -> None:
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s")
    worker_fn(cfg)
