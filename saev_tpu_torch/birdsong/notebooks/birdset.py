"""Birdset study: how do Bird-MAE audio activations differ from image ViTs?

The port's copy of `contrib/birdsong/notebooks/birdset.py`:
the same cells, environment variables, defaults, printed lines and
artifacts, on saev_tpu_torch (no JAX).

Capability mirror of reference contrib/birdsong/notebooks/birdset.py (1271-LoC
marimo notebook) as a percent-format script: sample activations from an audio
shard set and an image shard set, compare norm distributions and per-dimension
statistics, and hunt for pathological channels (the reference finds Bird-MAE
dimension 295 dominating every norm — the kind of channel that should be
clipped or normalized before SAE training). The heavy lifting lives in
`birdsong.stats`; this file is the narrative.

Run with env vars:
    BIRDSET_AUDIO_SHARDS=<bird-mae shards> BIRDSET_IMG_SHARDS=<image shards> \\
        python saev_tpu_torch/birdsong/notebooks/birdset.py

The trace cell (BIRDSET_TRACE=1) runs Bird-MAE on the card unless
BIRDSET_DEVICE=cpu. It prints the pathological channel and its dominance
before it draws the figures, so the two lines stand where matplotlib is
missing, and the figures' ImportError follows them.
"""

# %%
import json
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[3]))

AUDIO_SHARDS = pathlib.Path(os.environ.get("BIRDSET_AUDIO_SHARDS", "./shards/audio"))
IMG_SHARDS = pathlib.Path(os.environ.get("BIRDSET_IMG_SHARDS", "./shards/img"))
AUDIO_LAYER = int(os.environ.get("BIRDSET_AUDIO_LAYER", "0"))
IMG_LAYER = int(os.environ.get("BIRDSET_IMG_LAYER", "0"))
N_SAMPLE = int(os.environ.get("BIRDSET_N", "100000"))
OUT = pathlib.Path(os.environ.get("BIRDSET_OUT", "./birdset_report.json"))
DEVICE = os.environ.get("BIRDSET_DEVICE", "cuda")

# %% [markdown]
# ## Sample activations and compute the full report

# %%
from saev_tpu_torch.birdsong import stats  # noqa: E402

result = stats.report(
    {
        "audio": (AUDIO_SHARDS, AUDIO_LAYER),
        "image": (IMG_SHARDS, IMG_LAYER),
    },
    n=N_SAMPLE,
    out=OUT,
)

# %% [markdown]
# ## Outlier channels
# The reference's finding: one audio channel (d=295 for Bird-MAE-Large)
# carries most of the residual norm. Anything listed here deserves a look
# before training SAEs on these activations.

# %%
for name, per_set in result["per_set"].items():
    print(f"== {name} ==")
    for dim in per_set["outlier_dims"][:10]:
        print(
            f"  dim {dim['dim']}: |max| {dim['absmax']:.1f} "
            f"(robust z {dim['robust_z']:.1f}, mean {dim['mean']:.3f})"
        )
    if not per_set["outlier_dims"]:
        print("  no outlier dimensions")

# %% [markdown]
# ## Norm comparison

# %%
for key, cmp in result["comparisons"].items():
    print(key, json.dumps({k: v for k, v in cmp.items() if k == "norm_ratio"}))

# %% [markdown]
# ## Channel trace through the model internals
# The reference's graphs 1-4 (birdset.py:429-1046): instrument every block's
# attention / MLP / norm outputs and follow the pathological channel through
# the layers, plus its LayerNorm scale/bias per layer. Requires the Bird-MAE
# weights; set BIRDSET_TRACE=1 to run (downloads / loads the checkpoint).

# %%
if os.environ.get("BIRDSET_TRACE"):
    import numpy as np

    from saev_tpu_torch.birdsong import trace
    from saev_tpu_torch.models import bird_mae

    model = bird_mae.Transformer(
        os.environ.get("BIRDSET_ARCH", "Bird-MAE-Large"), device=DEVICE
    )
    rng = np.random.default_rng(0)
    waveforms = rng.normal(size=(2, bird_mae.SR_HZ * 5)).astype(np.float32)
    tokens = np.stack([
        bird_mae.spectrogram_to_tokens(bird_mae.transform(w)) for w in waveforms
    ])
    # trace.trace_report's steps, its figures last.
    acts = trace.trace_sites(
        model, tokens, (bird_mae.N_TIME_PATCHES, bird_mae.N_MEL_PATCHES)
    )
    channel = trace.find_bad_channel(acts)
    channel_trace = trace.channel_trace(acts, channel)
    print("pathological channel:", channel)
    print("dominance (resid):", channel_trace.dominance("resid").round(4).tolist())
    trace.plot_channel_trace(channel_trace, OUT.parent / "channel_trace")

# %% [markdown]
# ## Norm histograms (matplotlib, optional)

# %%
try:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 4))
    for name, per_set in result["per_set"].items():
        hist = per_set["norm_histogram"]
        centers = [
            (a + b) / 2 for a, b in zip(hist["edges"][:-1], hist["edges"][1:])
        ]
        ax.plot(centers, hist["counts"], label=name)
    ax.set_xlabel("token L2 norm")
    ax.set_ylabel("count")
    ax.legend()
    fig.savefig(OUT.with_suffix(".png"), dpi=120)
    print(f"saved {OUT.with_suffix('.png')}")
except ImportError:
    print("matplotlib unavailable; skipped the plot")
