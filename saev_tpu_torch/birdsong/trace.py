"""Model-internals channel tracing for the birdset study.

The reference's birdset notebook (contrib/birdsong/notebooks/birdset.py:
429-1046) instruments the Bird-MAE encoder with forward hooks at four sites
(block output "graph1", attention output "graph2", MLP output "graph3",
norm2 output "graph4") and plots how one pathological channel (d_bad=295 for
Bird-MAE-Large) evolves through the layers, plus the per-layer LayerNorm
weights at that channel (graph_layernorm1/2, :921-1046). Counterpart of
contrib/birdsong/src/birdsong/trace.py: `models.vit.forward_sites` records
every site of every block from one functional forward on the device of the
model's params, at its default precision (bf16 products with f32 results on
the card, f32 on the CPU), and this module computes the same per-layer
statistics (host numpy) and figures (matplotlib, imported when called).
"""

import dataclasses
import logging
import pathlib

import numpy as np
import torch

logger = logging.getLogger("birdsong.trace")

SITES = ("resid", "norm1", "attn_out", "norm2", "mlp_out")


@dataclasses.dataclass(frozen=True)
class ChannelTrace:
    """Per-layer statistics of one channel vs the rest of the model width."""

    channel: int
    n_layers: int
    # All arrays are (n_sites?, n_layers); keyed by site name.
    chan_mean: dict[str, np.ndarray]
    chan_std: dict[str, np.ndarray]
    rest_mean: dict[str, np.ndarray]  # signed mean over all other channels
    rest_std: dict[str, np.ndarray]
    rest_absmean: dict[str, np.ndarray]  # mean over channels of |per-chan mean|
    chan_absmax: dict[str, np.ndarray]

    def dominance(self, site: str = "resid") -> np.ndarray:
        """|chan mean| / mean_j |mean of channel j| per layer — >>1 flags a
        pathological channel (the reference's d_bad=295 reaches ~100x). The
        denominator averages per-channel |mean|s, so sign cancellation across
        healthy channels cannot inflate the ratio."""
        return np.abs(self.chan_mean[site]) / np.maximum(
            self.rest_absmean[site], 1e-9
        )


def trace_sites(model, tokens: np.ndarray, grid: tuple[int, int]) -> dict:
    """Record every internal site of every block: {site: (B, L, T, D) f32}.

    `model` is any wrapper holding a `spec` and `params` (e.g.
    models.bird_mae.Transformer); the forward runs where its params are.
    """
    from ..models import vit

    x = torch.as_tensor(np.asarray(tokens, np.float32)).to(vit.params_device(model.params))
    with torch.no_grad():
        out = vit.forward_sites(model.spec, model.params, x, grid=tuple(grid))
    return {k: v.cpu().numpy() for k, v in out.items()}


def channel_trace(acts_by_site: dict, channel: int) -> ChannelTrace:
    """Per-layer per-site mean/std of `channel` vs the mean/std over the other
    channels (the numbers behind the reference's graph1..graph4)."""
    chan_mean, chan_std, rest_mean, rest_std = {}, {}, {}, {}
    rest_absmean, chan_absmax = {}, {}
    n_layers = None
    for site, acts in acts_by_site.items():
        b, L, t, d = acts.shape
        n_layers = L
        # (B, L, T, D) -> (L, B*T, D): the layer axis must move OUT before
        # flattening batch x tokens (a bare reshape(b*t, L, d) interleaves
        # layers with tokens and mixes layers into every slice).
        flat = acts.transpose(1, 0, 2, 3).reshape(L, b * t, d)
        chan = flat[:, :, channel]
        rest = np.delete(flat, channel, axis=2)
        chan_mean[site] = chan.mean(axis=1)
        chan_std[site] = chan.std(axis=1)
        chan_absmax[site] = np.abs(chan).max(axis=1)
        rest_mean[site] = rest.mean(axis=(1, 2))
        rest_std[site] = rest.std(axis=(1, 2))
        rest_absmean[site] = np.abs(rest.mean(axis=1)).mean(axis=1)
    return ChannelTrace(
        channel=channel,
        n_layers=int(n_layers),
        chan_mean=chan_mean,
        chan_std=chan_std,
        rest_mean=rest_mean,
        rest_std=rest_std,
        rest_absmean=rest_absmean,
        chan_absmax=chan_absmax,
    )


def find_bad_channel(acts_by_site: dict, site: str = "resid") -> int:
    """The channel with the largest |mean| at the last layer of `site` — how
    the reference located d_bad=295 (birdset.py:429-434 hardcodes the result
    of this hunt)."""
    acts = acts_by_site[site]
    last = acts[:, -1].reshape(-1, acts.shape[-1])
    return int(np.abs(last.mean(axis=0)).argmax())


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def layernorm_weights(model, channel: int) -> dict:
    """Per-layer LayerNorm scale/bias at `channel` vs the mean over the rest
    (reference graph_layernorm1/graph_layernorm2, birdset.py:921-1046)."""
    out: dict[str, dict[str, list[float]]] = {}
    for name in ("ln1", "ln2"):
        rows = {"chan_scale": [], "chan_bias": [], "rest_scale": [], "rest_bias": []}
        for blk in model.params["blocks"]:
            scale = _numpy(blk[name]["g"])
            bias = _numpy(blk[name]["b"])
            rows["chan_scale"].append(float(scale[channel]))
            rows["chan_bias"].append(float(bias[channel]))
            rows["rest_scale"].append(float(np.delete(scale, channel).mean()))
            rows["rest_bias"].append(float(np.delete(bias, channel).mean()))
        out[name] = {k: np.asarray(v) for k, v in rows.items()}
    return out


def plot_channel_trace(
    trace: ChannelTrace, out_dir: pathlib.Path, *, prefix: str = "channel"
) -> list[pathlib.Path]:
    """One figure per site: layer on x, channel mean±std vs rest mean±std
    (the reference's graph1/graph2/graph3/graph4 layout)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    xs = np.arange(trace.n_layers)
    for site in trace.chan_mean:
        fig, ax = plt.subplots(figsize=(8, 4.5), layout="constrained")
        cm, cs = trace.chan_mean[site], trace.chan_std[site]
        rm, rs = trace.rest_mean[site], trace.rest_std[site]
        ax.plot(xs, cm, marker="o", color="tab:green", label=f"d={trace.channel}")
        ax.fill_between(xs, cm - cs, cm + cs, color="tab:green", alpha=0.3)
        ax.plot(xs, rm, marker="s", color="tab:blue", label="other dims (mean)")
        ax.fill_between(xs, rm - rs, rm + rs, color="tab:blue", alpha=0.3)
        ax.set_xlabel("layer")
        ax.set_ylabel("activation")
        ax.set_title(f"{site}: channel {trace.channel} vs rest")
        ax.legend()
        fpath = out_dir / f"{prefix}_{site}.png"
        fig.savefig(fpath, dpi=120)
        plt.close(fig)
        paths.append(fpath)
    return paths


def trace_report(
    model,
    tokens: np.ndarray,
    grid: tuple[int, int],
    *,
    channel: int | None = None,
    out_dir: pathlib.Path | None = None,
) -> dict:
    """End-to-end: trace sites -> locate/trace the pathological channel ->
    LayerNorm weights report -> (optionally) figures. Returns a JSON-able dict."""
    acts = trace_sites(model, tokens, grid)
    if channel is None:
        channel = find_bad_channel(acts)
    trace = channel_trace(acts, channel)
    ln = layernorm_weights(model, channel)
    report = {
        "channel": channel,
        "n_layers": trace.n_layers,
        "dominance_by_site": {
            site: trace.dominance(site).round(4).tolist() for site in SITES
        },
        "chan_mean": {s: trace.chan_mean[s].round(5).tolist() for s in SITES},
        "chan_absmax": {s: trace.chan_absmax[s].round(4).tolist() for s in SITES},
        "rest_mean": {s: trace.rest_mean[s].round(5).tolist() for s in SITES},
        "layernorm": {
            name: {k: v.round(5).tolist() for k, v in rows.items()}
            for name, rows in ln.items()
        },
    }
    if out_dir is not None:
        figs = plot_channel_trace(trace, out_dir)
        report["figures"] = [str(p) for p in figs]
    return report
