"""The port's channel trace (saev_tpu_torch.birdsong.trace) against contrib's
(contrib/birdsong/src/birdsong/trace.py), on the CPU, from the same numpy
params and tokens (the tiny ViT of tests/test_birdsong.py):

- `trace_report`'s numbers and `channel_trace`'s statistics within rtol
  1e-4 of contrib's (the two packages' float32 forwards differ in their last
  bits; a number rounded to 4 or 5 decimals may then round the other way,
  so the report's rounded numbers get one rounding step of slack);
- the planted channel found and dominant, a healthy model not dominated
  (tests/test_birdsong.py:236), the per-layer statistics from exactly their
  layer, the LayerNorm rows and the figures;
- the card's route (bf16 products with float32 results, modelled on the CPU
  by patching `modeling._bf16_operands`) within BF16_REL of the float32
  trace, the bound chip_smoke.py holds the card to.
"""

import pathlib
import sys
import types

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "contrib" / "birdsong" / "src"))

from birdsong import trace as jtrace  # noqa: E402

from saev_tpu.models import vit as jvit  # noqa: E402
from saev_tpu_torch.birdsong import trace  # noqa: E402
from saev_tpu_torch.models import vit  # noqa: E402
from saev_tpu_torch.nn import modeling  # noqa: E402

RTOL = 1e-4
BF16_REL = 2e-2  # tests/test_torch_vit.py's bound for the card's route
SPEC = dict(d_model=32, n_layers=3, n_heads=4, patch_size=4, cls_token=False, pos_kind="learned")
GRID = (4, 4)


def _models(bad_channel: int | None = None):
    """The JAX package's tiny model and the port's, from the same params."""
    params = jax.tree.map(np.asarray, jvit.init(jvit.Spec(**SPEC), jax.random.key(0), n_pos=16))
    if bad_channel is not None:
        # A huge constant component entering the residual stream at embed,
        # as tests/test_birdsong.py plants it.
        b = params["patch_embed"]["b"].copy()
        b[bad_channel] = 50.0
        params["patch_embed"] = {**params["patch_embed"], "b": b}
    return (types.SimpleNamespace(spec=jvit.Spec(**SPEC), params=params),
            types.SimpleNamespace(spec=vit.Spec(**SPEC), params=vit.to_device(params, "cpu")))


def _tokens(n=2):
    return np.random.default_rng(0).normal(size=(n, 16, 3 * 4 * 4)).astype(np.float32)


def _close(got, want, atol: float) -> None:
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=RTOL, atol=atol)


@pytest.mark.parametrize("bad", [3, None])
def test_trace_report_matches_contrib(bad):
    jmodel, model = _models(bad)
    got = trace.trace_report(model, _tokens(), GRID)
    want = jtrace.trace_report(jmodel, _tokens(), GRID)
    assert sorted(got) == sorted(want) and got["channel"] == want["channel"] and got["n_layers"] == 3
    if bad is not None:
        assert got["channel"] == bad
    for key, digits in (("dominance_by_site", 4), ("chan_mean", 5), ("chan_absmax", 4), ("rest_mean", 5)):
        assert sorted(got[key]) == sorted(trace.SITES)
        for site in trace.SITES:
            _close(got[key][site], want[key][site], atol=10.0**-digits)
    for name in ("ln1", "ln2"):
        for k, v in want["layernorm"][name].items():
            assert got["layernorm"][name][k] == v


def test_channel_trace_matches_contrib():
    jmodel, model = _models(7)
    acts = trace.trace_sites(model, _tokens(), GRID)
    jacts = jtrace.trace_sites(jmodel, _tokens(), GRID)
    assert sorted(acts) == sorted(jacts) == sorted(trace.SITES)
    for site in trace.SITES:
        assert acts[site].shape == (2, 3, 16, 32) and acts[site].dtype == np.float32
        _close(acts[site], jacts[site], atol=1e-5)
    got, want = trace.channel_trace(acts, 7), jtrace.channel_trace(jacts, 7)
    for field in ("chan_mean", "chan_std", "rest_mean", "rest_std", "rest_absmean", "chan_absmax"):
        for site in trace.SITES:
            _close(getattr(got, field)[site], getattr(want, field)[site], atol=1e-6)
    for site in trace.SITES:
        _close(got.dominance(site), want.dominance(site), atol=1e-6)


def test_planted_channel_found_and_dominant():
    bad = 7
    _, model = _models(bad)
    acts = trace.trace_sites(model, _tokens(), GRID)
    assert trace.find_bad_channel(acts) == bad
    assert (trace.channel_trace(acts, bad).dominance("resid") > 10).all()
    _, healthy = _models()
    assert trace.channel_trace(trace.trace_sites(healthy, _tokens(), GRID), bad).dominance("resid").max() < 10


def test_channel_trace_layer_axis_exact():
    b, n_layers, t, d = 2, 3, 5, 8
    acts = np.random.default_rng(0).normal(size=(b, n_layers, t, d)).astype(np.float32)
    ch = 4
    for layer in range(n_layers):
        acts[:, layer, :, ch] = 10.0 * (layer + 1)
    tr = trace.channel_trace({"resid": acts}, ch)
    np.testing.assert_allclose(tr.chan_mean["resid"], [10.0, 20.0, 30.0], rtol=1e-6)
    np.testing.assert_allclose(tr.chan_std["resid"], 0.0, atol=1e-5)
    assert np.abs(tr.rest_mean["resid"]).max() < 1.0


def test_layernorm_weights_take_tensors():
    jmodel, model = _models(3)
    got, want = trace.layernorm_weights(model, 3), jtrace.layernorm_weights(jmodel, 3)
    for name in ("ln1", "ln2"):
        for k in want[name]:
            assert np.array_equal(got[name][k], want[name][k])


def test_trace_report_figures(tmp_path):
    _, model = _models(3)
    report = trace.trace_report(model, _tokens(), GRID, out_dir=tmp_path)
    figs = [pathlib.Path(p) for p in report["figures"]]
    assert len(figs) == len(trace.SITES) and all(f.exists() for f in figs)


def test_card_route_within_bf16_rel(monkeypatch):
    """The card's route (bf16 operands, float32 results) modelled on the
    CPU: the trace's per-layer means and dominance within BF16_REL of the
    float32 trace's, and not equal to them (the route was taken)."""
    _, model = _models(5)
    want = trace.trace_report(model, _tokens(), GRID)
    monkeypatch.setattr(modeling, "_bf16_operands", lambda t: True)
    got = trace.trace_report(model, _tokens(), GRID)
    assert got["channel"] == 5
    taken = False
    for key in ("dominance_by_site", "chan_mean"):
        for site in trace.SITES:
            a, b = np.asarray(got[key][site]), np.asarray(want[key][site])
            err = np.linalg.norm(a - b) / np.linalg.norm(b)
            assert err <= BF16_REL, (key, site, err)
            taken |= err > 0
    assert taken
