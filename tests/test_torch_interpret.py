"""The port's interpretation layer (saev_tpu_torch.{colors,viz},
saev_tpu_torch.examples.inference, saev_tpu_torch.scripts.gradcam) against
the JAX package's (saev_tpu.{colors,viz}, examples/inference.py,
scripts/gradcam.py), on the CPU, from the same numpy inputs.

Tolerances:
- `add_highlights`: the same RGBA bytes, on the cases of tests/test_viz.py
  (out-of-range values, a transparent base, `upper` at and under the
  maximum); the port's plasma table is matplotlib's at every entry;
  `parse_color`, `load_palette`, the `colors` constants and the latent
  selectors: equal;
- `normalization_from_shards` on shards written by the JAX package: mean
  and scalar within 1e-6;
- `extract_features` on the fake backend: patch_acts, f_x and x_hat within
  rtol 1e-5 (atol 1e-5 of the tensor's largest magnitude, for entries near
  0), f_x with the same support;
- Grad-CAM: `compute_cam` within 1e-12; the score, the tap and the tap's
  gradient from torch autograd through `forward_from` within rtol 1e-5 of
  `jax.value_and_grad` through the JAX `forward_from`; `run` of both
  packages writes heatmaps within 1 LSB; so does the example's `run`.
"""

import importlib.util
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from saev_tpu import colors as jcolors
from saev_tpu import nn as jnn
from saev_tpu import viz as jviz
from saev_tpu.data import fake_vit as jfake
from saev_tpu.data import models as jmodels
from saev_tpu.models import families as jfamilies
from saev_tpu.models import vit as jvit
from saev_tpu.nn import modeling as jmod
from saev_tpu_torch import colors, viz
from saev_tpu_torch.data import fake_vit as tfake
from saev_tpu_torch.examples import inference
from saev_tpu_torch.models import families as tfamilies
from saev_tpu_torch.models import vit as tvit
from saev_tpu_torch.nn import modeling
from saev_tpu_torch.scripts import gradcam, vit_route

from conftest import _Helpers as helpers

ROOT = pathlib.Path(__file__).resolve().parent.parent
RTOL = 1e-5


def _load(relpath: str, name: str):
    """A file of the repo as a module, leaving sys.path as it was (the
    example and the scripts insert the repo's root)."""
    path = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(name, ROOT / relpath)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
    return mod


jinference = _load("examples/inference.py", "_jax_examples_inference")
jgradcam = _load("scripts/gradcam.py", "_jax_scripts_gradcam")


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-30))


def _same_pixels(a: pathlib.Path, b: pathlib.Path, lsb: int = 0) -> None:
    x, y = np.asarray(Image.open(a)), np.asarray(Image.open(b))
    assert x.shape == y.shape and x.dtype == y.dtype == np.uint8, (x.shape, y.shape)
    diff = int(np.abs(x.astype(np.int16) - y.astype(np.int16)).max())
    assert diff <= lsb, diff


# ---------------------------------------------------------------------------
# viz and colors
# ---------------------------------------------------------------------------


def _highlight_case(name: str):
    """(img, patches, patch_size, kwargs) of tests/test_viz.py's cases."""
    rng = np.random.default_rng(3)
    if name == "linspace":
        return Image.new("RGB", (32, 32), (255, 255, 255)), np.linspace(0, 1, 16), 8, dict(upper=1.0)
    if name in ("oracle", "upper-at-max", "upper-under-max"):
        img = Image.fromarray(rng.integers(0, 256, (24, 40, 3), dtype=np.uint8))
        patches = rng.uniform(0, 2.0, size=(15,))
        upper = {"oracle": 2.0, "upper-at-max": patches.max(), "upper-under-max": 0.6 * patches.max()}[name]
        return img, patches, 8, dict(upper=upper, opacity=0.7)
    if name == "out-of-range":
        return Image.new("RGB", (16, 8), (0, 0, 0)), np.array([1.5, -0.5]), 8, dict(upper=1.0, opacity=1.0)
    if name == "transparent":
        return Image.new("RGBA", (16, 8), (10, 20, 30, 0)), np.array([0.8, 0.3]), 8, dict(upper=1.0, opacity=0.9)
    if name == "rgba-base":
        img = Image.fromarray(rng.integers(0, 256, (16, 24, 4), dtype=np.uint8), "RGBA")
        return img, rng.normal(size=(6,)), 8, dict(upper=1.0, opacity=0.5)
    raise ValueError(name)


@pytest.mark.parametrize(
    "case", ["linspace", "oracle", "upper-at-max", "upper-under-max", "out-of-range", "transparent", "rgba-base"]
)
def test_add_highlights_same_bytes_as_jax(case):
    img, patches, ps, kw = _highlight_case(case)
    got = viz.add_highlights(img, patches, ps, **kw)
    want = jviz.add_highlights(img, patches, ps, **kw)
    assert got.mode == want.mode == "RGBA" and got.size == want.size
    assert np.asarray(got).tobytes() == np.asarray(want).tobytes()


def test_add_highlights_empty_returns_the_image():
    img = Image.new("RGB", (16, 16))
    assert viz.add_highlights(img, np.zeros(0), 8) is img


def test_plasma_table_is_matplotlibs():
    import matplotlib

    cmap = matplotlib.colormaps["plasma"]
    assert viz.PLASMA.shape == (cmap.N, 3)
    assert np.array_equal(viz.PLASMA, cmap(np.arange(cmap.N))[:, :3])
    x = np.concatenate([np.linspace(-0.5, 1.5, 4001), [0.0, 1.0, 255 / 256, np.nextafter(1.0, 0.0), np.nan, 1e30]])
    assert np.array_equal(viz.colormap(x), cmap(x))


@pytest.mark.parametrize(
    "line", ["#ff0000", "#00ff00", "rgb(255, 0, 0)", "rgb(0.5, 0.5, 0.5)", "  #0000ff  ", "RGB(128, 64, 32)",
             "", "#ff00", "notacolor", "rgb(1,2)", "rgb(-1, 0, 0)", "rgb(300, 0, 0)", "rgb (1, 1, 1)"],
)
def test_parse_color_matches_jax(line):
    def parse(mod):
        try:
            return mod.parse_color(line)
        except AssertionError as err:
            return ("AssertionError", str(err))

    assert parse(viz) == parse(jviz)


def test_load_palette_matches_jax(tmp_path):
    f = tmp_path / "palette.txt"
    f.write_text("#ff0000\n\n#0000ff\nrgb(10, 20, 30)\n\n\n")
    assert viz.load_palette(f) == jviz.load_palette(f)


def test_colors_match_jax():
    names = sorted(n for n in dir(jcolors) if n.isupper())
    assert names == sorted(n for n in dir(colors) if n.isupper()) and len(names) == 32
    for n in names:
        assert getattr(colors, n) == getattr(jcolors, n), n


# ---------------------------------------------------------------------------
# The inference example
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 5, 64])
def test_selectors_match_jax(k):
    rng = np.random.default_rng(4)
    f_x = np.maximum(rng.normal(size=(256, 64)), 0).astype(np.float32) * (rng.random((256, 64)) < 0.2)
    for name in ("variance", "max", "filtered"):
        fn = f"select_top_latents_by_{name}" if name != "filtered" else "select_top_latents_filtered"
        got, want = getattr(inference, fn)(f_x, k=k), getattr(jinference, fn)(f_x, k=k)
        assert got.tolist() == want.tolist(), name
    assert inference.select_top_latents_filtered(f_x, k=k).size > 0


def test_normalization_from_shards_matches_jax(tmp_path):
    shards_dir = helpers.write_shards(tmp_path, n_examples=6, layers=(0, 1))
    for layer in (0, 1):
        mean, scalar = inference.normalization_from_shards(shards_dir, layer)
        jmean, jscalar = jinference.normalization_from_shards(shards_dir, layer)
        assert mean.dtype == jmean.dtype == np.float32
        np.testing.assert_allclose(mean, jmean, rtol=1e-6, atol=1e-6)
        assert abs(scalar - jscalar) <= 1e-6 * abs(jscalar)


def _fake_models():
    jparams = jfake._make_params(0)
    jm = jmodels.load_model_cls("fake-clip")(jfake.CKPT)
    tm = tfake.Vit(tfake.CKPT, params=jax.tree.map(np.asarray, jparams), device="cpu")
    jm._content_tokens = tm._content_tokens = jfake.N_PATCHES
    return jm, tm


def _sae(d_model: int, d_sae: int, top_k: int, seed: int):
    jcfg = jmod.SparseAutoencoderConfig(d_model=d_model, d_sae=d_sae, activation=jmod.TopK(top_k=top_k))
    tcfg = modeling.SparseAutoencoderConfig(d_model=d_model, d_sae=d_sae, activation=modeling.TopK(top_k=top_k))
    jparams, jstate = jmod.init(jcfg, jax.random.key(seed))
    rng = np.random.default_rng(seed)
    # Nonzero biases, so that both are exercised.
    jparams = {k: np.asarray(v) + (0.05 * rng.normal(size=np.shape(v))).astype(np.float32) * k.startswith("b")
               for k, v in jparams.items()}
    tparams = modeling.params_from_numpy(jparams, "cpu")
    return (jcfg, jparams, jstate), (tcfg, tparams, modeling.init_state(tcfg, "cpu"))


@pytest.mark.parametrize("normalize", [False, True])
def test_extract_features_matches_jax(tmp_path, normalize):
    jm, tm = _fake_models()
    (jcfg, jparams, jstate), (tcfg, tparams, tstate) = _sae(jfake.D_MODEL, 64, 4, seed=5)
    (jtr, _), (ttr, _) = jm.make_transforms(jfake.CKPT, 16), tm.make_transforms(tfake.CKPT, 16)
    rng = np.random.default_rng(6)
    img = Image.fromarray(rng.integers(0, 256, (20, 28, 3), dtype=np.uint8))
    norm = None
    if normalize:
        norm = (rng.normal(size=jfake.D_MODEL).astype(np.float32), 1.7)
    got = inference.extract_features(tm, tcfg, tparams, tstate, img, ttr, 1, norm)
    want = jinference.extract_features(jm, jcfg, jparams, jstate, img, jtr, 1, norm)
    for name, g, w in zip(("patch_acts", "f_x", "x_hat"), got, want):
        assert g.shape == np.shape(w), name
        _close(g, w)
    assert np.array_equal(got[1] != 0, np.asarray(want[1]) != 0)
    assert got[1].shape == (16, 64) and ((got[1] != 0).sum(axis=1) == 4).all()


def test_demo_writes_three_heatmaps(tmp_path):
    paths = inference.demo(inference.DemoConfig(out=tmp_path / "demo", device="cpu"))
    assert len(paths) == 3 and sorted(tmp_path.joinpath("demo").iterdir()) == sorted(paths)
    for p in paths:
        img = Image.open(p)
        assert img.mode == "RGBA" and img.size == (tfake.IMG_SIZE, tfake.IMG_SIZE)


# ---------------------------------------------------------------------------
# Grad-CAM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["gradcam", "gradcam++", "eigencam"])
def test_compute_cam_matches_jax(method):
    rng = np.random.default_rng(0)
    acts = rng.normal(size=(16, 8))
    grads = rng.normal(size=(16, 8))
    got, want = gradcam.compute_cam(acts, grads, method), jgradcam.compute_cam(acts, grads, method)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert got.shape == (16,) and got.min() >= 0 and got.max() <= 1.0 + 1e-9


# tests/test_gradcam.py's spec: 3 blocks of width 32, 4 heads, 16 patches of 4 x 4.
GRADCAM_SPEC = dict(d_model=32, n_layers=3, n_heads=4, patch_size=4, pos_kind="learned")


def _randomize(tree, rng):
    """LayerNorm gains near 1 and small random biases everywhere: with the
    identity LayerNorms of `init`, the final norm's output has a constant
    norm and target -1's gradient would be rounding noise."""
    if isinstance(tree, list):
        return [_randomize(v, rng) for v in tree]
    if isinstance(tree, dict):
        return {k: _randomize(v, rng) if isinstance(v, (dict, list)) else _leaf(k, v, rng) for k, v in tree.items()}
    return tree


def _leaf(key, v, rng):
    v = np.asarray(v, np.float32)
    if key == "g":
        return (1.0 + 0.2 * rng.normal(size=v.shape)).astype(np.float32)
    if key == "b":
        return (0.1 * rng.normal(size=v.shape)).astype(np.float32)
    return v


@pytest.mark.parametrize("layer,target", [(0, -1), (1, -1), (0, 5), (1, 17)])
def test_gradcam_gradient_matches_jax(layer, target):
    jspec, tspec = jvit.Spec(**GRADCAM_SPEC), tvit.Spec(**GRADCAM_SPEC)
    jparams = _randomize(jax.tree.map(np.asarray, jvit.init(jspec, jax.random.key(2), n_pos=17)),
                         np.random.default_rng(2))
    tparams = tvit.to_device(jparams, "cpu")
    tokens = np.random.default_rng(3).normal(size=(1, 16, 48)).astype(np.float32)
    grid = (4, 4)

    def jscore(tap):
        out = jvit.forward_from(jspec, jparams, tap[:, 0], layer, grid=grid)
        pooled = out[0, 0, :]
        return pooled[target] if target >= 0 else jnp.linalg.norm(pooled)

    _, jtaps = jax.jit(lambda t: jvit.forward(jspec, jparams, t, (layer,), grid=grid))(jnp.asarray(tokens))
    jvalue, jgrads = jax.jit(jax.value_and_grad(jscore))(jtaps)
    value, taps, grads = gradcam.value_and_grad(tspec, tparams, torch.from_numpy(tokens), layer, grid, target)
    assert abs(value - float(jvalue)) <= RTOL * abs(float(jvalue))
    _close(taps.numpy(), jtaps)
    _close(grads.numpy(), jgrads)
    assert np.abs(grads.numpy()[0, 0, 1:]).max() > 0


# The card's route (bf16 operands with float32 results) against the float32
# one: the tap gradient's rel-norm, from the same tap. chip_smoke.py holds the
# card to the same bound at CLIP ViT-L/14's width (its GRADCAM_REL).
GRADCAM_REL = 2e-2


@pytest.mark.parametrize("layer,target", [(0, -1), (1, 17)])
def test_gradcam_card_route_has_a_bf16_backward(monkeypatch, layer, target):
    """With `modeling._bf16_operands` patched to True (the card's route on
    the CPU, `_mm_bf16`'s plain version), `forward_from`'s dense products
    run forward and backward as bf16 products through `modeling._Matmul`
    (`torch.mm(..., out_dtype=)`, which the route used before, has no
    derivative), and the tap gradient lies within GRADCAM_REL of the float32
    gradient from the same tap, and not on it."""
    tspec = tvit.Spec(**GRADCAM_SPEC)
    jparams = _randomize(jax.tree.map(np.asarray, jvit.init(jvit.Spec(**GRADCAM_SPEC), jax.random.key(4), n_pos=17)),
                         np.random.default_rng(4))
    tparams = tvit.to_device(jparams, "cpu")
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(1, 16, 48)).astype(np.float32))
    taps = gradcam.tap(tspec, tparams, x, layer, (4, 4), "highest")
    (want,) = torch.autograd.grad(gradcam.score(tspec, tparams, taps, layer, (4, 4), target, "highest"), taps)
    seen = []
    real = modeling._mm_bf16

    def spy(a, b):
        seen.append(torch.is_grad_enabled())
        return real(a, b)

    monkeypatch.setattr(modeling, "_bf16_operands", lambda t: True)
    monkeypatch.setattr(modeling, "_mm_bf16", spy)
    s = gradcam.score(tspec, tparams, taps, layer, (4, 4), target, "default")
    n_forward = len(seen)
    (got,) = torch.autograd.grad(s, taps)
    blocks = tspec.n_layers - layer - 1
    assert n_forward == 4 * blocks and len(seen) == 8 * blocks
    err = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
    assert 1e-6 < err <= GRADCAM_REL, err


def _tiny_clip(monkeypatch, tmp_path: pathlib.Path) -> str:
    """A 2-block CLIP of width 64 on 16 x 16 images (4 x 4 patches of 4),
    registered as preset "tiny" in both packages, from one random OpenCLIP
    checkpoint file. Returns its ckpt string."""
    kw = dict(d_model=64, n_layers=2, n_heads=4, patch_size=4, act="quick_gelu", pre_norm=True, ln_eps=1e-5,
              pos_kind="learned")
    monkeypatch.setitem(jfamilies.CLIP_PRESETS, "tiny", jfamilies.Preset(
        jvit.Spec(**kw), 16, 16, jfamilies.OPENAI_MEAN, jfamilies.OPENAI_STD, "openclip"))
    monkeypatch.setitem(tfamilies.CLIP_PRESETS, "tiny", tfamilies.Preset(
        tvit.Spec(**kw), 16, 16, tfamilies.OPENAI_MEAN, tfamilies.OPENAI_STD, "openclip"))
    sd = vit_route.openclip_state_dict(tvit.Spec(**kw), torch.Generator().manual_seed(7), 17)
    torch.save({k.removeprefix("visual."): v for k, v in sd.items()}, tmp_path / "tiny.pt")
    return f"tiny={tmp_path / 'tiny.pt'}"


def _image(tmp_path: pathlib.Path, seed: int = 8) -> pathlib.Path:
    rng = np.random.default_rng(seed)
    fpath = tmp_path / "image.png"
    Image.fromarray(rng.integers(0, 256, (20, 24, 3), dtype=np.uint8)).save(fpath)
    return fpath


@pytest.mark.parametrize("method,target", [("gradcam", -1), ("gradcam++", 3), ("eigencam", -1)])
def test_gradcam_run_matches_jax(monkeypatch, tmp_path, method, target):
    ckpt = _tiny_clip(monkeypatch, tmp_path)
    kw = dict(family="clip", ckpt=ckpt, image_path=_image(tmp_path), layer=-2, content_tokens=16,
              method=method, target=target)
    got = gradcam.run(gradcam.Args(**kw, out=tmp_path / "cam.png", device="cpu"))
    jgradcam.run(jgradcam.Args(**kw, out=tmp_path / "jcam.png"))
    _same_pixels(tmp_path / "cam.png", tmp_path / "jcam.png", lsb=1)
    assert got["cam"].shape == (16,) and np.isfinite(got["grads"]).all() and np.abs(got["grads"]).max() > 0


def test_example_run_matches_jax(monkeypatch, tmp_path):
    ckpt = _tiny_clip(monkeypatch, tmp_path)
    jcfg = jmod.SparseAutoencoderConfig(d_model=64, d_sae=48, activation=jmod.TopK(top_k=4))
    jparams, jstate = jmod.init(jcfg, jax.random.key(9))
    jnn.dump(tmp_path / "sae.pt", jcfg, jparams, jstate)
    kw = dict(sae_ckpt=tmp_path / "sae.pt", family="clip", ckpt=ckpt, layer=-2, content_tokens=16,
              image=_image(tmp_path, 10), k=3, select="max")
    got = inference.run(inference.RunConfig(**kw, out=tmp_path / "port", device="cpu"))
    jinference.run(jinference.RunConfig(**kw, out=tmp_path / "jax"))
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert sorted(p.name for p in got["paths"]) == names and len(names) == 3
    for name in names:
        _same_pixels(tmp_path / "port" / name, tmp_path / "jax" / name, lsb=1)
