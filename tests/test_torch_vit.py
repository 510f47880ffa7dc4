"""The port's ViT engine, converters, families and transforms
(saev_tpu_torch.models, saev_tpu_torch.data.{models,transforms}) against the
JAX package's (saev_tpu.models, saev_tpu.data), from the same numpy inputs,
JAX on the CPU.

Tolerances:
- forwards (taps and x_out, every site, forward_from): rtol 2e-4, atol 2e-5,
  as tests/test_models_vit.py holds the JAX engine to torch models; both run
  float32 products here;
- the numpy tables, converters, transforms and the Bird-MAE filterbank are
  copies of the JAX package's numpy code: exactly equal (the filterbank also
  within 1e-6, as the port's contract states it); the position table's
  bicubic resize is the JAX package's Pillow resize bit for bit, and loads
  with Pillow blocked;
- the card's route (bf16 operands, `modeling._bf16_operands` patched to True
  on the CPU, attention's plain version) against the float32 forward: the
  bound `BF16_REL`, which chip_smoke.py holds the card to.
"""

import dataclasses
import pathlib

import jax
import numpy as np
import pytest
import torch

from saev_tpu.data import models as jmodels
from saev_tpu.data import transforms as jtransforms
from saev_tpu.models import bird_mae as jbird
from saev_tpu.models import convert as jconvert
from saev_tpu.models import dinov3 as jdinov3
from saev_tpu.models import families as jfamilies
from saev_tpu.models import vit as jvit
from saev_tpu_torch.data import models as tmodels
from saev_tpu_torch.data import transforms as ttransforms
from saev_tpu_torch.models import bird_mae as tbird
from saev_tpu_torch.models import convert as tconvert
from saev_tpu_torch.models import dinov3 as tdinov3
from saev_tpu_torch.models import families as tfamilies
from saev_tpu_torch.models import vit as tvit
from saev_tpu_torch.nn import modeling

RTOL, ATOL = 2e-4, 2e-5

# The card's route against the float32 forward: the relative norm of the
# difference over a whole tap tensor, block taps of the residual stream and
# Bird-MAE's norm2 taps alike. The CPU model of the route gives 2.6e-3 to
# 5.6e-3 on Bird-MAE's spec at widths 128 and 256 over 24 layers
# (`python -m saev_tpu_torch.scripts.vit_route`); chip_smoke.py holds the
# card to the same bound (its BF16_REL).
BF16_REL = 2e-2

D, HEADS = 64, 4

# Every Spec feature, at small sizes: (spec kwargs, grid, rope per example).
SPECS = {
    "openclip": (dict(act="quick_gelu", pre_norm=True, ln_eps=1e-5, pos_kind="learned", patch_size=4), (4, 4), False),
    "siglip": (dict(cls_token=False, act="gelu_tanh", pos_kind="learned", patch_size=4), (4, 4), False),
    "dinov2": (dict(n_registers=4, layerscale=True, mlp_kind="swiglu", mlp_ratio=8 / 3, pos_kind="learned",
                    patch_size=4), (4, 4), False),
    "dinov3": (dict(pos_kind="rope", n_registers=4, layerscale=True, mask_k_bias=True, ln_eps=1e-5,
                    patch_size=4), (4, 4), True),
    "pe": (dict(pos_kind="rope", rope_style="pe", rope_base=10000.0, rope_abs_pos=True, qk_norm=True,
                pre_norm=True, layerscale=True, ln_eps=1e-5, patch_size=4), (4, 4), False),
    "bird-mae": (dict(in_chans=1, patch_size=4, pos_kind="learned", tap_point="norm2"), (8, 2), False),
    "sincos2d": (dict(pos_kind="sincos2d", final_norm=False, patch_size=4), (2, 8), False),
}


def _specs(name: str, n_layers: int = 3):
    kw, grid, per_example = SPECS[name]
    kw = dict(kw, d_model=D, n_layers=n_layers, n_heads=HEADS)
    return jvit.Spec(**kw), tvit.Spec(**kw), grid, per_example


def _randomize(tree, rng):
    """Random LayerNorm gains and biases, biases and LayerScales, so that
    none of them is the identity the JAX `init` leaves."""
    if isinstance(tree, list):
        return [_randomize(v, rng) for v in tree]
    out = {}
    for k, v in tree.items():
        if isinstance(v, (dict, list)):
            out[k] = _randomize(v, rng)
            continue
        v = np.asarray(v, np.float32)
        if k == "g":
            v = 1.0 + 0.1 * rng.normal(size=v.shape)
        elif k == "b":
            v = 0.1 * rng.normal(size=v.shape)
        elif k in ("ls1", "ls2"):
            v = 0.5 + 0.1 * rng.normal(size=v.shape)
        out[k] = np.asarray(v, np.float32)
    return out


def _params(jspec, grid, seed=0):
    n_pos = grid[0] * grid[1] + jspec.n_prefix_tokens
    p = jax.tree.map(np.asarray, jvit.init(jspec, jax.random.PRNGKey(seed), n_pos=n_pos))
    return _randomize(p, np.random.default_rng(seed))


def _tokens(jspec, grid, b=3, seed=1):
    n = grid[0] * grid[1]
    d_in = jspec.in_chans * jspec.patch_size**2
    return np.random.default_rng(seed).normal(size=(b, n, d_in)).astype(np.float32)


def _rope(jspec, b, per_example):
    """Per-example (B, N, d_head) tables over two grids of 16 patches."""
    if not per_example:
        return None
    grids = [(2, 8), (4, 4), (8, 2)][:b]
    tabs = [jvit.rope_angles(jspec, *g) for g in grids]
    return np.stack([t[0] for t in tabs]), np.stack([t[1] for t in tabs])


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def _tree_equal(a, b, path="params"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            _tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _tree_equal(x, y, f"{path}[{i}]")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        assert np.array_equal(a, b), path


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SPECS))
def test_forward_matches_jax(name):
    """Taps (requested out of order, with a negative index) and x_out."""
    jspec, tspec, grid, per_example = _specs(name)
    params = _params(jspec, grid)
    tokens = _tokens(jspec, grid)
    rope = _rope(jspec, tokens.shape[0], per_example)
    layers = (-1, 0, 1)
    j_out, j_taps = jvit.forward(jspec, params, tokens, layers, grid=grid,
                                 rope_sincos=None if rope is None else tuple(map(np.asarray, rope)))
    t_out, t_taps = tvit.forward(tspec, tvit.to_device(params, "cpu"), torch.from_numpy(tokens), layers,
                                 grid=grid, rope_sincos=rope)
    assert t_taps.shape == (3, 3, tokens.shape[1] + jspec.n_prefix_tokens, D)
    _close(t_taps, j_taps)
    _close(t_out, j_out)
    # Both precisions are float32 products on the CPU.
    _, h_taps = tvit.forward(tspec, tvit.to_device(params, "cpu"), torch.from_numpy(tokens), layers,
                             grid=grid, rope_sincos=rope, precision="highest")
    assert torch.equal(h_taps, t_taps)


@pytest.mark.parametrize("name", ["dinov2", "pe", "bird-mae"])
def test_run_matches_jax(name):
    """`run`: host tokens in, float32 numpy out, as the JAX package's."""
    jspec, tspec, grid, _ = _specs(name, n_layers=2)
    params = _params(jspec, grid, seed=2)
    tokens = _tokens(jspec, grid, seed=3)
    j_out, j_taps = jvit.run(jspec, params, tokens, (1, 0), grid)
    t_out, t_taps = tvit.run(tspec, tvit.to_device(params, "cpu"), tokens, (1, 0), grid)
    assert isinstance(t_taps, np.ndarray) and t_taps.dtype == np.float32
    _close(t_taps, j_taps)
    _close(t_out, j_out)


@pytest.mark.parametrize("name", ["openclip", "dinov3", "bird-mae"])
def test_forward_sites_matches_jax(name):
    jspec, tspec, grid, _ = _specs(name, n_layers=2)
    params = _params(jspec, grid, seed=4)
    tokens = _tokens(jspec, grid, seed=5)
    want = jvit.forward_sites(jspec, params, tokens, grid=grid)
    got = tvit.forward_sites(tspec, tvit.to_device(params, "cpu"), torch.from_numpy(tokens), grid=grid)
    assert sorted(got) == sorted(want) == sorted(tvit.SITE_NAMES)
    for site in tvit.SITE_NAMES:
        _close(got[site], want[site])


@pytest.mark.parametrize("name", ["openclip", "dinov3", "pe"])
def test_forward_from_matches_jax(name):
    jspec, tspec, grid, _ = _specs(name)
    params = _params(jspec, grid, seed=6)
    tokens = _tokens(jspec, grid, seed=7)
    _, j_taps = jvit.forward(jspec, params, tokens, (0,), grid=grid)
    x_tap = np.asarray(j_taps[:, 0])
    want = jvit.forward_from(jspec, params, x_tap, 0, grid=grid)
    got = tvit.forward_from(tspec, tvit.to_device(params, "cpu"), torch.from_numpy(np.array(x_tap)), 0, grid=grid)
    _close(got, want)
    # Continuing from a tap reproduces the whole forward's output.
    t_out, _ = tvit.forward(tspec, tvit.to_device(params, "cpu"), torch.from_numpy(tokens), (0,), grid=grid)
    _close(got, t_out)


def test_forward_from_carries_gradients():
    """forward_from is differentiable w.r.t. the tap (Grad-CAM's use)."""
    _, tspec, grid, _ = _specs("openclip")
    jspec = _specs("openclip")[0]
    params = tvit.to_device(_params(jspec, grid), "cpu")
    x = torch.randn(2, 17, D, requires_grad=True)
    tvit.forward_from(tspec, params, x, 0, grid=grid)[:, 0].sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all()) and float(x.grad.abs().sum()) > 0


def test_tables_match_jax():
    """The numpy tables are the JAX package's, bit for bit."""
    for d, gh, gw in ((64, 8, 32), (1024, 8, 32), (32, 3, 5)):
        assert np.array_equal(tvit.sincos_2d(d, gh, gw), jvit.sincos_2d(d, gh, gw))
    for name in ("dinov3", "pe"):
        jspec, tspec, _, _ = _specs(name)
        assert np.array_equal(tvit.rope_periods(tspec), jvit.rope_periods(jspec))
        for grid in ((4, 4), (2, 8), (3, 5)):
            for a, b in zip(tvit.rope_angles(tspec, *grid), jvit.rope_angles(jspec, *grid)):
                assert np.array_equal(a, b)
    periods = np.geomspace(1.0, 50.0, 4)
    for norm in ("min", "max", "separate"):
        for a, b in zip(tvit.rope_sincos_from_periods(periods, 3, 6, norm),
                        jvit.rope_sincos_from_periods(periods, 3, 6, norm)):
            assert np.array_equal(a, b)
    minmax = dataclasses.replace(_specs("dinov3")[1], rope_min_period=0.5, rope_max_period=40.0)
    jminmax = dataclasses.replace(_specs("dinov3")[0], rope_min_period=0.5, rope_max_period=40.0)
    assert np.array_equal(tvit.rope_periods(minmax), jvit.rope_periods(jminmax))


@pytest.mark.parametrize("per_example", [False, True])
def test_apply_rope_matches_jax(per_example):
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 4, 21, 16)).astype(np.float32)
    shape = (2, 16, 16) if per_example else (16, 16)
    sin, cos = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    want = jvit.apply_rope(x, sin, cos, 5)
    got = tvit.apply_rope(*(torch.from_numpy(a) for a in (x, sin, cos)), 5)
    _close(got, want)
    assert torch.equal(got[:, :, :5], torch.from_numpy(x[:, :, :5]))


def test_interpolate_pos_matches_jax():
    pos = np.random.default_rng(9).normal(size=(1 + 16, 8)).astype(np.float32)
    assert tvit.interpolate_pos(pos, 1, (4, 4), (4, 4)) is pos
    assert np.array_equal(tvit.interpolate_pos(pos, 1, (4, 4), (6, 5)),
                          jvit.interpolate_pos(pos, 1, (4, 4), (6, 5)))


# (grid_from, grid_to, channels): DINOv2's 37 x 37 table onto the 224-px
# presets' 16 x 16 grid at ViT-L's width, an upscale, a non-square target,
# and grids of one row.
RESIZES = {
    "dinov2-37-to-16": ((37, 37), (16, 16), 1024),
    "upscale": ((16, 16), (37, 37), 8),
    "non-square": ((37, 37), (24, 40), 16),
    "one-row": ((1, 8), (3, 5), 8),
    "one-row-to-one-row": ((1, 8), (1, 5), 8),
}


@pytest.mark.parametrize("name", sorted(RESIZES))
def test_interpolate_pos_is_pillow_bit_for_bit(name):
    """The port's numpy resize against the JAX package's Pillow one, on
    entries over six decades."""
    grid_from, grid_to, d = RESIZES[name]
    rng = np.random.default_rng(10)
    pos = (rng.normal(size=(1 + grid_from[0] * grid_from[1], d))
           * rng.choice([1e-3, 1.0, 1e3], size=(1, d))).astype(np.float32)
    got = tvit.interpolate_pos(pos, 1, grid_from, grid_to)
    want = jvit.interpolate_pos(pos, 1, grid_from, grid_to)
    assert got.dtype == want.dtype == np.float32 and got.shape == (1 + grid_to[0] * grid_to[1], d)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


NO_PILLOW = r"""
import dataclasses, importlib.abc, sys
import numpy as np, torch

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("PIL", "jax", "saev_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
from saev_tpu_torch.models import families, vit
from saev_tpu_torch.scripts import vit_route

ckpt, out = sys.argv[1], sys.argv[2]
name = "dinov2_vits14_reg"
spec = dataclasses.replace(families.DINOV2_PRESETS[name].spec, d_model=32, n_layers=1, n_heads=2)
families.DINOV2_PRESETS[name] = dataclasses.replace(families.DINOV2_PRESETS[name], spec=spec)
torch.save(vit_route.dinov2_state_dict(spec, torch.Generator().manual_seed(3), 1 + 37 * 37), ckpt)
model = families.Dinov2(f"{name}={ckpt}", device="cpu")
np.save(out, model.params["pos"].numpy())
assert "PIL" not in sys.modules
"""


def test_dinov2_loads_without_pillow(tmp_path):
    """`families.Dinov2` loads a checkpoint with DINOv2's 1 + 37 x 37 table
    onto the 16 x 16 grid with Pillow blocked from import (the card's
    machine has none): the JAX package's Pillow resize of the same table,
    bit for bit, with the registers' zero entries after CLS."""
    import subprocess
    import sys

    ckpt, out = tmp_path / "dinov2.pt", tmp_path / "pos.npy"
    root = pathlib.Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", NO_PILLOW, str(ckpt), str(out)], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    table = torch.load(ckpt)["pos_embed"].numpy().reshape(1 + 37 * 37, 32)
    want = jvit.interpolate_pos(table, 1, (37, 37), (16, 16))
    want = np.concatenate([want[:1], np.zeros((4, 32), np.float32), want[1:]])
    got = np.load(out)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_init_has_the_jax_layout():
    """The port's random init builds the JAX `init`'s tree: keys and shapes."""
    for name in sorted(SPECS):
        jspec, tspec, grid, _ = _specs(name, n_layers=2)
        n_pos = grid[0] * grid[1] + jspec.n_prefix_tokens
        want = jax.tree.map(lambda a: np.zeros(a.shape, np.float32),
                            jvit.init(jspec, jax.random.PRNGKey(0), n_pos=n_pos))
        got = tvit.init(tspec, torch.Generator().manual_seed(0), n_pos=n_pos)
        _tree_equal(jax.tree.map(lambda a: np.zeros(a.shape, np.float32), got,
                                 is_leaf=lambda a: isinstance(a, torch.Tensor)), want)


def test_to_device_carries_jax_arrays():
    jspec, tspec, grid, _ = _specs("openclip", n_layers=1)
    jparams = jvit.init(jspec, jax.random.PRNGKey(1), n_pos=17)
    t = tvit.to_device(jparams, "cpu")
    assert t["blocks"][0]["attn"]["qkv"]["w"].dtype == torch.float32
    _tree_equal(jax.tree.map(np.asarray, jparams),
                jax.tree.map(lambda a: a.numpy(), t, is_leaf=lambda a: isinstance(a, torch.Tensor)))


def test_precision_is_checked():
    jspec, tspec, grid, _ = _specs("openclip", n_layers=1)
    params = tvit.to_device(_params(jspec, grid), "cpu")
    with pytest.raises(ValueError, match="precision"):
        tvit.forward(tspec, params, torch.zeros(1, 16, 48), (0,), grid=grid, precision="high")


# ---------------------------------------------------------------------------
# The card's route, modelled on the CPU
# ---------------------------------------------------------------------------


def _route_error(monkeypatch, name: str, n_layers: int, seed: int = 10) -> float:
    jspec, tspec, grid, _ = _specs(name, n_layers=n_layers)
    params = tvit.to_device(_params(jspec, grid, seed=seed), "cpu")
    tokens = torch.from_numpy(_tokens(jspec, grid, b=4, seed=seed + 1))
    layers = tuple(range(n_layers))
    _, f32 = tvit.forward(tspec, params, tokens, layers, grid=grid, precision="highest")
    with monkeypatch.context() as m:
        seen = []
        real = modeling._mm_bf16

        def spy(a, b):
            seen.append(a.shape)
            return real(a, b)

        m.setattr(modeling, "_bf16_operands", lambda t: True)
        m.setattr(modeling, "_mm_bf16", spy)
        _, b16 = tvit.forward(tspec, params, tokens, layers, grid=grid)
        # 4 products a block (qkv, proj, fc1, fc2) and the patch embedding.
        assert len(seen) == 4 * n_layers + 1
        _, f32_again = tvit.forward(tspec, params, tokens, layers, grid=grid, precision="highest")
    assert torch.equal(f32_again, f32)
    return float(torch.linalg.vector_norm(b16 - f32) / torch.linalg.vector_norm(f32))


@pytest.mark.parametrize("name,n_layers", [
    ("openclip", 3), ("dinov3", 3), ("bird-mae", 3), ("bird-mae", 24), ("openclip", 24),
])
def test_bf16_route_error(monkeypatch, name, n_layers):
    """bf16 operands with float32 results, and attention's plain version on
    bf16 q, k, v and probabilities, against the float32 forward: within the
    bound chip_smoke.py holds the card to, and not equal to it (the route
    was taken)."""
    err = _route_error(monkeypatch, name, n_layers)
    assert 1e-5 < err <= BF16_REL, err


# ---------------------------------------------------------------------------
# Converters: the same state dict gives exactly the JAX package's tree
# ---------------------------------------------------------------------------


def _rand(rng, *shape):
    """Normal entries at a checkpoint's scale: 1/sqrt(fan-in) for a matrix or
    a conv kernel, 0.1 for a vector."""
    fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else 100
    return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)


def _timm_sd(rng, d, n_layers, *, p=4, c=3, n_patches=16, cls=True, reg=0, swiglu=None,
             qk_norm=False, ls="gamma", pre=None, prefix=""):
    sd = {
        "patch_embed.proj.weight": _rand(rng, d, c, p, p),
        "patch_embed.proj.bias": _rand(rng, d),
        "pos_embed": _rand(rng, 1, n_patches + int(cls), d),
        "norm.weight": _rand(rng, d),
        "norm.bias": _rand(rng, d),
    }
    if cls:
        sd["cls_token"] = _rand(rng, 1, 1, d)
    if reg:
        sd["register_tokens"] = _rand(rng, 1, reg, d)
    if pre:
        sd[f"{pre}.weight"], sd[f"{pre}.bias"] = _rand(rng, d), _rand(rng, d)
    for i in range(n_layers):
        b = f"blocks.{i}"
        for name, shape in (("norm1", (d,)), ("norm2", (d,))):
            sd[f"{b}.{name}.weight"], sd[f"{b}.{name}.bias"] = _rand(rng, *shape), _rand(rng, *shape)
        sd[f"{b}.attn.qkv.weight"], sd[f"{b}.attn.qkv.bias"] = _rand(rng, 3 * d, d), _rand(rng, 3 * d)
        sd[f"{b}.attn.proj.weight"], sd[f"{b}.attn.proj.bias"] = _rand(rng, d, d), _rand(rng, d)
        if swiglu == "w12":
            sd[f"{b}.mlp.w12.weight"], sd[f"{b}.mlp.w12.bias"] = _rand(rng, 2 * 2 * d, d), _rand(rng, 4 * d)
            sd[f"{b}.mlp.w3.weight"], sd[f"{b}.mlp.w3.bias"] = _rand(rng, d, 2 * d), _rand(rng, d)
        elif swiglu == "w1w2":
            for w in ("w1", "w2"):
                sd[f"{b}.mlp.{w}.weight"], sd[f"{b}.mlp.{w}.bias"] = _rand(rng, 2 * d, d), _rand(rng, 2 * d)
            sd[f"{b}.mlp.w3.weight"], sd[f"{b}.mlp.w3.bias"] = _rand(rng, d, 2 * d), _rand(rng, d)
        else:
            sd[f"{b}.mlp.fc1.weight"], sd[f"{b}.mlp.fc1.bias"] = _rand(rng, 4 * d, d), _rand(rng, 4 * d)
            sd[f"{b}.mlp.fc2.weight"], sd[f"{b}.mlp.fc2.bias"] = _rand(rng, d, 4 * d), _rand(rng, d)
        if qk_norm:
            for n in ("q_norm", "k_norm"):
                sd[f"{b}.attn.{n}.weight"], sd[f"{b}.attn.{n}.bias"] = _rand(rng, d // HEADS), _rand(rng, d // HEADS)
        if ls:
            sd[f"{b}.ls1.{ls}"], sd[f"{b}.ls2.{ls}"] = _rand(rng, d), _rand(rng, d)
    return {prefix + k: v for k, v in sd.items()}


def _openclip_sd(rng, d, n_layers, p=4, n_patches=16, prefix="visual."):
    sd = {
        "conv1.weight": _rand(rng, d, 3, p, p),
        "class_embedding": _rand(rng, d),
        "positional_embedding": _rand(rng, n_patches + 1, d),
    }
    for name in ("ln_pre", "ln_post"):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = _rand(rng, d), _rand(rng, d)
    for i in range(n_layers):
        b = f"transformer.resblocks.{i}"
        for name in ("ln_1", "ln_2"):
            sd[f"{b}.{name}.weight"], sd[f"{b}.{name}.bias"] = _rand(rng, d), _rand(rng, d)
        sd[f"{b}.attn.in_proj_weight"], sd[f"{b}.attn.in_proj_bias"] = _rand(rng, 3 * d, d), _rand(rng, 3 * d)
        sd[f"{b}.attn.out_proj.weight"], sd[f"{b}.attn.out_proj.bias"] = _rand(rng, d, d), _rand(rng, d)
        sd[f"{b}.mlp.c_fc.weight"], sd[f"{b}.mlp.c_fc.bias"] = _rand(rng, 4 * d, d), _rand(rng, 4 * d)
        sd[f"{b}.mlp.c_proj.weight"], sd[f"{b}.mlp.c_proj.bias"] = _rand(rng, d, 4 * d), _rand(rng, d)
    return {prefix + k: v for k, v in sd.items()}


def _copy(sd):
    return {k: np.array(v) for k, v in sd.items()}


def test_from_openclip_matches_jax():
    jspec, tspec, _, _ = _specs("openclip", n_layers=2)
    sd = _openclip_sd(np.random.default_rng(11), D, 2)
    _tree_equal(tconvert.from_openclip(_copy(sd), tspec), jconvert.from_openclip(_copy(sd), jspec))


@pytest.mark.parametrize("case", ["siglip", "dinov2-reg", "dinov2-w12", "dinov2-w1w2", "pe-qknorm", "bird-mae"])
def test_from_timm_matches_jax(case):
    rng = np.random.default_rng(12)
    name, kw = {
        "siglip": ("siglip", dict(cls=False, ls=None, prefix="trunk.")),
        "dinov2-reg": ("dinov2", dict(reg=4, ls="gamma")),
        "dinov2-w12": ("dinov2", dict(swiglu="w12")),
        "dinov2-w1w2": ("dinov2", dict(swiglu="w1w2", ls="scale")),
        "pe-qknorm": ("pe", dict(qk_norm=True, pre="ln_pre")),
        "bird-mae": ("bird-mae", dict(c=1, n_patches=16, ls=None)),
    }[case]
    jspec, tspec, _, _ = _specs(name, n_layers=2)
    if name == "dinov2":
        jspec = dataclasses.replace(jspec, mlp_kind="swiglu" if "w" in case else "gelu", mlp_ratio=2.0)
        tspec = dataclasses.replace(tspec, mlp_kind=jspec.mlp_kind, mlp_ratio=2.0)
    sd = _timm_sd(rng, D, 2, **kw)
    got = tconvert.from_timm(_copy(sd), tspec)
    _tree_equal(got, jconvert.from_timm(_copy(sd), jspec))
    if name == "pe":
        assert np.array_equal(tconvert.interleave_to_halves(16), jconvert.interleave_to_halves(16))


@pytest.mark.parametrize("swiglu", [None, "w12", "w1w2"])
def test_dinov3_convert_encoder_matches_jax(swiglu):
    rng = np.random.default_rng(13)
    jspec = dataclasses.replace(jdinov3.PRETRAINED_SPECS["dinov3_vits16"], d_model=D, n_layers=2, n_heads=HEADS,
                                mlp_kind="swiglu" if swiglu else "gelu")
    tspec = tdinov3.PRETRAINED_SPECS["dinov3_vits16"]
    tspec = dataclasses.replace(tspec, d_model=D, n_layers=2, n_heads=HEADS, mlp_kind=jspec.mlp_kind)
    sd = _timm_sd(rng, D, 2, p=16, reg=0, swiglu=swiglu)
    sd["storage_tokens"] = _rand(rng, 1, 4, D)
    sd["rope_embed.periods"] = np.geomspace(1.0, 100.0, D // HEADS // 4).astype(np.float32)
    for i in range(2):
        mask = np.ones(3 * D, np.float32)
        mask[D:2 * D] = 0.0
        sd[f"blocks.{i}.attn.qkv.bias_mask"] = mask
    del sd["blocks.1.attn.qkv.bias"]  # zero-filled, as the 7B checkpoint needs
    _tree_equal(tdinov3.convert_encoder(_copy(sd), tspec), jdinov3.convert_encoder(_copy(sd), jspec))


def test_load_state_dict_matches_jax(tmp_path):
    sd = {"a.weight": torch.randn(3, 4), "b": torch.arange(5), "c": torch.randn(2).to(torch.bfloat16)}
    path = tmp_path / "w.pt"
    torch.save({"state_dict": {k: v for k, v in sd.items() if k != "c"}}, path)
    _tree_equal(tconvert.load_state_dict(path), jconvert.load_state_dict(path))
    torch.save({"model": sd}, tmp_path / "m.pth")
    got = tconvert.load_state_dict(tmp_path / "m.pth")
    assert got["c"].dtype == np.float32 and np.array_equal(got["c"], sd["c"].float().numpy())
    with pytest.raises(FileNotFoundError):
        tconvert.load_state_dict(tmp_path / "missing.bin")


# ---------------------------------------------------------------------------
# Families
# ---------------------------------------------------------------------------


def test_registry_lists_the_jax_families():
    assert sorted(tmodels.list_families()) == sorted(jmodels.list_families())
    for fam in tmodels.list_families():
        assert tmodels.load_model_cls(fam).family == fam
    with pytest.raises(ValueError):
        tmodels.load_model_cls("nope")


def test_presets_match_jax():
    for name in ("CLIP_PRESETS", "DINOV2_PRESETS", "SIGLIP_PRESETS", "PE_PRESETS"):
        jp, tp_ = getattr(jfamilies, name), getattr(tfamilies, name)
        assert sorted(jp) == sorted(tp_)
        for arch in jp:
            a, b = dataclasses.asdict(jp[arch]), dataclasses.asdict(tp_[arch])
            a["spec"].pop("rope_dtype")
            assert a == b, arch
    for jd, td in ((jdinov3.PRETRAINED_SPECS, tdinov3.PRETRAINED_SPECS), (jbird.PRETRAINED_SPECS, tbird.PRETRAINED_SPECS)):
        assert sorted(jd) == sorted(td)
        for k in jd:
            a, b = dataclasses.asdict(jd[k]), dataclasses.asdict(td[k])
            a.pop("rope_dtype")
            assert a == b, k


def test_resolve_weights_looks_where_jax_does(tmp_path, monkeypatch):
    from saev_tpu import helpers as jhelpers
    from saev_tpu_torch import helpers as thelpers

    for name in ("ViT-B-16/openai", 'a:b*c?"d<e>f|g h\\i', "hf-hub:org/modèle-ü", "dinov3_vitl16.pth"):
        assert thelpers.fssafe(name) == jhelpers.fssafe(name)
    for env in ({}, {"HF_HOME": "/h"}, {"HF_HUB_CACHE": "/c", "HF_HOME": ""}, {"SAEV_CACHE": "/s", "HF_HOME": "/h"}):
        for var in ("SAEV_CACHE", "HF_HOME", "HF_HUB_CACHE"):
            monkeypatch.delenv(var, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert thelpers.get_cache_dir() == jhelpers.get_cache_dir()
    monkeypatch.setenv("SAEV_CACHE", str(tmp_path))
    with pytest.raises(FileNotFoundError) as t_err:
        tfamilies.resolve_weights("clip", "ViT-B-16/openai")
    with pytest.raises(FileNotFoundError) as j_err:
        jfamilies.resolve_weights("clip", "ViT-B-16/openai")
    where = str(tmp_path / "saev_tpu" / "clip" / "ViT-B-16_openai.safetensors")
    assert where in str(t_err.value) and where in str(j_err.value)
    path = tmp_path / "saev_tpu" / "clip" / "ViT-B-16_openai.pt"
    path.parent.mkdir(parents=True)
    path.write_bytes(b"")
    assert tfamilies.resolve_weights("clip", "ViT-B-16/openai") == jfamilies.resolve_weights("clip", "ViT-B-16/openai")


def test_clip_family_from_a_checkpoint_matches_jax(tmp_path, monkeypatch):
    """A small OpenCLIP checkpoint through each package's Clip: the same
    arrangement of the position table, the same Recorder taps."""
    spec_kw = dict(d_model=D, n_layers=2, n_heads=HEADS, patch_size=4, act="quick_gelu", pre_norm=True,
                   ln_eps=1e-5, pos_kind="learned")
    monkeypatch.setitem(jfamilies.CLIP_PRESETS, "tiny", jfamilies.Preset(
        jvit.Spec(**spec_kw), 16, 16, jfamilies.OPENAI_MEAN, jfamilies.OPENAI_STD, "openclip"))
    monkeypatch.setitem(tfamilies.CLIP_PRESETS, "tiny", tfamilies.Preset(
        tvit.Spec(**spec_kw), 16, 16, tfamilies.OPENAI_MEAN, tfamilies.OPENAI_STD, "openclip"))
    sd = _openclip_sd(np.random.default_rng(14), D, 2, prefix="")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "tiny.pt")
    ckpt = f"tiny={tmp_path / 'tiny.pt'}"
    jm, tm = jfamilies.Clip(ckpt), tfamilies.Clip(ckpt, device="cpu")
    assert tm.params["blocks"][0]["mlp"]["fc1"]["w"].device.type == "cpu"
    tokens = np.random.default_rng(15).normal(size=(2, 16, 48)).astype(np.float32)
    for cls_token in (True, False):
        jr, tr = (jmodels.Recorder(jm, 16, cls_token, (1, 0)), tmodels.Recorder(tm, 16, cls_token, (1, 0)))
        (j_out, j_acts), (t_out, t_acts) = jr(tokens), tr(tokens)
        assert t_acts.shape == (2, 2, 16 + int(cls_token), D)
        _close(t_acts, j_acts)
        _close(t_out, j_out)


def test_dinov3_family_mixed_grids_matches_jax():
    """DINOv3's wrapper with params: host-built RoPE tables, one for each
    example's grid, and the register-skipping token selection."""
    jspec = dataclasses.replace(jdinov3.PRETRAINED_SPECS["dinov3_vits16"], d_model=D, n_layers=2, n_heads=HEADS)
    params = _params(jspec, (4, 4), seed=16)
    params.pop("pos", None)
    jm = object.__new__(jdinov3.Vit)
    jm._ckpt_path, jm._name, jm.spec, jm.params = "t", "dinov3_vits16", jspec, params
    jm.periods = jvit.rope_periods(jspec)
    tm = tdinov3.Vit("dinov3_vits16", params=params, device="cpu")
    tm.spec = dataclasses.replace(tm.spec, d_model=D, n_layers=2, n_heads=HEADS)
    tm.periods = tvit.rope_periods(tm.spec)
    tokens = np.random.default_rng(17).normal(size=(2, 16, 768)).astype(np.float32)
    for grid in (np.array([[2, 8], [4, 4]]), np.array([[4, 4], [4, 4]]), None):
        kw = {} if grid is None else {"grid": grid}
        jr, tr = jmodels.Recorder(jm, 16, True, (0, -1)), tmodels.Recorder(tm, 16, True, (0, -1))
        (j_out, j_acts), (t_out, t_acts) = jr(tokens, **kw), tr(tokens, **kw)
        assert t_acts.shape == (2, 2, 17, D)
        _close(t_acts, j_acts)
        _close(t_out, j_out)
    assert tdinov3.Vit._parse_name("dinov3_vitl16_pretrain_lvd1689m-8aa4cbdd.pth") == "dinov3_vitl16"


def test_family_transforms_match_jax():
    """make_transforms and make_resize of each image family on one image."""
    from PIL import Image

    rng = np.random.default_rng(18)
    img = Image.fromarray(rng.integers(0, 256, size=(300, 260, 3), dtype=np.uint8))
    for jcls, tcls, ckpt in ((jfamilies.Clip, tfamilies.Clip, "ViT-B-16/openai"),
                             (jfamilies.Siglip, tfamilies.Siglip, "ViT-B-16-SigLIP"),
                             (jfamilies.Dinov2, tfamilies.Dinov2, "dinov2_vits14_reg")):
        n = (jcls.presets[jcls._normalize_arch(ckpt)].grid[0]) ** 2
        (jt, _), (tt, _) = jcls.make_transforms(ckpt, n), tcls.make_transforms(ckpt, n)
        assert np.array_equal(tt(img), jt(img))
        for scale in (1.0, 0.5):
            jr = jcls.make_resize(ckpt, n, scale=scale, resample=Image.NEAREST)
            tr = tcls.make_resize(ckpt, n, scale=scale, resample="NEAREST")
            assert np.array_equal(np.asarray(tr(img)), np.asarray(jr(img)))
    (jt, js), (tt, ts) = jdinov3.Vit.make_transforms("x", 64), tdinov3.Vit.make_transforms("x", 64)
    jx, tx = jt(img), tt(img)
    assert np.array_equal(tx, jx)
    j_sample, t_sample = js({"data": jx}), ts({"data": tx})
    assert np.array_equal(t_sample["data"], j_sample["data"]) and np.array_equal(t_sample["grid"], j_sample["grid"])
    assert np.array_equal(np.asarray(tdinov3.Vit.make_resize("x", 64)(img)),
                          np.asarray(jdinov3.Vit.make_resize("x", 64)(img)))


# ---------------------------------------------------------------------------
# Bird-MAE's audio front end
# ---------------------------------------------------------------------------


def test_bird_mae_front_end_matches_jax():
    rng = np.random.default_rng(19)
    for n in (160_000, 100_000, 200_000):
        wav = (0.3 * rng.normal(size=n)).astype(np.float32)
        fb_t, fb_j = tbird.kaldi_fbank(wav), jbird.kaldi_fbank(wav)
        np.testing.assert_allclose(fb_t, fb_j, rtol=0, atol=1e-6)
        assert np.array_equal(fb_t, fb_j)
        tr_t, tr_j = tbird.transform(wav), jbird.transform(wav)
        assert tr_t.shape == (tbird.TARGET_T, tbird.N_MELS)
        np.testing.assert_allclose(tr_t, tr_j, rtol=0, atol=1e-6)
        tok_t, tok_j = tbird.spectrogram_to_tokens(tr_t), jbird.spectrogram_to_tokens(tr_j)
        assert tok_t.shape == (tbird.N_PATCHES, 256)
        assert np.array_equal(tok_t, tok_j)
    assert np.array_equal(tbird.pos_table(1024), jbird.pos_table(1024))


@pytest.mark.parametrize("mode", ["time", "time+freq"])
def test_bird_mae_filter_audio_matches_jax(mode):
    rng = np.random.default_rng(20)
    wav = rng.normal(size=tbird.SR_HZ * tbird.CLIP_SEC).astype(np.float32)
    patches = rng.random(tbird.N_PATCHES) < 0.1
    assert np.array_equal(tbird.filter_audio(wav, tbird.SR_HZ, patches, mode=mode),
                          jbird.filter_audio(wav, jbird.SR_HZ, patches, mode=mode))


def test_bird_mae_family_from_a_checkpoint_matches_jax(tmp_path, monkeypatch):
    """A small timm-layout Bird-MAE checkpoint through each package's
    Transformer: spectrograms in, norm2 taps out."""
    jspec = dataclasses.replace(jbird.PRETRAINED_SPECS["Bird-MAE-Base"], d_model=D, n_layers=2, n_heads=HEADS)
    tspec = dataclasses.replace(tbird.PRETRAINED_SPECS["Bird-MAE-Base"], d_model=D, n_layers=2, n_heads=HEADS)
    monkeypatch.setitem(jbird.PRETRAINED_SPECS, "Bird-MAE-Base", jspec)
    monkeypatch.setitem(tbird.PRETRAINED_SPECS, "Bird-MAE-Base", tspec)
    sd = _timm_sd(np.random.default_rng(21), D, 2, p=16, c=1, n_patches=256, ls=None)
    sd["pos_embed"][0, 1:] = jbird.pos_table(D)[1:]
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "b.pt")
    ckpt = f"Bird-MAE-Base={tmp_path / 'b.pt'}"
    jm, tm = jbird.Transformer(ckpt), tbird.Transformer(ckpt, device="cpu")
    spec = np.random.default_rng(22).normal(size=(2, tbird.TARGET_T, tbird.N_MELS)).astype(np.float32)
    (j_out, j_taps), (t_out, t_taps) = jm.forward_recorded(spec, (1,)), tm.forward_recorded(spec, (1,))
    assert t_taps.shape == (2, 1, 257, D)
    _close(t_taps, j_taps)
    _close(t_out, j_out)
    with pytest.raises(NotImplementedError):
        tbird.Transformer.make_resize("Bird-MAE-Base")


# ---------------------------------------------------------------------------
# Transforms: exactly the JAX package's
# ---------------------------------------------------------------------------


def test_patchify_and_unfolded_conv_match_jax():
    rng = np.random.default_rng(23)
    img = rng.normal(size=(3, 12, 20)).astype(np.float32)
    for a, b in zip(ttransforms.patchify(img, 4), jtransforms.patchify(img, 4)):
        assert np.array_equal(a, b) and a.dtype == b.dtype
    x, w, bias = _rand(rng, 2, 3, 8, 12), _rand(rng, 5, 3, 4, 4), _rand(rng, 5)
    assert np.array_equal(ttransforms.unfolded_conv2d(x, w, bias), jtransforms.unfolded_conv2d(x, w, bias))
    assert np.array_equal(ttransforms.unfolded_conv2d(x, w), jtransforms.unfolded_conv2d(x, w))
    sample = {"data": img[:, :8, :8]}
    t, j = ttransforms.Patchify(4, 4)(dict(sample)), jtransforms.Patchify(4, 4)(dict(sample))
    assert np.array_equal(t["data"], j["data"]) and np.array_equal(t["grid"], j["grid"])
    assert ttransforms.aspect_ratios(24) == jtransforms.aspect_ratios(24)


def test_image_transforms_match_jax():
    from PIL import Image

    rng = np.random.default_rng(24)
    for size in ((50, 30), (30, 50), (40, 40)):
        img = Image.fromarray(rng.integers(0, 256, size=(size[1], size[0], 3), dtype=np.uint8))
        for p, n in ((4, 16), (2, 12)):
            a = ttransforms.resize_to_patch_grid(img, p=p, n=n)
            b = jtransforms.resize_to_patch_grid(img, p=p, n=n)
            assert a.size == b.size and np.array_equal(np.asarray(a), np.asarray(b))
            a = ttransforms.FlexResize(p, n, resample="BICUBIC")(img)
            b = jtransforms.FlexResize(p, n, resample=Image.BICUBIC)(img)
            assert np.array_equal(np.asarray(a), np.asarray(b))
        mean, std = (0.4, 0.5, 0.6), (0.2, 0.3, 0.25)
        assert np.array_equal(ttransforms.to_chw_float(img, mean=mean, std=std),
                              jtransforms.to_chw_float(img, mean=mean, std=std))
        gray = img.convert("L")
        assert np.array_equal(ttransforms.to_chw_float(gray), jtransforms.to_chw_float(gray))
        for mode in ("shortest", "squash"):
            a = tfamilies._resize_center_crop(img, 36, 32, mode=mode)
            b = jfamilies._resize_center_crop(img, 36, 32, mode=mode)
            assert np.array_equal(np.asarray(a), np.asarray(b))
    assert ttransforms.resample_filter("nearest") == Image.NEAREST
    assert ttransforms.resample_filter(Image.LANCZOS) == Image.LANCZOS
    with pytest.raises(TypeError):
        ttransforms.FlexResize(4, 16)(np.zeros((3, 8, 8)))


# ---------------------------------------------------------------------------
# The route's script: the card unless the CPU is asked for
# ---------------------------------------------------------------------------


def test_vit_route_needs_the_card_unless_asked(monkeypatch):
    """`python -m saev_tpu_torch.scripts.vit_route` runs on the card by
    default and raises where torch sees none; it never falls back to the
    CPU on its own."""
    from saev_tpu_torch.scripts import vit_route

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        vit_route.main(["--d-model", "64", "--n-layers", "2", "--clips", "1"])


def test_vit_route_cpu_model_when_asked(capsys):
    """`--device cpu` runs the route's CPU model and says so in its line."""
    import json

    from saev_tpu_torch.scripts import vit_route

    vit_route.main(["--d-model", "64", "--n-layers", "2", "--clips", "1", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu (CPU model of the route)"
    assert len(out["rel_norm_by_layer"]) == 2 and 0 < out["max"] <= BF16_REL
