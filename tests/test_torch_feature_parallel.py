"""Feature-parallel (latent-sharded) training of the port on the CPU, against
the JAX package's single-device step and the port's whole-row operations.

Ranks are processes spawned over gloo (tests/torch_ranks.py), once for each
world size of the module: one spawn of 2 ranks runs every case at
feature_parallel 2, the operations, the router and a worker_fn job; one of 4
ranks runs the step cases at feature_parallel 4 and at data 2 x feature 2,
and the meshes and `shard_features`' placement at sweep 2 x feature 2.

- The step (n_sae 2, d_model 16, d_sae 64, batch 32, TopK 4, Matryoshka 2,
  tests/test_parallel.py's feature-parallel shape, with AuxK 8 and dead
  latents planted across the shards), 3 steps from one state, at F = 2, F =
  4 and data 2 x feature 2, against the JAX package's single-device
  `make_train_step`: at "highest" (the decode path), at "default" (the
  fused path) with AuxK dense and in a subspace of 32 (and of 16 with every
  dead latent on shard 0, so that the other shards hold none of it), Muon,
  and BatchTopK
  (whose rows hold fewer winners than their share of candidates, so its
  threshold is the one-rank value). The loss to rtol 1e-5 / atol 1e-6 and
  W_dec to rtol 1e-4 / atol 5e-5, as tests/test_parallel.py holds the JAX
  package's; the other stats to rel 1e-4, the other params as W_dec, the
  counters and n_dead exact.
- The kernel path's algebra (ops.matryoshka._use_kernels patched: the
  sharded threshold, K1's threshold entry, K7's base summed over the
  group, bf16 E, K3 and K4, all by their plain versions) at F = 2 against
  the port's one-rank step on the same algebra.
- The whole row's k-th largest over the shards, with ties straddling the
  shard boundary, zeros of both signs across it and k above a shard's
  width, plain, masked and masked over unevenly split columns, bit for bit
  `_kth_plain` / `_kth_masked_plain` of the whole row; `topk_stats` over
  the group against the whole row's plain version.
- `stalest_columns` over the shards with counters tied across them: the
  whole dictionary's choice, ties in ascending whole index, bit for bit.
- The sharded prefix MSE with a prefix that ends before shard 1 and one on
  the shard boundary, against `prefix_mse` of the whole dictionary.
- Newton-Schulz over the shards, with more latents than d_model and fewer.
- The router: every rank picks the variant one process would, from the
  whole dictionary's dead count (each shard's alone would pick another).
- A worker_fn job at F = 2 stopped after its step-4 checkpoint and resumed:
  rank 0 writes whole arrays; the SAE files load in the JAX package's
  `nn.load` to the trained params; one process replaying the recorded
  global batches gives the same trajectory and eval; the last checkpoint
  resumes at F = 1.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_ranks
from test_torch_parallel import (
    JOB_BATCH, JOB_D_SAE, FixedLoader, _global_batches, _job_cfgs, _md, _write_shards, rel_norm,
)

from saev_tpu import nn as jnn
from saev_tpu.framework import train as jtrain
from saev_tpu.nn import modeling as jmod
from saev_tpu.nn import objectives as jobj
from saev_tpu_torch import parallel
from saev_tpu_torch.data import shards, shuffled
from saev_tpu_torch.framework import checkpoints, train
from saev_tpu_torch.nn import modeling, objectives
from saev_tpu_torch.ops import matryoshka, topk

N_SAE, D_MODEL, D_SAE, BATCH, K, J, K_AUX, N_STEPS = 2, 16, 64, 32, 4, 2, 8, 3
DEAD = (10, 5)  # latents planted dead in each SAE, spread over every shard
STEP_CASES = {
    # name: (optim, precision, activation, aux_subspace_cap, kernel path)
    "highest-dense": ("adam", "highest", "TopK", None, False),
    "default-dense": ("adam", "default", "TopK", None, False),
    "default-subspace": ("adam", "default", "TopK", 32, False),
    # Every dead latent on shard 0 and a subspace of 16: the other shards
    # hold none of it.
    "default-subspace-low": ("adam", "default", "TopK", 16, False),
    "muon-dense": ("muon", "default", "TopK", None, False),
    "batchtopk-dense": ("adam", "default", "BatchTopK", None, False),
    "kernels-dense": ("adam", "default", "TopK", None, True),
    "kernels-subspace": ("adam", "default", "TopK", 32, True),
}
JAX_CASES = [n for n, c in STEP_CASES.items() if not c[4]]
KERNEL_CASES = [n for n, c in STEP_CASES.items() if c[4]]
LAYOUTS = ("F2", "F4", "D2F2")


def _step_inputs(name: str) -> tuple[dict, dict]:
    optim, precision, activation, cap, kernels = STEP_CASES[name]
    act = getattr(jmod, activation)(top_k=K, aux=jmod.AuxK(k_aux=K_AUX))
    jcfg = jmod.SparseAutoencoderConfig(d_model=D_MODEL, d_sae=D_SAE, activation=act)
    inits = [jmod.init(jcfg, key) for key in jax.random.split(jax.random.key(1), N_SAE)]
    rng = np.random.default_rng(list(STEP_CASES).index(name))
    data = {f"p.{k}": np.stack([np.asarray(p[k]) for p, _ in inits]) for k in inits[0][0]}
    data |= {f"s.{k}": np.stack([np.asarray(s[k]) for _, s in inits]) for k in inits[0][1]}
    b_enc = (rng.normal(size=(N_SAE, D_SAE)) * 0.05).astype(np.float32)
    toks = np.zeros((N_SAE, D_SAE), np.int32)
    for i, n in enumerate(DEAD):
        dead = np.arange(n) if name.endswith("-low") else rng.choice(D_SAE, n, replace=False)
        b_enc[i, dead] = -1e6
        toks[i, dead] = 1 << 30
        if name.endswith("-low"):  # the next stalest, live and silent, up to 16: all on shard 0
            b_enc[i, n:16] = -1e3
            toks[i, n:16] = 1 << 19
    data["p.b_enc"], data["toks"] = b_enc, toks
    data |= {f"x{i}": rng.normal(size=(BATCH, D_MODEL)).astype(np.float32) for i in range(N_STEPS)}
    data["prefixes"] = np.stack([jobj.sample_prefixes(D_SAE, J, rng=rng) for _ in range(N_SAE)])
    data |= {
        "hp.lr": np.asarray([1e-3, 3e-3], np.float32), "hp.n_lr_warmup": np.full(N_SAE, 2.0, np.float32),
        "hp.grad_clip": np.ones(N_SAE, np.float32), "hp.sparsity_coeff": np.zeros(N_SAE, np.float32),
        "hp.aux_alpha": np.asarray([1 / 32, 1 / 8], np.float32), "hp.momentum": np.asarray([0.1, 0.3], np.float32),
    }
    spec = dict(optim=optim, precision=precision, activation=activation, aux_enabled=True, cap=cap, k=K,
                k_aux=K_AUX, d_model=D_MODEL, d_sae=D_SAE, n_prefixes=J, dead=1 << 20, n_steps=N_STEPS,
                kernels=kernels)
    return spec, data


# The operations' inputs (feature_parallel 2: columns [0, 32) and [32, 64)).
KS = (1, 3, 4, 8, 31, 33, 40, 64)
CAPS = (8, 20, 32, 40, 64)
UNEVEN = 40  # columns rank 0 holds in the uneven split (rank 1 none)


def _kth_inputs() -> dict:
    rng = np.random.default_rng(7)
    h = rng.normal(size=(8, D_SAE)).astype(np.float32)
    h[0] = 1.0  # one value everywhere
    h[1, 26:38] = 4.0  # a tie straddling the boundary at the k-th values
    h[1, :4] = 9.0
    h[2] = np.concatenate([np.full(32, -0.0), np.full(32, 0.0)]).astype(np.float32)  # zeros of both signs
    h[2, [5, 40]] = 2.0
    h[3, 32:] += 50.0  # every large value on shard 1
    h[4, 30:34] = h[4].max() + 1  # the top tied across the boundary
    h[5, :] = np.where(np.arange(D_SAE) % 2, 3.0, -3.0)
    mask = np.zeros(D_SAE, bool)
    mask[[1, 2, 3, 30, 31, 32, 33, 45, 50, 51, 52, 53, 54, 60]] = True  # 14 unmasked, straddling
    toks = rng.integers(0, 3, size=D_SAE).astype(np.int32)  # ties everywhere, across the shards
    toks[[3, 35]] = 9
    return {"h": h, "mask": mask, "ks": np.asarray(KS), "split": np.asarray(UNEVEN), "toks": toks,
            "caps": np.asarray(CAPS)}


def _mse_inputs() -> dict:
    """Small integers: every product and sum is exact in f32 and in bf16 on
    either route."""
    rng = np.random.default_rng(8)
    f = rng.integers(-2, 3, size=(BATCH, D_SAE)).astype(np.float32)
    f[rng.random(f.shape) < 0.7] = 0.0
    return {
        "f": f, "w": rng.integers(-2, 3, size=(D_SAE, D_MODEL)).astype(np.float32),
        "b": rng.integers(-2, 3, size=D_MODEL).astype(np.float32),
        "x": rng.integers(-4, 5, size=(BATCH, D_MODEL)).astype(np.float32),
        # A prefix ending before shard 1 and one on the boundary; one covering shard 0.
        "cuts_a": np.asarray([10, 32, 64], np.int32), "cuts_b": np.asarray([33, 64], np.int32),
    }


def _ns_inputs() -> dict:
    """Stacked (2, a, b) matrices: W_enc-like (d_model x latents) and
    W_dec-like (latents x d_model), with more latents than d_model (the Gram
    path) and fewer (the gather path)."""
    rng = np.random.default_rng(10)
    shapes = {"enc_wide": (2, 16, 64), "dec_wide": (2, 64, 16), "enc_narrow": (2, 64, 32), "dec_narrow": (2, 32, 64)}
    return {k: rng.normal(size=v).astype(np.float32) for k, v in shapes.items()}


ROUTER = dict(d_sae=1024, d_model=D_MODEL, k=K, k_aux=K_AUX, activation="TopK", n_prefixes=J, dead=1 << 20,
              router_batch=1 << 19, n_steps=5, dead_per_shard=100)


def _router_inputs() -> tuple[dict, dict]:
    """One SAE at d_sae 1024 (rungs of 128 and 256 latents) with 100 dead
    latents on each shard: 200 in all need the wide rung, where each shard's
    100 alone would take the tight one. The router's batch 2^19 starts AuxK
    at step 1 while the counters of live latents never near the threshold."""
    cfg = modeling.SparseAutoencoderConfig(d_model=D_MODEL, d_sae=ROUTER["d_sae"],
                                           activation=modeling.TopK(top_k=K, aux=modeling.AuxK(k_aux=K_AUX)))
    params, state = modeling.init(cfg, torch.Generator().manual_seed(3), "cpu")
    rng = np.random.default_rng(9)
    data = {f"p.{k}": v[None].numpy() for k, v in params.items()} | {f"s.{k}": v[None].numpy() for k, v in state.items()}
    toks = np.zeros((1, ROUTER["d_sae"]), np.int32)
    half = ROUTER["d_sae"] // 2
    for start in (0, half):
        toks[0, start : start + ROUTER["dead_per_shard"]] = 1 << 30
        data["p.b_enc"][0, start : start + ROUTER["dead_per_shard"]] = -1e6
    data["toks"] = toks
    data |= {f"x{i}": rng.normal(size=(BATCH, D_MODEL)).astype(np.float32) for i in range(ROUTER["n_steps"])}
    data["prefixes"] = np.stack([objectives.sample_prefixes(ROUTER["d_sae"], J, rng=rng)])
    data |= {"hp.lr": np.asarray([1e-3], np.float32), "hp.n_lr_warmup": np.ones(1, np.float32),
             "hp.grad_clip": np.ones(1, np.float32), "hp.sparsity_coeff": np.zeros(1, np.float32)}
    return ROUTER, data


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns, once for the module; the job's shards and runs under it."""
    out = tmp_path_factory.mktemp("feature")
    for name in STEP_CASES:
        spec, data = _step_inputs(name)
        (out / f"{name}.json").write_text(json.dumps(spec))
        np.savez(out / f"{name}.npz", **data)
    np.savez(out / "kth.npz", **_kth_inputs())
    np.savez(out / "mse.npz", **_mse_inputs())
    np.savez(out / "ns.npz", **_ns_inputs())
    spec, data = _router_inputs()
    (out / "router.json").write_text(json.dumps(spec))
    np.savez(out / "router.npz", **data)
    shards_root, runs_root = out / "saev" / "shards", out / "saev" / "runs"
    shards_root.mkdir(parents=True)
    runs_root.mkdir(parents=True)
    train_dir, val_dir = _write_shards(shards_root, 48, 0), _write_shards(shards_root, 16, 1)
    cfgs = _job_cfgs(train, modeling, objectives, shuffled, train_dir, val_dir, runs_root, 2, ckpt_every=2,
                     feature_parallel=2)
    cwd = os.getcwd()
    os.chdir(out)  # the local run recorder writes under ./.wandb
    try:
        torch_ranks.spawn(torch_ranks.feature_rank2, 2, out, list(STEP_CASES), cfgs, 4, limit=240.0)
        torch_ranks.spawn(torch_ranks.feature_rank4, 4, out, list(STEP_CASES), limit=240.0)
    finally:
        os.chdir(cwd)
    return out, cfgs


_JAX_RUNS: dict = {}


def _jax_run(name: str):
    """The JAX package's single-device step on the case: each step's stats,
    the final params, counters and BatchTopK threshold."""
    if name in _JAX_RUNS:
        return _JAX_RUNS[name]
    spec, data = _step_inputs(name)
    act = getattr(jmod, spec["activation"])(top_k=K, aux=jmod.AuxK(k_aux=K_AUX))
    jcfg = jmod.SparseAutoencoderConfig(d_model=D_MODEL, d_sae=D_SAE, activation=act)
    params = {k[2:]: jnp.asarray(v) for k, v in data.items() if k.startswith("p.")}
    init = jtrain._adam_init if spec["optim"] == "adam" else jtrain._muon_init
    ts = jtrain.SweepState(
        params=params, sae_state={k[2:]: jnp.asarray(v) for k, v in data.items() if k.startswith("s.")},
        obj_state={"toks_since_active": jnp.asarray(data["toks"])}, opt_state=init(params),
        step=jnp.zeros((), jnp.int32),
    )
    step = jtrain.make_train_step(
        jcfg, jobj.Matryoshka(n_prefixes=J, dead_threshold_tokens=spec["dead"]), n_steps=10, optim=spec["optim"],
        matmul_precision=spec["precision"], aux_subspace_cap=spec["cap"],
    )
    hp = {k[3:]: jnp.asarray(v) for k, v in data.items() if k.startswith("hp.")}
    stats = []
    for i in range(N_STEPS):
        ts, st = step(ts, jnp.asarray(data[f"x{i}"]), jnp.asarray(data["prefixes"]), hp)
        stats.append({k: np.asarray(v) for k, v in st.items()})
    _JAX_RUNS[name] = (stats, {k: np.asarray(v) for k, v in ts.params.items()},
                       np.asarray(ts.obj_state["toks_since_active"]), np.asarray(ts.sae_state["threshold"]))
    return _JAX_RUNS[name]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", JAX_CASES)
def test_feature_parallel_step_matches_jax_single_device(runs, name, layout):
    out, _ = runs
    got = dict(np.load(out / f"{name}_{layout}.npz"))
    stats, params, toks, threshold = _jax_run(name)
    for i, st in enumerate(stats):
        np.testing.assert_allclose(got[f"stats{i}.loss"], st["loss"], rtol=1e-5, atol=1e-6, err_msg=f"loss {i}")
        for k in ("mse", "l0", "l1", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(got[f"stats{i}.{k}"], st[k], rtol=1e-4, atol=1e-7, err_msg=f"{k} {i}")
        np.testing.assert_array_equal(got[f"stats{i}.n_dead"], st["n_dead"])
        np.testing.assert_array_equal(got[f"stats{i}.aux_risk"], st["aux_risk"])
    assert got[f"stats{N_STEPS - 1}.n_dead"].tolist() == list(DEAD)
    assert (got[f"stats{N_STEPS - 1}.aux"] > 0).all()
    for k, v in params.items():
        assert got[f"p.{k}"].shape == v.shape
        np.testing.assert_allclose(got[f"p.{k}"], v, rtol=1e-4, atol=5e-5, err_msg=k)
    np.testing.assert_array_equal(got["toks"], toks)
    if STEP_CASES[name][2] == "BatchTopK":
        np.testing.assert_allclose(got["s.threshold"], threshold, rtol=1e-6)


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_feature_parallel_kernel_algebra_matches_one_rank(runs, name, monkeypatch):
    """At F = 2 on the kernel path's algebra, against the port's one-rank
    step on the same algebra: within 1e-5 (the partial products' f32 sums
    round apart, and so can an E entry's bf16)."""
    out, _ = runs
    got = dict(np.load(out / f"{name}_F2.npz"))
    spec, data = _step_inputs(name)
    monkeypatch.setattr(matryoshka, "_use_kernels", lambda t: True)
    ts = torch_ranks._whole_state(data, spec["optim"])
    step = train.make_train_step(
        torch_ranks._sae_cfg(spec), objectives.Matryoshka(n_prefixes=J, dead_threshold_tokens=spec["dead"]),
        n_steps=10, optim=spec["optim"], matmul_precision=spec["precision"], aux_subspace_cap=spec["cap"],
    )
    hp = {k[3:]: torch.from_numpy(v) for k, v in data.items() if k.startswith("hp.")}
    for i in range(N_STEPS):
        ts, st = step(ts, torch.from_numpy(data[f"x{i}"]), torch.from_numpy(data["prefixes"]), hp)
        for k, v in st.items():
            np.testing.assert_allclose(got[f"stats{i}.{k}"], v.numpy(), rtol=1e-5, atol=1e-7, err_msg=f"{k} {i}")
    for k, v in ts.params.items():
        np.testing.assert_allclose(got[f"p.{k}"], v.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(got["toks"], ts.obj_state["toks_since_active"].numpy())


def _bits(a) -> np.ndarray:
    """The bits of f32 values, -0.0 taken as +0.0: the plain versions rank
    by float compares, in which the two zeros tie (the kernels rank by order
    keys, -0.0 below +0.0, and chip_smoke.py holds their bits)."""
    return (np.asarray(a, np.float32) + np.float32(0.0)).view(np.int32)


def test_sharded_threshold_bit_for_bit_whole_row(runs):
    out, _ = runs
    kd = _kth_inputs()
    h, mask = torch.from_numpy(kd["h"]), torch.from_numpy(kd["mask"])
    ranks = [dict(np.load(out / f"ops_rank{r}.npz")) for r in range(2)]
    for k in KS:
        want = topk._kth_plain(h, k).numpy()
        want_masked = topk._kth_masked_plain(h, mask, k).numpy()
        for r in ranks:
            np.testing.assert_array_equal(_bits(r[f"kth{k}"]), _bits(want), err_msg=f"k={k}")
            np.testing.assert_array_equal(_bits(r[f"masked{k}"]), _bits(want_masked), err_msg=f"masked k={k}")
            if k <= UNEVEN:
                want_uneven = topk._kth_masked_plain(h[:, :UNEVEN], mask[:UNEVEN], k).numpy()
                np.testing.assert_array_equal(_bits(r[f"uneven{k}"]), _bits(want_uneven), err_msg=f"uneven k={k}")
        # topk_stats over the group: kth and f bit for bit, live and L0
        # exact, L1 within its sums' order.
        whole = topk._topk_stats_plain(h, k)
        for i, r in enumerate(ranks):
            mine = slice(32 * i, 32 * (i + 1))
            np.testing.assert_array_equal(_bits(r[f"stats{k}.kth"]), _bits(whole.kth.numpy()))
            np.testing.assert_array_equal(r[f"stats{k}.f"], whole.f[:, mine].float().numpy())
            np.testing.assert_array_equal(r[f"stats{k}.live"], whole.live[mine].float().numpy())
            np.testing.assert_array_equal(r[f"stats{k}.l0"], whole.l0.numpy())
            np.testing.assert_allclose(r[f"stats{k}.l1"], whole.l1.numpy(), rtol=1e-6)
    assert float(topk._kth_plain(h, 3)[2]) == 0.0 and float(topk._kth_plain(h, 8)[1]) == 4.0


def test_stalest_columns_over_shards_with_ties(runs):
    out, _ = runs
    toks = torch.from_numpy(_kth_inputs()["toks"])
    ranks = [dict(np.load(out / f"ops_rank{r}.npz")) for r in range(2)]
    for cap in CAPS:
        want = objectives.stalest_columns(toks, cap).numpy()
        got = [ranks[r][f"stalest{cap}"] + 32 * r for r in range(2)]
        np.testing.assert_array_equal(np.sort(np.concatenate(got)), np.sort(want), err_msg=f"cap={cap}")
        for r in range(2):  # each rank's own, in the whole choice's order
            np.testing.assert_array_equal(got[r], want[(want >= 32 * r) & (want < 32 * (r + 1))])


@pytest.mark.parametrize("route", ["plain", "kernels"])
def test_sharded_prefix_mse_matches_whole(runs, route, monkeypatch):
    """Prefixes ending before shard 1 (10) and on the boundary (32), and one
    covering shard 0 whole (33): loss and reconstruction bit for bit (the
    inputs' sums are exact), the gradients within 1e-6 on the plain route
    and 1e-2 on the kernel path's (its dA is rounded to bf16 group by group,
    and a shard's groups are 32 latents, the whole one's 64)."""
    out, _ = runs
    md = _mse_inputs()
    ranks = [dict(np.load(out / f"ops_rank{r}.npz")) for r in range(2)]
    if route == "kernels":
        monkeypatch.setattr(matryoshka, "_use_kernels", lambda t: True)
    for name in ("cuts_a", "cuts_b"):
        w = torch.from_numpy(md["w"]).requires_grad_(True)
        b = torch.from_numpy(md["b"]).requires_grad_(True)
        f = torch.from_numpy(md["f"]).requires_grad_(True)
        loss, xhat = matryoshka.prefix_mse(w, b, f, torch.from_numpy(md["x"]), torch.from_numpy(md[name]), 64)
        loss.backward()
        tol = 1e-6 if route == "plain" else 1e-2
        for r, got in enumerate(ranks):
            pre = f"mse.{route}.{name}."
            mine = slice(32 * r, 32 * (r + 1))
            np.testing.assert_array_equal(got[pre + "loss"], loss.detach().numpy())
            np.testing.assert_array_equal(got[pre + "xhat"], xhat.numpy())
            np.testing.assert_array_equal(got[pre + "db"], b.grad.numpy())
            assert rel_norm(got[pre + "dw"], w.grad[mine].numpy()) <= tol, (name, r)
            assert rel_norm(got[pre + "df"], f.grad[:, mine].float().numpy()) <= tol, (name, r)


@pytest.mark.parametrize("name", ["enc_wide", "dec_wide", "enc_narrow", "dec_narrow"])
def test_sharded_newton_schulz_matches_whole(runs, name):
    """Each rank's part of Newton-Schulz over the shards is that part of the
    whole matrix's: its Gram matrix summed over the ranks where the latents
    outnumber d_model, the whole matrix gathered where they do not (f32 sums
    in another order: within 1e-5)."""
    out, _ = runs
    g = _ns_inputs()[name]
    want = train._newton_schulz(torch.from_numpy(g)).numpy()
    axis = -1 if name.startswith("enc") else -2
    got = np.concatenate([np.load(out / f"ops_rank{r}.npz")[f"ns.{name}"] for r in range(2)], axis=axis)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_router_picks_the_same_variant_on_every_rank(runs):
    """Every rank's router picks warm, dense, then the wide rung, as one
    process does: the whole dictionary's 200 dead latents, not a shard's
    100, which the tight rung of 128 would hold."""
    out, _ = runs
    picked = [json.loads((out / f"router_rank{r}.json").read_text()) for r in range(2)]
    spec, data = _router_inputs()
    mesh = parallel.make_mesh()
    ts = torch_ranks._whole_state(data, "adam")
    cfg = torch_ranks._sae_cfg(spec)
    router = train.make_step_router(cfg, objectives.Matryoshka(n_prefixes=J, dead_threshold_tokens=spec["dead"]),
                                    10, spec["router_batch"], mesh=mesh)
    names = {id(router.step_fn): "dense", id(router.step_fn_warm): "warm"}
    names |= {id(fn): f"cap{cap}" for cap, fn in router.step_fn_subs}
    hp = {k[3:]: torch.from_numpy(v) for k, v in data.items() if k.startswith("hp.")}
    want = []
    for i in range(spec["n_steps"]):
        fn = router.step_fn_at(i)
        want.append(names[id(fn)])
        ts, stats = fn(ts, torch.from_numpy(data[f"x{i}"]), torch.from_numpy(data["prefixes"]), hp)
        router.record_stats(i, stats)
    assert [cap for cap, _ in router.step_fn_subs] == [128, 256]
    assert want == ["warm", "dense", "cap256", "cap256", "cap256"]
    assert picked[0] == picked[1] == want


def test_meshes_and_shard_features_placement(runs):
    """rank = (d * sweep + s) * feature + f, and `shard_features` at sweep 2
    x feature 2 places W_enc (sweep, None, feature), W_dec and b_enc
    (sweep, feature), b_dec (sweep) and a scalar whole, as the JAX package's
    does (tests/test_parallel.py); `to_host` gathers them back whole."""
    out, _ = runs
    tree = {"W_enc": np.arange(4 * 16 * 32.0).reshape(4, 16, 32), "W_dec": np.arange(4 * 32 * 16.0).reshape(4, 32, 16),
            "b_enc": np.arange(4 * 32.0).reshape(4, 32), "b_dec": np.arange(4 * 16.0).reshape(4, 16)}
    for rank in range(4):
        res = json.loads((out / f"rank4_{rank}.json").read_text())
        assert res["F4"] == {"shape": {"data": 1, "sweep": 1, "feature": 4}, "dsf": [0, 0, rank], "data": None,
                             "sweep": None, "feature": [0, 1, 2, 3], "rows": [0, 1, 2, 3]}
        d, f = divmod(rank, 2)
        assert res["D2F2"] == {"shape": {"data": 2, "sweep": 1, "feature": 2}, "dsf": [d, 0, f], "data": [f, 2 + f],
                               "sweep": None, "feature": [2 * d, 2 * d + 1], "rows": [2 * d, 2 * d + 1]}
        s, f = divmod(rank, 2)
        assert res["S2F2"] == {"shape": {"data": 1, "sweep": 2, "feature": 2}, "dsf": [0, s, f], "data": None,
                               "sweep": [f, 2 + f], "feature": [2 * s, 2 * s + 1], "rows": [0, 1, 2, 3]}
        sw, ft = slice(2 * s, 2 * s + 2), slice(16 * f, 16 * f + 16)
        placed = res["placed"]
        np.testing.assert_array_equal(placed["W_enc"], tree["W_enc"][sw, :, ft])
        np.testing.assert_array_equal(placed["W_dec"], tree["W_dec"][sw, ft])
        np.testing.assert_array_equal(placed["b_enc"], tree["b_enc"][sw, ft])
        np.testing.assert_array_equal(placed["b_dec"], tree["b_dec"][sw])
        assert placed["scalar"] == 3.0 and res["back"]
    # World 1: the identity; a d_sae the axis does not divide raises.
    mesh = parallel.make_mesh()
    t = {"W_dec": torch.zeros(2, 63, 16)}
    assert parallel.shard_features(mesh, t, 63)["W_dec"] is t["W_dec"]
    with pytest.raises(ValueError, match="not divisible by the feature axis"):
        parallel.shard_features(dataclasses.replace(mesh, n_feature=2), t, 63)
    assert parallel.latent_axes(tree, 32) == {"W_enc": 2, "W_dec": 1, "b_enc": 1, "b_dec": None}


def test_feature_parallel_job_writes_whole_files_and_resumes_at_f1(runs, monkeypatch):
    """worker_fn at feature_parallel 2 over 2 processes, stopped on every
    rank once its step-4 checkpoint is written, then resumed to step 8,
    evaluated and written; then the last checkpoint resumed at F = 1."""
    out, cfgs = runs
    runs_root = cfgs[0].runs_root
    ranks = [json.loads((out / f"job_rank{r}.json").read_text()) for r in range(2)]
    assert ranks[0]["writes"] == {"state": 4, "sae": 2, "stopped": 4}
    assert ranks[1]["writes"] == {"state": 0, "sae": 0, "stopped": 4}
    ids = ranks[0]["ids"]
    assert len(ids) == 2 and ranks[1]["ids"] == []
    final = dict(np.load(out / "job_final.npz"))
    assert int(final["step"]) == 8 and final["p.W_dec"].shape == (2, JOB_D_SAE, cfgs[0].sae.d_model)
    (group,) = (runs_root / ".train_state").iterdir()
    assert sorted(p.name for p in group.iterdir()) == ["step_00000008"]
    saved = torch.load(group / "step_00000008" / "state.pt", weights_only=True)
    for k in ("W_enc", "W_dec", "b_enc", "b_dec"):  # whole arrays
        np.testing.assert_array_equal(saved["params"][k].numpy(), final[f"p.{k}"], err_msg=k)
        np.testing.assert_array_equal(saved["opt_state"]["m"][k].shape, final[f"p.{k}"].shape)
    assert tuple(saved["obj_state"]["toks_since_active"].shape) == (2, JOB_D_SAE)
    for i, run_id in enumerate(ids):  # each SAE file loads in the JAX package to the trained params
        _, params, _ = jnn.load(runs_root / run_id / "checkpoint" / "sae.pt")
        for k, v in params.items():
            np.testing.assert_array_equal(np.asarray(v), final[f"p.{k}"][i], err_msg=k)

    # One process replays the recorded global batches (as
    # tests/test_torch_parallel.py's two-rank job does).
    crashed = [dict(np.load(out / f"crashed_rank{r}.npz")) for r in range(2)]
    resumed = [dict(np.load(out / f"resumed_rank{r}.npz")) for r in range(2)]
    for logs in (crashed, resumed):  # both ranks of the feature group trained on every row
        for i, x in enumerate(_global_batches(logs, "train")):
            for log in logs:
                np.testing.assert_array_equal(log[f"train.gathered{i}"], x)
    c0 = cfgs[0]
    init = {n: {k.split(".", 2)[2]: torch.from_numpy(v) for k, v in crashed[0].items() if k.startswith(f"init.{n}.")}
            for n in ("params", "sae_state", "obj_state")}
    ts = train.SweepState(init["params"], init["sae_state"], init["obj_state"],
                          train._opt_init(c0.optim, init["params"]), torch.zeros((), dtype=torch.int32))
    hp = {k: torch.from_numpy(v) for k, v in train._hp_arrays(cfgs).items()}
    for start, logs in ((0, crashed), (4, resumed)):
        router = train.make_step_router(c0.sae, c0.objective, 8, JOB_BATCH, c0.optim, c0.matmul_precision)
        rng = np.random.default_rng(c0.seed + 1000)
        for i, x in enumerate(_global_batches(logs, "train")):
            prefixes = torch.from_numpy(np.stack([objectives.sample_prefixes(JOB_D_SAE, 3, rng=rng) for _ in cfgs]))
            ts, stats = router.step_fn_at(start + i)(ts, torch.from_numpy(x), prefixes, hp)
            router.record_stats(start + i, stats)
    for k, v in ts.params.items():
        for i in range(2):
            assert rel_norm(final[f"p.{k}"][i], v[i].numpy()) <= 1e-5, (k, i)
    got = json.loads((out / "eval_rank0.json").read_text())
    val = _global_batches(resumed, "eval")
    monkeypatch.setattr(train, "ShuffledDataLoader", lambda cfg: FixedLoader(cfg, _md(shards, 16), val))
    rt = train._CohortRuntime(cohort=train.make_cohorts(cfgs)[0], ts=ts, router=None, metrics_fn=None, hp=hp,
                              prefix_rng=rng, mesh=parallel.make_mesh())
    want = train.evaluate([dataclasses.replace(c, feature_parallel=1) for c in cfgs], [rt])
    for g, w in zip(got, want):
        for f in ("l0", "l1", "mse", "normalized_mse", "sse_sae", "sse_baseline"):
            assert abs(g[f] - getattr(w, f)) <= 1e-5 * abs(getattr(w, f)), (f, g[f], getattr(w, f))
        for f in ("n_dead", "n_almost_dead", "n_dense"):
            assert g[f] == getattr(w, f), f
        assert rel_norm(g["freqs"], w.freqs) <= 1e-5

    # The last checkpoint resumes in one process at feature_parallel 1: the
    # restored state is the saved whole one, and no step is left to run.
    monkeypatch.undo()
    monkeypatch.chdir(out)
    restored = []
    real_restore = checkpoints.restore

    def spy(*args, **kwargs):
        restored.append(real_restore(*args, **kwargs))
        return restored[-1]

    monkeypatch.setattr(checkpoints, "restore", spy)
    runtimes, run, steps = train.train([dataclasses.replace(c, feature_parallel=1, resume=True) for c in cfgs])
    run.finish()
    assert steps == 8 and len(restored) == 1 and int(restored[0].step) == 8
    for k, v in runtimes[0].ts.params.items():
        np.testing.assert_array_equal(v.numpy(), final[f"p.{k}"], err_msg=k)
