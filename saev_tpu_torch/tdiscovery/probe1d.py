"""Sparse 1-D logistic probes for trait discovery on PyTorch tensors
(counterpart of contrib/trait_discovery/src/tdiscovery/probe1d.py; reference
Reference1DProbe :96, Sparse1DProbe :427, compute_lm_step :887,
_compute_slab_stats :841): per-(latent, class) two-parameter logistic probes
`sigmoid(b + w·x)` fit with a Levenberg-Marquardt trust-region step.

Every (latent, class) problem is independent, so one LM iteration solves the
whole (n_latents × class_slab) grid at once on the device. The CSR events go
to the device once, sorted by latent (`x.tocsc()` order) in padded pieces of
PIECE events of one latent; a chunk's per-latent sums are a dense sum over
each piece, then a `torch.segment_reduce` over each latent's pieces. The
order is fixed, so a fit gives the same bits every time on the card, where
`index_add_`'s atomics would add in a different order on each run. The
loss that decides lambda's growth (rho) is kept in float64: near convergence
a step changes it by less than float32 resolves (on 2^20 tokens, a step of
2e-9 on a loss of 0.31), where the JAX package's float32 rho is rounding
noise and can stall a pair that the float64 reference fits in 3 steps. The 5-try lambda
escalation is five masked passes over (L, c_b) tensors. The zero-feature part
of the loss is analytic (per-latent counts), so work is O(nnz), never O(n·d).

Key invariants shared with the reference:
- x streams in CSR form; nothing shaped (nnz, n_classes) is materialized beyond
  one event chunk.
- qx (per-latent RMS of nonzero values) scales the trust region so db and
  qx·dw are commensurable.
- Ridge pulls the intercept toward the base rate logit, not zero.
"""

import dataclasses
import datetime
import json
import logging
import pathlib
import typing as tp

import numpy as np
import scipy.sparse
import torch

from . import device_of

logger = logging.getLogger("probe1d")

# Structured telemetry channel (reference probe1d.py:795-817 emits one JSON
# "probe_iteration" event per LM iteration on a stats logger). Enable with
# `logging.getLogger("probe1d.stats").setLevel(DEBUG)` plus a handler; the
# event names and fields are the JAX package's, which tdiscovery.logparse reads.
stats_log = logging.getLogger("probe1d.stats")

# Per-(latent, class) counts (tp, fp, positives) are f32 sums of 0/1: exact
# while a latent has fewer events than this.
EXACT_COUNT = 1 << 24

# The per-iteration telemetry, in the order `_iteration` stacks it.
AUX_FIELDS = ("grad_max", "step_max", "lambda_mean", "loss_mean", "loss_max", "rho_mean", "rho_min",
              "pred_mean", "success_frac", "fallback", "step_clipped")
_COUNT_FIELDS = ("fallback", "step_clipped")


def _rss_gb() -> float | None:
    try:
        import psutil

        return psutil.Process().memory_info().rss / 2**30
    except ImportError:
        return None


def _device_peak_gb(device: torch.device) -> float | None:
    """Peak allocation on the card in GiB; None on the CPU."""
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2**30


def _emit_event(name: str, **fields) -> None:
    event = {
        "timestamp": datetime.datetime.now(datetime.timezone.utc).isoformat(),
        "event": name,
        **fields,
    }
    rss = _rss_gb()
    if rss is not None:
        event["rss_gb"] = rss
    stats_log.debug(json.dumps(event))


def sigmoid(z):
    """Stable logistic (reference probe1d.py:84-93)."""
    z = np.asarray(z, dtype=np.float64)
    out = np.empty_like(z)
    pos = z >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-z[pos]))
    ez = np.exp(z[~pos])
    out[~pos] = ez / (1.0 + ez)
    return np.clip(out, 1e-12, 1 - 1e-12)


@dataclasses.dataclass
class ProbeHparams:
    ridge: float = 1e-8
    tol: float = 1e-6
    max_iter: int = 200
    lam_init: float = 1e-3
    lam_shrink: float = 0.1
    lam_grow: float = 10.0
    delta_logit: float = 6.0
    lam_min: float = 1e-12
    lam_max: float = 1e12
    eps: float = 1e-8
    fallback_step_scale: float = 1e-3


class Reference1DProbe:
    """Dense numpy reference implementing the trust-region spec step-for-step
    (reference probe1d.py:96-425). Used by tests to validate Sparse1DProbe."""

    def __init__(self, **kw):
        self.hp = ProbeHparams(**kw)
        self.intercept_: float = 0.0
        self.coef_: float = 0.0

    def fit(self, x: np.ndarray, y: np.ndarray) -> "Reference1DProbe":
        hp = self.hp
        x = np.asarray(x, dtype=np.float64).reshape(-1)
        y = np.asarray(y, dtype=np.float64).reshape(-1)
        n = len(x)
        pi = np.clip(y.mean(), hp.eps, 1 - hp.eps)
        base_b = float(np.log(pi / (1 - pi)))
        b, w = base_b, 0.0
        nz = x != 0
        rms = np.sqrt(np.mean(x[nz] ** 2)) if nz.any() else 1.0
        qx = max(rms, 1e-6)
        qx_sq = qx * qx

        lam = hp.lam_init
        prev_pred = np.nan
        prev_loss = np.nan
        prev_clipped = False

        for _ in range(hp.max_iter):
            z = b + w * x
            mu = sigmoid(z)
            s = mu * (1 - mu)
            g0 = float(np.mean(mu - y)) + hp.ridge * (b - base_b)
            g1 = float(np.mean((mu - y) * x)) + hp.ridge * w
            h0 = float(np.mean(s)) + hp.ridge
            h1 = float(np.mean(s * x))
            h2 = float(np.mean(s * x * x)) + hp.ridge
            loss = float(
                np.mean(-(y * np.log(mu) + (1 - y) * np.log1p(-np.minimum(mu, 1 - hp.eps))))
                + 0.5 * hp.ridge * (w**2 + (b - base_b) ** 2)
            )

            if np.isfinite(prev_pred) and np.isfinite(prev_loss):
                rho = (prev_loss - loss) / max(prev_pred, 1e-18)
                if rho >= 0.75 and not prev_clipped:
                    lam = max(lam * hp.lam_shrink, hp.lam_min)
                elif rho <= 0.25 or prev_clipped:
                    lam = min(lam * hp.lam_grow, hp.lam_max)

            if max(abs(g0), abs(g1)) <= hp.tol:
                break

            db = dw = pred = 0.0
            clipped = False
            ok = False
            lam_try = lam
            for _try in range(5):
                h0e, h2e = h0 + lam_try, h2 + lam_try * qx_sq
                det = h0e * h2e - h1 * h1
                if abs(det) > 1e-18:
                    db_t = (h2e * g0 - h1 * g1) / det
                    dw_t = (h0e * g1 - h1 * g0) / det
                    norm = np.sqrt(db_t**2 + (qx * dw_t) ** 2)
                    clipped_t = norm > hp.delta_logit
                    if clipped_t:
                        scale = hp.delta_logit / (norm + 1e-18)
                        db_t, dw_t = db_t * scale, dw_t * scale
                    pred_t = (
                        g0 * db_t + g1 * dw_t
                        - 0.5 * (h0 * db_t**2 + 2 * h1 * db_t * dw_t + h2 * dw_t**2)
                    )
                    if np.isfinite(pred_t) and pred_t > 0:
                        db, dw, pred, clipped, ok = db_t, dw_t, pred_t, clipped_t, True
                        break
                lam_try = min(lam_try * hp.lam_grow, hp.lam_max)

            if not ok:
                grad_scaled = np.sqrt(g0**2 + (qx * g1) ** 2)
                alpha = (
                    hp.fallback_step_scale * hp.delta_logit / (grad_scaled + 1e-18)
                    if grad_scaled > 0
                    else 0.0
                )
                db, dw = -alpha * g0, -alpha * g1
                pred = np.nan
                clipped = True
            lam = min(max(lam_try, hp.lam_min), hp.lam_max)

            b, w = b - db, w - dw
            prev_pred, prev_loss, prev_clipped = pred, loss, clipped

            step_norm = max(abs(db), abs(qx * dw))
            if max(abs(g0), abs(g1) / max(qx, 1e-12)) < hp.tol and step_norm < hp.tol:
                break

        self.intercept_, self.coef_ = float(b), float(w)
        return self

    def decision_function(self, x):
        return self.intercept_ + self.coef_ * np.asarray(x, dtype=np.float64)

    def predict_proba(self, x):
        p = sigmoid(self.decision_function(x))
        return np.stack([1 - p, p], axis=-1)

    def predict(self, x):
        return (self.decision_function(x) > 0).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class MemoryPlan:
    """Device-memory plan for one Sparse1DProbe.fit (reference probe1d.py
    plans classes in slabs and rows in chunks, :449-466, :993-1030; here the
    resident costs are the stacked event arrays plus per-slab state)."""

    class_slab_size: int
    event_chunk_size: int
    event_bytes: int
    """All CSR events stay device-resident: 12 B/event (i32 col + f32 val + i32 row)."""
    slab_bytes: int
    """Per-slab state: y_slab (n_samples × c_b) + ~17 (L, c_b) f32 buffers
    (7 stats accumulators + 6 carry arrays + LM temps) + chunk temporaries."""

    @property
    def total_bytes(self) -> int:
        return self.event_bytes + self.slab_bytes


def plan_memory(
    *,
    n_latents: int,
    n_classes: int,
    nnz: int,
    n_samples: int,
    budget_bytes: int = 4 << 30,
    max_class_slab: int = 64,
    max_event_chunk: int = 1 << 20,
) -> MemoryPlan:
    """Choose (class_slab_size, event_chunk_size) so a fit stays under
    `budget_bytes` of device memory at production shapes (d_sae=16k latents ×
    thousands of classes × 10^8 events).

    The event stream is fixed cost; the free variables are the class slab
    (bounds y_slab + all (L, c_b) state) and the event chunk (bounds per-chunk
    (chunk, c_b) temporaries inside the scan body).
    """
    event_bytes = 12 * max(nnz, 1)
    assert event_bytes < budget_bytes, (
        f"Event stream alone ({event_bytes / 2**30:.1f} GiB) exceeds the "
        f"{budget_bytes / 2**30:.1f} GiB budget; shard the rows externally."
    )
    remaining = budget_bytes - event_bytes

    def slab_bytes(c_b: int, chunk: int) -> int:
        state = 17 * (n_latents + 1) * c_b * 4
        y_cost = n_samples * c_b * 4
        # ~8 live (chunk, c_b) f32 temporaries in the scan body (logits, mu,
        # s, residual, loss, yc, bc, wc).
        chunk_cost = 8 * chunk * c_b * 4
        return state + y_cost + chunk_cost

    slab = max_class_slab
    chunk = min(max_event_chunk, max(nnz, 1))
    while slab > 1 and slab_bytes(slab, chunk) > remaining:
        slab //= 2
    while chunk > (1 << 14) and slab_bytes(slab, chunk) > remaining:
        chunk //= 2
    slab = min(slab, n_classes)
    return MemoryPlan(
        class_slab_size=max(slab, 1),
        event_chunk_size=max(chunk, 1),
        event_bytes=event_bytes,
        slab_bytes=slab_bytes(max(slab, 1), max(chunk, 1)),
    )


# Events a piece holds at most. The events of one latent go to the device
# in pieces of PIECE (its last piece shorter, padded), so an event reads its
# latent's (b, w) by broadcasting over its piece, and a chunk's sums are a
# dense sum over each piece, then a segment sum over each latent's pieces (a
# handful each). On an H100 a gather of 2^20 rows of 8 floats took 0.64 ms
# (52 GB/s), in any order, so the chunk works class-major: y's slab is
# (c_b, n) and an event's labels are one gather of floats along its rows
# (0.08 ms). A segment sum over a whole latent would add its events one
# after another in one thread (10^5 on a latent that fires on a tenth of the
# tokens).
PIECE = 256


class Events(tp.NamedTuple):
    """x's events on the device, in pieces of one latent each: latents
    ascending, rows ascending within a latent, each piece padded to PIECE
    with row 0 and value 0."""

    rows: torch.Tensor
    """(n_pieces, PIECE) int32 row (token) of each event."""
    vals: torch.Tensor
    """(n_pieces, PIECE) f32 value of each event."""
    latent: torch.Tensor
    """(n_pieces,) int64 latent of each piece."""
    length: torch.Tensor
    """(n_pieces,) int64 events of each piece, 1 to PIECE."""
    chunks: list[tuple[int, int, int, int, torch.Tensor]]
    """Per chunk of pieces: its first piece and one past its last, its first
    latent and one past its last, and the (hi - lo,) int64 pieces of each of
    those latents."""


def _sums(parts: list[torch.Tensor], valid: torch.Tensor, masked: tuple[bool, ...],
          pieces: torch.Tensor) -> torch.Tensor:
    """(n_latents, len(parts), c_b): each part (c_b, n_pieces, PIECE), its
    padding zeroed by `valid` where `masked` says, summed over each piece,
    then over each latent's pieces. A fixed order: the same bits on every
    call."""
    partial = torch.stack([(t * valid if m else t).sum(2) for t, m in zip(parts, masked)]).permute(2, 0, 1)
    return torch.segment_reduce(partial.contiguous(), "sum", lengths=pieces, axis=0, unsafe=True)


def _lm_step(hp: ProbeHparams, qx, qx_sq, g0, g1, h0, h1, h2, lam):
    """Masked 5-try LM solve (reference compute_lm_step, probe1d.py:887-993)."""
    success = torch.maximum(g0.abs(), g1.abs()) <= hp.tol
    db = torch.zeros_like(g0)
    dw = torch.zeros_like(g0)
    pred = torch.zeros_like(g0)
    clipped = torch.zeros_like(g0, dtype=torch.bool)
    for _ in range(5):
        active = ~success
        h0e = h0 + lam
        h2e = h2 + lam * qx_sq
        det = h0e * h2e - h1 * h1
        valid = active & (det.abs() > 1e-18)
        det_safe = torch.where(valid, det, 1.0)
        db_t = torch.where(valid, (h2e * g0 - h1 * g1) / det_safe, 0.0)
        dw_t = torch.where(valid, (h0e * g1 - h1 * g0) / det_safe, 0.0)
        norm = torch.sqrt(db_t**2 + (qx * dw_t) ** 2)
        clip = active & (norm > hp.delta_logit)
        scale = torch.where(clip, hp.delta_logit / (norm + 1e-18), 1.0)
        db_t, dw_t = db_t * scale, dw_t * scale
        pred_t = g0 * db_t + g1 * dw_t - 0.5 * (h0 * db_t**2 + 2 * h1 * db_t * dw_t + h2 * dw_t**2)
        ok = active & torch.isfinite(pred_t) & (pred_t > 0)
        lam = torch.where(active & ~ok, lam * hp.lam_grow, lam).clamp(hp.lam_min, hp.lam_max)
        success = success | ok
        db = torch.where(ok, db_t, db)
        dw = torch.where(ok, dw_t, dw)
        pred = torch.where(ok, pred_t, pred)
        clipped = torch.where(ok, clip, clipped)

    failed = ~success
    qx_safe = qx.clamp_min(1e-12)
    grad_scaled = torch.sqrt(g0**2 + (qx_safe * g1) ** 2)
    alpha = torch.where(grad_scaled > 0, hp.fallback_step_scale * hp.delta_logit / (grad_scaled + 1e-18), 0.0)
    db = torch.where(failed, -alpha * g0, db)
    dw = torch.where(failed, -alpha * g1, dw)
    pred = torch.where(failed, torch.nan, pred)
    return db, dw, pred, lam, clipped | failed


class Sparse1DProbe:
    """Vectorized trust-region probes over all (latent, class) pairs on the
    device (reference Sparse1DProbe, probe1d.py:427-786).

    Memory model: CSR events live on the device once (12 B/event); classes
    are processed in slabs whose y columns go to the device one slab at a
    time, so peak device use is events + O(n_latents × class_slab_size) state
    + one chunk's temporaries. `memory_budget_mb` auto-shrinks
    `class_slab_size`/`event_chunk_size` (the plan is logged). Runs on the
    card unless `device="cpu"`."""

    def __init__(
        self,
        *,
        n_latents: int,
        n_classes: int,
        class_slab_size: int = 8,
        event_chunk_size: int = 1 << 20,
        memory_budget_mb: int = 4096,
        device: str = "cuda",
        **hparams,
    ):
        self.n_latents = n_latents
        self.n_classes = n_classes
        self.class_slab_size = class_slab_size
        self.event_chunk_size = event_chunk_size
        self.memory_budget_mb = memory_budget_mb
        self.device = device_of(device)
        self.hp = ProbeHparams(**hparams)
        self.intercept_ = np.zeros((n_latents, n_classes), dtype=np.float32)
        self.coef_ = np.zeros((n_latents, n_classes), dtype=np.float32)
        self.n_iter_ = np.zeros((n_classes,), dtype=np.int32)

    def _plan(self, nnz: int, n_samples: int) -> MemoryPlan:
        plan = plan_memory(
            n_latents=self.n_latents,
            n_classes=self.n_classes,
            nnz=nnz,
            n_samples=n_samples,
            budget_bytes=self.memory_budget_mb << 20,
            max_class_slab=self.class_slab_size,
            max_event_chunk=self.event_chunk_size,
        )
        logger.info(
            "Memory plan: slab=%d chunk=%d events=%.1f MiB slab-state=%.1f MiB "
            "(budget %d MiB).",
            plan.class_slab_size, plan.event_chunk_size,
            plan.event_bytes / 2**20, plan.slab_bytes / 2**20,
            self.memory_budget_mb,
        )
        return plan

    # -- event preparation ----------------------------------------------------

    def _events(self, x: scipy.sparse.spmatrix, chunk_size: int | None = None) -> Events:
        """x's events on the device in pieces (`Events`), in chunks of
        `chunk_size` events' worth of pieces."""
        x = x.tocsc()
        x.sort_indices()
        counts = np.diff(x.indptr)
        n_pieces = -(-counts // PIECE)
        latent = np.repeat(np.arange(self.n_latents), n_pieces)
        within = np.arange(len(latent)) - np.repeat(np.cumsum(n_pieces) - n_pieces, n_pieces)
        start = x.indptr[latent] + PIECE * within
        length = np.minimum(PIECE, x.indptr[latent + 1] - start)
        idx = start[:, None] + np.arange(PIECE)
        valid = np.arange(PIECE) < length[:, None]
        idx = np.where(valid, idx, 0)
        rows = np.where(valid, x.indices[idx], 0).astype(np.int32)
        vals = np.where(valid, x.data[idx], 0).astype(np.float32)

        per_chunk = max((chunk_size or self.event_chunk_size) // PIECE, 1)
        chunks = []
        for p0 in range(0, len(latent), per_chunk):
            p1 = min(p0 + per_chunk, len(latent))
            lo, hi = int(latent[p0]), int(latent[p1 - 1]) + 1
            pieces = np.bincount(latent[p0:p1] - lo, minlength=hi - lo)
            chunks.append((p0, p1, lo, hi, torch.from_numpy(pieces).to(self.device)))
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)  # noqa: E731
        return Events(rows=to(rows), vals=to(vals), latent=to(latent), length=to(length), chunks=chunks)

    def _chunk(self, ev: Events, p0: int, p1: int, b: torch.Tensor, w: torch.Tensor, y_slab: torch.Tensor):
        """A chunk's logits and labels, each (c_b, pieces, PIECE), and its
        values and validity mask, (pieces, PIECE)."""
        lat, v = ev.latent[p0:p1], ev.vals[p0:p1]
        valid = (torch.arange(PIECE, device=v.device) < ev.length[p0:p1, None]).float()
        return b[lat].T[:, :, None] + w[lat].T[:, :, None] * v, y_slab[:, ev.rows[p0:p1]], v, valid

    def _latent_counts(self, x: scipy.sparse.csr_matrix):
        """Nonzeros and qx (RMS of the nonzero values, floored at 1e-6) per
        latent, as the JAX package's np.add.at sums them (np.bincount adds
        its weights in the same order)."""
        L = self.n_latents
        nnz_counts = np.bincount(x.indices, minlength=L).astype(np.int64)
        sum_sq = np.bincount(x.indices, weights=x.data.astype(np.float64) ** 2, minlength=L)
        assert len(nnz_counts) == L, f"x has latents past n_latents={L}"
        if nnz_counts.max(initial=0) >= EXACT_COUNT:
            raise ValueError(
                f"a latent has {nnz_counts.max()} events; the f32 counts are exact only below {EXACT_COUNT}"
            )
        rms = np.sqrt(np.where(nnz_counts > 0, sum_sq / np.maximum(nnz_counts, 1), 1.0))
        qx = np.maximum(np.where(nnz_counts > 0, rms, 1.0), 1e-6)
        return nnz_counts, qx.astype(np.float32)

    def _y_slab(self, y: np.ndarray, c0: int, c1: int) -> torch.Tensor:
        """y's columns c0:c1 on the device, class-major: (c1 - c0, n)."""
        return torch.from_numpy(np.ascontiguousarray(y[:, c0:c1].T)).to(self.device)

    # -- fit --------------------------------------------------------------------

    def _slab_stats(self, ev: Events, y_slab: torch.Tensor, b: torch.Tensor, w: torch.Tensor):
        """Event-streamed per-(latent, class) sums (reference
        _compute_slab_stats, probe1d.py:841-885): (L, 6, c_b) f32, in order
        mu_nz, g1, h0, h1, h2, pos_nz, and loss_nz (L, c_b) summed in f64."""
        acc = torch.zeros((b.shape[0], 6, b.shape[1]), dtype=torch.float32, device=self.device)
        loss_acc = torch.zeros(b.shape, dtype=torch.float64, device=self.device)
        for p0, p1, lo, hi, pieces in ev.chunks:
            logits, yc, v, valid = self._chunk(ev, p0, p1, b, w, y_slab)
            mu = torch.sigmoid(logits)
            s = mu * (1 - mu)
            # Numerically-stable BCE with logits.
            loss = logits.clamp_min(0) - logits * yc + torch.log1p(torch.exp(-logits.abs()))
            sv = s * v
            # Padding has v = 0, so only the terms without a factor v need the mask.
            acc[lo:hi] += _sums([mu, (mu - yc) * v, s, sv, sv * v, yc], valid,
                                (True, False, True, False, False, True), pieces)
            loss_acc[lo:hi] += _sums([loss.double()], valid, (True,), pieces)[:, 0]
        return acc, loss_acc

    def _iteration(self, ev: Events, carry, y_slab, pi_mean, base_slab, consts):
        """One outer LM iteration over a class slab (reference
        probe1d.py:632-825). Returns the new carry and the telemetry, stacked
        in AUX_FIELDS order."""
        hp = self.hp
        qx, qx_sq, empty, zeros_frac, n_f = consts
        b, w, lam, prev_pred, prev_loss, prev_clipped = carry
        stats, loss_nz = self._slab_stats(ev, y_slab, b, w)
        mu_nz, g1_nz, h0_nz, h1_nz, h2_nz, pos_nz = stats.unbind(1)

        mu0 = torch.sigmoid(b).clamp(hp.eps, 1 - hp.eps)
        s0 = mu0 * (1 - mu0)
        g0 = mu_nz / n_f + zeros_frac * mu0 - pi_mean
        g0 = g0 + hp.ridge * (b - base_slab)
        g1 = g1_nz / n_f + hp.ridge * w
        h0 = h0_nz / n_f + zeros_frac * s0 + hp.ridge
        h1 = h1_nz / n_f
        h2 = h2_nz / n_f + hp.ridge

        # The loss in f64: near convergence an LM step changes it by less
        # than f32 resolves at its size, and rho would be rounding noise.
        b64, w64, zf64 = b.double(), w.double(), zeros_frac.double()
        mu0_64 = torch.sigmoid(b64).clamp(hp.eps, 1 - hp.eps)
        pos_zero = torch.minimum((pi_mean.double() - pos_nz.double() / n_f).clamp_min(0.0), zf64)
        neg_zero = zf64 - pos_zero
        zero_loss = -(pos_zero * torch.log(mu0_64) + neg_zero * torch.log1p(-mu0_64.clamp_max(1 - hp.eps)))
        ridge_pen = 0.5 * hp.ridge * (w64**2 + (b64 - base_slab.double()) ** 2)
        loss_curr = loss_nz / n_f + zero_loss + ridge_pen

        g0 = torch.where(empty, 0.0, g0)
        g1 = torch.where(empty, 0.0, g1)
        lam = torch.where(empty, hp.lam_init, lam)

        mask_prev = torch.isfinite(prev_pred) & torch.isfinite(prev_loss)
        rho = torch.where(mask_prev, (prev_loss - loss_curr) / prev_pred.clamp_min(1e-18), 0.0)
        grow = mask_prev & ((rho <= 0.25) | prev_clipped)
        shrink = mask_prev & (rho >= 0.75) & (~prev_clipped)
        lam = torch.where(shrink, lam * hp.lam_shrink, torch.where(grow, lam * hp.lam_grow, lam))
        lam = lam.clamp(hp.lam_min, hp.lam_max)

        db, dw, pred, lam, clipped = _lm_step(hp, qx, qx_sq, g0, g1, h0, h1, h2, lam)
        fallback = torch.isnan(pred) & ~empty
        b = torch.where(empty, base_slab, b - db)
        w = torch.where(empty, 0.0, w - dw)
        pred = torch.where(empty, 0.0, pred)
        clipped = torch.where(empty, False, clipped)
        prev_pred = torch.where(empty, torch.nan, pred)

        qx_safe = qx.clamp_min(1e-12)
        grad_abs = torch.maximum(g0.abs(), (g1 / qx_safe).abs())
        step_abs = torch.maximum(db.abs(), (qx * dw).abs())
        # Per-iteration telemetry aggregates (reference probe1d.py:795-816).
        aux = torch.stack([t.double() for t in (
            grad_abs.max(), step_abs.max(), lam.mean(), loss_curr.mean(), loss_curr.max(), rho.mean(), rho.min(),
            torch.nanmean(torch.where(empty, torch.nan, pred)),
            1.0 - fallback.float().mean(), fallback.sum(), (clipped & ~fallback).sum(),
        )])
        return (b, w, lam, prev_pred, loss_curr, clipped), aux

    @torch.no_grad()
    def fit(self, x: scipy.sparse.spmatrix, y: np.ndarray) -> "Sparse1DProbe":
        x = x.tocsr()
        n_samples, n_latents = x.shape
        assert n_latents == self.n_latents
        y = np.asarray(y, dtype=np.float32)
        assert y.shape == (n_samples, self.n_classes)
        hp = self.hp
        dev = self.device

        plan = self._plan(x.nnz, n_samples)
        nnz_counts, qx_np = self._latent_counts(x)
        ev = self._events(x, plan.event_chunk_size)
        n_zeros = (n_samples - nnz_counts).clip(min=0).astype(np.float32)
        n_f = float(n_samples)
        L = self.n_latents
        qx = torch.from_numpy(qx_np).to(dev)[:, None]
        empty = torch.from_numpy(nnz_counts == 0).to(dev)[:, None]
        zeros_frac = torch.from_numpy(n_zeros).to(dev)[:, None] / n_f
        consts = (qx, qx * qx, empty, zeros_frac, n_f)

        pi_all = np.clip(y.mean(axis=0), hp.eps, 1 - hp.eps)
        base_all = np.log(pi_all / (1 - pi_all)).astype(np.float32)
        emit = stats_log.isEnabledFor(logging.DEBUG)

        slab = plan.class_slab_size
        for c0 in range(0, self.n_classes, slab):
            c1 = min(c0 + slab, self.n_classes)
            c_b = c1 - c0
            # y never lives on the device whole (the memory plan's y_cost term).
            y_slab = self._y_slab(y, c0, c1)
            pi_mean = torch.from_numpy(pi_all[c0:c1].astype(np.float32)).to(dev)[None, :]
            base_slab = torch.from_numpy(base_all[c0:c1]).to(dev)[None, :].expand(L, c_b)
            nan = torch.full((L, c_b), torch.nan, device=dev)
            carry = (base_slab, torch.zeros((L, c_b), device=dev), torch.full((L, c_b), hp.lam_init, device=dev),
                     nan, nan.double(), torch.zeros((L, c_b), dtype=torch.bool, device=dev))
            n_iter = hp.max_iter
            for it in range(hp.max_iter):
                carry, aux = self._iteration(ev, carry, y_slab, pi_mean, base_slab, consts)
                fields = dict(zip(AUX_FIELDS, aux.tolist()))  # the iteration's one host sync
                if emit:
                    fields = {k: int(v) if k in _COUNT_FIELDS else v for k, v in fields.items()}
                    peak = _device_peak_gb(dev)
                    if peak is not None:
                        fields["device_peak_gb"] = peak
                    _emit_event("probe_iteration", slab=[c0, c1], iter=it, **fields)
                # Reference probe1d.py:821-823: all(grad <= tol) terminates (its
                # second clause, grad < tol and step < tol, is implied).
                if fields["grad_max"] <= hp.tol:
                    n_iter = it + 1
                    break
            self.intercept_[:, c0:c1] = carry[0].cpu().numpy()
            self.coef_[:, c0:c1] = carry[1].cpu().numpy()
            self.n_iter_[c0:c1] = n_iter
        return self

    # -- evaluation --------------------------------------------------------------

    @torch.no_grad()
    def _eval_sums(self, x: scipy.sparse.spmatrix, y: np.ndarray, aux: bool) -> list[np.ndarray]:
        """Per-(latent, class) sums over x's events with the fitted params:
        [loss_nz, pos_nz] and, with `aux`, [tp_nz, fp_nz] at decision
        threshold 0, each (L, n_classes) f32."""
        n_samples = x.shape[0]
        plan = self._plan(x.nnz, n_samples)
        ev = self._events(x, plan.event_chunk_size)
        L, k = self.n_latents, 4 if aux else 2
        out = np.zeros((k, L, self.n_classes), dtype=np.float32)
        for c0 in range(0, self.n_classes, plan.class_slab_size):
            c1 = min(c0 + plan.class_slab_size, self.n_classes)
            b = torch.from_numpy(np.ascontiguousarray(self.intercept_[:, c0:c1])).to(self.device)
            w = torch.from_numpy(np.ascontiguousarray(self.coef_[:, c0:c1])).to(self.device)
            y_slab = self._y_slab(y, c0, c1)
            acc = torch.zeros((L, k, c1 - c0), dtype=torch.float32, device=self.device)
            for p0, p1, lo, hi, pieces in ev.chunks:
                z, yc, _, valid = self._chunk(ev, p0, p1, b, w, y_slab)
                parts = [z.clamp_min(0) - z * yc + torch.log1p(torch.exp(-z.abs())), yc]
                if aux:
                    pred = (z > 0).float()
                    parts += [pred * yc, pred * (1 - yc)]
                acc[lo:hi] += _sums(parts, valid, (True,) * k, pieces)
            out[:, :, c0:c1] = acc.permute(1, 0, 2).cpu().numpy()
        return list(out)

    def _loss(self, loss_nz: np.ndarray, pos_nz: np.ndarray, nnz_counts: np.ndarray, y: np.ndarray) -> np.ndarray:
        """Mean BCE from the nonzero events' sums and the analytic
        zero-feature terms."""
        n_samples = y.shape[0]
        n_zeros = (n_samples - nnz_counts).clip(min=0).astype(np.float32)
        pi = y.mean(axis=0)[None, :]
        mu0 = np.clip(sigmoid(self.intercept_.astype(np.float64)), self.hp.eps, 1 - self.hp.eps)
        zeros_frac = (n_zeros / n_samples)[:, None]
        pos_zero = np.minimum(np.clip(pi - pos_nz / n_samples, 0.0, None), zeros_frac)
        neg_zero = zeros_frac - pos_zero
        zero_loss = -(pos_zero * np.log(mu0) + neg_zero * np.log1p(-np.minimum(mu0, 1 - self.hp.eps)))
        return (loss_nz / n_samples + zero_loss).astype(np.float32)

    def loss_matrix(self, x: scipy.sparse.spmatrix, y: np.ndarray) -> np.ndarray:
        """Mean BCE per (latent, class) on (x, y) with the fitted params
        (reference loss_matrix, probe1d.py:1185-1265)."""
        x = x.tocsr()
        y = np.asarray(y, dtype=np.float32)
        loss_nz, pos_nz = self._eval_sums(x, y, aux=False)
        return self._loss(loss_nz, pos_nz, self._latent_counts(x)[0], y)

    def loss_matrix_with_aux(
        self, x: scipy.sparse.spmatrix, y: np.ndarray
    ) -> tuple[np.ndarray, ...]:
        """(loss, tp, fp, tn, fn) per (latent, class) at decision threshold 0
        (reference loss_matrix_with_aux, probe1d.py:1267-1336), from one pass
        over the events. Confusion counts decompose into streamed nonzero
        events + analytic zero-feature terms."""
        x = x.tocsr()
        n_samples = x.shape[0]
        y = np.asarray(y, dtype=np.float32)
        loss_nz, pos_nz, tp_nz, fp_nz = self._eval_sums(x, y, aux=True)
        nnz_counts, _ = self._latent_counts(x)
        loss = self._loss(loss_nz, pos_nz, nnz_counts, y)

        n_nz = nnz_counts.astype(np.float64)[:, None]
        n_zero = np.maximum(n_samples - n_nz, 0.0)
        total_pos = y.sum(axis=0)[None, :]
        pos_zero = np.clip(total_pos - pos_nz, 0.0, None)
        pred0 = (self.intercept_ > 0).astype(np.float64)

        tp = tp_nz + pred0 * pos_zero
        fp = fp_nz + pred0 * (n_zero - pos_zero)
        fn = total_pos - tp
        tn = n_samples - tp - fp - fn
        return (
            loss,
            tp.astype(np.float32),
            fp.astype(np.float32),
            tn.astype(np.float32),
            fn.astype(np.float32),
        )

    def decision_function(self, x: scipy.sparse.spmatrix, latent: int) -> np.ndarray:
        col = np.asarray(x[:, latent].todense()).reshape(-1)
        return self.intercept_[latent][None, :] + self.coef_[latent][None, :] * col[:, None]

    def predict_proba(self, x: scipy.sparse.spmatrix, latent: int) -> np.ndarray:
        return sigmoid(self.decision_function(x, latent))


@dataclasses.dataclass(frozen=True)
class Config:
    """Probe training pipeline config (reference probe1d.py:1343-1374): the
    JAX package's fields and defaults but for `device`."""

    run: pathlib.Path = pathlib.Path("./runs/abcdefg")
    """Run directory."""
    train_shards: pathlib.Path = pathlib.Path("./shards/01234567")
    """Training shards directory."""
    test_shards: pathlib.Path = pathlib.Path("./shards/abcdef01")
    """Test shards directory."""
    ridge: float = 1e-8
    class_slab_size: int = 8
    max_iter: int = 30
    memory_budget_mb: int = 4096
    """Device-memory budget; the fit auto-shrinks slab/chunk sizes to fit
    (see plan_memory)."""
    debug: bool = False
    device: tp.Literal["cuda", "cpu"] = "cuda"
    """Where the fit runs: the card unless "cpu" is asked for."""


def _one_hot(labels: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((labels.size, n), dtype=np.float32)
    out[np.arange(labels.size), labels] = 1.0
    return out


def worker_fn(cfg: Config) -> int:
    """Fit probes on the train split, dump probe1d_metrics.npz (loss, weights,
    biases, confusion counts) for both splits (reference probe1d.py:1390-1694)."""
    from .. import disk
    from ..data import Metadata

    run = disk.Run(cfg.run)

    def load_split(shards: pathlib.Path):
        art = run.inference / shards.name
        _emit_event("load_csr_start", split=shards.name, fpath=str(art / "token_acts.npz"))
        acts = scipy.sparse.load_npz(art / "token_acts.npz").tocsr()
        _emit_event("load_csr_end", split=shards.name, nnz=int(acts.nnz))
        md = Metadata.load(shards)
        labels = np.memmap(
            shards / "labels.bin", mode="r", dtype=np.uint8,
            shape=(md.n_examples, md.content_tokens_per_example),
        ).reshape(-1)
        return art, acts, np.asarray(labels)

    train_art, train_acts, train_labels = load_split(cfg.train_shards)
    test_art, test_acts, test_labels = load_split(cfg.test_shards)

    n_classes = int(max(train_labels.max(), test_labels.max())) + 1
    n_latents = train_acts.shape[1]
    assert test_acts.shape[1] == n_latents

    probe = Sparse1DProbe(
        n_latents=n_latents, n_classes=n_classes,
        class_slab_size=cfg.class_slab_size, ridge=cfg.ridge, max_iter=cfg.max_iter,
        memory_budget_mb=cfg.memory_budget_mb, device=cfg.device,
    )
    probe.fit(train_acts, _one_hot(train_labels, n_classes))
    logger.info("Fit probe on %d samples.", train_acts.shape[0])

    for art, acts, labels in (
        (train_art, train_acts, train_labels),
        (test_art, test_acts, test_labels),
    ):
        loss, tp, fp, tn, fn = probe.loss_matrix_with_aux(acts, _one_hot(labels, n_classes))
        out_fpath = art / "probe1d_metrics.npz"
        np.savez(
            out_fpath,
            loss=loss, weights=probe.coef_, biases=probe.intercept_,
            tp=tp, fp=fp, tn=tn, fn=fn,
        )
        logger.info("Saved probe outputs to %s.", out_fpath)
    return 0


def cli(cfg: Config, sweep: pathlib.Path | None = None) -> None:
    """Run the probe pipeline; with --sweep, expand a sweep file of config
    dicts (one worker per expanded config)."""
    from .. import configs

    logging.basicConfig(level=logging.INFO)
    if sweep is None:
        raise SystemExit(worker_fn(cfg))
    sweep_dcts = configs.load_sweep(sweep)
    if not sweep_dcts:
        # Never silently fall back to the bare CLI config.
        logger.error("No valid sweeps found in '%s'.", sweep)
        raise SystemExit(1)
    cfgs, errs = configs.load_cfgs(cfg, default=Config(), sweep_dcts=sweep_dcts)
    for err in errs:
        logger.warning("Error in config: %s", err)
    rc = 0
    for i, c in enumerate(cfgs, start=1):
        logger.info("Running probe1d config %d/%d.", i, len(cfgs))
        rc = max(rc, worker_fn(c))
    raise SystemExit(rc)
