"""
Generic Gaussian-process model (counterpart of `bild_tpu.models.ggm`).

Pure states are Gaussian processes specified by their MSD; the likelihood of
a profile factorizes over constant-state intervals, with trajectory
continuity enforced by conditioning each interval on the last observation of
the previous one.

Design
------
There are only ``nStates * T * (T+1) / 2`` distinct interval contributions
for a trajectory of length T, each a function of ``(state, t0, t1)`` alone.
They are computed ALL once per trajectory (batch) into an **interval
table**, and a profile batch's log-likelihood is a gather-sum over its
interval decomposition: one set of tensor operations for any number of
profiles and lanes.

The MSD functions are host callables, but they are only ever evaluated at
integer lags ``0..T`` (plus the plateau at infinity), so each becomes a lag
table; nothing else crosses from the host. The tables are built on the
model's device in float64 (Cholesky factors of window covariances near an
MSD's plateau are badly conditioned) and stored in the model's ``dtype``.
Three ways to build them, as in `bild_tpu`:

- gap-free trajectories: the window covariance depends on the window length
  alone, so one Cholesky factor serves every start and one triangular solve
  with prefix sums yields every end (`_stationary_tables_batch`);
- trajectories with missing frames: one batched Cholesky per window-length
  bucket over identity-padded blocks (`_bucketed_tables_batch`);
- long gap-free trajectories with ``T_band``: banded tables
  (`_banded_tables_batch`).

Continuity conditioning uses the Gaussian factorization
``log N(v; 0, C) = log N(v0; 0, C00) + log N(v_rest - v0 * C10/C00; 0, Schur)``
with the reference's exact conditional (which conditions on the *raw* first
datum, not the mean-subtracted one): set ``v = [trace_0, trace_rest - m]``
and subtract the ``v0`` marginal.

The gather-sums have no kernel/plain pair: one implementation runs on both
devices. `logL_host` is the straight float64 host algorithm, the oracle.
"""
from __future__ import annotations

import functools
import math
import warnings
from typing import Optional

import numpy as np
import torch
from scipy import linalg as sp_linalg

from ..config import DEFAULT_DEVICE, resolve_device
from ..lanes import lane_sum
from ..physics import gp
from ..physics.rouse import two_locus_msd
from ..profiles import Loopingprofile
from ..trajectory import Trajectory
from .base import MultiStateModel, tensor_token

__all__ = ["GenericGaussianModel"]

LOG_2PI = float(np.log(2.0 * np.pi))

# float64 elements per temporary block of a table build (1 GiB each; a
# build holds a handful at once)
_CHUNK_ELEMS = 1 << 27


# ---------------------------------------------------------------------------
# table entries (float64, on the model's device)
# ---------------------------------------------------------------------------

def _masked_gaussian_logpdf(x, C, n_terms):
    """``log N(x; 0, C)`` over the last axes of ``x (..., L)``, ``C (..., L,
    L)``, where inactive rows/cols of C are identity and inactive x are
    zero; ``n_terms`` counts the active entries for the 2-pi term. NaN
    where a factorization fails (one batched Cholesky, no error fetch)."""
    chol, info = torch.linalg.cholesky_ex(C, check_errors=False)
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    y = torch.linalg.solve_triangular(chol, x[..., None], upper=False)[..., 0]
    lp = -0.5 * ((y * y).sum(-1) + logdet + n_terms * LOG_2PI)
    return torch.where(info == 0, lp, math.nan)


def _interval_entries(t0, t1, values, valid, msd_tab, plateau, mean, *,
                      ss_order, Lb):
    """
    Interval log-likelihood contributions for one (state, dim), any gap
    pattern.

    t0, t1 : (C,) int64 interval starts (incl.) / ends (excl.), every
        conditioning window at most ``Lb`` frames
    values : (B, T) observed values of this dim (zeros at missing frames)
    valid : (B, T) bool
    msd_tab : (T+1,) MSD at integer lags
    plateau, mean : floats, MSD(inf) (ss_order 0 only) and the state mean

    Returns ``(B, C)``.
    """
    B, T = values.shape
    dev = values.device
    ar = torch.arange(Lb, device=dev)
    w = (t0 - 1).clamp(min=0)[:, None] + ar[None, :]            # (C, Lb)
    wc = w.clamp(max=T - 1)
    act = (w < t1[:, None])[None] & valid[:, wc]                # (B, C, Lb)

    if ss_order == 0:
        vals = values[:, wc]
        nobs = act.sum(-1).to(values.dtype)
        conditioning = (t0 > 0)[None] & (nobs > 0)
        # hybrid vector: raw first valid datum when conditioning, centered
        # elsewhere (reproduces the reference's mu = trace[0] * C10/C00)
        i0 = act.to(torch.int64).argmax(-1)                     # first valid
        first = ar == i0[..., None]
        x = torch.where(conditioning[..., None] & first, vals, vals - mean)
        x = torch.where(act, x, 0.0)

        lag = (w[:, :, None] - w[:, None, :]).abs().clamp(max=T)
        Cfull = 0.5 * (plateau - msd_tab[lag])                  # (C, Lb, Lb)
        eye = torch.eye(Lb, dtype=values.dtype, device=dev)
        C = torch.where(act[..., :, None] & act[..., None, :], Cfull[None], eye)
        lp = _masked_gaussian_logpdf(x, C, nobs)

        c00 = 0.5 * plateau
        v0 = torch.gather(vals, 2, i0[..., None])[..., 0]
        lp0 = -0.5 * (v0 ** 2 / c00 + math.log(c00) + LOG_2PI)
        return lp - torch.where(conditioning, lp0, 0.0)

    # ss_order 1: compact the valid frame times to the front (ascending)
    v = torch.sort(torch.where(act, w[None], T + Lb), dim=-1).values
    K = act.sum(-1)
    inc_act = ar[:-1] < (K - 1)[..., None]                      # (B, C, Lb-1)
    xv = torch.gather(values, 1, v.clamp(max=T - 1).reshape(B, -1)).reshape(v.shape)
    x = torch.where(inc_act, xv[..., 1:] - xv[..., :-1] - mean, 0.0)
    a, b = v[..., :-1], v[..., 1:]

    def m(p, q):
        return msd_tab[(p[..., :, None] - q[..., None, :]).abs().clamp(max=T)]

    Cfull = 0.5 * (m(a, b) + m(b, a) - m(a, a) - m(b, b))
    eye = torch.eye(Lb - 1, dtype=values.dtype, device=dev)
    C = torch.where(inc_act[..., :, None] & inc_act[..., None, :], Cfull, eye)
    n_inc = (K - 1).clamp(min=0).to(values.dtype)
    return _masked_gaussian_logpdf(x, C, n_inc)


def _stationary_prefix_entries(values, u, cond, Lchol, logdet_cum, mean, c00,
                               *, ss_order, W, T):
    """
    All interval contributions for gap-free trajectories via the Toeplitz
    structure of stationary windows.

    For a fully-observed trajectory, the window covariance of interval
    ``[t0, t1)`` depends only on the WINDOW LENGTH (``C_kl = f(|k-l|)``), so
    one Cholesky factor ``Lchol`` of the maximal window covariance is shared
    by every start, its leading submatrices factor every shorter window, and
    forward substitution is prefix-consistent: ONE triangular solve yields
    every ``t1`` at once via prefix sums of ``y^2`` (the per-interval
    Cholesky of the bucketed path is O(T^5) total across the table; this is
    O(T^3)).

    values : (B, T); u : (C,) window starts; cond : (C,) bool, continuity
    conditioning (ss_order 0: first window datum enters RAW, and the caller
    subtracts its marginal `lp0`). Returns ``(lp (B, C, W), lp0 (B, C))``
    where ``lp[b, c, k]`` is the Gaussian log-density of the first ``k+1``
    window entries (frames for ss0; increments for ss1).
    """
    B, C = values.shape[0], u.shape[0]
    kar = torch.arange(W, device=values.device)
    idx = u[:, None] + kar[None, :]                             # (C, W)
    if ss_order == 0:
        inb = idx < T
        g = values[:, idx.clamp(0, T - 1)]                      # (B, C, W)
        raw = cond[:, None] & (kar == 0)[None, :]
        x = torch.where(raw[None], g, g - mean)
        lp0 = torch.where(
            cond[None, :],
            -0.5 * (g[:, :, 0] ** 2 / c00 + math.log(c00) + LOG_2PI), 0.0)
    else:
        inb = (idx + 1) < T
        lo = values[:, idx.clamp(0, T - 1)]
        hi = values[:, (idx + 1).clamp(0, T - 1)]
        x = hi - lo - mean
        lp0 = values.new_zeros((B, C))
    x = torch.where(inb[None], x, 0.0)

    y = torch.linalg.solve_triangular(Lchol, x.reshape(B * C, W).T,
                                      upper=False)              # (W, B*C)
    quad = torch.cumsum(y * y, dim=0)
    lp = -0.5 * (quad + logdet_cum[:, None]
                 + (kar + 1).to(values.dtype)[:, None] * LOG_2PI)
    return lp.T.reshape(B, C, W), lp0


def _stationary_cov(msd_fun, ss_order, Wd):
    """Stationary covariance of ``Wd`` consecutive window ENTRIES (frames
    for ss_order 0, increments for ss_order 1), host float64: ``(Cfull (Wd,
    Wd), c00)`` with ``c00`` the unconditional first-entry variance."""
    msd_tab = np.asarray(msd_fun(np.arange(Wd + 2, dtype=float)), dtype=float)
    km = np.abs(np.subtract.outer(np.arange(Wd), np.arange(Wd)))
    if ss_order == 0:
        plateau = float(msd_fun(np.inf))
        return 0.5 * (plateau - msd_tab[km]), 0.5 * plateau
    return 0.5 * (msd_tab[np.abs(km - 1)] + msd_tab[km + 1]
                  - 2 * msd_tab[km]), 1.0


def _length_buckets(max_len):
    out = []
    b = 8
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(b)
    return out


@functools.lru_cache(maxsize=8)
def _bucketed_pairs(T):
    """``{Lb: (t0s, t1s)}`` (numpy int64): every interval ``[t0, t1)`` of a
    length-T trajectory, grouped by the bucket of its conditioning-window
    length. Depends on T alone, so it is built once per T."""
    t0, t1 = np.triu_indices(T + 1, k=1)       # t0-major, as nested loops
    wlen = t1 - np.maximum(t0 - 1, 0)
    edges = np.array(_length_buckets(T + 1))
    which = edges[np.searchsorted(edges, wlen)]
    return {int(Lb): (t0[which == Lb], t1[which == Lb])
            for Lb in np.unique(which)}


# ---------------------------------------------------------------------------
# gather-sums: profiles (L, P, T) against flat tables (L, ...)
# ---------------------------------------------------------------------------

def _dense_intervals(profiles):
    """Every frame as a candidate interval start: ``(t0, t1, s, is_start)``,
    each ``(L, P, T)``, with ``t1`` the next start strictly after ``t0``."""
    L, P, T = profiles.shape
    tgrid = torch.arange(T, device=profiles.device)
    start = torch.cat([torch.ones((L, P, 1), dtype=torch.bool,
                                  device=profiles.device),
                       profiles[..., 1:] != profiles[..., :-1]], dim=-1)
    idx = torch.where(start, tgrid, T)
    suffix_min = idx.flip(-1).cummin(-1).values.flip(-1)
    nxt = torch.cat([suffix_min[..., 1:], idx.new_full((L, P, 1), T)], dim=-1)
    return tgrid.expand(L, P, T), nxt, profiles, start


def _sparse_intervals(profiles, Kcap):
    """First ``Kcap`` interval ``(t0, t1, state)`` triples per profile, plus
    a slot-valid mask and an ``ok`` flag (False where a profile has more
    than ``Kcap`` intervals). Padded slots have ``t0 = T``."""
    L, P, T = profiles.shape
    tgrid = torch.arange(T, device=profiles.device)
    start = torch.cat([torch.ones((L, P, 1), dtype=torch.bool,
                                  device=profiles.device),
                       profiles[..., 1:] != profiles[..., :-1]], dim=-1)
    idx = torch.where(start, tgrid, T)
    t0 = torch.topk(idx, Kcap, dim=-1, largest=False, sorted=True).values
    t1 = torch.cat([t0[..., 1:], t0.new_full((L, P, 1), T)], dim=-1)
    slot_ok = t0 < T
    ok = start.sum(-1) <= Kcap
    s = torch.gather(profiles, 2, t0.clamp(0, T - 1))
    return t0, t1, s, slot_ok, ok


def _take(flat, idx):
    """``flat[l, idx[l, ...]]`` per lane (int64 indices, in range)."""
    return torch.gather(flat, 1, idx.reshape(idx.shape[0], -1)).reshape(idx.shape)


def _full_values(t0, t1, s, Vflat, n_states, T):
    """``Vflat[(s*T + t0)*(T+1) + t1]``: the contribution of interval
    ``[t0, t1)`` in state s, every index clipped into range."""
    flat = ((s.clamp(0, n_states - 1) * T + t0.clamp(0, T - 1)) * (T + 1)
            + t1.clamp(0, T))
    return _take(Vflat, flat)


def _banded_values(t0, t1, s, Bandflat, Headflat, Gflat, n_states, T, Lb):
    """
    Interval contributions from the banded tables (see
    ``GenericGaussianModel`` ``T_band``).

    ``Bandflat[(s*T + t0)*(Lb+1) + l]`` is the exact contribution of interval
    ``[t0, t0+l)`` for ``l <= Lb``. Longer intervals decompose into the exact
    W-frame head window plus per-frame sliding-window conditionals:

        V[t0, t1] = Head[s*T + t0] + G[s*T + t1 - 1] - G[s*T + u + Lb]

    with ``u = max(t0-1, 0)``, ``W = Lb+1``, ``G`` the cumulative sum of
    ``g[t] = log p(x_t | x_{t-Lb..t-1})``. Every index is clipped into range.
    """
    s = s.clamp(0, n_states - 1)
    t0 = t0.clamp(0, T - 1)
    length = t1 - t0
    u = (t0 - 1).clamp(min=0)
    row = s * T
    band = _take(Bandflat, (row + t0) * (Lb + 1) + length.clamp(0, Lb))
    tail = (_take(Headflat, row + t0)
            + _take(Gflat, row + (t1 - 1).clamp(0, T - 1))
            - _take(Gflat, row + (u + Lb).clamp(0, T - 1)))
    return torch.where(length <= Lb, band, tail)


def _finish(val, live, profiles, n_states, ok, exact):
    """Sum the live slots per profile; NaN where a state lies outside ``[0,
    n_states)`` (same contract as the Rouse kernels) or ``ok`` is False."""
    total = lane_sum(torch.where(live, val, 0.0), exact=exact)
    good = ((profiles >= 0) & (profiles < n_states)).all(-1)
    if ok is not None:
        good = good & ok
    return torch.where(good, total, math.nan)


def _profile_table_sum(profiles, Vflat, n_states, exact=False):
    """Gather-sum of ``(L, P, T)`` profiles' interval contributions from the
    flat full tables ``(L, n*T*(T+1))``, touching every frame: ``(L, P)``."""
    profiles = profiles.long()
    T = profiles.shape[-1]
    t0, t1, s, start = _dense_intervals(profiles)
    val = _full_values(t0, t1, s, Vflat, n_states, T)
    return _finish(val, start, profiles, n_states, None, exact)


def _profile_table_sum_banded(profiles, Bandflat, Headflat, Gflat, n_states,
                              Lb, exact=False):
    """`_profile_table_sum` on the banded tables."""
    profiles = profiles.long()
    T = profiles.shape[-1]
    t0, t1, s, start = _dense_intervals(profiles)
    val = _banded_values(t0, t1, s, Bandflat, Headflat, Gflat, n_states, T, Lb)
    return _finish(val, start, profiles, n_states, None, exact)


# Profiles of an AMIS sampler come from st2profile of K-slot parameters, so
# they carry at most K intervals, while the dense sums above gather at all T
# positions of each. The sparse variants extract the interval starts with
# one top-k and gather only there. The caller states the bound
# (``max_intervals``); a profile that breaks it gives NaN, never a wrong
# sum.

def _profile_table_sum_sparse(profiles, Vflat, n_states, Kcap, exact=False):
    """`_profile_table_sum` evaluated only at the first ``Kcap`` interval
    starts (see `_sparse_intervals`)."""
    profiles = profiles.long()
    T = profiles.shape[-1]
    t0, t1, s, slot_ok, ok = _sparse_intervals(profiles, min(Kcap, T))
    val = _full_values(t0, t1, s, Vflat, n_states, T)
    return _finish(val, slot_ok, profiles, n_states, ok, exact)


def _profile_table_sum_banded_sparse(profiles, Bandflat, Headflat, Gflat,
                                     n_states, Lb, Kcap, exact=False):
    """`_profile_table_sum_banded` evaluated only at the first ``Kcap``
    interval starts."""
    profiles = profiles.long()
    T = profiles.shape[-1]
    t0, t1, s, slot_ok, ok = _sparse_intervals(profiles, min(Kcap, T))
    val = _banded_values(t0, t1, s, Bandflat, Headflat, Gflat, n_states, T, Lb)
    return _finish(val, slot_ok, profiles, n_states, ok, exact)


class GenericGaussianModel(MultiStateModel):
    """
    ``state_spec`` is an ``(nStates, d)`` nested sequence of
    ``(msd_fun, mean, ss_order)`` triples; ``ss_order`` is 0 (positionally
    stationary) or 1 (increment-stationary).

    T_band : optional int (>= 8)
        Long-trajectory mode: for gap-free trajectories with ``T > T_band``,
        interval contributions are computed from a BANDED table, exact for
        intervals whose conditioning window fits in ``T_band`` frames, and
        a per-frame sliding-window conditional (memory ``T_band - 1``) for
        the tail of longer intervals. Memory/build cost drop from
        O(n T^2) / O(T^3) to O(n T T_band) / O(T T_band^2).

        The tail is a truncated-memory approximation: the conditional of a
        frame given its last ``T_band - 1`` observations instead of the
        whole window. The error depends on the MSD's memory and is
        CONTROLLED: at table-build time the model-expected worst-case tail
        error (`band_tail_error`, a closed-form Gaussian-KL estimate from
        the stationary window covariance) is evaluated against
        ``band_tol``:

        - ``T_band='auto'`` picks the smallest power-of-two band (>= 32)
          whose estimate is within ``band_tol`` for the batch's T, falling
          back to the exact tables when no band below T qualifies;
        - an explicit integer ``T_band`` emits a ``UserWarning`` (with the
          estimate, stored in ``band_error_estimate``) when it exceeds
          ``band_tol``.

        Leave ``T_band=None`` (default) when parity with `logL_host`
        matters more than memory. Trajectories with missing frames always
        use the exact tables and raise if they exceed ``T_band``.

    band_tol : float (nats, default 0.1)
        tolerance for the estimated worst-case per-trajectory tail error;
        compare against your evidence differences of interest (AMIS
        evidence SEMs are typically 0.01-0.1 nats).

    device, dtype : where the interval tables live and run (the GPU unless
        ``device="cpu"``), and the type they are stored in; they are always
        built in float64.
    """

    def __init__(self, state_spec, T_band=None, band_tol=0.1, *,
                 device=DEFAULT_DEVICE, dtype=torch.float32):
        self.state_spec = np.asarray(state_spec, dtype=object)
        assert len(self.state_spec.shape) == 3
        self.init_transitions(self.state_spec.shape[0])
        if isinstance(T_band, str):
            if T_band != "auto":
                raise ValueError(f"T_band must be None, an int >= 8, or "
                                 f"'auto'; got {T_band!r}")
            self.T_band = "auto"
        elif T_band is not None and int(T_band) < 8:
            raise ValueError(f"T_band must be >= 8, got {T_band}")
        else:
            self.T_band = None if T_band is None else int(T_band)
        self.band_tol = float(band_tol)
        self.band_error_estimate = None   # last explicit-band estimate
        self.device = resolve_device(device)
        self.dtype = dtype
        self.table_builds = 0             # payloads built (not cache hits)
        self._auto_band_cache = {}
        self._lockstep_logL_fns = {}
        self.clear_memo()

    # -- MSD constructors --------------------------------------------------
    @staticmethod
    def MSD_function_powerlaw(G=1.0, a=1.0, noise2=0.0, motion_blur_f=0.0):
        @gp.MSDfun
        @gp.imaging(noise2=noise2, f=motion_blur_f, alpha0=a)
        def msd(dt, G=G, a=a):
            return G * dt**a

        return msd

    @staticmethod
    def MSD_function_twoLocusRouse(G=1.0, J=1.0, noise2=0.0, motion_blur_f=0.0):
        @gp.MSDfun
        @gp.imaging(noise2=noise2, f=motion_blur_f, alpha0=0.5)
        def msd(dt, G=G, J=J):
            return two_locus_msd(dt, G, J)

        return msd

    @property
    def d(self):
        return self.state_spec.shape[1]

    def _fingerprint_parts(self):
        # per-(state, dim) MSD sampled on integer lags (what the interval
        # tables consume) + a deep-lag plateau probe, plus the means,
        # ss_orders, and band configuration
        dts = np.arange(1, 513, dtype=float)
        parts = []
        for s in range(self.state_spec.shape[0]):
            for dim in range(self.state_spec.shape[1]):
                msd_fun, mean, sso = self.state_spec[s, dim]
                parts.append(np.asarray(msd_fun(dts), dtype=float))
                parts.append([float(mean), float(sso),
                              float(msd_fun(1e9))])
        band = (-2.0 if self.T_band == "auto"
                else -1.0 if self.T_band is None else float(self.T_band))
        parts.append([band, self.band_tol])
        return parts

    # -- frame-factorized scores -------------------------------------------
    def initial_loopingprofile(self, traj):
        """Per-frame argmax of the single-frame interval scores (the
        ``[t, t+1)`` diagonal of the interval table, i.e. each frame's
        conditional log-likelihood given its predecessor)."""
        return Loopingprofile(np.argmax(self._segment_table(traj), axis=0))

    def _frame_scores(self, payload, T):
        """``(B, n, T)`` numpy: the ``[t, t+1)`` diagonal of a payload's
        tables, gathered on the device."""
        mode, arrs, Lb = payload
        B, n = arrs[0].shape[0], self.nStates
        if mode == "banded":
            diag = arrs[0].reshape(B, n, T, Lb + 1)[..., 1]
        else:
            t = torch.arange(T, device=arrs[0].device)
            diag = arrs[0].reshape(B, n, T, T + 1)[:, :, t, t + 1]
        return diag.cpu().numpy().astype(float)

    def _segment_table(self, traj):
        """``(n, T)`` frame-factorized scores: the single-frame diagonal of
        the interval table (the input of `segment_guess`)."""
        return self._frame_scores(self._payload_for_traj(traj), len(traj))[0]

    def lockstep_segment_tables(self, batch):
        """``(B, n, T)`` batched frame scores (see `_segment_table`); reuses
        the cached lockstep interval tables."""
        return self._frame_scores(
            self._cached_payload(batch.data, batch.valid), batch.T)

    def clear_memo(self):
        self._table_cache = None
        self._full_table_cache = None
        self._lockstep_table_cache = None

    # -- interval tables ----------------------------------------------------
    def _f64(self, x):
        return torch.as_tensor(x, device=self.device).to(torch.float64)

    def interval_table(self, traj) -> torch.Tensor:
        """``(n, T, T+1)`` EXACT table of interval log-likelihood
        contributions; entry ``[s, t0, t1]`` covers frames ``[t0, t1)`` in
        state s with the continuity conditioning applied whenever ``t0 > 0``.
        Always exact, independent of ``T_band`` (it materializes the full
        O(n T^2) table, which banded mode exists to avoid)."""
        token = tensor_token(traj.data, traj.valid)
        if (self._full_table_cache is not None
                and self._full_table_cache[0] == token):
            return self._full_table_cache[2]
        V = self._build_interval_tables_batch(
            traj.data[None], traj.valid[None])[0].to(self.dtype)
        # holding the tensors keeps their storage alive: the token is theirs
        self._full_table_cache = (token, (traj.data, traj.valid), V)
        return V

    # -- payload = ("full", (Vflat,), None) | ("banded", (Band, Head, G), Lb)
    def _tables_payload_batch(self, data, valid):
        """The tables of a batch, flat per trajectory, in the model's
        dtype: ``data (B, T, d)``, ``valid (B, T)``."""
        data = self._f64(data)
        valid = torch.as_tensor(valid, device=self.device)
        B, T, _ = data.shape
        self.table_builds += 1
        W = self._resolve_band(T)
        if W is not None and T > W:
            if not bool(valid.all()):
                raise ValueError(
                    "banded GGM tables (T_band) require gap-free "
                    "trajectories; rows with missing frames need the exact "
                    "tables: construct the model with T_band=None or "
                    "bucket gapped trajectories separately")
            tables = self._banded_tables_batch(data, W)
            return ("banded",
                    tuple(x.reshape(B, -1).to(self.dtype) for x in tables),
                    W - 1)
        V = self._build_interval_tables_batch(data, valid)
        return ("full", (V.reshape(B, -1).to(self.dtype),), None)

    def _cached_payload(self, data, valid):
        """The payload of ``(data, valid)``, from a single-entry cache when
        it was built for these very tensors (same storage, shape and
        version: views and slices of one tensor count as it). One entry
        for a single trajectory and one for a batch, so that a `sample()`
        or a `logL` between two dataset calls evicts nothing."""
        slot = "_table_cache" if data.shape[0] == 1 else "_lockstep_table_cache"
        token = tensor_token(data, valid)
        cache = getattr(self, slot)
        if cache is not None and cache[0] == token:
            return cache[2]
        payload = self._tables_payload_batch(data, valid)
        # holding the tensors keeps their storage alive: the token is theirs
        setattr(self, slot, (token, (data, valid), payload))
        return payload

    def _payload_for_traj(self, traj):
        """Single-trajectory payload with the tables' leading B=1 axis
        retained (so the single and lockstep paths share everything)."""
        return self._cached_payload(traj.data[None], traj.valid[None])

    def _build_interval_tables_batch(self, data, valid) -> torch.Tensor:
        """``(B, n, T, T+1)`` float64 interval tables for a whole batch.

        Gap-free trajectories take the Toeplitz fast path
        (`_stationary_tables_batch`); trajectories with missing frames go
        through the bucketed masked path, whose per-interval Cholesky
        handles arbitrary gap patterns. So does everything when a
        stationary covariance fails to factor."""
        data = self._f64(data)
        valid = torch.as_tensor(valid, device=self.device)
        B, T, _ = data.shape
        # frames past every row's last observation (the padding of a length
        # bucket) add nothing to any interval: build without them, then
        # every end beyond repeats the last real one and every start
        # beyond scores 0
        seen = valid.any(dim=0).cpu().numpy()
        Te = int(np.flatnonzero(seen)[-1]) + 1 if seen.any() else T
        if Te < T:
            V = data.new_zeros((B, self.nStates, T, T + 1))
            Ve = self._build_interval_tables_batch(data[:, :Te], valid[:, :Te])
            V[:, :, :Te, :Te + 1] = Ve
            V[:, :, :Te, Te + 1:] = Ve[:, :, :, Te:]
            return V
        full = valid.all(dim=1)
        full_host = full.cpu().numpy()
        try:
            if full_host.all():
                return self._stationary_tables_batch(data)
            if full_host.any():
                V = data.new_zeros((B, self.nStates, T, T + 1))
                V[full] = self._stationary_tables_batch(data[full])
                V[~full] = self._bucketed_tables_batch(data[~full], valid[~full])
                return V
        except np.linalg.LinAlgError:   # degenerate stationary covariance
            pass
        return self._bucketed_tables_batch(data, valid)

    def _factor(self, Cfull, infos):
        """Device float64 Cholesky factor of a host covariance and its
        cumulative log-determinant; the status joins ``infos`` (checked once
        per build by `_check_factors`)."""
        Lc, info = torch.linalg.cholesky_ex(self._f64(Cfull), check_errors=False)
        infos.append(info)
        return Lc, torch.cumsum(2.0 * torch.log(torch.diagonal(Lc)), dim=0)

    @staticmethod
    def _check_factors(infos):
        """One fetch for all factorizations of a build."""
        if infos and bool(torch.stack(infos).ne(0).any()):
            raise np.linalg.LinAlgError(
                "stationary window covariance is not positive definite")

    def _stationary_tables_batch(self, data) -> torch.Tensor:
        """Fast path for gap-free trajectories (see
        `_stationary_prefix_entries` for the algebra)."""
        data = self._f64(data)
        B, T, d = data.shape
        n = self.nStates
        dev = data.device
        V = data.new_zeros((B, n, T, T + 1))

        t0s = torch.arange(T, device=dev)
        us = (t0s - 1).clamp(min=0)
        conds = t0s > 0
        t1s = torch.arange(T + 1, device=dev)
        infos = []

        for s in range(n):
            for dim in range(d):
                msd_fun, mean, sso = self.state_spec[s, dim]
                sso = int(sso)
                W = T if sso == 0 else max(T - 1, 1)
                Cfull, c00 = _stationary_cov(msd_fun, sso, W)
                Lc, logdet_cum = self._factor(Cfull, infos)
                vals = data[:, :, dim]
                chunk = max(1, _CHUNK_ELEMS // max(B * W, 1))
                for lo in range(0, T, chunk):
                    hi = min(lo + chunk, T)
                    lp, lp0 = _stationary_prefix_entries(
                        vals, us[lo:hi], conds[lo:hi], Lc, logdet_cum,
                        float(mean), float(c00), ss_order=sso, W=W, T=T)
                    # entry index of end t1 in the window of start t0:
                    # frames t1 - u - 1 (ss0), increments t1 - u - 2 (ss1)
                    kidx = t1s[None, :] - us[lo:hi, None] - 1 - sso   # (C, T+1)
                    live = (t1s[None, :] > t0s[lo:hi, None]) & (kidx >= 0)
                    contrib = torch.gather(
                        lp, 2, kidx.clamp(0, W - 1)[None].expand(B, -1, -1))
                    if sso == 0:
                        contrib = contrib - lp0[:, :, None]
                    V[:, s, lo:hi] += torch.where(live[None], contrib, 0.0)
        self._check_factors(infos)
        return V

    def _bucketed_tables_batch(self, data, valid) -> torch.Tensor:
        """Masked bucketed build: per (length bucket, state, dim), one
        batched Cholesky over chunks of (trajectory, interval) blocks;
        handles arbitrary missing-frame patterns."""
        data = self._f64(data)
        valid = torch.as_tensor(valid, device=self.device)
        B, T, d = data.shape
        n = self.nStates
        dev = data.device

        # MSD lag tables: the only host evaluation of the user's callables
        lags = np.arange(T + 1, dtype=float)
        msd_tabs = np.empty((n, d, T + 1))
        plateaus = np.zeros((n, d))
        for s in range(n):
            for dim in range(d):
                msd_fun, _, sso = self.state_spec[s, dim]
                msd_tabs[s, dim] = msd_fun(lags)
                if sso == 0:
                    plateaus[s, dim] = float(msd_fun(np.inf))
        msd_dev = self._f64(msd_tabs)

        V = data.new_zeros((B, n, T, T + 1))
        for Lb, (t0s, t1s) in _bucketed_pairs(T).items():
            t0d = torch.as_tensor(t0s, device=dev)
            t1d = torch.as_tensor(t1s, device=dev)
            # the (B, chunk, Lb, Lb) block of covariances bounds the chunk
            chunk = int(max(8, (_CHUNK_ELEMS // 4) // (Lb * Lb * B)))
            for s in range(n):
                for lo in range(0, len(t0s), chunk):
                    sl = slice(lo, lo + chunk)
                    acc = 0.0
                    for dim in range(d):
                        _, mean, sso = self.state_spec[s, dim]
                        acc = acc + _interval_entries(
                            t0d[sl], t1d[sl], data[:, :, dim], valid,
                            msd_dev[s, dim], float(plateaus[s, dim]),
                            float(mean), ss_order=int(sso), Lb=Lb)
                    V[:, s, t0d[sl], t1d[sl]] = acc
        return V

    def _window_cov(self, s, dim, W):
        """Stationary covariance of one banded window for ``(state, dim)``:
        ``(Cfull (Wd, Wd), c00, sso, Wd)`` where ``Wd`` is the number of
        window ENTRIES (``W`` frames for ss_order 0, ``W - 1`` increments
        for ss_order 1) and ``c00`` the unconditional first-entry
        variance."""
        msd_fun, _, sso = self.state_spec[s, dim]
        Wd = W if int(sso) == 0 else W - 1
        Cfull, c00 = _stationary_cov(msd_fun, int(sso), Wd)
        return Cfull, c00, int(sso), Wd

    def band_tail_error(self, T, T_band=None):
        """
        Predicted worst-case tail error (nats) of the banded tables for one
        gap-free length-``T`` trajectory: the truncated-memory sliding
        conditional (``T_band - 1`` frames of memory) vs the exact
        full-window conditional.

        The prediction is **bias + fluctuation**:

        - Bias (expected deficit): per (state, dim), let ``v_m`` be the
          conditional variance of a window entry given ``m`` in-window
          predecessors (squared Cholesky diagonal of the stationary window
          covariance, window extended to ``min(T, max(4 T_band, 256))``
          entries). The expected per-frame log-likelihood deficit of
          conditioning on ``m_tr`` instead of ``m > m_tr`` predecessors is
          the Gaussian KL ``0.5 log(v_{m_tr} / v_m)`` (the mean-mismatch
          term contributes exactly ``(v_{m_tr} - v_m)/2 v_{m_tr}`` in
          expectation, cancelling the variance-ratio term). Summed over
          the tail offsets of one interval spanning all T frames (worst
          case), maxed over states, summed over dims -> ``KL``.
        - Fluctuation: each per-frame deficit has variance ~``2 KL_j``
          and neighboring frames share most of their window, so the
          realized deficit of one trajectory fluctuates around the bias
          with worst-case (fully correlated) scale
          ``sqrt(2 KL n_tail)``, ``n_tail = T - T_band``; a 1.5x safety
          factor rides on it.

        Offsets beyond the extended window reuse its deepest ``v``: a
        slight underestimate for extremely long-memory MSDs. A host
        float64 computation, once per ``(T, T_band)``.
        """
        W = self.T_band if T_band is None else T_band
        if not isinstance(W, (int, np.integer)):
            raise ValueError("band_tail_error needs a concrete T_band")
        if T <= W:
            return 0.0
        total = 0.0
        for dim in range(self.d):
            worst = 0.0
            for s in range(self.nStates):
                We = int(min(T, max(4 * W, 256)))
                C, _, sso, Wd_e = self._window_cov(s, dim, We)
                v = np.diag(np.linalg.cholesky(C)) ** 2
                Wd = W if sso == 0 else W - 1
                v_tr = v[Wd - 1]
                offs = np.arange(W, T)               # tail frame offsets
                m_ex = np.minimum(offs if sso == 0 else offs - 1, Wd_e - 1)
                with np.errstate(divide="ignore"):
                    err = float(np.sum(0.5 * np.log(v_tr / v[m_ex])))
                worst = max(worst, err)
            total += worst
        return total + 1.5 * float(np.sqrt(2.0 * total * (T - W)))

    def _resolve_band(self, T):
        """Concrete band width for a length-``T`` batch, or ``None`` for
        the exact tables. ``T_band='auto'``: the smallest power-of-two
        band >= 32 whose `band_tail_error` estimate is within ``band_tol``
        (resolved per T, cached); if no band strictly below T qualifies,
        the exact tables are used. Explicit integer bands get the same
        estimate and ``warnings.warn`` when they exceed ``band_tol``."""
        if self.T_band is None:
            return None
        if isinstance(self.T_band, str):            # 'auto'
            if T not in self._auto_band_cache:
                W = 32
                choice = None
                while W < T:
                    if self.band_tail_error(T, W) <= self.band_tol:
                        choice = W
                        break
                    W *= 2
                self._auto_band_cache[T] = choice
            return self._auto_band_cache[T]
        if T > self.T_band:
            est = self.band_error_estimate = self.band_tail_error(T)
            if est > self.band_tol:
                warnings.warn(
                    f"banded GGM tables: estimated worst-case tail error "
                    f"{est:.3g} nats at T={T}, T_band={self.T_band} exceeds "
                    f"band_tol={self.band_tol}; increase T_band (or use "
                    f"T_band='auto') or validate against logL_host")
        return self.T_band

    def _banded_tables_batch(self, data, W):
        """
        Banded interval tables for gap-free trajectories:
        ``(Band (B, n, T, Lb+1), Head (B, n, T), G (B, n, T))``, float64,
        with ``Lb = W - 1`` (see `_banded_values` for the decomposition).
        Two prefix-solves per (state, dim): one with the reference's
        per-``t0`` conditioning (Band + Head), one with sliding
        fully-centered windows (the per-frame tail conditionals g), each
        O(T * T_band^2) instead of the exact path's O(T^3).
        """
        data = self._f64(data)
        B, T, d = data.shape
        n = self.nStates
        dev = data.device
        Lb = W - 1

        Band = data.new_zeros((B, n, T, Lb + 1))
        Head = data.new_zeros((B, n, T))
        g = data.new_zeros((B, n, T))

        t0s = torch.arange(T, device=dev)
        usA = (t0s - 1).clamp(min=0)
        condsA = t0s > 0
        usB = (t0s - Lb).clamp(min=0)          # sliding window [t-Lb, t]
        condsB = torch.zeros(T, dtype=torch.bool, device=dev)
        ends = t0s[:, None] + torch.arange(1, Lb + 1, device=dev)[None, :]
        infos = []

        for s in range(n):
            for dim in range(d):
                mean = float(self.state_spec[s, dim][1])
                Cfull, c00, sso, Wd = self._window_cov(s, dim, W)
                Lc, logdet_cum = self._factor(Cfull, infos)
                vals = data[:, :, dim]

                chunk = max(1, _CHUNK_ELEMS // max(B * Wd, 1))
                for lo in range(0, T, chunk):
                    hi = min(lo + chunk, T)
                    lpA, lp0A = _stationary_prefix_entries(
                        vals, usA[lo:hi], condsA[lo:hi], Lc, logdet_cum,
                        mean, float(c00), ss_order=sso, W=Wd, T=T)
                    lpB, _ = _stationary_prefix_entries(
                        vals, usB[lo:hi], condsB[lo:hi], Lc, logdet_cum,
                        mean, float(c00), ss_order=sso, W=Wd, T=T)
                    # Band[t0, l], l = 1..Lb: entry of end t0 + l in the
                    # window of t0 (ss1: a negative index means no term)
                    kidx = ends[lo:hi] - usA[lo:hi, None] - 1 - sso
                    ok = (ends[lo:hi] <= T) & (kidx >= 0)
                    contrib = torch.gather(
                        lpA, 2, kidx.clamp(0, Wd - 1)[None].expand(B, -1, -1))
                    head = lpA[:, :, Wd - 1]
                    if sso == 0:
                        contrib = contrib - lp0A[:, :, None]
                        head = head - lp0A
                    Band[:, s, lo:hi, 1:] += torch.where(ok[None], contrib, 0.0)
                    Head[:, s, lo:hi] += head
                    tail = lpB[:, :, Wd - 1] - lpB[:, :, Wd - 2]
                    g[:, s, lo:hi] += torch.where(t0s[lo:hi] >= Lb, tail, 0.0)
        self._check_factors(infos)
        return Band, Head, torch.cumsum(g, dim=2)

    # -- likelihood ---------------------------------------------------------
    def logL(self, profile, traj) -> float:
        return float(self.logL_batch(np.asarray(profile)[None, :], traj)[0])

    def logL_batch(self, profiles, traj) -> torch.Tensor:
        """``(P,)`` log-likelihoods of a ``(P, T)`` profile batch with any
        number of intervals (the dense sums); out-of-range states give
        NaN."""
        mode, arrs, Lb = self._payload_for_traj(traj)
        profiles = torch.as_tensor(profiles, device=self.device)
        return self._logL_fn(mode, Lb, None)(profiles[None], arrs)[0]

    def logL_host(self, profile, traj) -> float:
        """Float64 host oracle: the straight blockwise algorithm (parity
        target for the interval tables)."""
        profile = Loopingprofile(np.asarray(profile))
        ivs = profile.intervals()
        ivs[0] = (0, ivs[0][1], ivs[0][2])
        ivs[-1] = (ivs[-1][0], len(profile), ivs[-1][2])

        trajdata = traj[:]  # NaN-sentinel (T, d) view
        logL = 0.0
        for i, (t0, t1, n) in enumerate(ivs):
            t_start = t0 if i == 0 else t0 - 1
            for dim in range(self.d):
                trace = trajdata[t_start:t1][:, dim]
                ti = np.nonzero(~np.isnan(trace))[0]
                trace = trace[ti]
                if len(trace) == 0:
                    # no observations in the window -> no contribution
                    continue

                msd_fun, m, ss_order = self.state_spec[n, dim]
                C = gp.msd2C(msd_fun, ti, ss_order)

                if ss_order == 0:
                    x = trace - m
                    if i > 0:
                        mu = trace[0] * C[1:, 0] / C[0, 0]
                        x = x[1:] - mu
                        C = C - C[:, [0]] * C[[0], :] / C[0, 0]
                        C = C[1:, 1:]
                elif ss_order == 1:
                    x = np.diff(trace) - m
                else:  # pragma: no cover
                    raise ValueError(f"ss_order should be 0 or 1; got {ss_order}")

                _, logdet = np.linalg.slogdet(C)
                xCx = x @ np.linalg.solve(C, x)
                logL += -0.5 * (xCx + logdet + len(C) * LOG_2PI)
        return float(logL)

    # -- lockstep hooks -------------------------------------------------------
    def _logL_fn(self, mode, Lb, max_intervals):
        """``logL_fn(profiles (L, P, T), tables (each (L, ...)))`` -> ``(L,
        P)``, lane-exact: the sparse sum over ``max_intervals`` slots, or
        the dense one when the caller knows no bound. One closure per
        ``(mode, Lb, max_intervals)``."""
        key = (mode, Lb, max_intervals)
        if key not in self._lockstep_logL_fns:
            n, dev = self.nStates, self.device
            if mode == "banded":
                dense = functools.partial(_profile_table_sum_banded,
                                          n_states=n, Lb=Lb, exact=True)
                sparse = functools.partial(_profile_table_sum_banded_sparse,
                                           n_states=n, Lb=Lb, exact=True,
                                           Kcap=max_intervals)
            else:
                dense = functools.partial(_profile_table_sum, n_states=n,
                                          exact=True)
                sparse = functools.partial(_profile_table_sum_sparse,
                                           n_states=n, exact=True,
                                           Kcap=max_intervals)
            fn = dense if max_intervals is None else sparse

            def logL_fn(profiles, per_lane):
                profiles = torch.as_tensor(profiles, device=dev)
                return fn(profiles, *per_lane)

            self._lockstep_logL_fns[key] = logL_fn
        return self._lockstep_logL_fns[key]

    def lockstep_fns(self, batch, max_intervals=None):
        """
        Lockstep-mode hooks (see `MultiStateRouse.lockstep_fns`): the
        per-trajectory data is the flattened interval table (full, or
        banded per ``T_band``), cached for the last batch; ``logL_fn``
        is the matching gather-sum. ``max_intervals``: the caller's bound
        on the intervals of any profile it will pass (an AMIS sampler with
        K parameter slots proposes at most K): the sum then visits that
        many interval starts per profile and not all T frames; ``None``
        (no bound known) sums densely. A profile beyond the bound gives
        NaN.
        """
        mode, arrs, Lb = self._cached_payload(batch.data, batch.valid)
        return arrs, self._logL_fn(mode, Lb, max_intervals)

    # -- generative model ----------------------------------------------------
    def trajectory_from_loopingprofile(
            self, profile, missing_frames=None,
            generator: Optional[torch.Generator] = None,
            rng: Optional[np.random.Generator] = None) -> Trajectory:
        """
        Sample a trajectory: per interval and dimension one host float64
        Cholesky of the interval's (conditional) covariance times standard
        normals. The normals come from ``rng`` (a numpy Generator: the same
        draws as `bild_tpu`'s model makes from it), else from ``generator``
        (a `torch.Generator`), else from a fresh numpy Generator.
        """
        if rng is not None:
            draw = rng.standard_normal
        elif generator is not None:
            def draw(size):
                return torch.randn(size, generator=generator,
                                   dtype=torch.float64,
                                   device=generator.device).cpu().numpy()
        else:
            draw = np.random.default_rng().standard_normal
        return self._trajectory_from_normals(profile, missing_frames, draw)

    def _trajectory_from_normals(self, profile, missing_frames, draw):
        """`trajectory_from_loopingprofile` with ``draw(size)`` supplying
        the standard normals, one call per (interval, dimension) in order."""
        profile = Loopingprofile(np.asarray(profile))
        missing_frames = self._preproc_missing_frames(missing_frames, len(profile))

        ivs = profile.intervals()
        ivs[-1] = (ivs[-1][0], len(profile), ivs[-1][2])

        snippets = []
        for i, (t0, t1, n) in enumerate(ivs):
            t_start = 0 if i == 0 else t0 - 1
            snippets.append([])
            for dim in range(self.d):
                ti = np.arange(t_start, t1)
                msd_fun, m, ss_order = self.state_spec[n, dim]
                continuing = ss_order == 0 and i > 0

                C = gp.msd2C(msd_fun, ti, ss_order)
                if continuing:
                    mu = (snippets[i - 1][dim][-1] - m) * C[1:, 0] / C[0, 0]
                    C = C - C[:, [0]] * C[[0], :] / C[0, 0]
                    C = C[1:, 1:]

                L = sp_linalg.cholesky(C, lower=True)
                x = L @ draw(len(L)) + m
                if continuing:
                    x += mu

                if ss_order == 0:
                    snippets[i].append(x)
                else:  # increments -> integrate, anchored at previous end (or 0)
                    x0 = 0.0 if i == 0 else snippets[i - 1][dim][-1]
                    cum = x0 + np.cumsum(x)
                    snippets[i].append(np.insert(cum, 0, 0) if i == 0 else cum)

        data = np.concatenate([np.array(snip).T for snip in snippets])
        data[missing_frames] = np.nan
        return Trajectory.create(data, loopingprofile=profile.state,
                                 device=self.device, dtype=self.dtype)
