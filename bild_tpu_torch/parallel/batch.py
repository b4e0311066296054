"""
Lockstep batched inference: the dataset-scale mode (counterpart of
`bild_tpu.parallel.batch`).

Every trajectory of a batch gets the SAME fixed schedule of AMIS steps:
``steps_per_k`` steps at every k in ``0..k_max``. Where `bild_tpu` vmaps
one sampler over trajectories and k and jits the program, this module
keeps one `AmisState` with a leading lane axis, one lane per (k,
trajectory) pair, and runs each step for all lanes at once: one proposal
draw, one likelihood launch (the CUDA kernels take the lane axis
themselves) and one ensemble update. The evidence maximum + dE rule then
picks ``best_k`` per trajectory, as in the adaptive `sample`. On CUDA the
step runs as one captured CUDA graph, replayed for every step
(`run_steps`, `parallel.graphs`), where `bild_tpu` runs a `fori_loop`
inside its jitted program; the CPU runs it eagerly.

Randomness: one `torch.Generator` drives a call. It draws one 64-bit key
per (k, trajectory) lane, k-major, and each lane draws from its own
counter-based stream (`lanes.LaneRNG`); every reduction over a lane's own
axes is lane-exact (``exact=True`` at each call). So a lane's result does not depend
on which lanes share its steps: the all-k schedule, the per-k
``checkpoint=`` schedule and the scout/refine schedule give the same
numbers for the same generator (on CUDA under the ``'auto'`` kernel
selector, wherever both schedules' launches take the same kernel,
`ops.kalman_sym.auto_kernel`: lanes times profiles of at least the SM
count). With ``row_keys`` a trajectory's lanes are
keyed by the trajectory itself, not by its position in the batch.

Under a ``mesh`` (`parallel.mesh`) each rank runs the lanes of its own
block of rows and the per-row results are all-gathered, so every rank
returns the full `BatchResults`; lane independence makes them equal to the
mesh-free run's bit for bit.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import os
from typing import Optional, Sequence

import numpy as np
import torch

from .._spans import spanned
from ..amis.cfc import CFC
from ..amis.dirichlet import check_exhausted
from ..amis.sampler import (AmisState, _marginal_posterior, amis_propose,
                            amis_update, informed_proposal_batch)
from ..infer.segment import dp_segment_all_batch, profiles_to_st_batch
from ..lanes import LaneRNG
from ..models.base import tensor_token
from ..ops import counters
from ..profiles import st2profile
from ..trajectory import Trajectory
from . import graphs
from .mesh import (broadcast_from_process0, checkpoint_hit, fetch_to_host,
                   is_multiprocess, require_data_axis)

__all__ = ["TrajectoryBatch", "BatchResults", "stack_trajectories",
           "bucket_trajectories", "pad_batch_rows", "sample_batch",
           "run_lanes"]


@dataclasses.dataclass(frozen=True)
class TrajectoryBatch:
    """A stacked, padded batch of trajectories: ``data (B, T, d)``,
    ``valid (B, T)`` (padding frames are simply invalid), and optional
    ``lengths (B,)`` (numpy ints): each trajectory's TRUE frame count, which
    the ``k >= len(traj)`` unidentifiability guard needs."""

    data: torch.Tensor
    valid: torch.Tensor
    lengths: Optional[np.ndarray] = None

    @property
    def B(self):
        return self.data.shape[0]

    @property
    def T(self):
        return self.data.shape[1]

    def to(self, device=None, dtype=None) -> "TrajectoryBatch":
        """The same batch on ``device`` and in ``dtype`` (itself if it is
        there already)."""
        data = self.data.to(device=device, dtype=dtype)
        valid = self.valid.to(device=device)
        if data is self.data and valid is self.valid:
            return self
        return dataclasses.replace(self, data=data, valid=valid)


def stack_trajectories(trajs: Sequence[Trajectory],
                       T_pad: Optional[int] = None, *, device=None,
                       dtype=None) -> TrajectoryBatch:
    """Stack `Trajectory` objects, padding to the longest (or ``T_pad``),
    on ``device`` and in ``dtype`` (default: the first trajectory's)."""
    T_max = max(len(t) for t in trajs)
    T_pad = T_max if T_pad is None else T_pad
    if T_pad < T_max:
        raise ValueError(f"T_pad={T_pad} < longest trajectory ({T_max})")
    d = trajs[0].d
    ref = trajs[0].data
    device = ref.device if device is None else device
    dtype = ref.dtype if dtype is None else dtype
    data = torch.zeros((len(trajs), T_pad, d), dtype=dtype, device=device)
    valid = torch.zeros((len(trajs), T_pad), dtype=torch.bool, device=device)
    for i, t in enumerate(trajs):
        if t.d != d:
            raise ValueError("All trajectories in a batch need the same d")
        data[i, : len(t)] = t.data
        valid[i, : len(t)] = t.valid
    return TrajectoryBatch(data=data, valid=valid,
                           lengths=np.array([len(t) for t in trajs]))


def pad_batch_rows(batch: TrajectoryBatch, n_rows: int) -> TrajectoryBatch:
    """Append ``n_rows`` all-invalid filler trajectories (length 0). Strip
    the corresponding result rows."""
    if n_rows == 0:
        return batch
    B, T = batch.B, batch.T
    data = torch.cat([batch.data, batch.data.new_zeros((n_rows, T, batch.data.shape[2]))])
    valid = torch.cat([batch.valid, batch.valid.new_zeros((n_rows, T))])
    lengths = np.full(B, T) if batch.lengths is None else np.asarray(batch.lengths)
    return TrajectoryBatch(data=data, valid=valid,
                           lengths=np.concatenate([lengths, np.zeros(n_rows, int)]))


def bucket_trajectories(trajs: Sequence[Trajectory],
                        bucket_edges=(64, 128, 256, 512, 1024), *,
                        device=None, dtype=None):
    """
    Group ragged-length trajectories into padded batches by length bucket.
    Returns a list of ``(indices, TrajectoryBatch)`` where ``indices`` maps
    each batch row back to its position in ``trajs``. Padding frames behave
    exactly like trailing missing frames; `sample_batch` trims a bucket's
    all-invalid tail before running it. ``device``, ``dtype`` as in
    `stack_trajectories`.
    """
    edges = sorted(bucket_edges)
    buckets = {}
    for i, t in enumerate(trajs):
        T = len(t)
        pad = next((e for e in edges if T <= e), None)
        if pad is None:
            pad = T  # oversize: its own exact-size bucket
        buckets.setdefault(pad, []).append(i)
    out = []
    for pad in sorted(buckets):
        idx = buckets[pad]
        out.append((np.array(idx),
                    stack_trajectories([trajs[i] for i in idx], T_pad=pad,
                                       device=device, dtype=dtype)))
    return out


@dataclasses.dataclass
class BatchResults:
    """
    Results of `sample_batch`: per-trajectory evidence curves and MAP
    profiles per k (numpy). Mirrors the point-estimate API of
    `SamplingResults`.
    """

    k: np.ndarray              # (K+1,)
    evidence: np.ndarray       # (B, K+1)
    evidence_se: np.ndarray    # (B, K+1)
    map_profiles: np.ndarray   # (K+1, B, T)
    dE: float = 0.0
    marginals: Optional[np.ndarray] = None  # (K+1, B, n, T) log-posteriors
    # (B, K+1): the CFC method-of-marginals fixed point converged at every
    # AMIS step of that (trajectory, k) run (lockstep cannot raise per lane)
    mom_ok: Optional[np.ndarray] = None
    # with ensemble=M: the M highest-weight ensemble samples per (k,
    # trajectory) as profiles, with their unnormalized log importance
    # weights (logL - logdelta)
    top_profiles: Optional[np.ndarray] = None  # (K+1, B, M, T)
    top_logw: Optional[np.ndarray] = None      # (K+1, B, M)
    # `infer.adaptive.sample_batch_adaptive` only: likelihood evaluations
    # spent per trajectory (B,), AMIS steps per (trajectory, k) lane (B,
    # K+1), and the number of adaptive rounds
    evals: Optional[np.ndarray] = None
    steps: Optional[np.ndarray] = None
    rounds: Optional[int] = None

    def best_k(self, dE=None) -> np.ndarray:
        """(B,) smallest k within dE of each trajectory's max evidence."""
        dE = self.dE if dE is None else dE
        ev = self.evidence
        plausible = ev >= (np.max(ev, axis=1, keepdims=True) - dE)
        return np.argmax(plausible, axis=1)

    def best_profile(self, dE=None) -> np.ndarray:
        """(B, T) MAP profile at each trajectory's best k."""
        bk = self.best_k(dE)
        return self.map_profiles[bk, np.arange(len(bk))]

    def log_marginal_posterior(self, dE=None) -> np.ndarray:
        """
        (B, n, T) log marginal state posteriors. ``dE='average'`` averages
        over k weighted by evidence. Requires ``marginals=True``.
        """
        if self.marginals is None:
            raise ValueError("run sample_batch(..., marginals=True) first")
        from scipy.special import logsumexp

        if isinstance(dE, str) and dE == "average":
            finite = np.isfinite(self.evidence)              # (B, K+1)
            w = np.where(finite.T[:, :, None, None],
                         self.marginals + self.evidence.T[:, :, None, None],
                         -np.inf)
            with np.errstate(under="ignore"):
                logpost = logsumexp(w, axis=0)               # (B, n, T)
                return logpost - logsumexp(logpost, axis=1, keepdims=True)
        bk = self.best_k(dE)
        return self.marginals[bk, np.arange(len(bk))]

    def profile_ensemble(self, dE=None):
        """
        Truncated posterior over profiles at each trajectory's best k:
        ``(B, M, T)`` int profiles and ``(B, M)`` weights, renormalized
        within the retained top-M set. Requires ``ensemble=M``. A trajectory
        with no finite-weight sample gets uniform weights.
        """
        if self.top_profiles is None:
            raise ValueError("run sample_batch(..., ensemble=M) first")
        from scipy.special import logsumexp

        bk = self.best_k(dE)
        rows = np.arange(len(bk))
        profs = self.top_profiles[bk, rows]
        lw = self.top_logw[bk, rows]                        # (B, M)
        with np.errstate(invalid="ignore", under="ignore"):
            norm = logsumexp(lw, axis=1, keepdims=True)
            w = np.exp(lw - norm)
        M = lw.shape[1]
        w = np.where(np.isfinite(norm), w, 1.0 / M)
        return profs, w


def lane_step(mutable, scratch, logL_fn, lane_data, keys, transitions,
              active, logprior, cb, pb, N, T, mom_maxiter, informed,
              exact=True):
    """
    One AMIS step of every lane, in place on ``mutable`` (`AmisState.tensors`
    with per-lane step counts, then the gamma sampler's exhaustion flag):
    per lane one proposal draw from its stream (``keys``) folded by its own
    step count (a device tag), one call ``logL_fn(profiles (L, N, T),
    lane_data)`` and one ensemble update written back into the same
    tensors; ``informed = (a (L, K), logp (L, n, K), use (L,))`` becomes the
    second mixture component of a lane in ``use`` after its first step.
    No host read: the step `run_lanes` runs eagerly and replays as a CUDA
    graph (``scratch`` unused). ``exact``: lane-exact reductions
    (`lanes.lane_sum`), which a lane needs beside others; a lone sampler
    that never shares its step may use PyTorch's own.
    """
    state = AmisState(*mutable[:-1])
    rng = LaneRNG(keys, mutable[-1])
    ss, th, profiles = amis_propose(state, rng.fold(state.n_steps), transitions,
                                    N=N, T=T, active=active, exact=exact)
    logLs = logL_fn(profiles, lane_data).to(state.logLs.dtype)
    new, _ = amis_update(dataclasses.replace(state), ss, th, logLs,
                         transitions, logprior, cb, pb, maxiter=mom_maxiter,
                         active=active, exact=exact)
    state.assign(new)
    if informed is not None:
        a_inf, logp_inf, use = informed
        seed = use & (state.n_steps == 1)
        state.a_params[:, 1] = torch.where(seed[:, None], a_inf,
                                           state.a_params[:, 1])
        state.logps[:, 1] = torch.where(seed[:, None, None], logp_inf,
                                        state.logps[:, 1])


@spanned("run_steps")
def run_steps(kind, step, mutable, args, steps, scratch=()) -> None:
    """``steps`` calls of ``step(mutable, scratch, *args)`` (``args[0]`` the
    likelihood closure): on CUDA replays of one CUDA graph of the step
    (`parallel.graphs`), after one eager step where no graph of these
    shapes is cached yet (it builds what the step needs; the capture
    follows it, also when no step is left, for the next call); on the CPU,
    or under ``graphs._EAGER``, an eager loop. Counts the steps of every
    call in ``run_steps.steps``; each call is span ``run_steps``."""
    run_steps.steps += max(steps, 0)
    device = mutable[0].device
    if steps > 0 and graphs.graphed(device):
        if not graphs.cached(kind, args[0], mutable, args, scratch):
            step(mutable, scratch, *args)
            steps -= 1
        graphs.replay(kind, args[0], step, mutable, args, steps, scratch)
        return
    for _ in range(steps):
        step(mutable, scratch, *args)


counters.register("run_steps.steps", run_steps, "steps")


def run_lanes(logL_fn, lane_data, state: AmisState, rng: LaneRNG,
              transitions, active, logprior, cb, pb, *, N, T, start, stop,
              informed=None, mom_maxiter=1000) -> AmisState:
    """
    AMIS steps ``start..stop-1`` for every lane of ``state`` (`lane_step`),
    in place; returns ``state``, its step counts an ``(L,)`` tensor.
    ``informed = (a (L, K), logp (L, n, K), use (L,))`` becomes the second
    mixture component of the lanes in ``use`` after step 0. On CUDA the
    steps replay one CUDA graph of the step (`run_steps`); the CPU runs
    them eagerly. The gamma sampler's exhaustion flag (``rng.exhausted``,
    made here if ``rng`` has none) is read once, after the steps. Counts
    its steps in ``run_lanes.steps`` and lane-steps in
    ``run_lanes.lane_steps``.
    """
    L = state.lanes
    device = state.ss.device
    if not isinstance(state.n_steps, torch.Tensor):
        state.n_steps = torch.full((L,), state.n_steps, dtype=torch.long,
                                   device=device)
    flag = rng.exhausted
    if flag is None:
        flag = torch.zeros((), dtype=torch.bool, device=device)
    steps = max(stop - start, 0)
    run_steps("lanes", lane_step, state.tensors() + [flag],
              (logL_fn, tuple(lane_data), rng.keys, transitions, active,
               logprior, cb, pb, N, T, mom_maxiter,
               informed if start == 0 else None), steps)
    run_lanes.steps += steps
    run_lanes.lane_steps += L * steps
    if rng.exhausted is None:
        check_exhausted(flag)
    return state


counters.register("run_lanes.steps", run_lanes, "steps")
counters.register("run_lanes.lane_steps", run_lanes, "lane_steps")


def _trim_tail(batch: TrajectoryBatch):
    """``(batch, T_eff)``: the batch without the frames past every
    trajectory's true length (they cost full likelihood propagation and
    contribute nothing); results are edge-padded back by the caller."""
    T_eff = batch.T
    if batch.lengths is not None and batch.B > 0:
        T_eff = min(max(int(np.max(batch.lengths)), 1), batch.T)
    if T_eff == batch.T:
        return batch, T_eff
    return TrajectoryBatch(data=batch.data[:, :T_eff],
                           valid=batch.valid[:, :T_eff],
                           lengths=batch.lengths), T_eff


def _prepare_batch(model, batch: TrajectoryBatch, device, dtype, trim=True):
    """``(batch, T_eff)``: ``batch`` on ``device`` in ``dtype`` with its
    all-invalid tail trimmed (`_trim_tail`; not with ``trim=False``).
    Memoized on the model for the last input batch (`tensor_token` of its
    tensors, plus its lengths), so that repeated calls on one batch hand
    the model's own caches (interval tables, segment tables, informed
    init) the same tensors and not a fresh copy each time."""
    token = (tensor_token(batch.data, batch.valid), device, dtype, trim,
             None if batch.lengths is None
             else np.asarray(batch.lengths).tobytes())
    memo = getattr(model, "_prepared_batch", None)
    if memo is not None and memo[0] == token:
        return memo[2]
    moved = batch.to(device, dtype)
    out = _trim_tail(moved) if trim else (moved, moved.T)
    # holding the input keeps its storage alive: the token stays its own
    model._prepared_batch = (token, batch, out)
    return out


def _summaries(state: AmisState, active, n_done, T, n, marginals, top_m):
    """Per-lane results over the first ``n_done`` ensemble rows, as numpy:
    ``(ev (L, 3), map (L, T), marginals (L, n, T) or None, mom_ok (L,),
    top profiles (L, M, T), top log-weights (L, M))``; reductions are
    lane-exact."""
    L, _, _, K1 = state.ss.shape
    rows = torch.arange(L, device=state.ss.device)
    flat_ss = state.ss[:, :n_done].reshape(L, -1, K1)
    flat_th = state.thetas[:, :n_done].reshape(L, -1, K1)
    idx = state.logLs[:, :n_done].reshape(L, -1).argmax(dim=1)
    map_prof = st2profile(flat_ss[rows, idx], flat_th[rows, idx], T,
                          active=active, exact=True)
    log_w = (state.logLs[:, :n_done] - state.logdeltas[:, :n_done]).reshape(L, -1)
    logpost = None
    if marginals:
        logpost = _marginal_posterior(flat_ss, flat_th,
                                      log_w + math.log(float(n_done)),
                                      T=T, nStates=n, active=active,
                                      exact=True).cpu().numpy()
    if top_m:
        # same weight convention as the marginals: NaN -> -inf, the shared
        # normalization dropped (consumers renormalize within the set)
        lw = torch.where(torch.isnan(log_w), -math.inf, log_w)
        top_lw, sel = torch.topk(lw, top_m, dim=1)
        top_profs = st2profile(flat_ss[rows[:, None], sel],
                               flat_th[rows[:, None], sel], T,
                               active=active[:, None, :],
                               exact=True).cpu().numpy()
        top_lw = top_lw.cpu().numpy()
    else:
        top_profs = np.zeros((L, 0, T), dtype=np.int32)
        top_lw = np.zeros((L, 0))
    return (state.evidences[:, n_done - 1].cpu().numpy(),
            map_prof.cpu().numpy(), logpost, state.mom_ok.cpu().numpy(),
            top_profs, top_lw)


def _informed_proposals_all_k(model, batch, K1, n, T, cache_token):
    """
    `_informed_proposals_all_k_impl`, cached on the model for the last
    ``cache_token`` (the prepared batch's data tensor, compared by
    identity, plus the effective shape): the segmentation is
    deterministic, and repeated calls on one batch would redo the host DP.
    """
    cache = getattr(model, "_informed_init_cache", None)
    if (cache is not None and cache[0] is cache_token[0]
            and cache[1] == cache_token[1:] and cache[2] == K1):
        return cache[3]
    out = _informed_proposals_all_k_impl(model, batch, K1, n, T)
    # holding the token tensor keeps it alive, so `is` cannot alias
    model._informed_init_cache = (cache_token[0], cache_token[1:], K1, out)
    return out


def _informed_proposals_all_k_impl(model, batch, K1, n, T):
    """
    Informed init for every trajectory and every k from one batched DP
    sweep: ``(a_inf (K1, B, K1), logp_inf (K1, B, n, K1), use (K1, B))``
    numpy, or ``None`` if the model has no frame-factorized score tables.
    A row's arrays depend on that row alone (the sharded runner computes
    them on each rank's own rows).
    """
    out = None
    seg_tables = model.lockstep_segment_tables(batch)
    if seg_tables is not None:
        B = batch.B
        profs, feas = dp_segment_all_batch(np.asarray(seg_tables), K1 - 1,
                                           model.transitions)
        a_inf = np.ones((K1, B, K1))
        logp_inf = np.full((K1, B, n, K1), -math.log(n))
        for k in range(K1):
            ok = feas[k]
            if not np.any(ok):
                continue
            fracs, theta = profiles_to_st_batch(profs[k][ok], k)
            a_k, logp_k = informed_proposal_batch(fracs, theta, n, T)
            a_inf[k][ok, : k + 1] = a_k
            logp_inf[k][ok, :, : k + 1] = logp_k
        out = (a_inf, logp_inf, feas)
    return out


def _checkpoint_config(batch, k_max, steps_per_k, N, marginals, informed_init,
                       ensemble=0, mom_maxiter=1000):
    cfg = [batch.B, batch.T, k_max, steps_per_k, N,
           int(marginals), int(informed_init)]
    if ensemble:
        cfg.append(ensemble)
    if mom_maxiter != 1000:
        cfg.append(mom_maxiter)
    return np.array(cfg)


def _checkpoint_tag(model, batch, lane_keys):
    """Content hash of (data, lane keys, model fingerprint): resuming a
    checkpoint against different data, another generator or other
    ``row_keys`` (both make the lane keys), or a re-parametrized model
    would silently mix results of two runs."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(batch.data.cpu().numpy()).tobytes())
    h.update(np.ascontiguousarray(lane_keys).tobytes())
    fp = getattr(model, "likelihood_fingerprint", lambda: None)()
    if fp is not None:
        h.update(fp.encode())
    return h.hexdigest()


def _per_k_params(cfc, k, K1, B, n, informed):
    """Host-side proposal-init parameters for one k (numpy; caller casts):
    ``a0 (B, K1), logp0 (B, n, K1), a_inf, logp_inf, use_inf (B,), active
    (K1,), logprior``."""
    a0 = np.ones((B, K1))
    logp0 = np.full((B, n, K1), -math.log(n))
    logp0[:, :, : k + 1] = np.asarray(cfc.logp_uniform(k))[None]
    if informed is not None:
        a_inf, logp_inf, use_inf = (informed[0][k], informed[1][k],
                                    informed[2][k])
    else:
        a_inf, logp_inf, use_inf = a0, logp0, np.zeros(B, dtype=bool)
    active = np.arange(K1) < (k + 1)
    logprior = (sum(math.log(i + 1) for i in range(k))
                - cfc.N_total(k, log=True))
    return a0, logp0, a_inf, logp_inf, use_inf, active, logprior


class _Lanes:
    """The lanes of one `run_lanes` pass: (k, trajectory row) pairs with
    their proposal-init parameters (`_per_k_params`, by k) as tensors on
    the run's device, and their random streams."""

    def __init__(self, ks, rows, params, lane_keys, device, dtype):
        ks, rows = np.asarray(ks), np.asarray(rows)
        fields = []
        for i in range(7):
            per_row = i < 5          # a0, logp0, a_inf, logp_inf, use_inf
            first = np.asarray(params[ks[0]][i])
            arr = np.empty((len(ks),) + (first.shape[1:] if per_row
                                         else first.shape), first.dtype)
            for k in np.unique(ks):
                m = ks == k
                arr[m] = np.asarray(params[k][i])[rows[m]] if per_row \
                    else params[k][i]
            fields.append(arr)

        def tensor(x, dt):
            return torch.as_tensor(x, dtype=dt, device=device)

        self.a0, self.logp0 = tensor(fields[0], dtype), tensor(fields[1], dtype)
        self.informed = ((tensor(fields[2], dtype), tensor(fields[3], dtype),
                          tensor(fields[4], torch.bool))
                         if fields[4].any() else None)
        self.active = tensor(fields[5], torch.bool)
        self.logprior = tensor(fields[6], dtype)
        self.rng = LaneRNG.from_seeds(lane_keys[ks, rows], device)
        self.row_index = torch.as_tensor(rows, device=device)

    def __len__(self):
        return len(self.row_index)


def _row_lane_keys(row_keys, K1) -> np.ndarray:
    """``(K1, B)`` lane keys from per-trajectory base keys: lane (k, b)
    takes ``row_keys[b]`` folded by k (`LaneRNG.fold`, the counterpart of
    ``fold_in(row_keys[b], k)``)."""
    base = LaneRNG(torch.as_tensor(row_keys, dtype=torch.int64))
    return torch.stack([base.fold(k).keys for k in range(K1)]).numpy()


def sample_batch(model, batch: TrajectoryBatch,
                 k_max=10,
                 steps_per_k=20,
                 N=128,
                 dE=0.0,
                 concentration_brake=1e-2,
                 polarization_brake=1e-3,
                 generator: Optional[torch.Generator] = None,
                 mesh=None,
                 marginals=False,
                 informed_init=False,
                 checkpoint=None,
                 scout_steps=None,
                 refine_top=3,
                 mom_maxiter=1000,
                 ensemble=0,
                 row_keys=None,
                 informed_arrays=None,
                 lockstep=None) -> BatchResults:
    """
    Lockstep inference over a trajectory batch.

    Parameters as `bild_tpu.parallel.sample_batch`, with ``generator`` (a
    `torch.Generator`, seeded from numpy's global RNG if omitted) in place
    of the JAX key:

    model : a model with ``lockstep_fns`` (`MultiStateRouse`,
        `FactorizedModel`, `GenericGaussianModel`); the batch is moved to
        its ``device`` and cast to its ``dtype`` first
    k_max, steps_per_k, N : every k gets ``steps_per_k`` AMIS steps of
        ``N`` proposals. Without ``checkpoint`` all k run as one lane set
        (``L = n_k * B`` lanes per step); with it, one k at a time.
    mesh : optional `parallel.mesh.Mesh`: the batch (the same on every
        rank) is padded to a multiple of the ``data`` axis with filler
        rows, each rank runs the lanes of its own block of rows, and the
        per-row results are all-gathered, so that every rank returns the
        full results. The default generator's seed is rank 0's.
    informed_init : seed each trajectory's proposal at its DP segmentation
        (the second mixture component, after the first step).
    checkpoint : optional ``.npz`` path for per-k checkpoint/resume; a rerun
        with the same configuration resumes at the first incomplete k. A
        checkpoint of another configuration, other data, another generator
        seed or another model raises. Under a mesh the first rank writes it.
    scout_steps, refine_top : two-phase schedule: every k gets
        ``scout_steps`` steps, then each trajectory's ``refine_top``
        highest-evidence k continue from their scout state to
        ``steps_per_k`` (``L = refine_top * B`` lanes, per-lane k). Not
        combinable with ``checkpoint``.
    mom_maxiter : iteration cap of the CFC fixed point; non-convergence is
        reported per (trajectory, k) in ``BatchResults.mom_ok``.
    ensemble : when > 0, also return the ``ensemble`` highest-weight samples
        per (trajectory, k) (``top_profiles``, ``top_logw``).
    row_keys : optional int64 ``(B,)`` per-trajectory base keys; lane (k, b)
        then draws from ``row_keys[b]`` folded by k instead of the
        generator's position-drawn table, so a trajectory's result does
        not depend on where in the batch it sits (what the sharded runner
        needs).
    lockstep : optional ``(per_traj, logL_fn)`` in place of
        ``model.lockstep_fns(batch)``; under a mesh ``per_traj`` holds this
        rank's rows. ``batch`` then supplies shapes and true lengths.
    informed_arrays : optional ``(a_inf (K1, B, K1), logp_inf (K1, B, n,
        K1), use (K1, B))`` in place of the host DP of ``informed_init``;
        under a mesh the B axis holds this rank's rows. Not combinable with
        ``checkpoint``.

    With ``lockstep`` or ``informed_arrays`` the batch is not trimmed: the
    injected arrays were built at its width. Per-trajectory true lengths
    (``batch.lengths``) gate the evidence: k at or beyond a trajectory's
    own frame count gets -inf.
    """
    require_data_axis(mesh)
    multiproc = mesh is not None and is_multiprocess(mesh)
    device = getattr(model, "device", batch.data.device)
    dtype = getattr(model, "dtype", batch.data.dtype)
    if generator is None and row_keys is None:
        # the default seed must be the same on every rank
        seed = np.int64(np.random.randint(2**31))
        if multiproc:
            seed = broadcast_from_process0(seed, mesh)
        generator = torch.Generator(device=device)
        generator.manual_seed(int(seed))
    if checkpoint is not None and scout_steps is not None:
        raise ValueError("scout_steps (two-phase schedule) cannot be "
                         "combined with checkpoint (per-k resume)")
    if checkpoint is not None and informed_arrays is not None:
        raise ValueError("informed_arrays (precomputed informed init) "
                         "cannot be combined with checkpoint")
    if scout_steps is not None and not (1 <= scout_steps <= steps_per_k):
        raise ValueError(f"scout_steps must be in [1, steps_per_k="
                         f"{steps_per_k}], got {scout_steps}")
    if steps_per_k < 1:
        raise ValueError(f"steps_per_k must be >= 1, got {steps_per_k}")
    min_ens = (scout_steps if scout_steps is not None else steps_per_k) * N
    if not 0 <= ensemble <= min_ens:
        raise ValueError(f"ensemble must be in [0, {min_ens}] (the smallest "
                         f"per-lane ensemble under this schedule), got "
                         f"{ensemble}")

    B_real = batch.B
    # trim the all-invalid tail of a padded bucket (results are edge-padded
    # back to T below), unless injected arrays were built at this width
    T_in = batch.T
    batch, T_eff = _prepare_batch(
        model, batch, device, dtype,
        trim=lockstep is None and informed_arrays is None)
    D = 1 if mesh is None else mesh.shape["data"]
    batch = pad_batch_rows(batch, -B_real % D)

    B, T = batch.B, batch.T
    K1 = min(k_max, max(T - 1, 0)) + 1     # padded slot count
    # this rank's block of rows: everything below runs on it alone
    if D > 1:
        Bl = B // D
        lo = mesh.index * Bl
        local = TrajectoryBatch(
            data=batch.data[lo:lo + Bl], valid=batch.valid[lo:lo + Bl],
            lengths=(None if batch.lengths is None
                     else np.asarray(batch.lengths)[lo:lo + Bl]))
    else:
        Bl, lo, local = B, 0, batch
    # K1 parameter slots propose profiles of at most K1 intervals
    per_traj, logL_fn = (lockstep if lockstep is not None
                         else model.lockstep_fns(local, max_intervals=K1))
    if any(x.dim() and x.shape[0] != Bl for x in per_traj):
        raise ValueError(f"per-trajectory lockstep data must hold {Bl} rows "
                         "(this rank's rows of the batch)")
    cfc = CFC(model.transitions)
    transitions = torch.as_tensor(model.transitions, device=device)
    n = cfc.n
    cb = N * concentration_brake
    pb = N * polarization_brake
    if informed_arrays is not None:
        informed = tuple(x.cpu().numpy() if isinstance(x, torch.Tensor)
                         else np.asarray(x) for x in informed_arrays)
        if informed[2].shape != (K1, Bl):
            raise ValueError(f"informed_arrays' use has shape "
                             f"{informed[2].shape}, want {(K1, Bl)}")
    elif informed_init:
        informed = _informed_proposals_all_k(model, local, K1, n, T,
                                             (local.data, T_eff, Bl))
    else:
        informed = None
    # one key per (k, trajectory) lane: drawn k-major from the generator,
    # or folded from the trajectory's own key
    if row_keys is not None:
        row_keys = np.asarray(row_keys, dtype=np.int64)
        if row_keys.shape != (B_real,):
            raise ValueError(f"row_keys must have shape ({B_real},), got "
                             f"{row_keys.shape}")
        lane_keys = _row_lane_keys(row_keys, k_max + 1)
    else:
        lane_keys = torch.randint(0, 2**62, (k_max + 1, B_real),
                                  generator=generator,
                                  device=generator.device).cpu().numpy()
    if B > B_real:
        # filler rows of the mesh padding: keys the draws never give (the
        # real rows' keys, and so their results, do not depend on D)
        lane_keys = np.concatenate(
            [lane_keys, 2**62 + np.arange((k_max + 1) * (B - B_real))
             .reshape(k_max + 1, -1)], axis=1)
    local_keys = lane_keys[:, lo:lo + Bl]
    params = {k: _per_k_params(cfc, k, K1, Bl, n, informed)
              for k in range(min(k_max, T - 1) + 1)}

    def run(lanes: _Lanes, stop, state=None, start=0):
        """Run ``lanes`` (fresh, or continuing ``state``) to step ``stop``
        and summarize."""
        if state is None:
            state = AmisState.create(steps_per_k, N, K1 - 1, n, lanes.a0,
                                     lanes.logp0, device=device, dtype=dtype,
                                     lanes=len(lanes))
        lane_data = tuple(x[lanes.row_index] for x in per_traj)
        state = run_lanes(logL_fn, lane_data, state, lanes.rng, transitions,
                          lanes.active, lanes.logprior, cb, pb, N=N, T=T,
                          start=start, stop=stop, informed=lanes.informed,
                          mom_maxiter=mom_maxiter)
        return state, _summaries(state, lanes.active, stop, T, n, marginals,
                                 ensemble)

    def gather(outs):
        """Under a mesh, replace this rank's rows of each per-row output
        in ``outs`` by all ranks' rows (one all-gather), in place."""
        if multiproc:
            full = fetch_to_host([[x for x in out if x is not None]
                                  for out in outs], mesh)
            for out, got in zip(outs, full):
                it = iter(got)
                out[:] = [None if x is None else next(it) for x in out]

    def skipped_k():
        return (np.full((B, 3), [-np.inf, 1e-10, np.inf]),
                np.zeros((B, T), dtype=int),
                np.full((B, n, T), -np.inf),
                np.ones(B, dtype=bool),
                np.zeros((B, ensemble, T), dtype=int),
                np.full((B, ensemble), -np.inf))

    # per k: (ev, map, marginals, mom_ok, top profiles, top log-weights)
    by_k = {}
    if checkpoint is None:
        # all k in one lane set, lane = (k index) * Bl + trajectory row
        ks = [k for k in range(k_max + 1) if k < T]
        lanes = _Lanes(np.repeat(ks, Bl), np.tile(np.arange(Bl), len(ks)),
                       params, local_keys, device, dtype)
        s1 = steps_per_k if scout_steps is None else scout_steps
        state, out = run(lanes, s1)
        for i, k in enumerate(ks):
            by_k[k] = [None if x is None else x[i * Bl:(i + 1) * Bl].copy()
                       for x in out]

        R = 0 if scout_steps is None else max(0, min(refine_top, len(ks)))
        if R > 0:
            # refine: each trajectory's top-R scouted k continue from their
            # scout state to steps_per_k, per-lane k in one lane set; a
            # refined lane ends exactly as a straight steps_per_k run would
            lengths = (np.asarray(local.lengths) if local.lengths is not None
                       else np.full(Bl, T))
            ks_arr = np.array(ks)
            ev_scout = np.stack([by_k[k][0][:, 0] for k in ks])     # (nk, Bl)
            ev_rank = np.where(ks_arr[:, None] >= lengths[None, :], -np.inf,
                               ev_scout)
            order = np.argsort(-ev_rank, axis=0)                    # ks-indices
            kb = order[:R]                                          # (R, Bl)
            with np.errstate(invalid="ignore"):
                bad = ~np.isfinite(ev_rank[kb, np.arange(Bl)[None]])
            kb = np.where(bad, kb[0][None], kb)                     # pad w/ best
            flat_kb = kb.reshape(-1)
            rows = np.tile(np.arange(Bl), R)
            sel = flat_kb * Bl + rows                               # scout lanes
            refine = _Lanes(ks_arr[flat_kb], rows, params, local_keys,
                            device, dtype)
            _, out_r = run(refine, steps_per_k,
                           state=state.select(torch.as_tensor(sel, device=device)),
                           start=scout_steps)
            for j, (ki, b) in enumerate(zip(flat_kb, rows)):
                for f, x in enumerate(out_r):
                    if x is not None:
                        by_k[ks[ki]][f][b] = x[j]
        gather([by_k[k] for k in ks])
    else:
        config = _checkpoint_config(batch, k_max, steps_per_k, N, marginals,
                                    informed_init, ensemble, mom_maxiter)
        tag = _checkpoint_tag(model, batch, lane_keys)
        start_k = 0
        if checkpoint_hit(checkpoint, mesh):
            ck = np.load(checkpoint)
            if not np.array_equal(ck["config"], config):
                raise ValueError(
                    f"checkpoint {checkpoint} was written by a different "
                    f"sample_batch configuration: {ck['config']} vs {config}")
            if str(ck["tag"]) != tag:
                raise ValueError(
                    f"checkpoint {checkpoint} was written against different "
                    "data, generator seed or model parameters (content tag "
                    "mismatch): resuming would mix results of two runs")
            start_k = int(ck["next_k"])
            for k in range(start_k):
                by_k[k] = [ck["evs"][k], ck["maps"][k],
                           ck["margs"][k] if marginals else None,
                           ck["moms"][k],
                           ck["tops"][k] if ensemble else np.zeros((B, 0, T), int),
                           ck["toplws"][k] if ensemble else np.zeros((B, 0))]

        def save_checkpoint(next_k):
            if mesh is not None and mesh.index != 0:
                return          # every rank holds the results; one writes
            got = [by_k[k] for k in range(next_k)]
            tmp = f"{checkpoint}.tmp.npz"
            np.savez(tmp, config=config, tag=tag, next_k=next_k,
                     evs=np.stack([g[0] for g in got]),
                     maps=np.stack([g[1] for g in got]),
                     margs=(np.stack([g[2] for g in got]) if marginals
                            else np.zeros(0)),
                     moms=np.stack([g[3] for g in got]),
                     tops=np.stack([g[4] for g in got]) if ensemble else np.zeros(0),
                     toplws=(np.stack([g[5] for g in got]) if ensemble
                             else np.zeros(0)))
            os.replace(tmp, checkpoint)

        for k in range(start_k, k_max + 1):
            if k >= T:
                by_k[k] = list(skipped_k())
                continue
            lanes = _Lanes(np.full(Bl, k), np.arange(Bl), params, local_keys,
                           device, dtype)
            _, out = run(lanes, steps_per_k)
            by_k[k] = list(out)
            gather([by_k[k]])
            save_checkpoint(k + 1)

    for k in range(k_max + 1):
        if k >= T:
            by_k[k] = list(skipped_k())
    evs = np.stack([by_k[k][0] for k in range(k_max + 1)], axis=1)  # (B, K+1, 3)
    mom_ok = np.stack([by_k[k][3] for k in range(k_max + 1)], axis=1)
    evidence = evs[:, :, 0]
    evidence_se = evs[:, :, 1]

    # unidentifiability guard at TRUE trajectory lengths
    if batch.lengths is not None:
        lengths = np.asarray(batch.lengths)
        over = np.arange(k_max + 1)[None, :] >= lengths[:, None]  # (B, K+1)
        evidence = np.where(over, -np.inf, evidence)
        evidence_se = np.where(over, 1e-10, evidence_se)

    def stacked(f):
        return np.stack([by_k[k][f] for k in range(k_max + 1)])[:, :B_real]

    map_profiles = stacked(1)
    margs_out = stacked(2) if marginals else None
    tops_out = stacked(4) if ensemble else None
    toplw_out = stacked(5) if ensemble else None
    if map_profiles.shape[-1] < T_in:
        # restore the input length: trailing all-invalid frames carry the
        # edge state (profiles span missing frames) and uniform marginals
        pad = T_in - map_profiles.shape[-1]
        map_profiles = np.pad(map_profiles, [(0, 0), (0, 0), (0, pad)],
                              mode="edge")
        if margs_out is not None:
            margs_out = np.concatenate(
                [margs_out,
                 np.full(margs_out.shape[:3] + (pad,), -math.log(n))], axis=-1)
        if tops_out is not None:
            tops_out = np.pad(tops_out, [(0, 0), (0, 0), (0, 0), (0, pad)],
                              mode="edge")

    return BatchResults(
        k=np.arange(k_max + 1),
        evidence=evidence[:B_real],
        evidence_se=evidence_se[:B_real],
        map_profiles=map_profiles,
        dE=dE,
        marginals=margs_out,
        mom_ok=mom_ok[:B_real],
        top_profiles=tops_out,
        top_logw=toplw_out,
    )
