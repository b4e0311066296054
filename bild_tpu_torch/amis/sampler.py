"""
Fixed-k AMIS sampler (counterpart of `bild_tpu.amis.sampler`).

AMIS (Cornuet et al. 2012) iterates: draw N profiles from the current
proposal, evaluate their likelihoods, deterministic-mixture-reweight the
whole stored ensemble, refit the proposal by (braked) method of moments,
and update the evidence estimate.

All sampler state lives in fixed-size tensors (`AmisState`): ``(S, N, .)``
buffers for the S = max_fev/N possible steps plus the proposal and evidence
tracks. The state may carry a leading lane axis: the lockstep runner
(`parallel.batch`) advances many samplers, one per (k, trajectory) lane,
with one call per step, where `bild_tpu` vmaps. The step counter is a host
int shared by all lanes (they step in lockstep). One step is
`amis_propose`, the model's batched likelihood and `amis_update`, all on
the state's device. `FixedkSampler` runs one sampler (no lane axis) and
fetches several steps' results to the host once, packed in one tensor.
"""
from __future__ import annotations

import dataclasses
import itertools
import math

import numpy as np
import torch

from ..lanes import LaneRNG, lane_logsumexp, lane_sum
from ..profiles import Loopingprofile, st2profile
from .cfc import CFC, SampleSpaceTooLarge, cfc_sample, cfc_logpmf, cfc_estimate
from .dirichlet import (dirichlet_logpdf, dirichlet_estimate,
                        dirichlet_sample_masked)

__all__ = ["FixedkSampler", "AmisState", "amis_propose", "amis_update",
           "informed_proposal", "informed_proposal_batch"]

_FIELDS = ("ss", "thetas", "logLs", "logdeltas", "a_params", "logps",
           "evidences")


@dataclasses.dataclass
class AmisState:
    """State of one fixed-k AMIS sampler, or of L of them with a leading
    lane axis on every tensor (shapes below without it); updated in place
    by `amis_update`."""

    ss: torch.Tensor          # (S, N, k+1) float — interval fractions
    thetas: torch.Tensor      # (S, N, k+1) int32 — state traces
    logLs: torch.Tensor       # (S, N) float
    logdeltas: torch.Tensor   # (S, N) float — deterministic-mixture proposal mass
    a_params: torch.Tensor    # (S+1, k+1) float — Dirichlet concentrations
    logps: torch.Tensor       # (S+1, n, k+1) float — CFC weights
    evidences: torch.Tensor   # (S, 3) float — (logev, dlogev, KL) per step
    n_steps: int              # steps ingested so far (shared by all lanes)
    mom_ok: torch.Tensor      # () bool — CFC fixed point converged at every step

    @staticmethod
    def create(S, N, k, n, a0, logp0, *, device, dtype, lanes=None) -> "AmisState":
        """A fresh state; with ``lanes=L``, ``a0 (L, k+1)`` and ``logp0 (L,
        n, k+1)`` give each lane its initial proposal."""
        lead = () if lanes is None else (lanes,)
        a_params = torch.zeros(lead + (S + 1, k + 1), dtype=dtype, device=device)
        a_params[..., 0, :] = torch.as_tensor(a0, dtype=dtype)
        logps = torch.zeros(lead + (S + 1, n, k + 1), dtype=dtype, device=device)
        logps[..., 0, :, :] = torch.as_tensor(logp0, dtype=dtype)
        return AmisState(
            ss=torch.zeros(lead + (S, N, k + 1), dtype=dtype, device=device),
            thetas=torch.zeros(lead + (S, N, k + 1), dtype=torch.int32,
                               device=device),
            logLs=torch.zeros(lead + (S, N), dtype=dtype, device=device),
            logdeltas=torch.zeros(lead + (S, N), dtype=dtype, device=device),
            a_params=a_params,
            logps=logps,
            evidences=torch.zeros(lead + (S, 3), dtype=dtype, device=device),
            n_steps=0,
            mom_ok=torch.ones(lead, dtype=torch.bool, device=device),
        )

    @property
    def lanes(self):
        """The number of lanes, or ``None`` for a single sampler."""
        return None if self.ss.dim() == 3 else self.ss.shape[0]

    def _map(self, fn) -> "AmisState":
        return AmisState(**{f: fn(getattr(self, f)) for f in _FIELDS},
                         n_steps=self.n_steps, mom_ok=fn(self.mom_ok))

    def select(self, idx) -> "AmisState":
        """A new state holding the lanes ``idx`` (a long tensor)."""
        return self._map(lambda x: x[idx])

    @staticmethod
    def from_numpy(arrays: dict, *, device, dtype) -> "AmisState":
        """A state from numpy arrays under the field names (``thetas`` as
        ints, ``n_steps`` an int, ``mom_ok`` a bool or bool array); e.g. a
        `bild_tpu` sampler's state, so both packages can run the same
        update."""
        fields = {k: torch.as_tensor(np.array(arrays[k]), device=device,
                                     dtype=torch.int32 if k == "thetas" else dtype)
                  for k in _FIELDS}
        return AmisState(**fields, n_steps=int(arrays["n_steps"]),
                         mom_ok=torch.as_tensor(np.array(arrays["mom_ok"]),
                                                dtype=torch.bool, device=device))

    def to_numpy(self) -> dict:
        out = {k: getattr(self, k).cpu().numpy() for k in _FIELDS}
        out["n_steps"] = self.n_steps
        mom = self.mom_ok.cpu().numpy()
        out["mom_ok"] = bool(mom) if mom.ndim == 0 else mom
        return out


def informed_proposal(fracs, theta, n, T):
    """
    Proposal parameters concentrated around a segmentation guess: Dirichlet
    mean = the guessed interval fractions at total concentration
    ``(k+1) * max(2, sqrt(T))``; CFC slots go 80/20 toward the guessed
    states. Returns numpy ``(a, logp)``.
    """
    a, logp = informed_proposal_batch(np.asarray(fracs)[None],
                                      np.asarray(theta)[None], n, T)
    return a[0], logp[0]


def informed_proposal_batch(fracs, theta, n, T):
    """`informed_proposal` for a batch: ``fracs, theta (B, k+1)`` ->
    ``(a (B, k+1), logp (B, n, k+1))``, numpy, with no per-row loop."""
    fracs = np.asarray(fracs, dtype=float)
    theta = np.asarray(theta, dtype=int)
    B, k1 = fracs.shape
    conc = k1 * max(2.0, float(np.sqrt(T)))
    a = np.maximum(conc * fracs, 0.05)
    p = np.full((B, n, k1), 0.2 / max(n - 1, 1))
    np.put_along_axis(p, theta[:, None, :], 0.8, axis=1)
    return a, np.log(p)


def _log_proposal(a, logp, ss, thetas, transitions, active=None, exact=False):
    """Joint proposal density Dirichlet(s) x CFC(theta), ``(..., N)``;
    shapes broadcast as in `dirichlet_logpdf` and `cfc_logpmf`. A +inf
    Dirichlet density (a zero coordinate with concentration < 1) dominates
    even a -inf CFC part: such points must get zero importance weight, and
    ``inf + -inf = nan`` would poison the mixture. ``exact``: lane-exact
    sums."""
    dlp = dirichlet_logpdf(a, ss, active=active, exact=exact)
    clp = cfc_logpmf(logp, thetas, transitions, active=active, exact=exact)
    return torch.where(torch.isposinf(dlp), dlp, dlp + clp)


def _lift(x):
    return None if x is None else x[None]


def amis_propose(state: AmisState, generator, transitions, *, N: int, T: int,
                 active=None, draws=None, exact=False):
    """Draw N ``(s, theta)`` pairs per lane from the current proposals and
    return them with their discretized profiles: ``(L, N, k+1)`` twice and
    ``(L, N, T)``, with no lane axis for a single sampler. ``generator`` is
    a `torch.Generator` or a `LaneRNG` (the streams of this step); ``draws
    = (ss, thetas)`` skips the sampling (the tests feed both packages the
    same draws). ``active`` (bool ``(L, K)``, or ``(K,)`` for a single
    sampler) enables the padded-k mode: padded slots have interval fraction
    exactly 0 and never produce a switch. ``exact`` makes every float
    reduction lane-exact (`lanes.lane_sum`), as the lockstep runner needs."""
    if state.lanes is None:
        out = _propose_lanes(state._map(_lift), generator, transitions, N, T,
                             _lift(active),
                             None if draws is None else tuple(map(_lift, draws)),
                             exact)
        return tuple(x[0] for x in out)
    return _propose_lanes(state, generator, transitions, N, T, active, draws,
                          exact)


def amis_update(state: AmisState, ss_new, th_new, logL_new, transitions,
                logprior, conc_brake_N, pol_brake_N, *, maxiter: int = 1000,
                active=None, exact=False):
    """
    Ingest one new sample block per lane and run the AMIS ensemble update;
    updates ``state`` in place and returns ``(state, (logev, dlogev, KL))``
    with one value per lane (use the returned state). ``ss_new, th_new (L,
    N, k+1)``, ``logL_new (L, N)``; ``logprior`` a float or ``(L,)``;
    ``active`` (bool ``(L, K)``) the per-lane padded-k mask. For a single
    sampler every lane axis is absent. ``exact`` as in `amis_propose`.
    """
    if state.lanes is None:
        st, out = _update_lanes(state._map(_lift), ss_new[None], th_new[None],
                                logL_new[None], transitions, logprior,
                                conc_brake_N, pol_brake_N, maxiter,
                                _lift(active), exact)
        return st._map(lambda x: x[0]), tuple(x[0] for x in out)
    return _update_lanes(state, ss_new, th_new, logL_new, transitions,
                         logprior, conc_brake_N, pol_brake_N, maxiter, active,
                         exact)


def _propose_lanes(state, generator, transitions, N, T, active, draws, exact):
    if draws is not None:
        ss, thetas = draws
    else:
        sc = state.n_steps
        a = state.a_params[:, sc]
        mask = torch.ones_like(a, dtype=torch.bool) if active is None else active
        gd, gc = ((generator.fold(0), generator.fold(1))
                  if isinstance(generator, LaneRNG) else (generator, generator))
        ss = dirichlet_sample_masked(gd, a, mask, N, exact=exact)
        thetas = cfc_sample(gc, state.logps[:, sc], transitions, N,
                            active=active)
    act = None if active is None else active[:, None, :]
    return ss, thetas, st2profile(ss, thetas, T, active=act, exact=exact)


def _update_lanes(state, ss_new, th_new, logL_new, transitions, logprior,
                  conc_brake_N, pol_brake_N, maxiter, active, exact):
    L, S, N = state.logLs.shape
    k1 = state.ss.shape[-1]
    n = state.logps.shape[2]
    sc = state.n_steps                      # index of the step being ingested
    neg_inf = -math.inf

    a_cur = state.a_params[:, sc]                               # (L, K)
    logp_cur = state.logps[:, sc]                               # (L, n, K)

    state.ss[:, sc] = ss_new
    state.thetas[:, sc] = th_new
    state.logLs[:, sc] = logL_new
    ss, thetas, logLs = state.ss, state.thetas, state.logLs
    flat_ss = ss.reshape(L, S * N, k1)
    flat_th = thetas.reshape(L, S * N, k1)

    # current-proposal density of every stored sample
    clp = _log_proposal(a_cur, logp_cur, flat_ss, flat_th, transitions,
                        active=active, exact=exact).reshape(L, S, N)

    # mixture density of the new block: over the proposals 0..sc
    all_lp = _log_proposal(
        state.a_params[:, :sc + 1], state.logps[:, :sc + 1],
        ss_new[:, None], th_new[:, None], transitions,
        active=None if active is None else active[:, None, :],
        exact=exact)                                            # (L, sc+1, N)
    logdelta_new = lane_logsumexp(all_lp, dim=1, exact=exact)

    row = torch.arange(S, device=ss.device)[:, None]
    logdeltas = torch.where(
        row < sc, torch.logaddexp(state.logdeltas, clp),
        torch.where(row == sc, logdelta_new[:, None, :].expand(L, S, N),
                    state.logdeltas))

    # weights over the valid ensemble; a NaN log-weight marks an
    # inconsistent point (conflicting infinities) -> zero weight
    valid = row <= sc
    log_w = logLs - logdeltas + math.log1p(sc)
    log_w_masked = torch.where(valid & ~torch.isnan(log_w), log_w, neg_inf)
    flat_lw = log_w_masked.reshape(L, S * N)

    # proposal refit; an invalid Dirichlet estimate (non-positive or
    # non-finite concentration) keeps the previous proposal
    new_a = dirichlet_estimate(flat_ss, flat_lw, active=active, exact=exact)
    bad_a = ~torch.isfinite(new_a) | (new_a <= 0)
    if active is not None:
        bad_a = bad_a & active
    new_a = torch.where(bad_a.any(dim=-1, keepdim=True), a_cur, new_a)

    new_logp, mom_conv = cfc_estimate(flat_th, flat_lw, transitions, n,
                                      maxiter=maxiter, active=active,
                                      exact=exact)
    lp_invalid = torch.isnan(new_logp).flatten(1).any(dim=1)    # (L,)
    new_logp = torch.where(lp_invalid[:, None, None], logp_cur, new_logp)
    mom_conv = mom_conv | lp_invalid  # reverted, not a convergence failure

    # concentration brake; sums over active slots only, so padded-k results
    # match the exact-k program
    def asum(a):
        return lane_sum(a if active is None else torch.where(active, a, 0.0),
                        exact=exact)

    log_cr = torch.log(asum(new_a) / asum(a_cur))               # (L,)
    over = (log_cr.abs() > conc_brake_N)[:, None]
    new_a = torch.where(
        over, new_a * torch.exp(torch.sign(log_cr) * conc_brake_N - log_cr)[:, None],
        new_a)
    if active is not None:
        new_a = torch.where(active, new_a, torch.ones_like(new_a))

    # polarization brake, per slot
    old_p = torch.exp(logp_cur)
    delta = torch.exp(new_logp) - old_p                         # (L, n, K)
    mad = delta.abs().amax(dim=1, keepdim=True)                 # (L, 1, K)
    safe_mad = torch.where(mad > 0, mad, torch.ones_like(mad))
    braked = torch.log(old_p + pol_brake_N * delta / safe_mad)
    new_logp = torch.where(mad > pol_brake_N, braked, new_logp)
    if active is not None:
        new_logp = torch.where(active[:, None, :], new_logp,
                               torch.full_like(new_logp, -math.log(n)))

    # evidence, its standard error, KL
    cnt = float((sc + 1) * N)
    max_lw = flat_lw.amax(dim=1)                                # (L,)
    w_o = torch.exp(log_w_masked - max_lw[:, None, None])       # (L, S, N)
    ev_o = lane_sum(w_o.reshape(L, S * N), exact=exact) / cnt
    logev = torch.log(ev_o) + max_lw + logprior
    var = lane_sum(torch.where(valid, (w_o - ev_o[:, None, None]) ** 2, 0.0)
                   .reshape(L, S * N), exact=exact) / (cnt - 1)
    dlogev = torch.sqrt(var / cnt) / ev_o
    kl_term = w_o * (logLs - clp)
    kl_term = torch.where(valid & ~torch.isnan(kl_term), kl_term, 0.0)
    KL = (lane_sum(kl_term.reshape(L, S * N), exact=exact) / cnt / ev_o
          - logev + logprior)

    state.logdeltas = logdeltas
    state.a_params[:, sc + 1] = new_a
    state.logps[:, sc + 1] = new_logp
    state.evidences[:, sc] = torch.stack([logev, dlogev, KL], dim=-1)
    state.n_steps = sc + 1
    state.mom_ok = state.mom_ok & mom_conv
    return state, (logev, dlogev, KL)


def _marginal_posterior(ss, thetas, log_weights, *, T: int, nStates: int,
                        active=None, exact=False):
    """Weighted state marginals over an ensemble: ``(n, T)`` log-probs from
    ``ss, thetas (M, K)``, ``log_weights (M,)``, or ``(L, n, T)`` from a
    lane axis on each (``active (L, K)``). NaN log-weights (inconsistent
    points) get zero weight; with no finite weight at all the result is all
    -inf. Lanes are processed in groups that bound the ``(lanes, M, n, T)``
    intermediate; ``exact`` makes the reductions lane-exact."""
    if log_weights.dim() == 1:
        return _marginal_posterior(
            ss[None], thetas[None], log_weights[None], T=T, nStates=nStates,
            active=None if active is None else active[None], exact=exact)[0]
    L, M = log_weights.shape
    log_weights = torch.where(torch.isnan(log_weights), -math.inf, log_weights)
    states = torch.arange(nStates, device=ss.device)[None, None, :, None]
    group = max(1, 2**24 // max(1, M * nStates * T))
    out = []
    for lo in range(0, L, group):
        sl = slice(lo, lo + group)
        act = None if active is None else active[sl, None, :]
        profs = st2profile(ss[sl], thetas[sl], T, active=act,
                           exact=exact)                          # (l, M, T)
        indic = profs[:, :, None, :] == states                   # (l, M, n, T)
        logpost = lane_logsumexp(
            torch.where(indic, log_weights[sl, :, None, None], -math.inf),
            dim=1, exact=exact)                                  # (l, n, T)
        norm = lane_logsumexp(logpost, dim=1, keepdim=True, exact=exact)
        out.append(torch.where(torch.isfinite(norm), logpost - norm, -math.inf))
    return torch.cat(out)


def draw_seed(generator: torch.Generator) -> int:
    """A 62-bit seed drawn from ``generator``."""
    return int(torch.randint(0, 2**62, (1,), generator=generator,
                             device=generator.device))


def spawn_generator(generator: torch.Generator) -> torch.Generator:
    """A new generator on the same device, seeded from ``generator``."""
    child = torch.Generator(device=generator.device)
    child.manual_seed(draw_seed(generator))
    return child


class FixedkSampler:
    """
    AMIS sampling at fixed switch count ``k`` for one (trajectory, model).

    Parameters as `bild_tpu.amis.FixedkSampler`; ``generator`` is the
    `torch.Generator` (on the trajectory's device) all draws come from,
    seeded from numpy's global RNG if omitted.
    """

    class ExhaustionImpractical(ValueError):
        pass

    def __init__(self, traj, model, k,
                 N=100,
                 concentration_brake=1e-2,
                 polarization_brake=1e-3,
                 max_fev=20000,
                 max_fcomplete=1000,
                 generator=None,
                 k_pad=None,
                 informed_init=False):
        self.k = k
        self.k_pad = k_pad
        self.informed_init = informed_init
        self.N = N
        self.brakes = (concentration_brake, polarization_brake)
        self.max_fev = max_fev
        self.max_fcomplete = max_fcomplete
        self.exhausted = False
        self._steps_host = 0

        self.traj = traj
        self.model = model
        self.T = len(traj)
        self.device = traj.data.device
        self.dtype = traj.data.dtype

        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(int(np.random.randint(2**31)))
        self.generator = generator
        self.evidences = []          # host mirror: [(logev, dlogev, KL)]
        self._exhaustive = None      # dict if exhaustively enumerated

        if self.k >= self.T:
            # unidentifiable by construction
            self.evidences = [(-np.inf, 1e-10, np.inf)]
            self.exhausted = True
            return

        self.cfc = CFC(model.transitions)
        self._transitions = torch.as_tensor(model.transitions, device=self.device)
        self.n = self.cfc.n

        # uniform prior over profiles: k! / N_total
        self.logprior = float(
            sum(math.log(i + 1) for i in range(self.k))
            - self.cfc.N_total(self.k, log=True))

        # padded-k slot count: padded slots carry interval fraction exactly 0
        # and are masked out of all proposal math
        self.K1 = max(self.k, k_pad if k_pad is not None else self.k) + 1
        self.active = torch.arange(self.K1, device=self.device) < (self.k + 1)

        a0 = np.ones(self.K1)
        logp0 = np.full((self.n, self.K1), -np.log(self.n))
        logp0[:, : self.k + 1] = self.cfc.logp_uniform(self.k)

        # informed initialization: the guess becomes the SECOND mixture
        # component, the first stays uniform
        self._informed = None
        if informed_init:
            guess = model.segment_guess(traj, k)
            if guess is not None:
                fracs, theta = guess
                a_inf, logp_inf = informed_proposal(fracs, theta, self.n, self.T)
                a_full = np.ones(self.K1)
                a_full[: self.k + 1] = a_inf
                logp_full = np.full((self.n, self.K1), -np.log(self.n))
                logp_full[:, : self.k + 1] = logp_inf
                self._informed = (
                    torch.as_tensor(a_full, dtype=self.dtype, device=self.device),
                    torch.as_tensor(logp_full, dtype=self.dtype, device=self.device))

        self.S = max(1, -(-self.max_fev // self.N) - 1)  # max possible steps
        # held as one lane: the steps call the lane functions directly, as
        # lifting a lane-less state would cost views on every step
        self._lane = AmisState.create(self.S, self.N, self.K1 - 1, self.n,
                                      a0[None], logp0[None], device=self.device,
                                      dtype=self.dtype, lanes=1)
        self._lane_active = self.active[None]

        if hasattr(model, "lockstep_fns_single"):
            per_traj, logL_fn = model.lockstep_fns_single(traj)
            self._logL = lambda profiles: logL_fn(profiles, per_traj)
        else:
            self._logL = lambda profiles: model.logL_batch(profiles, traj)

        try:
            self.fix_exhaustive()
        except (self.ExhaustionImpractical, SampleSpaceTooLarge):
            pass  # space too large to enumerate -> AMIS stepping

    @property
    def state(self) -> AmisState:
        """The sampler's `AmisState`, without the lane axis (views)."""
        return self._lane._map(lambda x: x[0])

    def _tensor(self, x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype or self.dtype,
                               device=self.device)

    # -- parameter conversion (host convenience) --------------------------
    def st2profile(self, s, theta) -> Loopingprofile:
        """(s, theta) -> Loopingprofile."""
        return Loopingprofile(st2profile(self._tensor(s),
                                         self._tensor(theta, torch.int32),
                                         self.T))

    def log_proposal(self, parameters, ss, thetas):
        """Joint proposal density Dirichlet(ss) x CFC(thetas) under the
        given ``(a, logp)`` parameters; ``(N,)`` numpy."""
        a, logp = parameters
        ss = np.asarray(ss)
        if ss.shape[-1] == self.k + 1:        # exact-size arrays
            active = None
        elif ss.shape[-1] == self.K1:          # padded-k arrays
            active = self.active
        else:
            raise ValueError(f"ss has {ss.shape[-1]} slots; expected "
                             f"{self.k + 1} (exact) or {self.K1} (padded)")
        return _log_proposal(self._tensor(a), self._tensor(logp),
                             self._tensor(ss), self._tensor(thetas, torch.int32),
                             self._transitions, active=active).cpu().numpy()

    def logL(self, ss, thetas):
        """Batched likelihood of (s, theta) parameter arrays; ``(N,)``."""
        profiles = st2profile(self._tensor(ss), self._tensor(thetas, torch.int32),
                              self.T)
        return self.model.logL_batch(profiles, self.traj)

    # -- exhaustive enumeration ------------------------------------------------
    def fix_exhaustive(self):
        Nmax = min(self.max_fcomplete, self.max_fev)

        Nsamples = self.cfc.N_total(self.k)
        for i in range(self.k):
            Nsamples *= self.T - i - 1
            if Nsamples > Nmax:
                raise self.ExhaustionImpractical(
                    f"Parameter space too large for exhaustive sampling "
                    f"(number of profiles = {Nsamples} > Nmax = {Nmax})")

        # switch positions at inter-frame midpoints; ss = interval fractions
        switch_list = list(itertools.combinations(np.arange(self.T - 1) + 0.5, self.k))
        normed = (np.array(switch_list, dtype=float).reshape(len(switch_list), self.k)
                  / (self.T - 1))
        normed = np.concatenate(
            [np.zeros((len(normed), 1)), normed, np.ones((len(normed), 1))], axis=1)
        ss = np.diff(normed, axis=1)                       # (n_pos, k+1)

        thetas = self.cfc.full_sample(self.k, Nmax=Nmax)   # (n_theta, k+1)

        n_pos = len(ss)
        ss = np.tile(ss, (len(thetas), 1))
        thetas = np.repeat(thetas, n_pos, axis=0)

        profiles = st2profile(self._tensor(ss), self._tensor(thetas, torch.int32),
                              self.T)
        logLs = self._logL(profiles).cpu().numpy().astype(float)

        # exact evidence: mean over the uniform prior ensemble
        max_logL = np.max(logLs)
        with np.errstate(under="ignore"):
            weights_o = np.exp(logLs - max_logL)
            ev_o = np.mean(weights_o)
            logev = float(np.log(ev_o) + max_logL)
            dlogev = 1e-10
            KL = float(np.mean(logLs * weights_o) / ev_o - logev)

        self._exhaustive = {
            "ss": ss, "thetas": thetas,
            "logLs": logLs, "profiles": profiles.cpu().numpy(),
        }
        self.evidences.append((logev, dlogev, KL))
        self.exhausted = True

    # -- AMIS steps --------------------------------------------------------------
    @property
    def n_steps_host(self) -> int:
        """Steps run so far."""
        return self._steps_host

    def step(self) -> bool:
        """Run one AMIS iteration; ``False`` iff the sampler is exhausted."""
        return self.steps(1) == 1

    def steps(self, n: int) -> int:
        """Run up to ``n`` AMIS iterations with one host fetch for all their
        outputs; returns the number actually run."""
        if self.exhausted or n <= 0:
            return 0
        n_run = min(int(n), self.S - self._steps_host)
        if n_run <= 0:  # pragma: no cover - guarded by `exhausted`
            self.exhausted = True
            return 0

        cb = self.N * self.brakes[0]
        pb = self.N * self.brakes[1]
        ev_rows, mom_rows = [], []
        for _ in range(n_run):
            ss, thetas, profiles = _propose_lanes(
                self._lane, self.generator, self._transitions, self.N, self.T,
                self._lane_active, None, False)
            logLs = self._logL(profiles[0]).to(self.dtype)
            self._lane, out = _update_lanes(
                self._lane, ss, thetas, logLs[None], self._transitions,
                self.logprior, cb, pb, 1000, self._lane_active, False)
            ev_rows.append(torch.stack(out))
            # cumulative convergence after this step: the host drops
            # evidences from a diverged step onward
            mom_rows.append(self._lane.mom_ok)
            if self._informed is not None and self._lane.n_steps == 1:
                # second mixture component <- informed proposal
                self._lane.a_params[0, 1], self._lane.logps[0, 1] = self._informed

        packed = torch.cat([torch.stack(ev_rows).reshape(-1),
                            torch.stack(mom_rows).to(self.dtype).reshape(-1)])
        vals = packed.cpu().numpy()                  # ONE fetch for everything
        ev = vals[: 3 * n_run].reshape(n_run, 3)
        mom = vals[3 * n_run:] != 0
        mom_ok = bool(mom[-1])
        if not mom_ok:
            # keep only evidences from steps before the divergence
            ev = ev[: int(np.argmin(mom))]

        self.evidences.extend((float(a), float(b), float(c)) for a, b, c in ev)
        self._steps_host = self._lane.n_steps
        if not mom_ok:
            raise RuntimeError(
                "CFC method-of-marginals iteration did not converge")
        if (self._steps_host + 1) * self.N >= self.max_fev:
            self.exhausted = True
        return n_run

    # -- views -------------------------------------------------------------------
    def _stored(self):
        """``(ss, thetas, logLs, log_weights)`` of the valid steps (numpy)."""
        sc = self.state.n_steps
        ss = self.state.ss[:sc].cpu().numpy()
        th = self.state.thetas[:sc].cpu().numpy()
        lls = self.state.logLs[:sc].cpu().numpy()
        lws = lls - self.state.logdeltas[:sc].cpu().numpy() + (np.log(sc) if sc else 0.0)
        return ss, th, lls, lws

    @property
    def samples(self):
        """Per-step sample dicts (keys ``ss``, ``thetas``, ``logLs``,
        ``log_weights``)."""
        if self._exhaustive is not None:
            ex = self._exhaustive
            return [{"ss": ex["ss"], "thetas": ex["thetas"], "logLs": ex["logLs"]}]
        ss, th, lls, lws = self._stored()
        return [{"ss": ss[i], "thetas": th[i], "logLs": lls[i],
                 "log_weights": lws[i]} for i in range(len(ss))]

    @property
    def parameters(self):
        """Proposal parameter track ``[(a, logp), ...]``."""
        sc = self.state.n_steps
        a = self.state.a_params[: sc + 1].cpu().numpy()
        logp = self.state.logps[: sc + 1].cpu().numpy()
        return [(a[i], logp[i]) for i in range(sc + 1)]

    # -- results -----------------------------------------------------------------
    def tstat(self, other) -> float:
        """Evidence separation score."""
        logev0, dlogev0 = self.evidences[-1][:2]
        logev1, dlogev1 = other.evidences[-1][:2]
        return (logev0 - logev1) / np.sqrt(dlogev0**2 + dlogev1**2)

    def MAP_profile(self) -> Loopingprofile:
        """Maximum-likelihood profile over all evaluated samples."""
        if self._exhaustive is not None:
            i = int(np.argmax(self._exhaustive["logLs"]))
            return Loopingprofile(self._exhaustive["profiles"][i])
        ss, th, lls, _ = self._stored()
        step_i, samp_i = np.unravel_index(np.argmax(lls), lls.shape)
        k1 = self.k + 1          # slice away padded slots (fractions are 0)
        return self.st2profile(ss[step_i, samp_i][:k1], th[step_i, samp_i][:k1])

    def log_marginal_posterior(self) -> np.ndarray:
        """``(n, T)`` normalized log marginal posterior."""
        if self._exhaustive is not None:
            ex = self._exhaustive
            ss, th, lw, active = ex["ss"], ex["thetas"], ex["logLs"], None
        else:
            ss, th, _, lw = self._stored()
            ss, th, lw = (ss.reshape(-1, self.K1), th.reshape(-1, self.K1),
                          lw.reshape(-1))
            active = self.active
        return _marginal_posterior(
            self._tensor(ss), self._tensor(th, torch.int32), self._tensor(lw),
            T=self.T, nStates=self.model.nStates, active=active).cpu().numpy()
