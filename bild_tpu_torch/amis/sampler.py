"""
Fixed-k AMIS sampler (counterpart of `bild_tpu.amis.sampler`).

AMIS (Cornuet et al. 2012) iterates: draw N profiles from the current
proposal, evaluate their likelihoods, deterministic-mixture-reweight the
whole stored ensemble, refit the proposal by (braked) method of moments,
and update the evidence estimate.

All sampler state lives in fixed-size tensors (`AmisState`): ``(S, N, .)``
buffers for the S = max_fev/N possible steps plus the proposal and evidence
tracks; only the step counter is a host int. One step is `amis_propose`,
the model's batched likelihood and `amis_update`, all on the state's
device. `FixedkSampler.steps` runs several steps and fetches their results
to the host once, packed in one tensor.
"""
from __future__ import annotations

import dataclasses
import itertools
import math

import numpy as np
import torch

from ..profiles import Loopingprofile, st2profile
from .cfc import CFC, SampleSpaceTooLarge, cfc_sample, cfc_logpmf, cfc_estimate
from .dirichlet import (dirichlet_logpdf, dirichlet_estimate,
                        dirichlet_sample_masked)

__all__ = ["FixedkSampler", "AmisState", "amis_propose", "amis_update",
           "informed_proposal"]

_FIELDS = ("ss", "thetas", "logLs", "logdeltas", "a_params", "logps",
           "evidences")


@dataclasses.dataclass
class AmisState:
    """State of one fixed-k AMIS sampler; updated in place by `amis_update`."""

    ss: torch.Tensor          # (S, N, k+1) float — interval fractions
    thetas: torch.Tensor      # (S, N, k+1) int32 — state traces
    logLs: torch.Tensor       # (S, N) float
    logdeltas: torch.Tensor   # (S, N) float — deterministic-mixture proposal mass
    a_params: torch.Tensor    # (S+1, k+1) float — Dirichlet concentrations
    logps: torch.Tensor       # (S+1, n, k+1) float — CFC weights
    evidences: torch.Tensor   # (S, 3) float — (logev, dlogev, KL) per step
    n_steps: int              # steps ingested so far
    mom_ok: torch.Tensor      # () bool — CFC fixed point converged at every step

    @staticmethod
    def create(S, N, k, n, a0, logp0, *, device, dtype) -> "AmisState":
        a_params = torch.zeros((S + 1, k + 1), dtype=dtype, device=device)
        a_params[0] = torch.as_tensor(a0, dtype=dtype)
        logps = torch.zeros((S + 1, n, k + 1), dtype=dtype, device=device)
        logps[0] = torch.as_tensor(logp0, dtype=dtype)
        return AmisState(
            ss=torch.zeros((S, N, k + 1), dtype=dtype, device=device),
            thetas=torch.zeros((S, N, k + 1), dtype=torch.int32, device=device),
            logLs=torch.zeros((S, N), dtype=dtype, device=device),
            logdeltas=torch.zeros((S, N), dtype=dtype, device=device),
            a_params=a_params,
            logps=logps,
            evidences=torch.zeros((S, 3), dtype=dtype, device=device),
            n_steps=0,
            mom_ok=torch.ones((), dtype=torch.bool, device=device),
        )

    @staticmethod
    def from_numpy(arrays: dict, *, device, dtype) -> "AmisState":
        """A state from numpy arrays under the field names (``thetas`` as
        ints, ``n_steps`` an int, ``mom_ok`` a bool); e.g. a `bild_tpu`
        sampler's state, so both packages can run the same update."""
        fields = {k: torch.as_tensor(np.array(arrays[k]), device=device,
                                     dtype=torch.int32 if k == "thetas" else dtype)
                  for k in _FIELDS}
        return AmisState(**fields, n_steps=int(arrays["n_steps"]),
                         mom_ok=torch.as_tensor(bool(arrays["mom_ok"]),
                                                device=device))

    def to_numpy(self) -> dict:
        out = {k: getattr(self, k).cpu().numpy() for k in _FIELDS}
        out["n_steps"] = self.n_steps
        out["mom_ok"] = bool(self.mom_ok)
        return out


def informed_proposal(fracs, theta, n, T):
    """
    Proposal parameters concentrated around a segmentation guess: Dirichlet
    mean = the guessed interval fractions at total concentration
    ``(k+1) * max(2, sqrt(T))``; CFC slots go 80/20 toward the guessed
    states. Returns numpy ``(a, logp)``.
    """
    fracs = np.asarray(fracs, dtype=float)
    theta = np.asarray(theta, dtype=int)
    k1 = len(fracs)
    conc = k1 * max(2.0, float(np.sqrt(T)))
    a = np.maximum(conc * fracs, 0.05)
    p = np.full((n, k1), 0.2 / max(n - 1, 1))
    p[theta, np.arange(k1)] = 0.8
    return a, np.log(p)


def _log_proposal(a, logp, ss, thetas, transitions, active=None):
    """Joint proposal density Dirichlet(s) x CFC(theta), ``(..., N)`` for
    parameters with a leading axis. A +inf Dirichlet density (a zero
    coordinate with concentration < 1) dominates even a -inf CFC part:
    such points must get zero importance weight, and ``inf + -inf = nan``
    would poison the mixture."""
    dlp = dirichlet_logpdf(a, ss, active=active)
    clp = cfc_logpmf(logp, thetas, transitions, active=active)
    return torch.where(torch.isposinf(dlp), dlp, dlp + clp)


def amis_propose(state: AmisState, generator, transitions, *, N: int, T: int,
                 active=None, draws=None):
    """Draw N ``(s, theta)`` pairs from the current proposal and return them
    with their discretized ``(N, T)`` profiles. ``draws = (ss, thetas)``
    skips the sampling (the tests feed both packages the same draws).
    ``active`` (bool ``(K,)``) enables the padded-k mode: padded slots have
    interval fraction exactly 0 and never produce a switch."""
    if draws is not None:
        ss, thetas = draws
    else:
        sc = state.n_steps
        a = state.a_params[sc]
        mask = (torch.ones_like(a, dtype=torch.bool) if active is None
                else active)
        ss = dirichlet_sample_masked(generator, a, mask, N)
        thetas = cfc_sample(generator, state.logps[sc], transitions, N,
                            active=active)
    return ss, thetas, st2profile(ss, thetas, T, active=active)


def amis_update(state: AmisState, ss_new, th_new, logL_new, transitions,
                logprior, conc_brake_N, pol_brake_N, *, maxiter: int = 1000,
                active=None):
    """
    Ingest one new sample block and run the AMIS ensemble update; updates
    ``state`` in place and returns ``(state, (logev, dlogev, KL))`` with
    0-d tensors. ``active`` enables the padded-k mode.
    """
    S, N = state.logLs.shape
    k1 = state.ss.shape[-1]
    n = state.logps.shape[1]
    sc = state.n_steps                      # index of the step being ingested
    neg_inf = -math.inf

    a_cur = state.a_params[sc]
    logp_cur = state.logps[sc]

    state.ss[sc] = ss_new
    state.thetas[sc] = th_new
    state.logLs[sc] = logL_new
    ss, thetas, logLs = state.ss, state.thetas, state.logLs

    # current-proposal density of every stored sample (flat over S*N)
    clp = _log_proposal(a_cur, logp_cur, ss.reshape(S * N, k1),
                        thetas.reshape(S * N, k1), transitions,
                        active=active).reshape(S, N)

    # mixture density of the new block: over the proposals 0..sc
    all_lp = _log_proposal(state.a_params[:sc + 1], state.logps[:sc + 1],
                           ss_new, th_new, transitions, active=active)
    logdelta_new = torch.logsumexp(all_lp, dim=0)

    row = torch.arange(S, device=ss.device)[:, None]
    logdeltas = torch.where(
        row < sc, torch.logaddexp(state.logdeltas, clp),
        torch.where(row == sc, logdelta_new[None, :].expand(S, N),
                    state.logdeltas))

    # weights over the valid ensemble; a NaN log-weight marks an
    # inconsistent point (conflicting infinities) -> zero weight
    valid = row <= sc
    log_w = logLs - logdeltas + math.log1p(sc)
    log_w_masked = torch.where(valid & ~torch.isnan(log_w), log_w, neg_inf)
    flat_lw = log_w_masked.reshape(S * N)

    # proposal refit; an invalid Dirichlet estimate (non-positive or
    # non-finite concentration) keeps the previous proposal
    new_a = dirichlet_estimate(ss.reshape(S * N, k1), flat_lw, active=active)
    bad_a = ~torch.isfinite(new_a) | (new_a <= 0)
    if active is not None:
        bad_a = bad_a & active
    new_a = torch.where(bad_a.any(), a_cur, new_a)

    new_logp, mom_conv = cfc_estimate(thetas.reshape(S * N, k1), flat_lw,
                                      transitions, n, maxiter=maxiter,
                                      active=active)
    lp_invalid = torch.isnan(new_logp).any()
    new_logp = torch.where(lp_invalid, logp_cur, new_logp)
    mom_conv = mom_conv | lp_invalid  # reverted, not a convergence failure

    # concentration brake; sums over active slots only, so padded-k results
    # match the exact-k program
    def asum(a):
        return a.sum() if active is None else torch.where(active, a, 0.0).sum()

    log_cr = torch.log(asum(new_a) / asum(a_cur))
    over = log_cr.abs() > conc_brake_N
    new_a = torch.where(
        over, new_a * torch.exp(torch.sign(log_cr) * conc_brake_N - log_cr),
        new_a)
    if active is not None:
        new_a = torch.where(active, new_a, torch.ones_like(new_a))

    # polarization brake, per slot
    old_p = torch.exp(logp_cur)
    delta = torch.exp(new_logp) - old_p                        # (n, k+1)
    mad = delta.abs().amax(dim=0)                              # (k+1,)
    safe_mad = torch.where(mad > 0, mad, torch.ones_like(mad))
    braked = torch.log(old_p + pol_brake_N * delta / safe_mad)
    new_logp = torch.where((mad > pol_brake_N)[None, :], braked, new_logp)
    if active is not None:
        new_logp = torch.where(active[None, :], new_logp,
                               torch.full_like(new_logp, -math.log(n)))

    # evidence, its standard error, KL
    cnt = float((sc + 1) * N)
    max_lw = log_w_masked.max()
    w_o = torch.exp(log_w_masked - max_lw)
    ev_o = w_o.sum() / cnt
    logev = torch.log(ev_o) + max_lw + logprior
    var = torch.where(valid, (w_o - ev_o) ** 2, 0.0).sum() / (cnt - 1)
    dlogev = torch.sqrt(var / cnt) / ev_o
    kl_term = w_o * (logLs - clp)
    kl_term = torch.where(valid & ~torch.isnan(kl_term), kl_term, 0.0)
    KL = kl_term.sum() / cnt / ev_o - logev + logprior

    state.logdeltas = logdeltas
    state.a_params[sc + 1] = new_a
    state.logps[sc + 1] = new_logp
    state.evidences[sc] = torch.stack([logev, dlogev, KL])
    state.n_steps = sc + 1
    state.mom_ok = state.mom_ok & mom_conv
    return state, (logev, dlogev, KL)


def _marginal_posterior(ss, thetas, log_weights, *, T: int, nStates: int,
                        active=None):
    """Weighted state marginals over an ensemble: ``(n, T)`` log-probs.
    NaN log-weights (inconsistent points) get zero weight; with no finite
    weight at all the result is all -inf."""
    log_weights = torch.where(torch.isnan(log_weights), -math.inf, log_weights)
    profs = st2profile(ss, thetas, T, active=active)           # (M, T)
    indic = profs[:, None, :] == torch.arange(
        nStates, device=profs.device)[None, :, None]           # (M, n, T)
    logpost = torch.logsumexp(
        torch.where(indic, log_weights[:, None, None], -math.inf), dim=0)
    norm = torch.logsumexp(logpost, dim=0)
    return torch.where(torch.isfinite(norm), logpost - norm, -math.inf)


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
        self.state = AmisState.create(self.S, self.N, self.K1 - 1, self.n,
                                      a0, logp0, device=self.device,
                                      dtype=self.dtype)

        if hasattr(model, "lockstep_fns_single"):
            per_traj, logL_fn = model.lockstep_fns_single(traj)
            self._logL = lambda profiles: logL_fn(profiles, per_traj)
        else:
            self._logL = lambda profiles: model.logL_batch(profiles, traj)

        try:
            self.fix_exhaustive()
        except (self.ExhaustionImpractical, SampleSpaceTooLarge):
            pass  # space too large to enumerate -> AMIS stepping

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
            ss, thetas, profiles = amis_propose(
                self.state, self.generator, self._transitions, N=self.N,
                T=self.T, active=self.active)
            logLs = self._logL(profiles).to(self.dtype)
            self.state, out = amis_update(
                self.state, ss, thetas, logLs, self._transitions,
                self.logprior, cb, pb, active=self.active)
            ev_rows.append(torch.stack(out))
            # cumulative convergence after this step: the host drops
            # evidences from a diverged step onward
            mom_rows.append(self.state.mom_ok)
            if self._informed is not None and self.state.n_steps == 1:
                # second mixture component <- informed proposal
                self.state.a_params[1], self.state.logps[1] = self._informed

        packed = torch.cat([torch.stack(ev_rows).reshape(-1),
                            torch.stack(mom_rows).to(self.dtype)])
        vals = packed.cpu().numpy()                  # ONE fetch for everything
        ev = vals[: 3 * n_run].reshape(n_run, 3)
        mom = vals[3 * n_run:] != 0
        mom_ok = bool(mom[-1])
        if not mom_ok:
            # keep only evidences from steps before the divergence
            ev = ev[: int(np.argmin(mom))]

        self.evidences.extend((float(a), float(b), float(c)) for a, b, c in ev)
        self._steps_host = self.state.n_steps
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
