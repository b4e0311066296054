"""
Conflict-Free Categorical (CFC) proposal over state traces theta
(counterpart of `bild_tpu.amis.cfc`).

The CFC is a categorical over length-(k+1) state sequences with transition
constraints, parametrized by per-slot weights ``logp (n, k+1)`` and sampled
causally slot by slot.

- Tensor functions: `cfc_sample` (Gumbel-max per slot), `cfc_logpmf`,
  `cfc_estimate` and `cfc_logp_from_marginals` (a fixed-point solve per
  slot: `solve_marginals`, which launches ``csrc/cfc_solve.cu`` for CUDA
  tensors and runs the plain loop `_solve_marginals` for CPU tensors).
- Host class `CFC`: counting traces with transition-matrix powers in
  Python ints, exhaustive enumeration, and the uniform-proposal weights
  (numpy; a copy of the JAX package's host code).

Every tensor function takes an optional ``active`` bool mask over the
slot axis (padded-k mode): inactive slots are sampled from an unconstrained
uniform categorical (their interval fractions are exactly 0, so their
values are never used) and contribute nothing to pmf or estimates. Every
tensor function also takes an optional leading lane axis (one lane per
sampler of the lockstep runner), with a mask per lane; float reductions
over a lane's own axes go through `lanes.lane_sum`; with ``exact=True``
(the lockstep runner) a lane's numbers do not depend on how many lanes
share the call.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..lanes import lane_logsumexp, lane_sum, uniform
from ..ops import _build, counters

__all__ = ["CFC", "SampleSpaceTooLarge", "cfc_sample", "cfc_logpmf",
           "cfc_estimate", "cfc_logp_from_marginals", "solve_marginals"]

# The plain `_solve_marginals` asks the device whether every slot has
# converged only every this many iterations (each ask is a host
# synchronization). A converged slot is frozen, so the extra iterations
# change nothing: the result is exactly that of checking after every
# iteration. The kernel stops each slot on its own and asks nothing.
SOLVE_CHECK_EVERY = 4
# the largest state count the kernel takes (csrc/cfc_solve.cu)
SOLVE_MAX_STATES = 64
# State counts up to `SOLVE_GROUP_STATES` have a kernel of their own in
# which a group of threads (the power of two >= n) serves a row; larger
# ones take one thread per row. Blocks of `SOLVE_THREADS` threads.
SOLVE_GROUP_STATES = 8
SOLVE_THREADS = 64


def solve_plan(M: int, n: int):
    """``(group, threads, blocks)`` of the CFC kernel for ``M`` rows of
    ``n`` states: the threads serving one row (the power of two >= n up to
    `SOLVE_GROUP_STATES` states, else 1; a warp holds 32 // group rows),
    the threads of a block and the blocks covering ``M`` rows (the kernel
    refuses a plan that is not its own)."""
    group = 1 << (n - 1).bit_length() if n <= SOLVE_GROUP_STATES else 1
    return group, SOLVE_THREADS, -(-M * group // SOLVE_THREADS)


class SampleSpaceTooLarge(ValueError):
    """`CFC.full_sample` would exceed its Nmax."""


def _masked_lse(x, mask, dim, keepdim=False, exact=False):
    """``log(sum(mask * exp(x)))`` along ``dim``; -inf where mask is empty."""
    return lane_logsumexp(torch.where(mask, x, -math.inf), dim=dim,
                          keepdim=keepdim, exact=exact)


def cfc_sample(generator, logp, transitions, N, active=None):
    """
    Draw ``N`` state traces from CFC(logp): ``(N, k+1)`` int32, or ``(L,
    N, k+1)`` for lane-batched ``logp (L, n, k+1)``, ``active (L, k+1)``.

    Slot 0 from ``logp[:, 0]``; each next slot from ``logp[:, i]``
    restricted to the states allowed after the previous one. Each draw is
    the argmax of the masked logits plus Gumbel noise, which handles -inf
    logits exactly. ``generator`` is a `torch.Generator` or a `LaneRNG`.
    """
    if logp.dim() == 2:
        return cfc_sample(generator, logp[None], transitions, N,
                          None if active is None else active[None])[0]
    L, n, k1 = logp.shape
    u = uniform(generator, (L, k1, N, n), 0, logp.dtype, logp.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(logp.dtype).tiny)))
    # slot-major views, made once: the loop below indexes one slot each
    lp_slot = logp.permute(2, 0, 1)[:, :, None, :]                 # (K, L, 1, n)
    act_slot = None if active is None else active.T[:, :, None, None]
    th = torch.argmax(lp_slot[0] + gumbel[:, 0], dim=-1)           # (L, N)
    out = [th]
    for i in range(1, k1):
        logits = torch.where(transitions[th], lp_slot[i], -math.inf)
        if act_slot is not None:
            # padded slot: unconstrained uniform, keeps the chain alive
            logits = torch.where(act_slot[i], logits, torch.zeros_like(logits))
        th = torch.argmax(logits + gumbel[:, i], dim=-1)
        out.append(th)
    return torch.stack(out, dim=-1).to(torch.int32)


def cfc_logpmf(logp, thetas, transitions, active=None, exact=False):
    """
    Log-pmf of traces under CFC(logp) -> ``(..., N)``: weights ``logp
    (..., n, k+1)`` and traces ``thetas (..., N, k+1)`` broadcast with the
    traces' ``N`` axis (a leading axis of ``logp`` evaluates several
    proposals on the same traces; a lane axis pairs each lane's weights
    with its traces). ``active`` is broadcastable to ``logp``'s slot shape
    ``(..., k+1)``; ``exact`` makes the sums lane-exact (`lanes.lane_sum`).
    """
    th = thetas.long()
    n, k1 = logp.shape[-2:]
    lpT = logp.transpose(-1, -2)                              # (..., k+1, n)
    logp_theta = lpT[..., None, :, 0]                         # (..., 1, k+1)
    for s in range(1, n):
        logp_theta = torch.where(th == s, lpT[..., None, :, s], logp_theta)
    act = None if active is None else active[..., None, :]
    if act is not None:
        logp_theta = torch.where(act, logp_theta, torch.zeros_like(logp_theta))
    total = lane_sum(logp_theta, exact=exact)
    if k1 > 1:
        # normalization of each conditional slot: over the states allowed
        # after the previous slot's state
        allowed = transitions[th[..., :-1]]                   # (..., N, k, n)
        log_norm = _masked_lse(lpT[..., None, 1:, :], allowed, dim=-1,
                               exact=exact)
        if act is not None:
            log_norm = torch.where(act[..., 1:], log_norm,
                                   torch.zeros_like(log_norm))
        total = total - lane_sum(log_norm, exact=exact)
    return total - lane_logsumexp(logp[..., :, 0], exact=exact)[..., None]


def _solve_marginals(logf, logg, transitions, maxiter, precision, frozen=None,
                     exact=False):
    """
    Fixed-point solve for slot weights from (current, previous) marginals,
    all slots (and lanes) at once: ``logf, logg (..., K, n)`` -> ``(logp
    (..., K, n), converged (..., K))``. A slot freezes at its first iterate
    with max-delta < precision; ``frozen`` pre-freezes slots. The loop ends
    when every slot of every lane is frozen (asked of the device every
    `SOLVE_CHECK_EVERY` iterations) or after ``maxiter`` iterations.
    ``exact`` makes the log-sum-exps lane-exact (`lanes.lane_logsumexp`).
    The plain version of `solve_marginals`' kernel; counts its calls in
    ``_solve_marginals.calls``.
    """
    _solve_marginals.calls += 1
    i_f0 = logf == -math.inf
    i_g0 = logg == -math.inf
    # Kronecker-delta marginals: weights equal the marginal directly
    is_delta = (logf == 0).any(dim=-1) | (logg == 0).any(dim=-1)
    done = is_delta if frozen is None else (is_delta | frozen)
    zero = torch.zeros_like(logf)
    logp = logf
    for it in range(maxiter):
        if it % SOLVE_CHECK_EVERY == 0 and bool(done.all()):
            break
        log_norm = _masked_lse(logp[..., None, :], transitions, dim=-1,
                               exact=exact)                              # per i
        log_norm = torch.where(i_g0, zero, log_norm)
        log_Sgp = _masked_lse((logg - log_norm)[..., :, None], transitions,
                              dim=-2, exact=exact)                       # per j
        log_Sgp = torch.where(i_f0, zero, log_Sgp)
        lp = logf - log_Sgp
        lp = lp - lane_logsumexp(lp, dim=-1, keepdim=True, exact=exact)
        delta = torch.where(i_f0, zero, (lp - logp).abs())
        lp = torch.where(done[..., None], logp, lp)          # freeze finished
        done = done | (delta.amax(dim=-1) < precision)
        logp = lp
    return torch.where(is_delta[..., None], logf, logp), done


counters.register("plain_cfc", _solve_marginals, "calls")


def solve_marginals(logf, logg, transitions, maxiter, precision, frozen=None,
                    exact=False):
    """
    `_solve_marginals` on the device of ``logf``: CUDA tensors launch the
    fixed-point kernel (``csrc/cfc_solve.cu``, a group of threads per slot
    up to `SOLVE_GROUP_STATES` states, else one, `solve_plan`; on the
    current stream, no synchronization), CPU tensors run the plain loop.
    The kernel sums in the lane-exact order, so it computes what
    ``_solve_marginals(..., exact=True)`` computes, whatever ``exact`` says;
    it takes float32 and float64 and up to `SOLVE_MAX_STATES` states.
    Counts its launches in
    ``solve_marginals.launches``.
    """
    if logf.device.type == "cpu":
        return _solve_marginals(logf, logg, transitions, maxiter, precision,
                                frozen=frozen, exact=exact)
    if logf.device.type != "cuda":
        raise ValueError(f"no kernel for device {logf.device}")
    n = logf.shape[-1]
    dtype, dev = logf.dtype, logf.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the CFC solve takes float32 or float64, not {dtype}")
    if not 1 <= n <= SOLVE_MAX_STATES:
        raise ValueError(f"the CFC solve takes 1 to {SOLVE_MAX_STATES} states, "
                         f"not {n}")
    if logg.shape != logf.shape or logg.dtype != dtype or logg.device != dev:
        raise ValueError("logf and logg must match in shape, dtype and device")
    if transitions.shape != (n, n) or transitions.device != dev:
        raise ValueError(f"transitions must be ({n}, {n}) on {dev}")
    lead = logf.shape[:-1]
    M = math.prod(lead)
    logf, logg = logf.contiguous(), logg.contiguous()
    tr = transitions.to(torch.bool).contiguous()
    if frozen is not None:
        frozen = frozen.to(device=dev, dtype=torch.bool).expand(lead).contiguous()
    logp = torch.empty_like(logf)
    converged = torch.empty(lead, dtype=torch.bool, device=dev)
    if M > 0:
        sfx = "f32" if dtype == torch.float32 else "f64"
        lib, fn = _build.entry("cfc_solve", f"bild_cfc_solve_{sfx}", 6, 6, 1)
        group, threads, _ = solve_plan(M, n)
        rc = fn(logf.data_ptr(), logg.data_ptr(), tr.data_ptr(),
                None if frozen is None else frozen.data_ptr(), logp.data_ptr(),
                converged.data_ptr(), M, n, int(maxiter), group, threads,
                dev.index or 0, float(precision),
                torch.cuda.current_stream(dev).cuda_stream)
        solve_marginals.launches += 1
        _build.check(lib, rc, "cfc_solve launch")
    return logp, converged


counters.register("cfc_solve", solve_marginals, "launches")


def cfc_logp_from_marginals(log_marginals, transitions, maxiter=1000,
                            precision=1e-2, active=None, exact=False):
    """Weights reproducing the per-slot marginals ``(..., n, k+1)``.
    Returns ``(logp, converged (...))``; inactive slots get uniform
    weights and never count against convergence. ``exact`` as in
    `_solve_marginals` (`solve_marginals` runs the solve)."""
    n, k1 = log_marginals.shape[-2:]
    lead = log_marginals.shape[:-2]
    logp0 = log_marginals[..., :, 0]
    if k1 == 1:
        return logp0[..., None], torch.ones(lead, dtype=torch.bool,
                                            device=logp0.device)
    act = (torch.ones(k1 - 1, dtype=torch.bool, device=logp0.device)
           if active is None else active[..., 1:])
    logps, convs = solve_marginals(
        log_marginals[..., :, 1:].transpose(-1, -2),
        log_marginals[..., :, :-1].transpose(-1, -2), transitions,
        maxiter, precision, frozen=~act, exact=exact)
    logps = torch.where(act[..., None], logps,
                        torch.full_like(logps, -math.log(n)))
    convs = convs | ~act
    return (torch.cat([logp0[..., None], logps.transpose(-1, -2)], dim=-1),
            convs.all(dim=-1))


def cfc_estimate(thetas, log_weights, transitions, n, maxiter=1000,
                 precision=1e-2, active=None, exact=False):
    """Method of marginals: weighted marginals per slot of the traces
    ``thetas (..., M, k+1)`` with log-weights ``(..., M)``, then the
    weights that reproduce them. Returns ``(logp (..., n, k+1),
    converged (...))``; ``exact`` makes every log-sum-exp lane-exact."""
    indicators = thetas[..., None, :, :] == torch.arange(
        n, device=thetas.device)[:, None, None]              # (..., n, M, k+1)
    log_marginals = _masked_lse(log_weights[..., None, :, None], indicators,
                                dim=-2, exact=exact)         # (..., n, k+1)
    log_marginals = log_marginals - lane_logsumexp(log_marginals, dim=-2,
                                                   keepdim=True, exact=exact)
    if active is not None:
        # padded slots carry arbitrary thetas: give the solver uniform ones
        log_marginals = torch.where(
            active[..., None, :], log_marginals,
            torch.full_like(log_marginals, -math.log(n)))
    return cfc_logp_from_marginals(log_marginals, transitions, maxiter,
                                   precision, active=active, exact=exact)


def _solve_marginals_np(logf, logg, transitions, maxiter, precision):
    """Numpy twin of `_solve_marginals` for host-side setup work
    (`CFC.logp_uniform`)."""
    from scipy.special import logsumexp as sp_lse

    logf = np.asarray(logf, dtype=float)
    logg = np.asarray(logg, dtype=float)
    tr = np.asarray(transitions, dtype=bool)
    i_f0 = logf == -np.inf
    i_g0 = logg == -np.inf
    is_delta = np.any(logf == 0, axis=1) | np.any(logg == 0, axis=1)
    done = is_delta.copy()
    logp = logf.copy()
    for _ in range(maxiter):
        if done.all():
            break
        with np.errstate(divide="ignore", invalid="ignore"):
            log_norm = sp_lse(logp[:, None, :], b=tr[None], axis=2)
            log_norm = np.where(i_g0, 0.0, log_norm)
            logg_norm = logg - log_norm
            log_Sgp = sp_lse(logg_norm[:, :, None], b=tr[None], axis=1)
            log_Sgp = np.where(i_f0, 0.0, log_Sgp)
            lp = logf - log_Sgp
            lp = lp - sp_lse(lp, axis=1, keepdims=True)
            delta = np.where(i_f0, 0.0, np.abs(lp - logp))
        lp = np.where(done[:, None], logp, lp)
        done = done | (np.max(delta, axis=1) < precision)
        logp = lp
    logp = np.where(is_delta[:, None], logf, logp)
    return logp, done


class CFC:
    """
    Host side of the Conflict-Free Categorical distribution over state
    traces: exact counting and enumeration. ``transitions[i, j]`` says
    whether the switch ``i -> j`` is allowed.
    """

    def __init__(self, transitions):
        self.transitions = np.array(transitions, dtype=bool, copy=True)
        self.MOM_maxiter = 1000
        self.MOM_precision = 1e-2

    @property
    def n(self):
        return self.transitions.shape[0]

    # -- tensor wrappers: the functions above on this transition matrix,
    # placed on the device of their first argument
    def _tr(self, like):
        return torch.as_tensor(self.transitions, device=like.device)

    def _converged(self, result):
        logp, converged = result
        if not bool(torch.all(converged)):
            raise RuntimeError("Iteration did not converge")
        return logp

    def sample(self, logp, N=1, generator=None):
        """``(N, k+1)`` traces from CFC(logp), drawn from ``generator``
        (where bild_tpu takes a key)."""
        logp = torch.as_tensor(logp)
        return cfc_sample(generator, logp, self._tr(logp), N)

    def logpmf(self, logp, thetas):
        logp = torch.as_tensor(logp)
        return cfc_logpmf(logp, torch.as_tensor(thetas, device=logp.device),
                          self._tr(logp))

    def estimate(self, thetas, log_weights):
        """Method of marginals (`cfc_estimate`); raises if the fixed-point
        solve does not converge."""
        thetas = torch.as_tensor(thetas)
        return self._converged(cfc_estimate(
            thetas, torch.as_tensor(log_weights, device=thetas.device),
            self._tr(thetas), self.n, self.MOM_maxiter, self.MOM_precision))

    def logp_from_marginals(self, log_marginals):
        """Weights reproducing the per-slot marginals ``(n, k+1)``
        (reference ``bild/amis.py:307-334``); raises if a slot's solve
        does not converge, like `estimate`."""
        log_marginals = torch.as_tensor(log_marginals)
        return self._converged(cfc_logp_from_marginals(
            log_marginals, self._tr(log_marginals), self.MOM_maxiter,
            self.MOM_precision))

    def solve_marginals_single(self, logf, logg):
        """The fixed-point solve of one slot: weights ``(n,)`` from its
        marginal ``logf`` and the previous slot's ``logg``."""
        logf = torch.as_tensor(logf)
        logp, converged = solve_marginals(
            logf[None], torch.as_tensor(logg, device=logf.device)[None],
            self._tr(logf), self.MOM_maxiter, self.MOM_precision)
        return self._converged((logp[0], converged[0]))

    def _T_int(self):
        """Transition matrix as a python-int nested list."""
        return [[int(v) for v in row] for row in self.transitions]

    @staticmethod
    def _matmul_int(A, B):
        n = len(A)
        return [[sum(A[i][l] * B[l][j] for l in range(n)) for j in range(n)]
                for i in range(n)]

    def _matpow_int(self, p):
        n = self.n
        out = [[int(i == j) for j in range(n)] for i in range(n)]
        base = self._T_int()
        while p:
            if p & 1:
                out = self._matmul_int(out, base)
            base = self._matmul_int(base, base)
            p >>= 1
        return out

    def N_total(self, k, log=False):
        """Number of state traces with ``k`` switches (exact python int)."""
        P = self._matpow_int(k)
        N = sum(sum(row) for row in P)
        return math.log(N) if log else N

    def uniform_marginals(self, k):
        """Per-slot log-marginals ``(n, k+1)`` of the uniform distribution
        over all traces, by path counting in python ints."""
        n = self.n
        counts = np.empty((n, k + 1), dtype=object)
        for i in range(k + 1):
            Pin = self._matpow_int(i)
            Pout = self._matpow_int(k - i)
            col_in = [sum(Pin[a][s] for a in range(n)) for s in range(n)]
            row_out = [sum(Pout[s][b] for b in range(n)) for s in range(n)]
            for s in range(n):
                counts[s, i] = col_in[s] * row_out[s]

        def safe_log(x):
            return math.log(x) if x > 0 else -np.inf

        totals = [sum(counts[s, i] for s in range(n)) for i in range(k + 1)]
        return np.array([[safe_log(counts[s, i]) - safe_log(totals[i])
                          for i in range(k + 1)] for s in range(n)])

    def logp_uniform(self, k):
        """Weights ``(n, k+1)`` reproducing the uniform distribution."""
        return _logp_uniform(self.transitions.tobytes(), self.transitions.shape,
                             k, self.MOM_maxiter, self.MOM_precision)

    def full_sample(self, k, Nmax=1000):
        """All state traces with ``k`` switches, ``(N_total, k+1)`` ints in
        lexicographic order; raises `SampleSpaceTooLarge` above ``Nmax``."""
        N = self.N_total(k)
        if N > Nmax:
            raise SampleSpaceTooLarge(
                f"Full sample would be {N} > Nmax = {Nmax} traces")
        allowed = [np.nonzero(self.transitions[i])[0].tolist() for i in range(self.n)]
        rows = [[s] for s in range(self.n)]
        for _ in range(k):
            rows = [row + [nxt] for row in rows for nxt in allowed[row[-1]]]
        rows = [row for row in rows if len(row) == k + 1]
        return np.array(rows, dtype=int).reshape(len(rows), k + 1)


@functools.lru_cache(maxsize=512)
def _logp_uniform(tr_bytes, shape, k, maxiter, precision):
    """`CFC.logp_uniform`, cached: pure in (transitions, k)."""
    cfc = CFC(np.frombuffer(tr_bytes, dtype=bool).reshape(shape))
    lm = np.asarray(cfc.uniform_marginals(k))
    if k == 0:
        return lm[:, :1]
    logps, conv = _solve_marginals_np(lm[:, 1:].T, lm[:, :-1].T,
                                      cfc.transitions, maxiter, precision)
    if not bool(np.all(conv)):
        raise RuntimeError("Iteration did not converge")
    return np.concatenate([lm[:, :1], logps.T], axis=1)
