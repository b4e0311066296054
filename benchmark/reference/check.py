"""
The comparisons that decide a run's ``correct``: the program's answers,
as plain arrays, judged against the float64 reference, the ``logL`` of the
configuration's model kind (``benchmark/models/<model>.py``; for
``MultiStateRouse`` `kalman.logL` on `rouse.operators`). Nothing here
imports the program; the entries (``benchmark/entries/``) read its results
into the dicts below.

Numbers, each the worst over what was checked (limits: the traffic file's
``check.limits``):

- ``logL_rel``: the likelihoods that the timed path scored (every defined
  sample of every judged sampler or lane, as the step left it) against
  the reference's of the same profiles, ``|l - r| / max(|r|, 1)``.
- ``answer_nats``: the answers in nats: each k's evidence against the
  reference's from the same samples and proposal masses, the chosen k
  against the margin rule on the reference's evidences, and how far each
  reported MAP profile falls below the best defined sample by the
  reference.
- ``marginal_gap``: a dataset row's state marginals of each k against the
  reference's from the same samples, the largest gap in probability.
- ``climb_nats``: a dataset row's climbed profile against every legal
  single-boundary move and against the MAP profile it started from (a
  greedy climb ends where no move gains).
- ``evidence_nats``: a dataset row's evidence at k = 0 against the exact
  one, the log-mean likelihood of the n constant profiles: the proposal
  masses, which the other numbers take from the program, checked whole.
"""
from __future__ import annotations

import itertools
import math

import numpy as np

from . import rouse

__all__ = ["st2profile_f32", "enumerate_profiles", "judge_sample", "dataset_profiles",
           "judge_dataset", "verdict"]


def _logmeanexp(x):
    x = np.asarray(x, dtype=np.float64)
    m = np.max(x)
    if not np.isfinite(m):
        return m
    return float(m + np.log(np.mean(np.exp(x - m))))


def _logsumexp(x):
    x = np.asarray(x, dtype=np.float64)
    x = x[~np.isnan(x)]
    m = np.max(x, initial=-np.inf)
    if not np.isfinite(m):
        return m
    return float(m + np.log(np.sum(np.exp(x - m))))


def st2profile_f32(ss, thetas, T, k):
    """Profiles ``(M, T)`` from interval fractions and state traces ``(M,
    K1)`` of which the first ``k + 1`` slots are active: the switch
    positions are a left-to-right float32 cumulative sum, frame ``floor(pos
    * (T - 1)) + 1`` starts the next interval (``profiles.st2profile`` in
    its lane-exact form, float32 bit for bit)."""
    ss = np.asarray(ss, dtype=np.float32)
    thetas = np.asarray(thetas, dtype=np.int64)
    M = ss.shape[0]
    if k == 0:
        return np.repeat(thetas[:, :1], T, axis=1)
    pos = np.empty((M, k), dtype=np.float32)
    acc = ss[:, 0].copy()
    pos[:, 0] = acc
    for i in range(1, k):
        acc = (acc + ss[:, i]).astype(np.float32)
        pos[:, i] = acc
    starts = np.floor(pos * np.float32(T - 1)).astype(np.int64) + 1      # (M, k)
    frame = np.arange(T)[None, :, None]
    interval = np.sum(starts[:, None, :] <= frame, axis=2)              # (M, T)
    return np.take_along_axis(thetas, interval, axis=1)


def enumerate_profiles(n, k, T):
    """Every profile of exactly ``k`` switches over ``n`` states with no
    switch to the same state, ``n (n-1)^k C(T-1, k)`` of them."""
    traces = [t for t in itertools.product(range(n), repeat=k + 1)
              if all(a != b for a, b in zip(t, t[1:]))]
    out = []
    for cuts in itertools.combinations(range(1, T), k):
        bounds = (0, *cuts, T)
        iv = np.repeat(np.arange(k + 1), np.diff(bounds))
        for t in traces:
            out.append(np.asarray(t)[iv])
    return np.asarray(out, dtype=np.int64).reshape(-1, T)


def _gap(prog, ref):
    """``|prog - ref|``, 0 where both are -inf (no evidence at all)."""
    prog, ref = float(prog), float(ref)
    if prog == ref == -np.inf:
        return 0.0
    gap = abs(prog - ref)
    return np.inf if np.isnan(gap) else gap


def _rel(prog, ref):
    prog, ref = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    if prog.size == 0:
        return 0.0
    gap = np.abs(prog - ref) / np.maximum(np.abs(ref), 1.0)
    return float(np.max(np.where(np.isnan(gap), np.inf, gap)))


def _sample_profiles(s, T, k):
    """The profiles ``(S N, T)`` of one sampler's samples ``ss, thetas (S,
    N, K1)``, and which of them are defined: a draw whose interval
    fractions are not finite (a gamma draw that underflowed) has no switch
    frame but what the device's float-to-int conversion makes of NaN, and
    the program gives it no weight."""
    S, N, K1 = s["ss"].shape
    ss = s["ss"].reshape(S * N, K1)
    return (st2profile_f32(ss, s["thetas"].reshape(S * N, K1), T, k),
            np.all(np.isfinite(ss[:, :k]), axis=1))


def _scored_rel(s, ref, defined):
    """`_rel` of a sampler's scored likelihoods over its defined draws; an
    undefined draw that the program weighs reads infinite."""
    weighed = ~np.isnan(s["logdeltas"].reshape(-1))
    if np.any(~defined & weighed):
        return np.inf
    return _rel(s["logLs"].reshape(-1)[defined], ref[defined])


def _evidence(ref, s, n, k):
    """The AMIS evidence of one sampler from the reference's likelihoods
    ``ref`` of its samples and the program's proposal masses."""
    N = s["ss"].shape[1]
    log_w = ref - s["logdeltas"].reshape(-1).astype(np.float64)
    return _logsumexp(log_w) - math.log(N) + rouse.log_prior(n, k)


def _choice_gap(ev_ref, kp, dE):
    """How far the chosen ``kp`` misses the margin rule (the smallest k
    within ``dE`` of the best evidence) on the evidences ``ev_ref`` ({k:
    nats})."""
    floor = max(ev_ref.values()) - dE
    return max(floor - ev_ref[kp],
               max((ev_ref[k] - floor for k in ev_ref if k < kp), default=0.0), 0.0)


def judge_sample(reference, calls, n, dE):
    """``{"logL_rel", "answer_nats"}`` over ``calls``, against
    ``reference.logL(profiles, data)``: each call a dict with
    ``data (T, d)``, ``best_k``, ``best_profile (T,)`` and ``samplers``, a
    list of dicts with ``k``, ``evidence`` and either ``exhaustive``
    (``profiles``, ``logLs``) or the AMIS state ``ss, thetas (S, N, K1)``,
    ``logLs, logdeltas (S, N)``."""
    worst_rel = worst_nats = 0.0
    for call in calls:
        data = call["data"]
        T = data.shape[0]
        ev_ref, best_scored = {}, {}
        for s in call["samplers"]:
            k = s["k"]
            if k >= T:
                ev_ref[k] = -np.inf
                continue
            if s["exhaustive"]:
                ref = reference.logL(s["profiles"], data)
                worst_rel = max(worst_rel, _rel(s["logLs"], ref))
                every = reference.logL(enumerate_profiles(n, k, T), data)
                ev_ref[k] = _logmeanexp(every)
                best_scored[k] = float(np.max(every))
            else:
                if s["ss"].shape[0] == 0:
                    ev_ref[k], best_scored[k] = -np.inf, -np.inf
                    worst_nats = max(worst_nats, _gap(s["evidence"], -np.inf))
                    continue
                profiles, defined = _sample_profiles(s, T, k)
                ref = reference.logL(profiles, data)
                worst_rel = max(worst_rel, _scored_rel(s, ref, defined))
                ev_ref[k] = _evidence(ref, s, n, k)
                best_scored[k] = float(np.max(ref[defined], initial=-np.inf))
            worst_nats = max(worst_nats, _gap(s["evidence"], ev_ref[k]))
        kp = call["best_k"]
        got = float(reference.logL(np.asarray(call["best_profile"])[None], data)[0])
        worst_nats = max(worst_nats, _choice_gap(ev_ref, kp, dE), best_scored[kp] - got)
    return {"logL_rel": worst_rel, "answer_nats": worst_nats}


def _marginals(profiles, log_w, n):
    """``(n, T)`` state probabilities of weighted samples (NaN weights count
    nothing; no finite weight gives all zeros, as the program's all -inf)."""
    lw = np.where(np.isnan(log_w), -np.inf, log_w)
    top = np.max(lw, initial=-np.inf)
    if not np.isfinite(top):
        return np.zeros((n, profiles.shape[1]))
    w = np.exp(lw - top)
    w /= w.sum()
    return np.stack([w @ (profiles == state) for state in range(n)])


def _moves(profile):
    """``(legal, eliminating)`` single-boundary moves of a profile: each
    boundary moved one frame left or right; a legal move keeps the switch
    count."""
    p = np.asarray(profile, dtype=np.int64)
    nb = np.count_nonzero(np.diff(p))
    legal, elim = [], []
    for b in np.flatnonzero(np.diff(p)):
        left, right = p.copy(), p.copy()
        left[b] = p[b + 1]
        right[b + 1] = p[b]
        for c in (left, right):
            (legal if np.count_nonzero(np.diff(c)) == nb else elim).append(c)
    return legal, elim


def dataset_profiles(row, n):
    """The profiles judged in a dataset row besides its samples, in order:
    the climbed profile, the MAP profile it started from, its legal moves,
    its eliminating moves, the MAP profile of every k, and the ``n``
    constant profiles (``(P, T)`` ints), with the counts ``(legal,
    eliminating, k's)``."""
    opt = np.asarray(row["optimized"], dtype=np.int64)
    legal, elim = _moves(opt)
    maps = np.asarray(row["profiles_by_k"], dtype=np.int64)
    start = maps[row["best_k"]]
    T = opt.shape[0]
    const = np.repeat(np.arange(n)[:, None], T, axis=1)
    every = np.concatenate([np.stack([opt, start, *legal, *elim]), maps, const])
    return every, (len(legal), len(elim), len(maps))


def judge_dataset(reference, rows, n, dE):
    """``{"logL_rel", "answer_nats", "marginal_gap", "climb_nats",
    "evidence_nats"}`` over dataset ``rows``, against
    ``reference.logL(profiles, data, rows=)``: each row a dict with ``data (T,
    d)``, ``evidence (K1,)``, ``best_k``, ``profiles_by_k (K1, T)``,
    ``optimized (T,)``, ``eliminated``, ``marginals (K1, n, T)`` (log) and
    ``samples``, ``{k: {ss, thetas (S, N, K1), logLs, logdeltas (S, N)}}``:
    each k's samples as the step left them, those its evidence, MAP
    profile and marginals were read from. The reference scores each row's
    distinct profiles once."""
    names = ("logL_rel", "answer_nats", "marginal_gap", "climb_nats", "evidence_nats")
    worst = dict.fromkeys(names, 0.0)
    if not rows:
        return worst
    T = rows[0]["data"].shape[0]
    plans, uniq, which = [], [], []
    for i, r in enumerate(rows):
        extra, counts = dataset_profiles(r, n)
        per_k = {k: _sample_profiles(s, T, k) for k, s in sorted(r["samples"].items())
                 if s["ss"].shape[0]}
        every = np.concatenate([extra, *(p for p, _ in per_k.values())])
        u, inv = np.unique(every, axis=0, return_inverse=True)
        plans.append((extra, counts, per_k, inv.reshape(-1)))
        uniq.append(u)
        which.append(np.full(len(u), i))
    data = np.stack([r["data"] for r in rows])
    ll_all = reference.logL(np.concatenate(uniq), data, rows=np.concatenate(which))
    lo = 0
    for r, u, (extra, (n_legal, n_elim, n_k), per_k, inv) in zip(rows, uniq, plans):
        ref = ll_all[lo:lo + len(u)][inv]
        lo += len(u)
        ll, at = ref[:len(extra)], len(extra)
        # the climb, from the climbed profile, its moves and the MAP it left
        here, from_map = ll[0], ll[1]
        gains = ll[2:2 + n_legal]
        elim = ll[2 + n_legal:2 + n_legal + n_elim]
        stay = max(here, np.max(elim, initial=-np.inf)) if r["eliminated"] else here
        worst["climb_nats"] = max(worst["climb_nats"], float(np.max(gains, initial=-np.inf))
                                  - stay, from_map - here)
        maps = ll[2 + n_legal + n_elim:2 + n_legal + n_elim + n_k]
        worst["evidence_nats"] = max(worst["evidence_nats"],
                                     _gap(r["evidence"][0], _logmeanexp(ll[len(ll) - n:])))
        # each k: the scored likelihoods, the evidence, the MAP, the marginals
        ev_ref = {}
        nats = 0.0
        for k in range(len(r["evidence"])):
            s = r["samples"].get(k)
            if k not in per_k:
                ev_ref[k] = -np.inf
                nats = max(nats, _gap(r["evidence"][k], -np.inf))
                if r["marginals"] is not None:
                    worst["marginal_gap"] = max(worst["marginal_gap"],
                                                float(np.max(np.exp(r["marginals"][k]))))
                continue
            profiles, defined = per_k[k]
            ref_k = ref[at:at + len(profiles)]
            at += len(profiles)
            worst["logL_rel"] = max(worst["logL_rel"], _scored_rel(s, ref_k, defined))
            ev_ref[k] = _evidence(ref_k, s, n, k)
            nats = max(nats, _gap(r["evidence"][k], ev_ref[k]),
                       float(np.max(ref_k[defined], initial=-np.inf)) - maps[k])
            if r["marginals"] is not None:
                log_w = ref_k - s["logdeltas"].reshape(-1).astype(np.float64)
                want = _marginals(profiles, log_w, n)
                worst["marginal_gap"] = max(worst["marginal_gap"], float(np.max(np.abs(
                    np.exp(r["marginals"][k]) - want))))
        nats = max(nats, _choice_gap(ev_ref, r["best_k"], dE))
        worst["answer_nats"] = max(worst["answer_nats"], nats)
    return worst


def verdict(numbers, limits):
    """``(correct, [[name, number, limit], ...])``: correct when every
    number is finite and at most its limit."""
    rows = [[name, float(numbers[name]), float(limits[name])] for name in sorted(limits)]
    ok = all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
