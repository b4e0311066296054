"""
Optimal k-switch segmentation under a per-frame state-score table (a copy
of `bild_tpu.infer.segment`: host numpy, no framework).

Given ``table[s, t]`` (e.g. the factorized per-frame log-likelihoods, the
same quantity behind the reference's frame-wise MLE guess,
``bild/models.py:453-481``), find the profile with EXACTLY ``k`` switches
(respecting the allowed-transition mask) maximizing ``sum_t table[profile[t], t]``.

Dynamic program over (switch count j, frame t, state s) with prefix sums and
a running max, O(k * T * n^2) — cheap host work even at T ~ 1e5. Used to
seed AMIS proposals at each k (`FixedkSampler(informed_init=True)`): the
uniform initial proposal struggles to find fine-grained switch positions at
long T (see DESIGN.md section 7); this segmentation is the natural informed
starting point, and the AMIS deterministic-mixture weighting keeps the
evidence estimate consistent regardless of the initial proposal.
"""
from __future__ import annotations

import numpy as np

__all__ = ["dp_segment", "dp_segment_all", "dp_segment_all_batch",
           "profile_to_st", "profiles_to_st_batch"]

# Sentinel for -inf / NaN score entries. Must be large enough that such a
# frame-state is never chosen when alternatives exist, yet small enough that
# prefix sums over T of it keep unit-scale score differences exactly
# representable in float64 (raw -inf through nan_to_num would catastrophically
# cancel in the prefix-sum subtraction and silently zero out ALL scores).
_SCORE_FLOOR = -1e6


def profile_to_st(profile):
    """Decompose an int profile into ``(interval_fractions, states)`` —
    the (s, theta) parameters whose `st2profile` image is the profile."""
    profile = np.asarray(profile, dtype=int)
    T = len(profile)
    bounds = np.concatenate([[0], np.nonzero(np.diff(profile))[0] + 1, [T]])
    return np.diff(bounds) / T, profile[bounds[:-1]]


def profiles_to_st_batch(profiles, k):
    """
    Vectorized `profile_to_st` for a ``(B, T)`` batch of profiles that each
    have EXACTLY ``k`` switches (the fixed-k output of
    `dp_segment_all_batch`). Returns ``(fracs (B, k+1), theta (B, k+1))``.
    """
    profiles = np.asarray(profiles, dtype=int)
    B, T = profiles.shape
    is_switch = profiles[:, 1:] != profiles[:, :-1]
    assert np.all(np.sum(is_switch, axis=1) == k), \
        "every profile must have exactly k switches"
    cuts = (np.nonzero(is_switch)[1] + 1).reshape(B, k)
    bounds = np.concatenate(
        [np.zeros((B, 1), int), cuts, np.full((B, 1), T)], axis=1)
    return (np.diff(bounds, axis=1) / T,
            np.take_along_axis(profiles, bounds[:, :-1], axis=1))


def dp_segment(table, k, transitions=None):
    """
    Parameters
    ----------
    table : (n, T) float
        per-frame, per-state scores (higher = better); NaN treated as 0
        (missing frames score equally under every state); -inf clamped to a
        finite floor (never chosen when alternatives exist)
    k : int
        exact number of switches in the output profile
    transitions : (n, n) bool or None
        allowed transitions; default all-but-self

    Returns
    -------
    profile : (T,) int, or None if no k-switch profile exists (e.g. k >= T
        or the transition graph forbids it)
    score : float
    """
    profiles, scores = dp_segment_all(table, k, transitions)
    return profiles[k], scores[k]


def dp_segment_all(table, k_max, transitions=None):
    """
    Optimal segmentations for EVERY switch count ``k in 0..k_max`` from one
    DP sweep (layer j's state is exactly layer j+1's input, so all k share
    the forward pass; only backtracking is per k).

    Returns ``(profiles, scores)``: lists of length ``k_max + 1`` with
    ``profiles[k]`` an int array or None (infeasible k), ``scores[k]`` float.
    """
    table = np.nan_to_num(np.asarray(table, dtype=float),
                          nan=0.0, posinf=-_SCORE_FLOOR, neginf=_SCORE_FLOOR)
    table = np.clip(table, _SCORE_FLOOR, -_SCORE_FLOOR)
    n, T = table.shape
    if transitions is None:
        transitions = ~np.eye(n, dtype=bool)
    transitions = np.asarray(transitions, dtype=bool)

    # prefix[s, t] = sum of table[s, :t]
    prefix = np.concatenate([np.zeros((n, 1)), np.cumsum(table, axis=1)], axis=1)

    NEG = -np.inf
    # D[t, s] = best score of frames [0, t] (inclusive) ending in state s
    # with exactly j switches, where the last switch is anywhere <= t.
    # Layer j=0: single segment.
    D = prefix[:, 1:].T.copy()                      # (T, s): prefix[s, t+1]
    parent = []                                     # per layer: (T, s) switch frame
    finals = [D[T - 1].copy()]                      # per layer: final-frame row

    for j in range(1, k_max + 1):
        # best previous-layer value at switch position t' (profile switches
        # INTO s at frame t'+1): cand[t', s] = max_{s' -> s} D_prev[t', s']
        # minus the new state's prefix at the switch.
        Dp = np.where(np.isfinite(D), D, NEG)       # (T, s')
        # max over allowed predecessors for each target state
        cand = np.full((T, n), NEG)
        arg_sprev = np.zeros((T, n), dtype=int)
        for s in range(n):
            allowed = transitions[:, s]
            if not np.any(allowed):
                continue
            vals = np.where(allowed[None, :], Dp, NEG)   # (T, s')
            arg_sprev[:, s] = np.argmax(vals, axis=1)
            cand[:, s] = vals[np.arange(T), arg_sprev[:, s]]
        # subtract prefix of the new state up to the switch: score of the new
        # segment (t'+1 .. t) = prefix[s, t+1] - prefix[s, t'+1]
        adj = cand - prefix[:, 1:].T                 # (t', s)
        # running max over t' < t
        run = np.maximum.accumulate(adj[:-1], axis=0)            # (T-1, s)
        argrun = np.zeros((T - 1, n), dtype=int)
        for s in range(n):
            better = np.concatenate([[True], adj[1:-1, s] > run[:-1, s]])
            argrun[:, s] = np.where(better, np.arange(T - 1), 0)
            argrun[:, s] = np.maximum.accumulate(argrun[:, s])
        D_new = np.full((T, n), NEG)
        D_new[1:] = run + prefix[:, 2:].T            # score at frame t = run[t-1] + prefix[s, t+1]
        parent.append((argrun, arg_sprev))
        finals.append(D_new[T - 1].copy())
        D = D_new

    profiles, scores = [], []
    for k in range(k_max + 1):
        if k >= T or not np.any(np.isfinite(finals[k])):
            profiles.append(None)
            scores.append(-np.inf)
            continue
        s_best = int(np.argmax(finals[k]))
        scores.append(float(finals[k][s_best]))

        profile = np.empty(T, dtype=int)
        t, s = T - 1, s_best
        for j in range(k, 0, -1):
            argrun, arg_sprev = parent[j - 1]
            t_switch = int(argrun[t - 1, s])         # last switch position t'
            profile[t_switch + 1 : t + 1] = s
            s = int(arg_sprev[t_switch, s])
            t = t_switch
        profile[: t + 1] = s
        profiles.append(profile)
    return profiles, scores


def dp_segment_all_batch(tables, k_max, transitions=None):
    """
    `dp_segment_all` vectorized over a batch of score tables — the
    dataset-mode informed-init path (a serial per-trajectory sweep would put
    minutes of single-thread host work in front of the TPU at B ~ 10k).

    Parameters
    ----------
    tables : (B, n, T) float
    k_max : int
    transitions : (n, n) bool or None

    Returns
    -------
    profiles : (k_max+1, B, T) int
        optimal exactly-k-switch profile per (k, trajectory); rows where
        ``feasible`` is False are filler (all zeros)
    feasible : (k_max+1, B) bool
    """
    tables = np.nan_to_num(np.asarray(tables, dtype=float),
                           nan=0.0, posinf=-_SCORE_FLOOR, neginf=_SCORE_FLOOR)
    tables = np.clip(tables, _SCORE_FLOOR, -_SCORE_FLOOR)
    B, n, T = tables.shape
    if transitions is None:
        transitions = ~np.eye(n, dtype=bool)
    transitions = np.asarray(transitions, dtype=bool)

    prefix = np.concatenate(
        [np.zeros((B, n, 1)), np.cumsum(tables, axis=2)], axis=2)  # (B, n, T+1)
    prefix_t = np.swapaxes(prefix[:, :, 1:], 1, 2)                 # (B, T, n)

    NEG = -np.inf
    D = prefix_t.copy()                      # (B, T, s): layer j=0
    parents = []                             # per layer: (argrun, arg_sprev)
    finals = [D[:, T - 1].copy()]            # per layer: (B, n)

    tgrid = np.arange(T - 1)
    for _ in range(1, k_max + 1):
        Dp = np.where(np.isfinite(D), D, NEG)                      # (B, T, s')
        # best allowed predecessor per target state, all states at once:
        # vals[b, t, s', s] = Dp[b, t, s'] masked by transitions[s', s]
        vals = np.where(transitions[None, None, :, :],
                        Dp[:, :, :, None], NEG)                    # (B, T, s', s)
        arg_sprev = np.argmax(vals, axis=2)                        # (B, T, s)
        cand = np.take_along_axis(vals, arg_sprev[:, :, None, :],
                                  axis=2)[:, :, 0, :]              # (B, T, s)
        adj = cand - prefix_t                                      # (B, t', s)
        run = np.maximum.accumulate(adj[:, :-1], axis=1)           # (B, T-1, s)
        better = np.concatenate(
            [np.ones((B, 1, n), bool), adj[:, 1:-1] > run[:, :-1]], axis=1)
        argrun = np.where(better, tgrid[None, :, None], 0)
        argrun = np.maximum.accumulate(argrun, axis=1)             # (B, T-1, s)

        D = np.full((B, T, n), NEG)
        D[:, 1:] = run + np.swapaxes(prefix[:, :, 2:], 1, 2)
        parents.append((argrun, arg_sprev))
        finals.append(D[:, T - 1].copy())

    profiles = np.zeros((k_max + 1, B, T), dtype=int)
    feasible = np.zeros((k_max + 1, B), dtype=bool)
    frames = np.arange(T)
    brange = np.arange(B)
    for k in range(k_max + 1):
        ok = np.any(np.isfinite(finals[k]), axis=1) & (k < T)      # (B,)
        feasible[k] = ok
        if not np.any(ok):
            continue
        with np.errstate(invalid="ignore"):
            s = np.argmax(np.where(np.isfinite(finals[k]), finals[k], NEG),
                          axis=1)                                  # (B,)
        t = np.full(B, T - 1)
        prof = profiles[k]
        for j in range(k, 0, -1):
            argrun, arg_sprev = parents[j - 1]
            t_switch = argrun[brange, np.maximum(t - 1, 0), s]     # (B,)
            seg = (frames[None, :] >= (t_switch + 1)[:, None]) \
                & (frames[None, :] <= t[:, None])
            prof[:] = np.where(seg & ok[:, None], s[:, None], prof)
            s = np.where(ok, arg_sprev[brange, t_switch, s], s)
            t = t_switch
        head = frames[None, :] <= t[:, None]
        prof[:] = np.where(head & ok[:, None], s[:, None], prof)
    return profiles, feasible
