"""
Post-processing: greedy local optimization of profile boundaries
(counterpart of `bild_tpu.postproc`).

Each iteration scores ALL candidate boundary moves (2 per boundary) in one
batched likelihood call. `optimize_boundary_batch` climbs a whole
trajectory batch: a host loop whose every iteration scores every
still-active trajectory's candidates in ONE lane-batched likelihood call
(lanes = trajectories; on a GPU, one kernel launch), where `bild_tpu` runs a
vmapped ``while_loop``. Trajectories freeze as they converge.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops import counters
from .profiles import Loopingprofile

__all__ = ["logLR_boundaries", "optimize_boundary",
           "optimize_boundary_batch", "BoundaryEliminationError"]


class BoundaryEliminationError(Exception):
    pass


def _candidate_moves(states):
    """All single-boundary moves of a profile: ``(boundaries, candidates)``
    where ``candidates[i, 0]`` moves boundary ``i`` left and
    ``candidates[i, 1]`` right."""
    boundaries = np.nonzero(np.diff(states))[0]  # boundary between b and b+1
    cands = np.empty((len(boundaries), 2, len(states)), dtype=int)
    for i, b in enumerate(boundaries):
        left = states.copy()
        left[b] = states[b + 1]
        right = states.copy()
        right[b + 1] = states[b]
        cands[i, 0] = left
        cands[i, 1] = right
    return boundaries, cands


def _logLs(model, profiles, traj):
    return np.asarray(model.logL_batch(profiles, traj).cpu().numpy(),
                      dtype=float)


def logLR_boundaries(profile, traj, model):
    """``(k, 2)`` log-likelihood ratios for moving each boundary left/right,
    evaluated in one batch."""
    states = np.asarray(profile)[:]
    boundaries, cands = _candidate_moves(states)
    if len(boundaries) == 0:
        return np.array([])
    batch = np.concatenate([cands.reshape(-1, len(states)), states[None, :]])
    logLs = _logLs(model, batch, traj)
    return logLs[:-1].reshape(len(boundaries), 2) - logLs[-1]


def optimize_boundary_batch(profiles, batch, model, max_iteration=10000):
    """
    Greedy boundary hill climb for a whole trajectory batch: per iteration
    every active trajectory's candidate moves (2 per boundary, padded to
    the batch's most boundaries ``Kb``) and its current profile are scored
    by the model's lockstep likelihood in one call, the best positive move
    is taken, and trajectories freeze as they converge.

    Parameters: ``profiles (B, T)`` int states (e.g.
    ``BatchResults.best_profile()``), ``batch`` the matching
    `parallel.TrajectoryBatch`, ``model`` exposing ``lockstep_fns``.

    Returns ``(profiles (B, T), eliminated (B,))``. Per trajectory the
    semantics are those of `optimize_boundary`, except that where it raises
    `BoundaryEliminationError` the batch freezes that trajectory at its
    pre-elimination profile and flags it. Raises ``RuntimeError`` if any
    trajectory exceeds ``max_iteration``. The number of candidate profiles
    scored is added to ``optimize_boundary_batch.evaluations``.
    """
    states = np.array(profiles, dtype=int)
    B, T = states.shape
    nb = np.sum(states[:, 1:] != states[:, :-1], axis=1)           # (B,)
    Kb = int(np.max(nb, initial=0))
    elim = np.zeros(B, dtype=bool)
    if Kb == 0 or T < 2:
        return states, elim

    per_traj, logL_fn = model.lockstep_fns(batch)
    device = batch.data.device
    active = np.flatnonzero(nb > 0)
    for _ in range(max_iteration):
        if len(active) == 0:
            break
        cur = states[active]                                        # (A, T)
        A = len(active)
        # boundary positions, padded with the first one (masked below)
        pos = np.full((A, Kb), -1)
        for j, st in enumerate(cur):
            b = np.flatnonzero(st[1:] != st[:-1])
            pos[j, :len(b)] = b
        validb = pos >= 0
        pos = np.where(validb, pos, pos[:, :1])
        rows = np.arange(A)[:, None]
        lefts = np.repeat(cur[:, None, :], Kb, axis=1)
        lefts[rows, np.arange(Kb), pos] = cur[rows, pos + 1]
        rights = np.repeat(cur[:, None, :], Kb, axis=1)
        rights[rows, np.arange(Kb), pos + 1] = cur[rows, pos]
        cands = np.concatenate([lefts, rights, cur[:, None, :]], axis=1)

        lane_data = tuple(x[torch.as_tensor(active, device=device)]
                          for x in per_traj)
        lls = logL_fn(torch.as_tensor(cands, dtype=torch.int32,
                                      device=device), lane_data)
        optimize_boundary_batch.evaluations += cands.shape[0] * cands.shape[1]
        lls = lls.cpu().numpy().astype(float)                       # (A, 2Kb+1)
        gains = np.where(np.concatenate([validb, validb], axis=1),
                         lls[:, :-1] - lls[:, -1:], -np.inf)
        i = np.argmax(gains, axis=1)
        pos_gain = gains[np.arange(A), i] > 0
        winner = cands[np.arange(A), i]
        nb2 = np.sum(winner[:, 1:] != winner[:, :-1], axis=1)
        # a legal move shifts a boundary, never merges or drops one
        elim_now = pos_gain & (nb2 != nb[active])
        take = pos_gain & ~elim_now
        states[active[take]] = winner[take]
        elim[active[elim_now]] = True
        active = active[take]
    else:
        if len(active):
            raise RuntimeError(f"Exceeded max_iteration = {max_iteration}")
    return states, elim


counters.register("optimize_boundary_batch.evaluations", optimize_boundary_batch,
                  "evaluations")


def optimize_boundary(profile, traj, model, max_iteration=10000):
    """
    Greedy hill climb on boundary positions. Raises
    `BoundaryEliminationError` if the best move would change the number of
    boundaries (shrink an interval to nothing, usually a sign the sampling
    was too thin) and ``RuntimeError`` if ``max_iteration`` is exceeded.
    """
    states = np.asarray(profile)[:].copy()
    for _ in range(max_iteration):
        boundaries, cands = _candidate_moves(states)
        if len(boundaries) == 0:
            break

        batch = np.concatenate([cands.reshape(-1, len(states)), states[None, :]])
        logLs = _logLs(model, batch, traj)
        gain = logLs[:-1].reshape(len(boundaries), 2) - logLs[-1]

        i, j = np.unravel_index(np.argmax(gain), gain.shape)
        if gain[i, j] <= 0:
            break
        winner = cands[i, j]
        # a legal move shifts a boundary; it never merges or drops one
        if np.count_nonzero(np.diff(winner)) != len(boundaries):
            raise BoundaryEliminationError(
                f"best move would eliminate the boundary after frame {boundaries[i]}")
        states = winner
    else:
        raise RuntimeError(f"Exceeded max_iteration = {max_iteration}")

    return Loopingprofile(states)
