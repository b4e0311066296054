"""
Looping profiles (counterpart of `bild_tpu.profiles`).

A looping profile is an integer state sequence; ``profile[t]`` is the model
state used to propagate *to* frame ``t``, and ``profile[0]`` selects the
steady-state ensemble the trajectory starts from.

- `Loopingprofile`: the host-side wrapper (numpy).
- `count_switches`, `st2profile`: tensor functions; `st2profile` takes
  any leading batch shape.
"""
from __future__ import annotations

import numpy as np
import torch

from .lanes import lane_cumsum

__all__ = [
    "Loopingprofile",
    "state_probabilities",
    "count_switches",
    "st2profile",
]


class Loopingprofile:
    """
    Host-side profile wrapper. Operators: ``len``, get/setitem (integer
    dtype enforced on set), ``==``, plus `copy`, `count_switches`,
    `intervals`, `plottable`.
    """

    def __init__(self, states=None):
        if states is None:
            self.state = np.array([], dtype=int)
        else:
            if isinstance(states, torch.Tensor):
                states = states.detach().cpu().numpy()
            self.state = np.asarray(states, dtype=int)

    def copy(self) -> "Loopingprofile":
        new = Loopingprofile()
        new.state = self.state.copy()
        return new

    def __len__(self):
        return len(self.state)

    def __getitem__(self, key):
        return self.state[key]

    def __setitem__(self, key, val):
        val = np.asarray(val)
        if not np.issubdtype(val.dtype, np.integer):
            raise TypeError("Loopingprofile states must be integers")
        self.state[key] = val

    def __eq__(self, other):
        try:
            if len(self) != len(other):
                return False
            return bool(np.all(self.state == np.asarray(other)))
        except TypeError:
            return False

    def __array__(self, dtype=None, copy=None):
        return self.state if dtype is None else self.state.astype(dtype)

    def __repr__(self):
        return f"Loopingprofile({self.state.tolist()})"

    def count_switches(self) -> int:
        return int(np.count_nonzero(self.state[1:] != self.state[:-1]))

    def _switch_frames(self) -> np.ndarray:
        """Indices of the first frame of each new interval (excluding 0)."""
        return np.flatnonzero(self.state[1:] != self.state[:-1]) + 1

    def intervals(self):
        """Constant-state intervals as ``(start, end, state)`` tuples;
        ``start``/``end`` are ``None`` for the first/last interval."""
        cuts = self._switch_frames().tolist()
        starts = [None, *cuts]
        ends = [*cuts, None]
        return [(a, b, int(self.state[0 if a is None else a]))
                for a, b in zip(starts, ends)]

    def plottable(self):
        """Step-function plotting coordinates; frame ``t`` is drawn over
        ``(t-1, t]`` (the state *propagates to* frame t)."""
        cuts = self._switch_frames()
        edges = np.concatenate(([0], cuts, [len(self.state)])) - 1
        t = np.repeat(edges, 2)[1:-1]
        y = np.repeat(self.state[np.concatenate(([0], cuts))], 2)
        return t, y


def state_probabilities(profiles, nStates=None) -> np.ndarray:
    """Marginal state probabilities ``(nStates, T)`` over an ensemble."""
    allstates = np.array([np.asarray(profile)[:] for profile in profiles])
    if nStates is None:
        nStates = int(np.max(allstates)) + 1
    counts = np.array(
        [np.count_nonzero(allstates == i, axis=0) for i in range(nStates)])
    return counts / allstates.shape[0]


def count_switches(states: torch.Tensor) -> torch.Tensor:
    """Number of switches along the last axis of an int state tensor."""
    return torch.count_nonzero(states[..., 1:] != states[..., :-1], dim=-1)


def st2profile(s: torch.Tensor, theta: torch.Tensor, T: int,
               active=None, exact=False) -> torch.Tensor:
    """
    Convert ``(s, θ)`` to discrete profiles: ``s, θ (..., k+1)`` ->
    ``(..., T)`` int32.

    Floor discretization as in `bild_tpu.profiles.st2profile`: switch
    positions ``cumsum(s)[:k]`` in [0, 1) map to frames
    ``floor(pos * (T-1)) + 1``, and frame ``t`` takes ``θ`` of the number of
    switches at or before it. ``active`` (bool, broadcastable to ``s``:
    ``(k+1,)``, or one mask per lane; padded-k mode) disables the switches
    into padded slots: the cumulative position at the end of the active
    slots is 1 only up to round-off, and ``1 - eps`` would floor to a
    spurious switch at the last frame. The positions are a `lane_cumsum`,
    lane-exact with ``exact`` (the lockstep runner).
    """
    theta = theta.to(torch.int32)
    k = s.shape[-1] - 1
    if k == 0:
        return theta[..., :1].expand(*theta.shape[:-1], T).clone()
    switchpos = lane_cumsum(s[..., :-1], exact=exact)                 # (..., k)
    switches = torch.floor(switchpos * (T - 1)).to(torch.int32) + 1
    t_idx = torch.arange(T, dtype=torch.int32, device=s.device)
    counts = switches[..., None, :] <= t_idx[:, None]                # (..., T, k)
    if active is not None:
        counts = counts & active[..., None, 1:]
    iv_idx = counts.sum(dim=-1)                                      # (..., T)
    return torch.gather(theta, -1, iv_idx).to(torch.int32)
