"""
The benchmark's one traffic generator: truths and trajectories from a seed,
made on the device in a few large calls. It reads a traffic file's sizes and
imports nothing of the program, so that a change to the program's own
generator cannot change the traffic.

Truths follow ``truth_profiles`` of ``bench_e2e_torch.py`` (itself
``bench_e2e.py``'s ``_truth_profiles``) at commit c0c4c56: per trajectory a
switch count uniform in ``0..max_switches``, that many distinct switch
frames uniform in ``1..T-1``, a first state uniform over the ``n`` states
and, at each switch, a state uniform over the others. The draws here are
vectorized on the device, so they are not that loop's draws.

Trajectories follow the multi-state Rouse generative model
(``MultiStateRouse.trajectories_from_loopingprofiles`` at the same commit),
computed in float64 from the reference's operators (`reference.rouse`): a
steady-state conformation of the first frame's state, evolved frame by
frame with the state-selected dynamics, measured end to end, plus Gaussian
localization noise. The data are handed out in float32, the configuration's
type, and both the program and the reference read those same values.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Exhausted", "substream", "truths", "trajectories", "switch_counts"]


class Exhausted(RuntimeError):
    """The window asked for more traffic than the traffic file made: the
    file's pool is too small for the run (not a failure of the program)."""


def substream(seed, *tags):
    """A 63-bit seed for the named part of a run (``"window"``,
    ``"warmup"``, ``"program"``, ...), from the run's ``--seed``: every
    part draws from a stream of its own."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF]
    for tag in tags:
        words.extend(tag.encode() if isinstance(tag, str) else [int(tag) & 0xFFFFFFFF])
    return int(np.random.SeedSequence(words).generate_state(2, np.uint64)[0]
               >> np.uint64(1))


def _generator(seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def truths(seed, B, T, n, max_switches, device):
    """``(B, T)`` long tensor of piecewise-constant state profiles."""
    g = _generator(seed, device)
    k = torch.randint(0, max_switches + 1, (B,), generator=g, device=device)
    keys = torch.rand((B, T - 1), generator=g, device=device)
    first = torch.topk(keys, min(max_switches, T - 1), dim=1, largest=False).indices
    take = torch.arange(first.shape[1], device=device)[None, :] < k[:, None]
    cut = torch.zeros((B, T), dtype=torch.bool, device=device)
    cut.scatter_(1, first + 1, take)
    step = torch.randint(1, max(n, 2), (B, T), generator=g, device=device)
    start = torch.randint(0, n, (B, 1), generator=g, device=device)
    return (start + torch.cumsum(torch.where(cut, step, 0), dim=1)) % n


def trajectories(seed, profiles, arrays, localization_error, device):
    """``(B, T, d)`` float32 data of one trajectory per row of ``profiles``
    (``(B, T)`` ints), drawn from the model's operators ``arrays``
    (`reference.rouse.operators`)."""
    g = _generator(seed, device)
    t = {k: torch.as_tensor(np.asarray(v), dtype=torch.float64, device=device)
         for k, v in arrays.items()}
    profiles = torch.as_tensor(profiles, device=device).long()
    B, T = profiles.shape
    N, d = t["Gs"].shape[1:]

    def normal(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64, device=device)

    s = profiles[:, 0]
    conf = t["M0s"][s] + t["L_sss"][s] @ normal(B, N, d)
    meas = [t["w"] @ conf]
    for i in range(1, T):
        s = profiles[:, i]
        conf = t["Bs"][s] @ conf + t["Gs"][s] + t["L_sigs"][s] @ normal(B, N, d)
        meas.append(t["w"] @ conf)
    data = torch.stack(meas, dim=1)
    err = torch.as_tensor(np.broadcast_to(localization_error, (d,)).copy(),
                          dtype=torch.float64, device=device)
    return (data + err * normal(B, T, d)).to(torch.float32)


def switch_counts(profiles):
    p = np.asarray(profiles)
    return np.sum(p[..., 1:] != p[..., :-1], axis=-1)
