"""
Faults planted in the program underneath a run, to show that the check
catches them (``tests/test_harness_faults.py`` on the CPU,
``readings.py --fault`` on the card, where they give the upper readings
of the numbers the control does not move). One card: there is no
exchange between chips to leave out.

- ``unchanged_state``: every AMIS step returns its state unchanged.
- ``half_the_batch``: the likelihood scores the first half of each lane's
  profiles; the rest get the mean of those. The likelihood closures of
  every model class are wrapped, so the fault reaches any model kind.
- ``altered_answer``: in `sample()` the first profile of every step gains
  a nat of likelihood; in a dataset every climbed profile has its first
  boundary moved a frame, and the states of every lane's marginals are
  rolled by one.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["FAULTS", "plant"]

FAULTS = ("unchanged_state", "half_the_batch", "altered_answer")


def _half(fn, profiles, per):
    profiles = torch.as_tensor(profiles)
    half = max(1, profiles.shape[-2] // 2)
    out = fn(profiles[..., :half, :].contiguous(), per)
    rest = out.mean(dim=-1, keepdim=True).expand(*out.shape[:-1], profiles.shape[-2] - half)
    return torch.cat([out, rest], dim=-1)


def _plus_one(fn, profiles, per):
    out = fn(profiles, per).clone()
    out[..., 0] += 1.0
    return out


def _moved(climb):
    def moved(profiles, *args, **kw):
        states, elim = climb(profiles, *args, **kw)
        for row in states:
            b = (row[1:] != row[:-1]).nonzero()[0]
            if len(b) and b[0] > 0 and (len(b) == 1 or b[1] > b[0] + 1):
                row[b[0] + 1] = row[b[0]]
        return states, elim
    moved.evaluations = 0
    return moved


def _rolled(marginals):
    def rolled(*args, **kw):
        return marginals(*args, **kw).roll(1, dims=-2)
    return rolled


@contextlib.contextmanager
def plant(name):
    """Inside the block the program runs with fault ``name``."""
    from bild_tpu_torch import postproc
    from bild_tpu_torch.infer import adaptive
    from bild_tpu_torch.models.base import MultiStateModel
    from bild_tpu_torch.parallel import batch

    saved = []

    def patch(owner, attr, value):
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    def model_classes():
        found, todo = [], [MultiStateModel]
        while todo:
            cls = todo.pop()
            if cls not in found:
                found.append(cls)
                todo.extend(cls.__subclasses__())
        return found

    def wrap_likelihoods(change, names):
        for owner in model_classes():
            for attr in names:
                if attr not in vars(owner):
                    continue
                original, made = vars(owner)[attr], {}

                def hooked(self, *args, _original=original, _made=made, **kw):
                    data, fn = _original(self, *args, **kw)
                    if fn not in _made:      # one wrapper per closure: the graphs' key
                        _made[fn] = lambda profiles, per, _fn=fn: change(_fn, profiles, per)
                    return data, _made[fn]
                patch(owner, attr, hooked)

    if name == "unchanged_state":
        patch(batch, "lane_step", lambda *args, **kw: None)
        patch(adaptive, "slot_step", lambda *args, **kw: None)
    elif name == "half_the_batch":
        wrap_likelihoods(_half, ("lockstep_fns", "lockstep_fns_lane"))
    elif name == "altered_answer":
        wrap_likelihoods(_plus_one, ("lockstep_fns_lane",))
        patch(postproc, "optimize_boundary_batch", _moved(postproc.optimize_boundary_batch))
        for owner in (batch, adaptive):
            patch(owner, "_marginal_posterior", _rolled(owner._marginal_posterior))
    else:
        raise ValueError(f"no fault {name!r}; faults: {FAULTS}")
    try:
        yield
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)
