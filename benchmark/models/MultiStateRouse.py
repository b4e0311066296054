"""
The model kind ``MultiStateRouse``: what the benchmark needs of a
configuration whose ``model`` is ``"MultiStateRouse"`` (keys ``N``, ``D``,
``k``, ``d``, ``dt``, ``localization_error``, ``looppositions``, ``dtype``,
``matmul``).

A model kind is a file ``benchmark/models/<model>.py``, found by the
configuration's ``model``, with a class ``Kind(bt, cfg, device,
matmul=None)`` that gives the entries:

- ``model``: the program's model, built through ``bt`` from ``cfg``;
- ``n_states`` and ``d``;
- ``sizes``: the sizes that the traced record carries to the metric
  readers;
- ``trajectories(seed, truths)``: the traffic law, ``(B, T, d)`` float32
  data on the device, one trajectory per row of ``truths`` (``(B, T)``
  state profiles);
- ``trajectory(data)``: the program's ``Trajectory`` of one row of that
  data;
- ``reference``: an object whose ``logL(profiles, data, rows=None)`` gives
  float64 log-likelihoods; like everything under ``benchmark/reference/``
  it imports nothing of the program.

``matmul`` is the program's precision tier in place of the
configuration's (the control runs): here the Rouse likelihood's
``set_rouse_matmul``.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import kalman, rouse
from benchmark.traffic import generate


class Kind:
    """The multi-state Rouse model: the program's `MultiStateRouse`, the
    Rouse law of `generate.trajectories` on the reference's operators
    (``arrays``, `rouse.operators`), and the float64 Kalman likelihood
    (``ref_ops``, `kalman.Operators`) as the reference."""

    def __init__(self, bt, cfg, device, matmul=None):
        bt.config.set_rouse_matmul(matmul or cfg["matmul"])
        self.bt, self.device = bt, device
        self.d = int(cfg["d"])
        self.localization_error = float(cfg["localization_error"])
        loops = tuple(None if x is None else tuple(x) for x in cfg["looppositions"])
        self.n_states = len(loops)
        self.model = bt.models.MultiStateRouse(
            cfg["N"], cfg["D"], cfg["k"], d=self.d, looppositions=loops,
            localization_error=self.localization_error, dt=cfg["dt"],
            device=device, dtype=getattr(torch, cfg["dtype"]))
        self.arrays = rouse.operators(cfg["N"], cfg["D"], cfg["k"], self.d, cfg["dt"], loops)
        self.ref_ops = kalman.Operators(self.arrays, np.full(self.d, self.localization_error),
                                        device)
        self.reference = self.ref_ops
        self.sizes = {"n": self.n_states, "N": int(cfg["N"]), "d": self.d,
                      "q": int(self.ref_ops.s2.shape[0])}
        self._err = np.full(self.d, self.localization_error)
        self._valid = {}

    def trajectories(self, seed, truths):
        return generate.trajectories(seed, truths, self.arrays, self.localization_error,
                                     self.device)

    def trajectory(self, data):
        """Every frame observed; one mask per length, shared by the
        trajectories of that length."""
        T = data.shape[0]
        if T not in self._valid:
            self._valid[T] = torch.ones(T, dtype=torch.bool, device=data.device)
        return self.bt.Trajectory(data=data, valid=self._valid[T],
                                  localization_error=self._err)
