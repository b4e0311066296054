"""
The plain float64 Kalman likelihood of a multi-state Rouse model, in
PyTorch, batched over profiles: what the benchmark holds the program's
likelihoods, evidences and answers to.

A frozen copy of the recursion of ``bild_tpu_torch/ops/oracle.py``
(``msrouse_logL_numpy``, itself a transcription of bild's
``MSRouse_logL``) at commit c0c4c56, vectorized over a leading profile
axis: mean and covariance propagated through the state-selected dynamics
``M' = B_s M + G_s``, ``C' = B_s C B_s + Sig_s`` and updated at every
observed frame, with one covariance per distinct localization error.
Float64 throughout, on whatever device its inputs lie; it imports nothing
of the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["Operators", "logL"]

LOG_2PI = math.log(2.0 * math.pi)
BLOCK = 32768


class Operators:
    """A model's float64 operators (`rouse.operators`) and noise on one
    device: a model kind's ``reference`` (`logL`)."""

    def __init__(self, arrays, localization_error, device):
        self.device = torch.device(device)
        t = {k: torch.as_tensor(np.asarray(v), dtype=torch.float64, device=self.device)
             for k, v in arrays.items()}
        self.Bs, self.Gs, self.Sigs = t["Bs"], t["Gs"], t["Sigs"]
        self.M0s, self.C0s, self.w = t["M0s"], t["C0s"], t["w"]
        err = np.asarray(localization_error, dtype=np.float64)
        unique, cind = np.unique(err, return_inverse=True)
        self.s2 = torch.as_tensor(unique ** 2, dtype=torch.float64, device=self.device)
        self.cind = torch.as_tensor(cind.reshape(-1), dtype=torch.long, device=self.device)

    def logL(self, profiles, data, rows=None):
        """`logL` on these operators, every frame observed."""
        return logL(self, profiles, data, rows=rows)


def _block(ops, profiles, data, valid):
    P, T = profiles.shape
    q = ops.s2.shape[0]
    w, cind = ops.w, ops.cind
    M = ops.M0s[profiles[:, 0]].clone()                                # (P, N, d)
    C = ops.C0s[profiles[:, 0]][:, None].expand(-1, q, -1, -1).clone()  # (P, q, N, N)
    total = torch.zeros(P, dtype=torch.float64, device=ops.device)

    def update(M, C, x, obs):
        Cw = C @ w                                                     # (P, q, N)
        S = Cw @ w + ops.s2                                            # (P, q)
        K = Cw / S[..., None]
        C_new = C - K[..., :, None] * Cw[..., None, :]
        xmm = x - torch.einsum("n,pnd->pd", w, M)                      # (P, d)
        M_new = M + K[:, cind].transpose(1, 2) * xmm[:, None, :]
        Sd = S[:, cind]                                                # (P, d)
        ll = -0.5 * (xmm * xmm / Sd + torch.log(Sd) + LOG_2PI).sum(dim=1)
        keep = obs[:, None, None]
        return (torch.where(keep, M_new, M), torch.where(keep[..., None], C_new, C),
                torch.where(obs, ll, 0.0))

    M, C, ll = update(M, C, data[:, 0], valid[:, 0])
    total += ll
    for t in range(1, T):
        s = profiles[:, t]
        B = ops.Bs[s]
        M = B @ M + ops.Gs[s]
        C = B[:, None] @ C @ B[:, None] + ops.Sigs[s][:, None]
        M, C, ll = update(M, C, data[:, t], valid[:, t])
        total += ll
    return total


def logL(ops, profiles, data, valid=None, rows=None):
    """``(P,)`` float64 log-likelihoods of ``profiles (P, T)`` (ints) against
    ``data``: one trajectory ``(T, d)``, or ``(R, T, d)`` with ``rows (P,)``
    naming each profile's trajectory. ``valid`` (bool, the shape of
    ``data`` without ``d``) marks observed frames; all by default."""
    dev = ops.device
    profiles = torch.as_tensor(np.asarray(profiles), dtype=torch.long, device=dev)
    data = torch.as_tensor(data, device=dev).to(torch.float64)
    if valid is None:
        valid = torch.ones(data.shape[:-1], dtype=torch.bool, device=dev)
    valid = torch.as_tensor(valid, device=dev).to(torch.bool)
    if data.dim() == 2:
        data, valid = data[None], valid[None]
        rows = torch.zeros(profiles.shape[0], dtype=torch.long, device=dev)
    else:
        rows = torch.as_tensor(np.asarray(rows), dtype=torch.long, device=dev)
    out = []
    for lo in range(0, profiles.shape[0], BLOCK):
        r = rows[lo:lo + BLOCK]
        out.append(_block(ops, profiles[lo:lo + BLOCK], data[r], valid[r]))
    if not out:
        return np.zeros(0)
    return torch.cat(out).cpu().numpy()
