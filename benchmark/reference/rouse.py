"""
Plain multi-state Rouse physics in NumPy float64: the operators that the
benchmark's reference and its trajectory generator use.

A frozen copy of ``bild_tpu_torch/physics/rouse.py`` (``_build_laplacian``,
``rouse_arrays``) and of the operator stacking in
``bild_tpu_torch/models/msrouse.py`` (``MultiStateRouse.__init__``), both at
commit c0c4c56. It imports nothing of the program, so that a change there
cannot move what the benchmark calls right.

Per spatial dimension and state s, ``x_{t+1} = B_s x_t + G_s + eta``,
``eta ~ N(0, Sig_s)``, from the spectral decomposition of the connectivity
Laplacian (backbone plus the state's extra bonds); a trajectory starts in
the steady state ``(M_ss, C_ss)`` of its first frame's state and measures
``w . x`` (end to end: last monomer minus first) plus Gaussian noise of the
localization error.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["laplacian", "rouse_arrays", "operators", "n_traces", "log_prior"]

_FREE_MODE_TOL = 1e-10


def laplacian(N, extra_bonds):
    """Backbone bonds ``(i, i+1)`` of strength 1 plus ``extra_bonds``
    ``(left, right[, strength])``; negative indices count from the end."""
    A = np.zeros((N, N))
    bonds = [(i, i + 1, 1.0) for i in range(N - 1)]
    for bond in extra_bonds or ():
        if bond is None:
            continue
        l, r, strength = (*bond, 1.0) if len(bond) == 2 else bond
        l, r = int(l) % N, int(r) % N
        if l != r:
            bonds.append((l, r, float(strength)))
    for l, r, strength in bonds:
        A[l, l] += strength
        A[r, r] += strength
        A[l, r] -= strength
        A[r, l] -= strength
    return A


def rouse_arrays(N, D, k, d, dt, extra_bonds=None):
    """``B, Sig, C_ss, L_ss, L_sig (N, N)`` and ``G, M_ss (N, d)`` of one
    chain, float64."""
    lam, V = np.linalg.eigh(laplacian(N, extra_bonds))
    lam = np.clip(lam, 0.0, None)
    free = lam <= _FREE_MODE_TOL * max(1.0, float(lam[-1]))
    kl = k * lam
    with np.errstate(divide="ignore", invalid="ignore"):
        b = np.exp(-kl * dt)
        sig = np.where(free, 2.0 * D * dt, D / kl * (1.0 - np.exp(-2.0 * kl * dt)))
        css = np.where(free, 0.0, D / kl)

    def sandwich(diag):
        return (V * diag[None, :]) @ V.T

    return {"B": sandwich(b), "Sig": sandwich(sig), "C_ss": sandwich(css),
            "G": np.zeros((N, d)), "M_ss": np.zeros((N, d)),
            "L_ss": V * np.sqrt(css)[None, :], "L_sig": V * np.sqrt(sig)[None, :]}


def operators(N, D, k, d, dt, looppositions):
    """The stacked per-state operators of a multi-state Rouse model,
    float64: ``Bs, Sigs, C0s, L_sigs, L_sss (n, N, N)``, ``Gs, M0s (n, N,
    d)`` and the end-to-end measurement ``w (N,)``. ``looppositions``: one
    entry per state, ``None`` or a bond or a list of bonds."""
    per_state = []
    for loop in looppositions:
        if loop is not None and np.isscalar(loop[0]):
            loop = (tuple(loop),)
        per_state.append(rouse_arrays(N, D, k, d, dt, loop))
    w = np.zeros(N)
    w[0], w[-1] = -1.0, 1.0
    out = {name: np.stack([a[src] for a in per_state]) for name, src in (
        ("Bs", "B"), ("Gs", "G"), ("Sigs", "Sig"), ("M0s", "M_ss"),
        ("C0s", "C_ss"), ("L_sigs", "L_sig"), ("L_sss", "L_ss"))}
    out["w"] = w
    return out


def n_traces(n, k):
    """State traces of ``k`` switches between ``n`` states, none to itself."""
    return n * (n - 1) ** k


def log_prior(n, k):
    """The AMIS log prior of a ``k``-switch profile, ``log(k!) - log(traces)``
    (``FixedkSampler.logprior``)."""
    return math.lgamma(k + 1) - math.log(n_traces(n, k))
