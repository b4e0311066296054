"""
Rouse polymer dynamics (counterpart of `bild_tpu.physics.rouse`).

Discrete-time linear-Gaussian dynamics per spatial dimension,

    x_{t+1} = B x_t + G + eta,   eta ~ N(0, Sig),

derived in closed form from the spectral decomposition of the connectivity
Laplacian ``A`` (backbone plus extra bonds). The eigendecomposition runs
once, on the host in numpy float64; the arrays are cast to the requested
dtype and device at the end. See the JAX module for the physics.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from scipy.special import erfc as _erfc

from ..config import DEFAULT_DEVICE, resolve_device

__all__ = ["RouseModel", "two_locus_msd"]

_FREE_MODE_TOL = 1e-10


def _build_laplacian(N: int, extra_bonds) -> np.ndarray:
    """
    Connectivity Laplacian: backbone bonds ``(i, i+1)`` with strength 1 plus
    ``extra_bonds`` as ``(left, right[, rel_strength])`` tuples. A negative
    strength removes connectivity; negative monomer indices count from the
    chain end, so ``(0, -1)`` is an end-to-end bond.
    """
    A = np.zeros((N, N), dtype=np.float64)
    bonds = [(i, i + 1, 1.0) for i in range(N - 1)]
    if extra_bonds is not None:
        for bond in extra_bonds:
            if bond is None:
                continue
            if len(bond) == 2:
                l, r = bond
                strength = 1.0
            else:
                l, r, strength = bond
            l = int(l) % N
            r = int(r) % N
            if l == r:
                continue  # vacuous bond, e.g. (0, 0) for "no loop"
            bonds.append((l, r, float(strength)))
    for l, r, strength in bonds:
        A[l, l] += strength
        A[r, r] += strength
        A[l, r] -= strength
        A[r, l] -= strength
    return A


def rouse_arrays(N, D, k, d, dt, add_bonds=None) -> dict:
    """numpy float64 dynamics of one Rouse chain: ``B, Sig, C_ss, L_ss,
    L_sig (N, N)`` and ``G, M_ss (N, d)``."""
    A = _build_laplacian(N, add_bonds)
    lam, V = np.linalg.eigh(A)
    lam = np.clip(lam, 0.0, None)
    free = lam <= _FREE_MODE_TOL * max(1.0, float(lam[-1]))
    kl = k * lam

    with np.errstate(divide="ignore", invalid="ignore"):
        b = np.exp(-kl * dt)
        sig = np.where(free, 2.0 * D * dt,
                       D / kl * (1.0 - np.exp(-2.0 * kl * dt)))
        css = np.where(free, 0.0, D / kl)

    def _sandwich(diag):
        return (V * diag[None, :]) @ V.T

    return {
        "B": _sandwich(b),
        "Sig": _sandwich(sig),
        "C_ss": _sandwich(css),
        "G": np.zeros((N, d)),
        "M_ss": np.zeros((N, d)),
        "L_ss": V * np.sqrt(css)[None, :],
        "L_sig": V * np.sqrt(sig)[None, :],
    }


@dataclasses.dataclass(frozen=True)
class RouseModel:
    """
    An N-monomer Rouse chain with optional extra bonds: ``D`` is the free
    monomer 1d diffusion constant, ``k`` the backbone spring constant, ``d``
    the spatial dimension, ``dt`` the frame interval.

    Tensors (``dtype`` on ``device``, the GPU unless ``device="cpu"``):
    ``B, Sig, C_ss, L_ss, L_sig (N, N)``,
    ``G, M_ss (N, d)``. ``host`` holds the same arrays in numpy float64.
    """

    N: int
    D: float
    k: float
    d: int
    dt: float
    add_bonds: Optional[Tuple] = None
    device: torch.device | str = DEFAULT_DEVICE
    dtype: torch.dtype = torch.float32

    host: dict = dataclasses.field(init=False, repr=False)
    B: torch.Tensor = dataclasses.field(init=False, repr=False)
    G: torch.Tensor = dataclasses.field(init=False, repr=False)
    Sig: torch.Tensor = dataclasses.field(init=False, repr=False)
    C_ss: torch.Tensor = dataclasses.field(init=False, repr=False)
    M_ss: torch.Tensor = dataclasses.field(init=False, repr=False)
    L_ss: torch.Tensor = dataclasses.field(init=False, repr=False)
    L_sig: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))
        host = rouse_arrays(self.N, self.D, self.k, self.d, self.dt,
                            self.add_bonds)
        object.__setattr__(self, "host", host)
        for name, arr in host.items():
            object.__setattr__(self, name, torch.as_tensor(
                arr, dtype=self.dtype, device=self.device))

    def check_dynamics(self):
        """The dynamics are computed at construction; kept for the
        reference API (``rouse.Model.check_dynamics``)."""
        return True

    def steady_state(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(M, C)``: steady-state mean ``(N, d)`` and covariance ``(N, N)``."""
        return self.M_ss, self.C_ss

    def propagate_M(self, M: torch.Tensor) -> torch.Tensor:
        return self.B @ M + self.G

    def propagate_C(self, C: torch.Tensor) -> torch.Tensor:
        return self.B @ C @ self.B + self.Sig

    def _normal(self, generator):
        return torch.randn((self.N, self.d), generator=generator,
                           dtype=self.dtype, device=self.device)

    def conf_ss(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Sample an ``(N, d)`` steady-state conformation."""
        return self.M_ss + self.L_ss @ self._normal(generator)

    def evolve(self, conf: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """One discrete-time step from conformation ``conf`` (``(N, d)``)."""
        return self.propagate_M(conf) + self.L_sig @ self._normal(generator)


def two_locus_msd(dt, G=1.0, J=1.0):
    """
    Analytic MSD of the separation of two loci on an infinite Rouse chain:
    ``G sqrt(t) (1 - exp(-u^2)) + 2 J erfc(u)``, ``u = 2 J / (G sqrt(pi t))``.
    """
    dt = np.abs(np.asarray(dt, dtype=float))
    scalar = dt.ndim == 0
    dt = np.atleast_1d(dt)
    out = np.zeros_like(dt)
    out[np.isinf(dt)] = 2.0 * J  # plateau
    pos = (dt > 0) & np.isfinite(dt)
    t = dt[pos]
    with np.errstate(over="ignore", under="ignore"):
        u = 2.0 * J / (G * np.sqrt(np.pi * t))
        out[pos] = G * np.sqrt(t) * (1.0 - np.exp(-u * u)) + 2.0 * J * _erfc(u)
    return out[0] if scalar else out
