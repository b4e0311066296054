"""
Multi-state Rouse model (counterpart of `bild_tpu.models.msrouse`), built on
`physics.rouse.RouseModel` and the batched Kalman likelihoods of `ops`.

The model's "weights" are the per-state Rouse operators, computed in numpy
float64 and held as tensors of one dtype on one device. `from_arrays`
builds a model from given operators, so that this package and `bild_tpu`
can compute the same function in the tests.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ..config import DEFAULT_DEVICE, resolve_device, rouse_kernel
from ..ops.kalman import msrouse_logL_batch
from ..ops.kalman_dense import msrouse_logL_dense
from ..ops.kalman_sym import SymOperators, msrouse_logL_sym
from ..physics.rouse import RouseModel
from ..profiles import Loopingprofile
from ..trajectory import Trajectory
from .base import MultiStateModel

__all__ = ["MultiStateRouse"]

_ARRAYS = ("Bs", "Gs", "Sigs", "M0s", "C0s", "L_sigs", "L_sss", "w")


def _psd_factor(C):
    """``L`` with ``L @ L.T = C`` for a PSD ``C`` with null modes (the
    steady state pins free modes to zero variance, so no Cholesky)."""
    lam, V = np.linalg.eigh(C)
    return V * np.sqrt(np.clip(lam, 0.0, None))[None, :]


class MultiStateRouse(MultiStateModel):
    """
    Switch between per-state Rouse dynamics along the trajectory.

    Parameters (as `bild_tpu.models.MultiStateRouse`)
    ----------
    N : int                 number of monomers
    D, k : float            free-monomer diffusion constant, backbone spring
    d : int                 spatial dimension
    looppositions : sequence
        one entry per state: ``None`` (no extra bond), a ``(left, right[,
        rel_strength])`` tuple, or a list of such tuples.
    measurement : "end2end" or (N,) array
        measured linear combination of monomers; "end2end" = last - first.
    localization_error : None, float, or (d,) array
        model-side noise; if ``None``, use ``traj.localization_error``.
    dt : float              frame interval
    device, dtype           where and in which float type the tensors live
                            (the GPU unless ``device="cpu"``)
    """

    def __init__(self, N, D, k, d=3,
                 looppositions=(None, (0, -1)),
                 measurement="end2end",
                 localization_error=None,
                 dt=1.0, *, device=DEFAULT_DEVICE, dtype=torch.float32):
        if isinstance(measurement, str) and measurement == "end2end":
            measurement = np.zeros(N)
            measurement[0] = -1
            measurement[-1] = 1
        measurement = np.asarray(measurement, dtype=float)
        if measurement.shape != (N,):
            raise ValueError(f"measurement should have shape ({N},)")

        models = []
        for loop in looppositions:
            if loop is not None and np.isscalar(loop[0]):
                loop = (tuple(loop),)
            elif loop is not None:
                loop = tuple(tuple(b) for b in loop)
            models.append(RouseModel(N=N, D=D, k=k, d=d, dt=dt, add_bonds=loop,
                                     device=device, dtype=dtype))
        host = {
            "Bs": np.stack([m.host["B"] for m in models]),
            "Gs": np.stack([m.host["G"] for m in models]),
            "Sigs": np.stack([m.host["Sig"] for m in models]),
            "M0s": np.stack([m.host["M_ss"] for m in models]),
            "C0s": np.stack([m.host["C_ss"] for m in models]),
            "L_sigs": np.stack([m.host["L_sig"] for m in models]),
            "L_sss": np.stack([m.host["L_ss"] for m in models]),
            "w": measurement,
        }
        self._setup(host, d, localization_error, ~np.eye(len(models), dtype=bool),
                    device, dtype)
        self.models = models

    @classmethod
    def from_arrays(cls, Bs, Gs, Sigs, M0s, C0s, L_sigs, w,
                    localization_error, transitions, *, device=DEFAULT_DEVICE,
                    dtype=torch.float32) -> "MultiStateRouse":
        """A model with the given per-state operators (numpy arrays, e.g.
        those of a `bild_tpu` model): ``Bs, Sigs, C0s, L_sigs (n, N, N)``,
        ``Gs, M0s (n, N, d)``, ``w (N,)``. The steady-state sampling factor
        is derived from ``C0s``."""
        self = cls.__new__(cls)
        host = {k: np.array(v, dtype=np.float64) for k, v in dict(
            Bs=Bs, Gs=Gs, Sigs=Sigs, M0s=M0s, C0s=C0s, L_sigs=L_sigs,
            w=w).items()}
        host["L_sss"] = np.stack([_psd_factor(C) for C in host["C0s"]])
        self._setup(host, host["Gs"].shape[2], localization_error,
                    np.asarray(transitions, dtype=bool), device, dtype)
        self.models = None
        return self

    def _setup(self, host, d, localization_error, transitions, device, dtype):
        self._d = d
        self.device = resolve_device(device)
        self.dtype = dtype
        if localization_error is not None:
            if np.isscalar(localization_error):
                localization_error = localization_error * np.ones(d)
            localization_error = np.asarray(localization_error, dtype=float)
            if localization_error.shape != (d,):
                raise ValueError(
                    f"localization_error should be scalar or shape ({d},); "
                    f"got shape {localization_error.shape}")
        self.localization_error = localization_error
        self.transitions = transitions
        self.measurement = host["w"]
        self.host = host
        for name in _ARRAYS:
            setattr(self, name, torch.as_tensor(host[name], dtype=dtype,
                                                device=self.device))
        self._sym_ops = None
        self._single_fns = {}
        self._lockstep_fns = {}
        self._factorized = None

    @property
    def d(self):
        return self._d

    def _fingerprint_parts(self):
        # the per-state dynamics, the measurement vector and the model
        # noise determine the Kalman likelihood; localization_error=None
        # (per-trajectory noise) is a distinct configuration: a sentinel
        err = (np.asarray([-1.0]) if self.localization_error is None
               else self.localization_error)
        h = self.host
        return [[self._d], err, h["w"], h["Bs"], h["Gs"], h["Sigs"],
                h["M0s"], h["C0s"]]

    def sym_operators(self) -> SymOperators:
        """The packed-kernel operators, built once from the float64 arrays."""
        if self._sym_ops is None:
            h = self.host
            self._sym_ops = SymOperators.build(
                h["Bs"], h["Gs"], h["Sigs"], h["M0s"], h["C0s"], h["w"],
                device=self.device, dtype=self.dtype)
        return self._sym_ops

    def _kernel(self):
        """The likelihood this model runs: the plain recursion for CPU
        tensors, the selected kernel (`config.rouse_kernel`) for CUDA."""
        name = rouse_kernel()
        if self.device.type == "cpu" or name == "torch":
            return msrouse_logL_batch
        if name == "dense":
            return msrouse_logL_dense
        return functools.partial(msrouse_logL_sym, ops=self.sym_operators())

    # -- noise handling --------------------------------------------------------
    def _get_noise(self, traj) -> np.ndarray:
        if self.localization_error is not None:
            return np.asarray(self.localization_error)
        if getattr(traj, "localization_error", None) is not None:
            err = np.asarray(traj.localization_error)
            if err.ndim == 0:
                err = err * np.ones(self.d)
            return err
        raise ValueError(
            "No localization error specified (use model.localization_error "
            "or Trajectory.localization_error)")

    def _noise_arrays(self, traj):
        """``(s2 (q,) tensor, Cind (d,) int32 tensor)``: the distinct squared
        localization errors and each dimension's index among them."""
        unique, Cind = np.unique(self._get_noise(traj), return_inverse=True)
        return (torch.as_tensor(unique**2, dtype=self.dtype, device=self.device),
                torch.as_tensor(Cind.astype(np.int32), device=self.device))

    # -- likelihood ------------------------------------------------------------
    def logL(self, profile, traj) -> float:
        """Likelihood of one profile, via the batched kernel."""
        profile = torch.as_tensor(np.asarray(profile), dtype=torch.int32)
        return float(self.logL_batch(profile[None, :], traj)[0])

    def logL_batch(self, profiles, traj) -> torch.Tensor:
        """
        ``(P,)`` log-likelihoods for a ``(P, T)`` profile batch. States must
        lie in ``[0, nStates)``; out-of-range states give NaN.
        """
        _, fn = self.lockstep_fns_single(traj)
        return fn(profiles, (traj.data, traj.valid))

    def lockstep_fns_single(self, traj):
        """``(per_traj, logL_fn)`` for the AMIS loop: ``logL_fn(profiles,
        per_traj)`` with ``per_traj = (data, valid)``. The noise tensors are
        made once per noise configuration and kernel selection."""
        key = (tuple(self._get_noise(traj).tolist()), rouse_kernel())
        if key not in self._single_fns:
            # bounded: per-trajectory noise would otherwise add one entry
            # per distinct value
            while len(self._single_fns) >= 16:
                self._single_fns.pop(next(iter(self._single_fns)))
            s2, Cind = self._noise_arrays(traj)
            kern = self._kernel()
            args = (self.Bs, self.Gs, self.Sigs, self.M0s, self.C0s, self.w,
                    s2, Cind)

            def logL_fn(profiles, per_traj):
                ydata, valid = per_traj
                profiles = torch.as_tensor(profiles, dtype=torch.int32,
                                           device=self.device).contiguous()
                return kern(*args, profiles, ydata, valid)

            self._single_fns[key] = logL_fn
        return (traj.data, traj.valid), self._single_fns[key]

    def lockstep_fns(self, batch):
        """
        Lockstep-mode hooks: ``(per_traj, logL_fn)`` with ``per_traj =
        (batch.data (B, T, d), batch.valid (B, T))`` and ``logL_fn(profiles
        (L, P, T), (ydata (L, T, d), valid (L, T)))`` the ``(L, P)``
        likelihood of each lane's profiles against its own trajectory: one
        kernel launch for every lane. Needs a model-level
        ``localization_error`` (one noise model for the dataset). The
        closure is made once per kernel selection.
        """
        if self.localization_error is None:
            raise ValueError("lockstep batch mode needs model.localization_error")
        key = rouse_kernel()
        if key not in self._lockstep_fns:
            unique, Cind = np.unique(self.localization_error,
                                     return_inverse=True)
            s2 = torch.as_tensor(unique**2, dtype=self.dtype, device=self.device)
            Cind = torch.as_tensor(Cind.astype(np.int32), device=self.device)
            kern = self._kernel()
            args = (self.Bs, self.Gs, self.Sigs, self.M0s, self.C0s, self.w,
                    s2, Cind)

            def logL_fn(profiles, per_lane):
                ydata, valid = per_lane
                profiles = torch.as_tensor(profiles, dtype=torch.int32,
                                           device=self.device).contiguous()
                return kern(*args, profiles, ydata.contiguous(),
                            valid.contiguous())

            self._lockstep_fns[key] = logL_fn
        return (batch.data, batch.valid), self._lockstep_fns[key]

    # -- frame-factorized approximation -------------------------------------
    def toFactorized(self):
        """
        Time-scale-separated approximation: per state, a Maxwell
        distribution of the distance from the steady-state measurement
        variance ``w C_ss w`` plus the model noise per dimension.
        """
        import scipy.stats

        from .factorized import FactorizedModel

        noise2_per_d = (float(np.sum(self.localization_error**2)) / self.d
                        if self.localization_error is not None else 0.0)
        w = self.host["w"]
        distributions = [
            scipy.stats.maxwell(scale=np.sqrt(float(w @ C @ w) + noise2_per_d))
            for C in self.host["C0s"]]
        return FactorizedModel(distributions, d=self.d, device=self.device,
                               dtype=self.dtype)

    def _factorized_model(self):
        if self._factorized is None:
            self._factorized = self.toFactorized()
        return self._factorized

    def _segment_table(self, traj):
        """Frame-factorized scores of the steady-state Maxwell
        approximation (the one behind `initial_loopingprofile`)."""
        return self._factorized_model()._segment_table(traj)

    def lockstep_segment_tables(self, batch):
        """``(B, n, T)`` frame-factorized score tables for a batch."""
        return self._factorized_model().lockstep_segment_tables(batch)

    def initial_loopingprofile(self, traj) -> Loopingprofile:
        return self.toFactorized().initial_loopingprofile(traj)

    def trajectory_from_loopingprofile(
            self, profile, localization_error=None, missing_frames=None,
            generator: Optional[torch.Generator] = None) -> Trajectory:
        """
        Generative model: a steady-state conformation for ``profile[0]``,
        evolved frame by frame with the state-selected dynamics, measured,
        plus noise. Draws come from ``generator`` (a `torch.Generator` on the
        model's device; seeded from numpy's global RNG if omitted).
        """
        if localization_error is None:
            if self.localization_error is None:
                raise ValueError("Need localization_error or model.localization_error")
            localization_error = self.localization_error
        localization_error = self._preproc_localization_error(localization_error)

        profile = np.asarray(profile, dtype=int)
        T = len(profile)
        missing_frames = self._preproc_missing_frames(missing_frames, T)
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(int(np.random.randint(2**31)))

        N = self.Bs.shape[1]

        def normal(*shape):
            return torch.randn(shape, generator=generator, dtype=self.dtype,
                               device=self.device)

        conf = self.M0s[profile[0]] + self.L_sss[profile[0]] @ normal(N, self.d)
        meas = [self.w @ conf]
        for s in profile[1:]:
            conf = (self.Bs[s] @ conf + self.Gs[s]
                    + self.L_sigs[s] @ normal(N, self.d))
            meas.append(self.w @ conf)
        data = torch.stack(meas)                                   # (T, d)
        err = torch.as_tensor(localization_error, dtype=self.dtype,
                              device=self.device)
        data = (data + err[None, :] * normal(T, self.d)).cpu().numpy()
        data = data.astype(np.float64)
        data[missing_frames, :] = np.nan
        return Trajectory.create(data, localization_error=localization_error,
                                 loopingprofile=profile,
                                 device=self.device, dtype=self.dtype)

    def trajectories_from_loopingprofiles(
            self, profiles, localization_error=None,
            generator: Optional[torch.Generator] = None):
        """
        Batched generative model: one trajectory per row of the ``(B, T)``
        int profile array, all B advanced frame by frame in one tensor.
        Returns a `parallel.TrajectoryBatch` on the model's device.
        """
        from ..parallel.batch import TrajectoryBatch

        if localization_error is None:
            if self.localization_error is None:
                raise ValueError("Need localization_error or model.localization_error")
            localization_error = self.localization_error
        localization_error = self._preproc_localization_error(localization_error)
        profiles = torch.as_tensor(np.asarray(profiles, dtype=np.int64),
                                   device=self.device)
        B, T = profiles.shape
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(int(np.random.randint(2**31)))
        N = self.Bs.shape[1]

        def normal(*shape):
            return torch.randn(shape, generator=generator, dtype=self.dtype,
                               device=self.device)

        st = profiles[:, 0]
        conf = self.M0s[st] + self.L_sss[st] @ normal(B, N, self.d)  # (B, N, d)
        meas = [self.w @ conf]
        for t in range(1, T):
            st = profiles[:, t]
            conf = (self.Bs[st] @ conf + self.Gs[st]
                    + self.L_sigs[st] @ normal(B, N, self.d))
            meas.append(self.w @ conf)
        data = torch.stack(meas, dim=1)                             # (B, T, d)
        err = torch.as_tensor(localization_error, dtype=self.dtype,
                              device=self.device)
        data = data + err * normal(B, T, self.d)
        return TrajectoryBatch(
            data=data, valid=torch.ones((B, T), dtype=torch.bool,
                                        device=self.device),
            lengths=np.full(B, T))
