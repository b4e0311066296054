"""
Factorized (time-scale-separated, HMM-like) model (counterpart of
`bild_tpu.models.factorized`).

Each frame's distance is drawn i.i.d. from a per-state distribution, so a
trajectory's likelihood is a sum over frames of a per-frame, per-state
table. The distributions are host callables (scipy frozen distributions,
KDEs), so the ``(n, T)`` table is computed once per trajectory on the host
in numpy and moved to the model's device; profile likelihoods are then a
masked gather-sum, batched over profiles (and over lanes in the lockstep
runner).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import DEFAULT_DEVICE, resolve_device
from ..lanes import lane_sum
from ..profiles import Loopingprofile
from ..trajectory import Trajectory
from .base import MultiStateModel

__all__ = ["FactorizedModel"]


def _gather_sum(tables, profiles, exact=False):
    """``sum_t tables[..., profiles[..., p, t], t]``: ``tables (..., n, T)``,
    ``profiles (..., P, T)`` -> ``(..., P)``; out-of-range states score 0.
    ``exact``: a lane-exact sum (`lanes.lane_sum`)."""
    vals = torch.zeros(profiles.shape, dtype=tables.dtype,
                       device=tables.device)
    for s in range(tables.shape[-2]):
        vals = torch.where(profiles == s, tables[..., None, s, :], vals)
    return lane_sum(vals, exact=exact)


class FactorizedModel(MultiStateModel):
    """
    Each frame's distance is drawn i.i.d. from a per-state distribution.

    ``distributions`` need a ``logpdf()`` accepting arrays; ``rvs()`` is
    needed only for `trajectory_from_loopingprofile`. Localization error is
    assumed baked into the distributions, so ``traj.localization_error`` is
    ignored. ``device``/``dtype`` say where the score tables live (the GPU
    unless ``device="cpu"``).
    """

    def __init__(self, distributions, d=3, *, device=DEFAULT_DEVICE,
                 dtype=torch.float32):
        self.distributions = list(distributions)
        self._d = d
        self.device = resolve_device(device)
        self.dtype = dtype
        self._known_trajs = {}
        self._seg_cache = None
        self._lockstep_logL_fn = None
        self.init_transitions(len(self.distributions))

    @property
    def d(self):
        return self._d

    def _fingerprint_parts(self):
        # distributions are arbitrary host callables; their logpdf sampled
        # on a fixed wide grid is the likelihood-relevant content
        probe = np.geomspace(1e-6, 1e6, 256)
        with np.errstate(divide="ignore", invalid="ignore",
                         under="ignore", over="ignore"):
            vals = [np.asarray(dist.logpdf(probe), dtype=float)
                    for dist in self.distributions]
        return [[self._d], *vals]

    def _tables(self, mags, valid):
        """Per-frame state scores ``(..., n, T)`` (numpy) from magnitudes
        ``(..., T)``; unobserved frames score 0 under every state."""
        with np.errstate(divide="ignore", invalid="ignore", under="ignore"):
            tables = np.stack([dist.logpdf(mags) for dist in self.distributions],
                              axis=-2)
        return np.where(valid[..., None, :], tables, 0.0)

    # -- memoized logL table ----------------------------------------------
    def _memo(self, traj: Trajectory) -> np.ndarray:
        if traj not in self._known_trajs:
            table = self._tables(traj.magnitudes().cpu().numpy(),
                                 traj.valid.cpu().numpy())
            self._known_trajs[traj] = (
                table, torch.as_tensor(table, dtype=self.dtype,
                                       device=self.device))
        return self._known_trajs[traj]

    def clear_memo(self):
        self._known_trajs = {}

    def _segment_table(self, traj):
        # NaN-free, missing frames already zeroed (equal score under every
        # state, so segmentation ignores them)
        return self._memo(traj)[0]

    # -- likelihood --------------------------------------------------------
    def logL(self, profile, traj) -> float:
        return float(self.logL_batch(np.asarray(profile)[None, :], traj)[0])

    def logL_batch(self, profiles, traj) -> torch.Tensor:
        """``(P,)`` log-likelihoods of a ``(P, T)`` profile batch."""
        profiles = torch.as_tensor(np.asarray(profiles), dtype=torch.int32,
                                   device=self.device)
        return _gather_sum(self._memo(traj)[1], profiles)

    def lockstep_segment_tables(self, batch) -> np.ndarray:
        """``(B, n, T)`` per-frame state-score tables of a
        `parallel.TrajectoryBatch` (numpy; also the DP segmentation's
        input); masked frames score 0. Cached for the last batch data
        tensor: `lockstep_fns` and the informed-init path both need it, and
        the host scipy evaluation is the expensive part."""
        if self._seg_cache is not None and self._seg_cache[0] is batch.data:
            return self._seg_cache[1]
        mags = np.linalg.norm(batch.data.cpu().numpy(), axis=-1)    # (B, T)
        tables = self._tables(mags, batch.valid.cpu().numpy())
        self._seg_cache = (batch.data, tables)
        return tables

    def lockstep_fns(self, batch, max_intervals=None):
        """
        Lockstep-mode hooks (see `MultiStateRouse.lockstep_fns`): the
        per-trajectory data is the ``(n, T)`` score table, and
        ``logL_fn(profiles (L, P, T), (tables (L, n, T),))`` is the masked
        gather-sum, ``(L, P)``, lane-exact (a lane's value does not
        depend on the other lanes of the call). The sum runs over frames:
        ``max_intervals`` changes nothing.
        """
        tables = torch.as_tensor(self.lockstep_segment_tables(batch),
                                 dtype=self.dtype, device=self.device)
        if self._lockstep_logL_fn is None:
            def logL_fn(profiles, per_lane):
                (table,) = per_lane
                return _gather_sum(table, profiles, exact=True)

            self._lockstep_logL_fn = logL_fn
        return (tables,), self._lockstep_logL_fn

    # -- convenience -------------------------------------------------------
    def initial_loopingprofile(self, traj) -> Loopingprofile:
        """
        MLE profile: per observed frame the argmax state, extended across
        missing frames: frames up to and including an observed frame take
        that frame's best state.
        """
        table = self._memo(traj)[0]
        valid = traj.valid.cpu().numpy()
        valid_times = np.nonzero(valid)[0]
        best_states = np.argmax(table[:, valid_times], axis=0)

        states = np.zeros(len(traj), dtype=int)
        states[: valid_times[0] + 1] = best_states[0]
        last_time = valid_times[0]
        for cur_time, cur_state in zip(valid_times[1:], best_states[1:]):
            states[last_time + 1 : cur_time + 1] = cur_state
            last_time = cur_time
        if last_time < len(traj):
            states[last_time + 1 :] = best_states[-1]
        return Loopingprofile(states)

    def trajectory_from_loopingprofile(
            self, profile, localization_error=0.0, missing_frames=None,
            generator: Optional[torch.Generator] = None) -> Trajectory:
        """
        Sample magnitudes from the per-state distributions (host ``rvs``)
        and isotropic orientations, from ``generator`` if given (else from
        numpy's global RNG).
        """
        localization_error = self._preproc_localization_error(localization_error)
        profile = np.asarray(profile, dtype=int)
        T = len(profile)
        missing_frames = self._preproc_missing_frames(missing_frames, T)

        magnitudes = np.array([self.distributions[s].rvs() for s in profile])
        if generator is not None:
            dirs = torch.randn((T, self.d), generator=generator,
                               dtype=torch.float64,
                               device=generator.device).cpu().numpy()
        else:
            dirs = np.random.normal(size=(T, self.d))
        data = dirs * (magnitudes / np.linalg.norm(dirs, axis=1))[:, None]
        data[missing_frames, :] = np.nan
        return Trajectory.create(data, localization_error=localization_error,
                                 loopingprofile=profile, device=self.device,
                                 dtype=self.dtype)
