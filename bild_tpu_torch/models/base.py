"""
Model interface (counterpart of `bild_tpu.models.base`).

Inference evaluates likelihoods for a *batch* of profiles in one call
(`logL_batch`); models should override it with a vectorized version, the
base one is a host loop over `logL`.

A model written by the user need not derive from `MultiStateModel`:
`sample()` and `amis.FixedkSampler` take any object with ``nStates``,
``transitions`` (bool ``(n, n)``, the allowed switches) and
``logL_batch(profiles, traj)``. That call receives an int tensor ``(P,
T)`` on the trajectory's device and may return anything `torch.as_tensor`
takes (a tensor on either device, a numpy array, a list) holding ``P``
log-likelihoods; the sampler's AMIS steps convert it to the trajectory's
device and dtype, its exhaustive enumeration to float64 on the host.
``device`` and ``dtype`` attributes are optional: `sample()` places
the trajectory by them and defaults to the GPU and float32.
"""
from __future__ import annotations

import abc
import hashlib

import numpy as np
import torch

from ..infer.segment import dp_segment, profile_to_st
from ..profiles import Loopingprofile

__all__ = ["MultiStateModel", "tensor_token"]


def tensor_token(*tensors):
    """A key that says "these very tensors, unchanged": per tensor its
    storage address, shape, strides, dtype, device and in-place version
    counter. Equal tokens mean equal contents as long as the cache that
    stores the token also holds the tensors (a live tensor's storage cannot
    be handed to another). Views and slices that a runner takes anew on every
    call (``traj.data[None]``, a trimmed batch) get the same token each
    time, which identity (``is``) would not give them."""
    return tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype,
                  t.device, t._version) for t in tensors)


class MultiStateModel(metaclass=abc.ABCMeta):
    """
    Abstract base class for inference models.

    Required: `logL` (and ideally `logL_batch`), `nStates`, `d`,
    ``transitions``. ``transitions[i, j]`` says whether the switch
    ``i -> j`` is allowed; `init_transitions` allows everything but
    self-transitions.
    """

    def init_transitions(self, n: int):
        self.transitions = ~np.eye(n, dtype=bool)

    @property
    def nStates(self) -> int:
        return self.transitions.shape[0]

    @property
    def d(self) -> int:
        raise NotImplementedError  # pragma: no cover

    def initial_loopingprofile(self, traj) -> Loopingprofile:
        """Default: a random profile."""
        return Loopingprofile(np.random.choice(self.nStates, size=len(traj)))

    @abc.abstractmethod
    def logL(self, loopingprofile, traj) -> float:
        """Log-likelihood of a (profile, trajectory) pair."""
        raise NotImplementedError  # pragma: no cover

    def logL_batch(self, profiles, traj):
        """Log-likelihoods for a ``(P, T)`` int array of profiles; the base
        version loops over `logL` on the host."""
        if isinstance(profiles, torch.Tensor):
            profiles = profiles.cpu().numpy()
        return torch.tensor([self.logL(Loopingprofile(p), traj)
                             for p in np.asarray(profiles)],
                            dtype=traj.data.dtype, device=traj.data.device)

    def _fingerprint_parts(self):
        """Hook for `likelihood_fingerprint`: array-likes that together
        determine the likelihood (and segmentation scores), or ``None``
        (the default): the model cannot fingerprint."""
        return None

    def likelihood_fingerprint(self):
        """Hex digest of everything that determines this model's
        likelihood, or ``None``. It hashes float64 host arrays, so it does
        not depend on the device or dtype the model's tensors live in.
        `parallel.sample_dataset` keys its chunk checkpoints on it."""
        parts = self._fingerprint_parts()
        if parts is None:
            return None
        h = hashlib.sha256()
        h.update(type(self).__name__.encode())
        h.update(np.ascontiguousarray(self.transitions).tobytes())
        for p in parts:
            a = np.ascontiguousarray(np.asarray(p, dtype=np.float64))
            h.update(repr(a.shape).encode())
            h.update(a.tobytes())
        return h.hexdigest()

    def _segment_table(self, traj):
        """``(n, T)`` per-frame state-score table for DP segmentation, or
        ``None`` if the model has no frame-factorized approximation."""
        return None

    def segment_guess(self, traj, k):
        """
        Informed ``(s_fractions, theta)`` initialization for a k-switch AMIS
        proposal: the optimal k-segmentation of the model's frame-factorized
        score table (`infer.segment.dp_segment`). ``None`` when unavailable
        or infeasible.
        """
        table = self._segment_table(traj)
        if table is None:
            return None
        profile, _ = dp_segment(np.asarray(table), k, self.transitions)
        if profile is None:
            return None
        return profile_to_st(profile)

    def lockstep_segment_tables(self, batch):
        """``(B, n, T)`` frame-factorized score tables for a batch, or
        ``None`` (lockstep informed init then stays uniform)."""
        return None

    def lockstep_fns_single(self, traj, max_intervals=None):
        """
        ``(per_traj, logL_fn)`` for ONE trajectory: ``logL_fn(profiles (P,
        T), per_traj)`` gives the ``(P,)`` likelihoods (`bild_tpu`'s hook;
        the sampler's step calls the lane form, `lockstep_fns_lane`).
        Default: `lockstep_fns_lane`, its lane axis added and removed
        around each call; a model without `lockstep_fns` falls back to
        `logL_batch`. ``max_intervals`` is the caller's bound on the
        intervals of any profile it will pass (see
        `GenericGaussianModel.lockstep_fns`).
        """
        if not hasattr(self, "lockstep_fns"):
            return traj, lambda profiles, t: self.logL_batch(profiles, t)
        per_lane, logL_fn = self.lockstep_fns_lane(traj,
                                                   max_intervals=max_intervals)

        def single(profiles, per_lane):
            profiles = torch.as_tensor(profiles, device=traj.data.device)
            return logL_fn(profiles[None], per_lane)[0]

        return per_lane, single

    def lockstep_fns_lane(self, traj, max_intervals=None):
        """
        ``(lane_data, logL_fn)`` for ONE trajectory in lane form, what the
        single-trajectory sampler's step calls: ``logL_fn(profiles (1, P,
        T), lane_data)`` gives the ``(1, P)`` likelihoods, and
        ``lane_data`` is a tuple of tensors with a leading lane axis of 1.
        The trajectory travels in ``lane_data``, not in the closure, so
        that one closure (a captured step's owner) serves every sampler of
        the model. Default: `lockstep_fns` on a singleton batch.
        """
        from ..parallel.batch import TrajectoryBatch

        batch = TrajectoryBatch(data=traj.data[None], valid=traj.valid[None])
        per_lane, logL_fn = self.lockstep_fns(batch,
                                              max_intervals=max_intervals)
        return tuple(per_lane), logL_fn

    # -- generative-path preprocessing ---------------------------------------
    def _preproc_localization_error(self, localization_error):
        if np.isscalar(localization_error):
            localization_error = self.d * [localization_error]
        localization_error = np.asarray(localization_error, dtype=float)
        if localization_error.shape != (self.d,):
            raise ValueError("Did not understand localization_error")
        return localization_error

    def _preproc_missing_frames(self, missing_frames, T, rng=None):
        """
        Resolve ``missing_frames``: None/0 = none; float in (0, 1) =
        per-frame drop probability; int = that many random frames; array =
        explicit indices.
        """
        rng = np.random if rng is None else rng
        if missing_frames is None or (np.isscalar(missing_frames) and missing_frames == 0):
            return np.array([], dtype=int)
        if np.isscalar(missing_frames):
            if 0 < missing_frames < 1:
                return np.nonzero(rng.rand(T) < missing_frames)[0]
            return rng.choice(T, size=int(missing_frames), replace=False).astype(int)
        return np.asarray(missing_frames, dtype=int)
