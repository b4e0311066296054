"""
Model interface (counterpart of `bild_tpu.models.base`).

Inference evaluates likelihoods for a *batch* of profiles in one call
(`logL_batch`); models should override it with a vectorized version, the
base one is a host loop over `logL`.
"""
from __future__ import annotations

import abc
import hashlib

import numpy as np
import torch

from ..infer.segment import dp_segment, profile_to_st
from ..profiles import Loopingprofile

__all__ = ["MultiStateModel"]


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
