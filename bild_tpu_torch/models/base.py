"""
Model interface (counterpart of `bild_tpu.models.base`).

Inference evaluates likelihoods for a *batch* of profiles in one call
(`logL_batch`); models should override it with a vectorized version, the
base one is a host loop over `logL`.
"""
from __future__ import annotations

import abc

import numpy as np
import torch

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

    def segment_guess(self, traj, k):
        """Informed ``(s_fractions, theta)`` initialization for AMIS; needs
        the DP segmentation of `bild_tpu.infer.segment`, not ported yet."""
        raise NotImplementedError(
            "informed initialization needs infer/segment.py, which "
            "bild_tpu_torch does not port yet; use informed_init=False")

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
