"""
Trajectory container (counterpart of `bild_tpu.trajectory`).

A `Trajectory` carries

- ``data``  : ``(T, d)`` float tensor with missing frames zero-filled,
- ``valid`` : ``(T,)`` bool tensor (True = frame observed),

plus host metadata (``localization_error`` as a numpy array, an optional
ground-truth ``loopingprofile``). NaN rows in the input mark missing frames
and become the mask; ``traj[:]`` returns the NaN-sentinel view.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = ["Trajectory", "make_trajectory"]


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass(frozen=True)
class Trajectory:
    """One particle-tracking trajectory; see the module docstring."""

    data: torch.Tensor
    valid: torch.Tensor
    localization_error: Optional[np.ndarray] = None
    loopingprofile: Optional[np.ndarray] = None

    @staticmethod
    def create(data, localization_error=None, loopingprofile=None, *,
               device="cpu", dtype=torch.float32) -> "Trajectory":
        data = np.asarray(_to_numpy(data), dtype=np.float64)
        if data.ndim == 1:
            data = data[:, None]
        if data.ndim != 2:
            raise ValueError(f"Trajectory data should be (T,) or (T, d); got shape {data.shape}")
        valid = ~np.any(np.isnan(data), axis=1)
        data = np.where(valid[:, None], np.nan_to_num(data), 0.0)
        if localization_error is not None:
            localization_error = np.asarray(_to_numpy(localization_error),
                                            dtype=np.float64)
            if localization_error.ndim == 0:
                localization_error = localization_error * np.ones(data.shape[1])
            if localization_error.shape != (data.shape[1],):
                raise ValueError(
                    "localization_error should be scalar or (d,); "
                    f"got shape {localization_error.shape} for d={data.shape[1]}")
        if loopingprofile is not None:
            loopingprofile = np.asarray(loopingprofile)
        return Trajectory(
            data=torch.as_tensor(data, dtype=dtype, device=device),
            valid=torch.as_tensor(valid, device=device),
            localization_error=localization_error,
            loopingprofile=loopingprofile,
        )

    def to(self, device=None, dtype=None) -> "Trajectory":
        """The same trajectory with its tensors on ``device`` / in ``dtype``."""
        return dataclasses.replace(
            self,
            data=self.data.to(device=device, dtype=dtype),
            valid=self.valid.to(device=device))

    def __len__(self) -> int:
        return self.data.shape[0]

    @property
    def T(self) -> int:
        return self.data.shape[0]

    @property
    def d(self) -> int:
        return self.data.shape[1]

    def __getitem__(self, key):
        """NaN-sentinel numpy view, like ``noctiluca.Trajectory.__getitem__``."""
        dat = self.data.detach().cpu().numpy()
        val = self.valid.cpu().numpy()
        return np.where(val[:, None], dat, np.nan)[key]

    def magnitudes(self) -> torch.Tensor:
        """``(T,)`` distance magnitudes; 0 at missing frames (use ``valid``)."""
        return torch.linalg.vector_norm(self.data, dim=1)

    def count_valid_frames(self) -> int:
        return int(self.valid.sum())

    # -- hashing for memo tables: on the host data, not on tensor identity
    def __hash__(self):
        return hash((tuple(self.data.shape),
                     self.data.detach().cpu().numpy().tobytes()))

    def __eq__(self, other):
        if not isinstance(other, Trajectory):
            return NotImplemented
        return (self.data.shape == other.data.shape
                and self.data.dtype == other.data.dtype
                and torch.equal(self.data.cpu(), other.data.cpu())
                and torch.equal(self.valid.cpu(), other.valid.cpu()))


def make_trajectory(obj, localization_error=None, *, device="cpu",
                    dtype=torch.float32, **meta) -> Trajectory:
    """
    Coerce user input to a `Trajectory`: an existing `Trajectory` (moved to
    ``device``/``dtype``), or an array of shape ``(N, T, d)``, ``(T, d)`` or
    ``(T,)``. ``N = 2`` loci become the relative (difference) trajectory.
    """
    if isinstance(obj, Trajectory):
        return obj.to(device=device, dtype=dtype)
    arr = np.asarray(_to_numpy(obj), dtype=float)
    if arr.ndim == 3:
        if arr.shape[0] == 1:
            arr = arr[0]
        elif arr.shape[0] == 2:
            arr = arr[1] - arr[0]
        else:
            raise ValueError(f"Cannot interpret {arr.shape[0]}-locus trajectory; expected N in (1, 2)")
    return Trajectory.create(arr, localization_error=localization_error,
                             device=device, dtype=dtype, **meta)
