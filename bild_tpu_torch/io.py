"""
Dataset IO (counterpart of `bild_tpu.io`): trajectory tables -> `Trajectory`
objects.

`load_trajectories_csv` reads a delimited table with columns ``traj_id,
frame, v0 .. v{d-1}`` (header optional, rows in any order) and returns one
`Trajectory` per id, in ascending id order, with frame-index gaps as
missing frames. The parse runs in the native multithreaded C++ loader
(`native`) when it builds, else in `load_trajectories_csv_python`, which
has the same semantics. The trajectories are host data: CPU tensors in
``dtype``; the samplers move them to the model's device.

For two-locus tables (``x1,y1,z1,x2,y2,z2``), ``two_locus=True`` gives the
relative (difference) trajectory that BILD models.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import native
from .trajectory import Trajectory

__all__ = ["load_trajectories_csv", "load_trajectories_csv_python"]


def _assemble(ids, offsets, frames, data, two_locus, localization_error,
              max_frames: Optional[int], return_ids, dtype):
    d = data.shape[1]
    if two_locus:
        if d % 2 != 0:
            raise ValueError(f"two_locus needs an even number of value columns; got {d}")
        data = data[:, d // 2:] - data[:, : d // 2]
    trajs = []
    for i in range(len(ids)):
        lo, hi = offsets[i], offsets[i + 1]
        fr = frames[lo:hi]
        f0 = fr[0]
        T = int(fr[-1] - f0) + 1
        if max_frames is not None and T > max_frames:
            raise ValueError(
                f"trajectory {ids[i]} spans {T} frames > max_frames={max_frames}")
        full = np.full((T, data.shape[1]), np.nan)
        full[fr - f0] = data[lo:hi]
        trajs.append(Trajectory.create(full, localization_error=localization_error,
                                       dtype=dtype))
    if return_ids:
        return trajs, np.asarray(ids, dtype=np.int64)
    return trajs


def load_trajectories_csv_python(path, two_locus=False, localization_error=None,
                                 max_frames=None, return_ids=False, *,
                                 dtype=torch.float32):
    """The pure-Python CSV loader. ``return_ids=True`` also returns the
    ``traj_id`` of each trajectory."""
    groups = {}
    n_values = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = [p for p in line.replace(",", " ").replace(";", " ")
                     .replace("\t", " ").split(" ") if p]
            try:
                tid = int(float(parts[0]))
                frame = int(float(parts[1]))
            except ValueError:
                continue  # header
            vals = []
            for p in parts[2:]:
                try:
                    vals.append(float(p))
                except ValueError:
                    vals.append(np.nan)
            if not vals:
                continue
            # the widest row sets the width: a short first row must not
            # truncate later rows' columns
            n_values = max(n_values, len(vals))
            groups.setdefault(tid, []).append((frame, vals))

    ids = sorted(groups)
    offsets = [0]
    frames_all, data_all = [], []
    for tid in ids:
        for frame, vals in sorted(groups[tid], key=lambda r: r[0]):
            frames_all.append(frame)
            data_all.append((vals + [np.nan] * n_values)[:n_values])
        offsets.append(len(frames_all))
    return _assemble(np.array(ids), np.array(offsets),
                     np.array(frames_all, dtype=np.int64),
                     np.array(data_all, dtype=float).reshape(len(data_all), n_values),
                     two_locus, localization_error, max_frames, return_ids,
                     dtype)


def load_trajectories_csv(path, two_locus=False, localization_error=None,
                          max_frames=None, return_ids=False, *,
                          dtype=torch.float32):
    """
    Load a trajectory table with the native parser, or with the Python one
    if the native library is unavailable or fails on the file (its error
    message is the precise one). ``return_ids=True`` also returns the
    ``traj_id`` of each trajectory. Counts the native parses in
    ``load_trajectories_csv.native_parses``.
    """
    kw = dict(two_locus=two_locus, localization_error=localization_error,
              max_frames=max_frames, return_ids=return_ids, dtype=dtype)
    lib = native.get_lib()
    if lib is None:
        return load_trajectories_csv_python(path, **kw)
    handle = ctypes.c_void_p()
    if lib.bild_csv_load(str(path).encode(), ctypes.byref(handle)) != 0:
        # 1/2: unreadable file, 3: a C++ exception
        return load_trajectories_csv_python(path, **kw)
    try:
        n_trajs = ctypes.c_int64()
        total_rows = ctypes.c_int64()
        n_values = ctypes.c_int()
        lib.bild_csv_dims(handle, ctypes.byref(n_trajs),
                          ctypes.byref(total_rows), ctypes.byref(n_values))
        nt, tr, nv = n_trajs.value, total_rows.value, n_values.value
        ids = np.empty(nt, dtype=np.int64)
        offsets = np.empty(nt + 1, dtype=np.int64)
        frames = np.empty(tr, dtype=np.int64)
        data = np.empty((tr, nv), dtype=np.float64)
        lib.bild_csv_fill(handle,
                          ids.ctypes.data_as(ctypes.c_void_p),
                          offsets.ctypes.data_as(ctypes.c_void_p),
                          frames.ctypes.data_as(ctypes.c_void_p),
                          data.ctypes.data_as(ctypes.c_void_p))
    finally:
        lib.bild_csv_free(handle)
    load_trajectories_csv.native_parses += 1
    return _assemble(ids, offsets, frames, data, two_locus,
                     localization_error, max_frames, return_ids, dtype)


load_trajectories_csv.native_parses = 0
