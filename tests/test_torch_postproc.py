"""bild_tpu_torch.postproc against bild_tpu.postproc on a shared batch made
by bild_tpu (float64): the batched boundary climb gives equal profiles and
elimination flags from the same start profiles, and each row equals the
single-trajectory climb."""
import jax
import numpy as np
import pytest
import torch

import bild_tpu as bj
import bild_tpu_torch as bt
from bild_tpu import postproc as jpp
from bild_tpu_torch import postproc as tpp
from bild_tpu_torch.parallel import TrajectoryBatch
import test_torch_kalman  # noqa: F401  (one torch thread per worker)

F64 = torch.float64


@pytest.fixture(scope="module")
def shared():
    kw = dict(N=8, D=1.0, k=5.0, d=3, localization_error=0.1)
    jm = bj.models.MultiStateRouse(**kw)
    tm = bt.models.MultiStateRouse(**kw, device="cpu", dtype=F64)
    truth = np.zeros((5, 40), dtype=int)
    truth[0, 10:25] = 1
    truth[1, 5:30] = 1
    truth[2, 20:] = 1
    truth[3, 8:16] = 1
    truth[3, 26:34] = 1
    jb = jm.trajectories_from_loopingprofiles(truth, key=jax.random.key(3))
    tb = TrajectoryBatch(data=torch.as_tensor(np.array(jb.data)),
                         valid=torch.as_tensor(np.array(jb.valid)),
                         lengths=np.array(jb.lengths))
    # start profiles: the truths with boundaries shifted, and one interval
    # of a single frame (row 4), which the climb eliminates
    start = truth.copy()
    start[0, 10:14] = 0
    start[1, 30:35] = 1
    start[2, 15:20] = 1
    start[3, 16:19] = 1
    start[4, 20] = 1
    return jm, tm, truth, jb, tb, start


def test_batch_climb_matches_bild_tpu(shared):
    jm, tm, truth, jb, tb, start = shared
    got, got_elim = tpp.optimize_boundary_batch(start, tb, tm)
    want, want_elim = jpp.optimize_boundary_batch(start, jb, jm)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_elim, want_elim)
    assert got_elim[4] and not got_elim[:4].any()
    acc = np.mean(got[:4] == truth[:4])
    assert acc >= 0.9 and acc > np.mean(start[:4] == truth[:4])
    assert tpp.optimize_boundary_batch.evaluations > 0


def test_rows_equal_single_trajectory_climb(shared):
    jm, tm, _, jb, tb, start = shared
    got, _ = tpp.optimize_boundary_batch(start, tb, tm)
    for b in range(4):
        traj = bt.Trajectory(tb.data[b], tb.valid[b])
        jtraj = bj.Trajectory(jb.data[b], jb.valid[b])
        one = tpp.optimize_boundary(start[b], traj, tm)
        np.testing.assert_array_equal(one[:], got[b])
        np.testing.assert_array_equal(
            one[:], jpp.optimize_boundary(start[b], jtraj, jm)[:])
        np.testing.assert_allclose(
            tpp.logLR_boundaries(start[b], traj, tm),
            jpp.logLR_boundaries(start[b], jtraj, jm), rtol=1e-9, atol=1e-9)
    with pytest.raises(tpp.BoundaryEliminationError):
        tpp.optimize_boundary(start[4], bt.Trajectory(tb.data[4], tb.valid[4]), tm)


def test_edge_cases(shared):
    _, tm, _, _, tb, start = shared
    flat = np.zeros((5, 40), dtype=int)
    got, elim = tpp.optimize_boundary_batch(flat, tb, tm)
    assert np.array_equal(got, flat) and not elim.any()
    with pytest.raises(RuntimeError, match="max_iteration"):
        tpp.optimize_boundary_batch(start, tb, tm, max_iteration=1)
    assert tpp.logLR_boundaries(flat[0], bt.Trajectory(tb.data[0], tb.valid[0]),
                                tm).size == 0
