"""The plain PyTorch likelihood (`bild_tpu_torch.ops.kalman`, selector
'torch') against bild_tpu.ops.kalman and the float64 oracle."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bild_tpu import Trajectory
from bild_tpu.models import MultiStateRouse
from bild_tpu.ops.kalman import kalman_update_batch as j_update
from bild_tpu.ops.kalman import msrouse_logL_batch as j_logL
from bild_tpu.ops.oracle import msrouse_logL_numpy
from bild_tpu_torch.ops import kalman

# one intra-op thread per process: the tier-1 run puts several pytest
# workers on one host, and a torch thread pool in each oversubscribes it.
# Every port test file that runs torch imports this module for it.
torch.set_num_threads(1)

RTOL = 1e-10

CASES = {
    "missing frames": dict(missing=(3, 4, 17)),
    "first frame missing": dict(missing=(0,)),
    "q=3": dict(locerr=(0.1, 0.2, 0.3)),
    "q=2": dict(locerr=(0.1, 0.3, 0.1), missing=(9,)),
    "n=3": dict(loops=(None, (0, -1), (0, 4))),
    "d=1": dict(d=1, locerr=0.4),
    "NaN rows": dict(bad_rows=(2, 5)),
}


def make_case(rng, N=10, d=3, T=30, P=24, locerr=0.2, missing=(),
              loops=(None, (0, -1)), bad_rows=()):
    """(jax args, torch args, profiles, oracle inputs) of one case."""
    model = MultiStateRouse(N, 1.0, 4.0, d=d, localization_error=locerr,
                            looppositions=loops)
    data = rng.normal(size=(T, d))
    data[list(missing)] = np.nan
    traj = Trajectory.create(data)
    prof = rng.integers(0, model.nStates, size=(P, T)).astype(np.int32)
    for r, bad in zip(bad_rows, (model.nStates, -1)):
        prof[r, T // 3] = bad
    s2, Cind = model._noise_arrays(traj)
    jargs = (model.Bs, model.Gs, model.Sigs, model.M0s, model.C0s, model.w,
             s2, Cind, jnp.asarray(prof), traj.data, traj.valid)
    targs = [torch.as_tensor(np.array(a)) for a in jargs[:7]]
    targs += [np.asarray(Cind), torch.as_tensor(prof),
              torch.as_tensor(np.array(traj.data)),
              torch.as_tensor(np.array(traj.valid))]
    oracle = [np.asarray(a) for a in jargs[:6]] + [model._get_noise(traj)]
    return jargs, targs, prof, oracle, traj[:]


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_bild_tpu_and_oracle(rng, case):
    jargs, targs, prof, oracle, data = make_case(rng, **CASES[case])
    n = jargs[0].shape[0]
    got = kalman.msrouse_logL_batch(*targs).numpy()
    want = np.asarray(j_logL(*jargs))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    bad = np.any((prof < 0) | (prof >= n), axis=1)
    assert np.array_equal(np.isnan(got), bad)
    orc = np.array([msrouse_logL_numpy(*oracle, p, data)
                    for p in prof[~bad][:6]])
    np.testing.assert_allclose(got[~bad][:6], orc, rtol=RTOL)


@pytest.mark.parametrize("symmetrize", [True, False])
def test_symmetrize_flag_matches_bild_tpu(rng, symmetrize):
    jargs, targs, *_ = make_case(rng, missing=(1,))
    got = kalman.msrouse_logL_batch(*targs, symmetrize=symmetrize).numpy()
    want = np.asarray(j_logL(*jargs, symmetrize=symmetrize))
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_kalman_update_matches_bild_tpu(rng):
    P, q, N, d = 5, 2, 6, 3
    A = rng.normal(size=(P, q, N, N))
    C = A @ np.swapaxes(A, -1, -2) + np.eye(N)
    M = rng.normal(size=(P, N, d))
    y, w = rng.normal(size=d), rng.normal(size=N)
    s2, Cind = np.array([0.1, 0.4]), np.array([0, 1, 0])
    want = j_update(jnp.asarray(M), jnp.asarray(C), jnp.asarray(y),
                    jnp.asarray(w), jnp.asarray(s2), jnp.asarray(Cind))
    got = kalman.kalman_update_batch(
        *(torch.as_tensor(x) for x in (M, C, y, w, s2)),
        torch.as_tensor(Cind))
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=RTOL)


def test_in_range_mask():
    prof = torch.tensor([[0, 1, 1], [0, 2, 1], [-1, 0, 0]])
    assert kalman.in_range_mask(prof, 2).tolist() == [True, False, False]
    assert kalman.in_range_mask(prof, 3).tolist() == [True, True, False]


def test_call_counter(rng):
    _, targs, *_ = make_case(rng, T=5, P=2)
    before = kalman.msrouse_logL_batch.calls
    kalman.msrouse_logL_batch(*targs)
    assert kalman.msrouse_logL_batch.calls == before + 1


# (L, P) of every kernel launch that chip_smoke.py and the main path make:
# sample() (P = 2, 198, 100), bench.py's batch (P = 8192), the lane phase
# (6 x 37), the subset check (P = 7 of each of 640 lanes), per dataset
# chunk the scout (320 x 128), refine (192 x 128) and boundary-climb
# (64 x 9) steps, and config 3 in one chunk (640 x 128)
LAUNCHES = [(1, 2), (1, 100), (1, 198), (1, 8192), (6, 37), (640, 7),
            (320, 128), (192, 128), (64, 9), (640, 128)]


def covers_once(ranges, total):
    """Whether the half-open ranges of item indices cover ``[0, total)``,
    every item exactly once."""
    ranges = sorted((r.start, r.stop) for r in ranges)
    return (ranges[0][0] == 0 and ranges[-1][1] == total
            and all(a < b for a, b in ranges)
            and all(x[1] == y[0] for x, y in zip(ranges, ranges[1:])))


def make_lane_case(rng, L=4, N=8, d=3, T=20, P=7, locerr=(0.1, 0.2, 0.1),
                   loops=(None, (0, -1)), bad=((1, 2), (2, 0))):
    """A lane batch: L trajectories with different missing frames (lane 0
    none, lane 1 its first frame), random profiles per lane, and
    out-of-range rows at the (lane, row) pairs ``bad``. Returns (jax model
    args, torch model args, profiles (L, P, T), ydata (L, T, d), valid (L,
    T), oracle inputs, NaN-sentinel data per lane)."""
    model = MultiStateRouse(N, 1.0, 4.0, d=d, localization_error=locerr,
                            looppositions=loops)
    n = model.nStates
    data = rng.normal(size=(L, T, d))
    for lane in range(1, L):
        miss = [0] if lane == 1 else rng.choice(T, size=lane + 1, replace=False)
        data[lane, miss] = np.nan
    trajs = [Trajectory.create(x) for x in data]
    prof = rng.integers(0, n, size=(L, P, T)).astype(np.int32)
    for (lane, r), state in zip(bad, (n, -1)):
        prof[lane, r, T // 2] = state
    s2, Cind = model._noise_arrays(trajs[0])
    jargs = (model.Bs, model.Gs, model.Sigs, model.M0s, model.C0s, model.w,
             s2, Cind)
    targs = [torch.as_tensor(np.array(a)) for a in jargs[:7]] + [np.asarray(Cind)]
    ydata = np.stack([np.asarray(t.data) for t in trajs])
    valid = np.stack([np.asarray(t.valid) for t in trajs])
    oracle = [np.asarray(a) for a in jargs[:6]] + [model._get_noise(trajs[0])]
    return jargs, targs, prof, ydata, valid, oracle, [t[:] for t in trajs]


@pytest.mark.parametrize("symmetrize", [True, False])
def test_lanes_match_vmapped_bild_tpu_and_oracle(rng, symmetrize):
    import jax
    jargs, targs, prof, ydata, valid, oracle, datas = make_lane_case(rng)
    got = kalman.msrouse_logL_batch(
        *targs, torch.as_tensor(prof), torch.as_tensor(ydata),
        torch.as_tensor(valid), symmetrize=symmetrize).numpy()
    want = np.asarray(jax.vmap(
        lambda p, y, v: j_logL(*jargs, p, y, v, symmetrize=symmetrize))(
        jnp.asarray(prof), jnp.asarray(ydata), jnp.asarray(valid)))
    assert got.shape == prof.shape[:2]
    bad = np.any((prof < 0) | (prof >= 2), axis=2)
    assert np.array_equal(np.isnan(got), bad) and bad.sum() == 2
    np.testing.assert_allclose(got[~bad], want[~bad], rtol=RTOL)
    for lane in range(prof.shape[0]):
        rows = np.flatnonzero(~bad[lane])[:2]
        orc = [msrouse_logL_numpy(*oracle, prof[lane, r], datas[lane]) for r in rows]
        np.testing.assert_allclose(got[lane, rows], orc, rtol=RTOL)


def test_single_lane_form_is_lane_one(rng):
    _, targs, prof, ydata, valid, *_ = make_lane_case(rng, L=2, bad=())
    lanes = kalman.msrouse_logL_batch(*targs, torch.as_tensor(prof),
                                      torch.as_tensor(ydata),
                                      torch.as_tensor(valid))
    one = kalman.msrouse_logL_batch(*targs, torch.as_tensor(prof[1]),
                                    torch.as_tensor(ydata[1]),
                                    torch.as_tensor(valid[1]))
    assert one.shape == (prof.shape[1],)
    assert torch.equal(one, lanes[1])
    with pytest.raises(ValueError, match="do not match"):
        kalman.msrouse_logL_batch(*targs, torch.as_tensor(prof),
                                  torch.as_tensor(ydata[:1]),
                                  torch.as_tensor(valid[:1]))
