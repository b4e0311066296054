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
