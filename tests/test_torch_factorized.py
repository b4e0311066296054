"""bild_tpu_torch.models.factorized and the model-side informed-init hooks
against bild_tpu, on the same scipy distributions and data (float64,
rtol 1e-12); plus the trajectory hashing the factorized memo relies on."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

import bild_tpu as bj
import bild_tpu_torch as bt
from bild_tpu.parallel import stack_trajectories as j_stack
from bild_tpu_torch.parallel import stack_trajectories as t_stack
import test_torch_kalman  # noqa: F401  (one torch thread per worker)

F64 = torch.float64
RTOL = 1e-12


@pytest.fixture(scope="module")
def dists():
    return [scipy.stats.maxwell(scale=0.3), scipy.stats.maxwell(scale=1.0),
            scipy.stats.maxwell(scale=2.0)]


def _data(rng, T, missing=()):
    data = rng.normal(size=(T, 3)) * rng.choice([0.3, 1.0], size=(T, 1))
    data[list(missing)] = np.nan
    return data


def test_tables_logL_and_mle_equal(rng, dists):
    jm = bj.models.FactorizedModel(dists, d=3)
    tm = bt.models.FactorizedModel(dists, d=3, device="cpu", dtype=F64)
    data = _data(rng, 30, missing=(0, 7, 8))
    jt, tt = bj.Trajectory.create(data), bt.Trajectory.create(data, dtype=F64)
    np.testing.assert_allclose(tm._segment_table(tt), jm._segment_table(jt),
                               rtol=RTOL)
    prof = rng.integers(0, 3, size=(17, 30))
    np.testing.assert_allclose(tm.logL_batch(prof, tt).numpy(),
                               np.asarray(jm.logL_batch(prof, jt)), rtol=RTOL)
    assert tm.logL(prof[3], tt) == pytest.approx(jm.logL(prof[3], jt), rel=RTOL)
    np.testing.assert_array_equal(tm.initial_loopingprofile(tt)[:],
                                  jm.initial_loopingprofile(jt)[:])
    # the memo keys on host data: an equal trajectory reuses the table
    assert len(tm._known_trajs) == 1
    tm.logL_batch(prof, bt.Trajectory.create(data, dtype=F64))
    assert len(tm._known_trajs) == 1


def test_lockstep_tables_and_logL_equal(rng, dists):
    jm = bj.models.FactorizedModel(dists, d=3)
    tm = bt.models.FactorizedModel(dists, d=3, device="cpu", dtype=F64)
    datas = [_data(rng, T, missing=(1,)) for T in (20, 14, 20)]
    jb = j_stack([bj.Trajectory.create(x) for x in datas])
    tb = t_stack([bt.Trajectory.create(x, dtype=F64) for x in datas])
    np.testing.assert_allclose(tm.lockstep_segment_tables(tb),
                               jm.lockstep_segment_tables(jb), rtol=RTOL)
    assert tm.lockstep_segment_tables(tb) is tm.lockstep_segment_tables(tb)
    prof = rng.integers(0, 3, size=(3, 9, 20))
    (ttab,), tfn = tm.lockstep_fns(tb)
    (jtab,), jfn = jm.lockstep_fns(jb)
    got = tfn(torch.as_tensor(prof, dtype=torch.int32), (ttab,)).numpy()
    want = np.stack([np.asarray(jfn(jnp.asarray(prof[b]), (jtab[b],)))
                     for b in range(3)])
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("locerr", [0.1, None])
def test_rouse_factorized_approximation_equal(rng, locerr):
    kw = dict(N=8, D=1.0, k=5.0, d=3, localization_error=locerr)
    jm = bj.models.MultiStateRouse(**kw)
    tm = bt.models.MultiStateRouse(**kw, device="cpu", dtype=F64)
    jf, tf = jm.toFactorized(), tm.toFactorized()
    for jd, td in zip(jf.distributions, tf.distributions):
        assert td.kwds["scale"] == pytest.approx(jd.kwds["scale"], rel=RTOL)
    true = np.zeros(40, dtype=int)
    true[12:30] = 1
    data = jm.trajectory_from_loopingprofile(
        true, localization_error=0.1, key=jax.random.key(1))[:]
    jt = bj.Trajectory.create(data, localization_error=0.1)
    tt = bt.Trajectory.create(data, localization_error=0.1, dtype=F64)
    np.testing.assert_allclose(tm._segment_table(tt), jm._segment_table(jt),
                               rtol=RTOL)
    for k in (0, 2, 5):
        g, w = tm.segment_guess(tt, k), jm.segment_guess(jt, k)
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
    np.testing.assert_array_equal(tm.initial_loopingprofile(tt)[:],
                                  jm.initial_loopingprofile(jt)[:])


def test_fingerprint_is_device_and_dtype_free(dists):
    kw = dict(N=8, D=1.0, k=5.0, d=3, localization_error=0.1)
    a = bt.models.MultiStateRouse(**kw, device="cpu", dtype=F64).likelihood_fingerprint()
    b = bt.models.MultiStateRouse(**kw, device="cpu", dtype=torch.float32).likelihood_fingerprint()
    c = bt.models.MultiStateRouse(**dict(kw, k=4.0), device="cpu").likelihood_fingerprint()
    d = bt.models.MultiStateRouse(**dict(kw, localization_error=None), device="cpu").likelihood_fingerprint()
    assert a == b and len({a, c, d}) == 3
    f1 = bt.models.FactorizedModel(dists, device="cpu", dtype=F64).likelihood_fingerprint()
    f2 = bt.models.FactorizedModel(dists[:2], device="cpu").likelihood_fingerprint()
    assert f1 == bt.models.FactorizedModel(dists, device="cpu").likelihood_fingerprint() != f2


def test_trajectory_hash_eq_magnitudes(rng):
    data = _data(rng, 12, missing=(3,))
    a, b = (bt.Trajectory.create(data, dtype=F64) for _ in range(2))
    c = bt.Trajectory.create(data + 1e-9, dtype=F64)
    assert a == b and hash(a) == hash(b) and a != c
    assert a != bt.Trajectory.create(data)            # float32
    np.testing.assert_allclose(
        a.magnitudes().numpy(),
        np.asarray(bj.Trajectory.create(data).magnitudes()), rtol=RTOL)


def test_factorized_generator_reproducible(dists):
    tm = bt.models.FactorizedModel(dists, d=3, device="cpu", dtype=F64)
    prof = np.repeat([0, 2, 1], 10)
    np.random.seed(0)
    a = tm.trajectory_from_loopingprofile(prof, generator=torch.Generator().manual_seed(4))
    np.random.seed(0)
    b = tm.trajectory_from_loopingprofile(prof, generator=torch.Generator().manual_seed(4))
    assert a == b and a.T == 30 and a.d == 3
