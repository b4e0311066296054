"""bild_tpu_torch.fit against bild_tpu.fit (float64): the dynamics map, the
objective and its gradient, a few Adam steps, and calibrate_rouse at a
tiny size."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bild_tpu as bj
import bild_tpu_torch as bt
from bild_tpu import fit as jfit
from bild_tpu_torch import fit as tfit
from bild_tpu_torch.parallel import TrajectoryBatch
import test_torch_kalman  # noqa: F401  (one torch thread per worker)

F64 = torch.float64


def models(N=8, D=1.0, k=5.0, err=0.1, d=3, **kw):
    return (bj.models.MultiStateRouse(N, D, k, d=d, localization_error=err, **kw),
            bt.models.MultiStateRouse(N, D, k, d=d, localization_error=err,
                                      device="cpu", dtype=F64, **kw))


def shared_batch(jm, profiles, key):
    jb = jm.trajectories_from_loopingprofiles(profiles, key=jax.random.key(key))
    data = np.array(jb.data)
    valid = np.array(jb.valid)
    valid[0, [3, 11]] = False                      # missing frames
    data[~valid] = 0.0
    return (bj.parallel.TrajectoryBatch(data=jnp.asarray(data),
                                        valid=jnp.asarray(valid),
                                        lengths=np.asarray(jb.lengths)),
            TrajectoryBatch(data=torch.as_tensor(data), valid=torch.as_tensor(valid),
                            lengths=np.asarray(jb.lengths)))


def test_dynamics_map_matches_bild_tpu():
    jm, tm = models(N=10, D=0.7, k=3.2, looppositions=(None, (0, -1), (2, 7)))
    consts = tfit._spectral_consts(tm)
    got = tfit._dynamics_from_params(consts, torch.tensor(np.log(0.7), dtype=F64),
                                     torch.tensor(np.log(3.2), dtype=F64), 1.0)
    want = jfit._dynamics_from_params(jfit._spectral_consts(jm), jnp.log(0.7),
                                      jnp.log(3.2), 1.0, jnp.float64)
    for g, w, own in zip(got, want, (tm.Bs, tm.Sigs, tm.C0s)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(g.numpy(), own.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("fit_localization", [True, "vector", False])
def test_nll_and_gradient_match_bild_tpu(fit_localization):
    jm, tm = models(N=6, err=(0.1, 0.15, 0.1))
    prof = np.zeros((3, 24), dtype=int)
    prof[:, 8:15] = 1
    prof[2, 20:] = 1
    jb, tb = shared_batch(jm, prof, 3)
    jnll, jp0 = jfit.make_rouse_nll(jm, jb, prof, fit_localization=fit_localization)
    tnll, tp0 = tfit.make_rouse_nll(tm, tb, prof, fit_localization=fit_localization)
    shift = {"log_D": 0.1, "log_k": -0.2, "log_err": 0.05}
    jp = {k: v + shift[k] for k, v in jp0.items()}
    tp = {k: (v + shift[k]).requires_grad_(True) for k, v in tp0.items()}
    val, grads = jax.value_and_grad(jnll)(jp)
    got = tnll(tp)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(val), rtol=1e-9)
    assert set(tp) == set(grads)
    for name, g in grads.items():
        np.testing.assert_allclose(tp[name].grad.numpy(), np.asarray(g),
                                   rtol=1e-9, atol=1e-12, err_msg=name)


def test_weighted_nll_matches_bild_tpu():
    jm, tm = models(N=5, d=2)
    rng = np.random.default_rng(1)
    prof = np.zeros((3, 25), dtype=int)
    prof[:, 8:15] = 1
    jb, tb = shared_batch(jm, prof, 5)
    sets = rng.integers(0, 2, size=(3, 4, 25)).astype(np.int32)
    w = rng.dirichlet(np.ones(4), size=3)
    w[1, 2] = 0.0
    w[1] /= w[1].sum()
    jnll, jp0 = jfit.make_rouse_nll(jm, jb, sets, weights=w)
    tnll, tp0 = tfit.make_rouse_nll(tm, tb, sets, weights=w)
    np.testing.assert_allclose(float(tnll(tp0)), float(jnll(jp0)), rtol=1e-9)
    with pytest.raises(ValueError, match="weighted profiles"):
        tfit.make_rouse_nll(tm, tb, sets[:, :, :10], weights=w)


def test_fit_rouse_trace_matches_bild_tpu():
    jm, tm = models(N=5, D=1.3, k=4.0)
    prof = np.zeros((2, 20), dtype=int)
    prof[:, 6:13] = 1
    jb, tb = shared_batch(jm, prof, 7)
    jf = jfit.fit_rouse(jm, jb, prof, steps=5, learning_rate=0.05)
    before = tfit.calibration_logL.calls
    tf = tfit.fit_rouse(tm, tb, prof, steps=5, learning_rate=0.05)
    assert tfit.calibration_logL.calls == before + 6    # 5 steps, the last value
    assert tf.nll_trace.shape == (6,)
    np.testing.assert_allclose(tf.nll_trace, jf.nll_trace, rtol=1e-8)
    np.testing.assert_allclose([tf.D, tf.k], [jf.D, jf.k], rtol=1e-8)
    np.testing.assert_allclose(tf.localization_error, jf.localization_error,
                               rtol=1e-8)
    np.testing.assert_allclose(tf.grad_norm, jf.grad_norm, rtol=1e-6)
    assert tf.model.device.type == "cpu" and tf.model.dtype == F64
    np.testing.assert_allclose(tf.model.Bs.numpy(), np.asarray(jf.model.Bs),
                               rtol=1e-8, atol=1e-10)
    assert isinstance(tf.converged, bool)


def test_frozen_localization():
    jm, tm = models(N=5, err=(0.1, 0.2, 0.1))
    prof = np.zeros(30, dtype=int)
    prof[10:20] = 1
    traj = tm.trajectory_from_loopingprofile(
        prof, generator=torch.Generator().manual_seed(3))
    fit = tfit.fit_rouse(tm, traj, prof, fit_localization=False, steps=5)
    np.testing.assert_array_equal(fit.localization_error, [0.1, 0.2, 0.1])
    assert "log_err" not in fit.params
    np.testing.assert_array_equal(fit.model.localization_error, [0.1, 0.2, 0.1])
    with pytest.raises(ValueError, match="fit_localization"):
        tfit.make_rouse_nll(tm, traj, prof, fit_localization="matrix")


def test_errors_as_bild_tpu():
    """Heterogeneous per-trajectory errors and short ragged profiles raise
    the same errors in both packages."""
    rng = np.random.default_rng(0)
    datas = [rng.normal(size=(10, 1)) for _ in range(3)]
    for pkg, mk in ((jfit, bj.make_trajectory), (tfit, bt.make_trajectory)):
        model = (bj.models.MultiStateRouse(5, 1.0, 5.0, d=1) if pkg is jfit else
                 bt.models.MultiStateRouse(5, 1.0, 5.0, d=1, device="cpu", dtype=F64))
        kw = {} if pkg is jfit else {"dtype": F64}
        t1, t2, t3 = (mk(x, localization_error=e, **kw)
                      for x, e in zip(datas, (0.1, 0.2, 0.1)))
        with pytest.raises(ValueError, match="heterogeneous"):
            pkg.make_rouse_nll(model, [t1, t2], np.zeros((2, 10), int))
        nll, p0 = pkg.make_rouse_nll(model, [t1, t3], np.zeros((2, 10), int))
        assert np.isfinite(float(nll(p0)))
        short = mk(datas[0][:8], localization_error=0.1, **kw)
        with pytest.raises(ValueError, match="profile 1 has 5 frames"):
            pkg.make_rouse_nll(model, [t1, short], [np.zeros(10, int),
                                                    np.zeros(5, int)])
        with pytest.raises(ValueError, match="profiles for"):
            pkg.make_rouse_nll(model, [t1, short, t3],
                               [np.zeros(10, int), np.zeros(8, int)])


def test_calibrate_rouse_modes_and_engines():
    jm, tm = models(N=5, d=1)
    rng = np.random.default_rng(2)
    profs = []
    for T in (24, 30, 24):
        p = np.zeros(T, dtype=int)
        t0 = int(rng.integers(0, T // 2))
        p[t0:t0 + 8] = 1
        profs.append(p)
    trajs = [tm.trajectory_from_loopingprofile(
        p, generator=torch.Generator().manual_seed(i)) for i, p in enumerate(profs)]
    start = bt.models.MultiStateRouse(5, 1.2, 4.0, d=1, localization_error=0.1,
                                      device="cpu", dtype=F64)
    kw = dict(rounds=1, sample_kwargs=dict(k_max=2, steps_per_k=4, N=16),
              fit_kwargs=dict(steps=10, fit_localization=False),
              generator=torch.Generator().manual_seed(2))
    hard = tfit.calibrate_rouse(start, trajs, **kw)
    assert hard.pre_fit is not None and len(hard.fits) == 1
    assert hard.profiles.shape == (3, 30)
    assert np.isfinite(hard.fits[0].nll_trace).all() and hard.D > 0 and hard.k > 0
    soft = tfit.calibrate_rouse(start, trajs, mode="soft", ensemble=4,
                                init="model", **kw)
    assert soft.pre_fit is None and soft.results.top_profiles is not None
    ds = tfit.calibrate_rouse(
        start, trajs, engine="dataset", **{**kw, "sample_kwargs": dict(
            k_max=2, steps_per_k=4, N=16, bucket_edges=(24, 32),
            informed_init=False)})
    assert [len(p) for p in ds.profiles] == [24, 30, 24]
    np.testing.assert_allclose(ds.localization_error, 0.1)
    # a model without a model-level error takes the trajectories' metadata
    bare = bt.models.MultiStateRouse(5, 1.2, 4.0, d=1, device="cpu", dtype=F64)
    meta = [bt.Trajectory.create(t[:], localization_error=0.1, dtype=F64) for t in trajs]
    cal = tfit.calibrate_rouse(bare, meta, **kw)
    np.testing.assert_allclose(cal.model.localization_error, 0.1)
    for bad, match in ((dict(mode="em"), "mode"), (dict(init="warm"), "init"),
                       (dict(engine="chunked"), "engine"),
                       (dict(engine="dataset", mode="soft"), "hard")):
        with pytest.raises(ValueError, match=match):
            tfit.calibrate_rouse(start, trajs, **bad)
    with pytest.raises(ValueError, match="Trajectory"):
        tfit.calibrate_rouse(start, bt.parallel.stack_trajectories(trajs),
                             engine="dataset")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")


@pytest.mark.cuda
def test_graphed_fit_on_the_card_matches_the_cpu(cuda):
    """On the GPU the objective runs as one CUDA graph: the float64 trace
    equals the CPU's eager one."""
    kw = dict(N=5, D=1.3, k=4.0, d=3, localization_error=0.1, dtype=F64)
    cpu = bt.models.MultiStateRouse(**kw, device="cpu")
    gpu = bt.models.MultiStateRouse(**kw, device="cuda")
    prof = np.zeros((2, 20), dtype=int)
    prof[:, 6:13] = 1
    batch = cpu.trajectories_from_loopingprofiles(
        prof, generator=torch.Generator().manual_seed(7))
    a = tfit.fit_rouse(cpu, batch, prof, steps=8)
    b = tfit.fit_rouse(gpu, batch, prof, steps=8)
    np.testing.assert_allclose(b.nll_trace, a.nll_trace, rtol=1e-10)
    np.testing.assert_allclose([b.D, b.k], [a.D, a.k], rtol=1e-10)
