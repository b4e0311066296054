"""bild_tpu_torch.models and .trajectory against bild_tpu (float64)."""
import numpy as np
import pytest
import torch

import bild_tpu as bj
import bild_tpu_torch as bt
from bild_tpu_torch import config
from bild_tpu_torch.ops import kalman
import test_torch_kalman  # noqa: F401  (one torch thread per worker)

F64 = torch.float64
ARRAYS = ("Bs", "Gs", "Sigs", "M0s", "C0s", "L_sigs", "w")

MODELS = {
    "2 states": dict(N=12, D=1.0, k=4.0, d=3, localization_error=0.2),
    "3 states, anisotropic": dict(N=9, D=0.5, k=3.0, d=3,
                                  looppositions=(None, (0, -1), (2, 6)),
                                  localization_error=(0.1, 0.3, 0.1)),
    "d=2, no model noise": dict(N=8, D=1.0, k=2.0, d=2),
}


def _pair(kw):
    return (bj.models.MultiStateRouse(**kw),
            bt.models.MultiStateRouse(**kw, device="cpu", dtype=F64))


def _from_arrays(jmodel, **kw):
    return bt.models.MultiStateRouse.from_arrays(
        *(np.asarray(getattr(jmodel, a)) for a in ARRAYS),
        localization_error=jmodel.localization_error,
        transitions=jmodel.transitions, device="cpu", dtype=F64, **kw)


@pytest.mark.parametrize("name", list(MODELS))
def test_constructor_matches_bild_tpu_and_from_arrays(name):
    jm, tm = _pair(MODELS[name])
    fm = _from_arrays(jm)
    for a in ARRAYS:
        np.testing.assert_allclose(getattr(tm, a).numpy(),
                                   np.asarray(getattr(jm, a)),
                                   rtol=1e-12, atol=1e-12, err_msg=a)
        np.testing.assert_array_equal(getattr(fm, a).numpy(),
                                      np.asarray(getattr(jm, a)))
    np.testing.assert_allclose((fm.L_sss @ fm.L_sss.transpose(1, 2)).numpy(),
                               np.asarray(jm.C0s), atol=1e-12)
    np.testing.assert_array_equal(tm.transitions, jm.transitions)
    assert tm.nStates == fm.nStates == jm.nStates and tm.d == jm.d


@pytest.mark.parametrize("name", list(MODELS))
def test_logL_batch_matches_bild_tpu(rng, name):
    jm, tm = _pair(MODELS[name])
    fm = _from_arrays(jm)
    T = 25
    data = rng.normal(size=(T, jm.d))
    data[[0, 11]] = np.nan
    err = None if jm.localization_error is not None else 0.25
    jt = bj.Trajectory.create(data, localization_error=err)
    tt = bt.Trajectory.create(data, localization_error=err, dtype=F64)
    prof = rng.integers(0, jm.nStates, size=(15, T))
    want = np.asarray(jm.logL_batch(prof, jt))
    for model in (tm, fm):
        np.testing.assert_allclose(model.logL_batch(prof, tt).numpy(), want,
                                   rtol=1e-10)
    assert tm.logL(prof[3], tt) == pytest.approx(float(want[3]), rel=1e-10)


@pytest.mark.parametrize("selector", config.KERNELS)
def test_cpu_model_takes_the_plain_path(rng, selector):
    """Whatever the selector, a CPU model runs ops.kalman."""
    _, tm = _pair(MODELS["2 states"])
    tt = bt.Trajectory.create(rng.normal(size=(6, 3)), dtype=F64)
    calls = kalman.msrouse_logL_batch.calls
    try:
        config.set_rouse_kernel(selector)
        tm.logL_batch(np.zeros((2, 6), dtype=int), tt)
    finally:
        config.set_rouse_kernel("sym")
    assert kalman.msrouse_logL_batch.calls == calls + 1


def test_set_rouse_kernel_rejects_unknown():
    with pytest.raises(ValueError):
        config.set_rouse_kernel("xla")
    assert config.rouse_kernel() == "sym"


def test_noise_resolution():
    _, tm = _pair(MODELS["d=2, no model noise"])
    tt = bt.Trajectory.create(np.zeros((4, 2)), dtype=F64)
    with pytest.raises(ValueError, match="localization error"):
        tm.logL_batch(np.zeros((1, 4), dtype=int), tt)
    s2, Cind = tm._noise_arrays(bt.Trajectory.create(
        np.zeros((4, 2)), localization_error=(0.3, 0.1), dtype=F64))
    np.testing.assert_allclose(s2.numpy(), [0.01, 0.09])
    assert Cind.dtype == torch.int32 and Cind.tolist() == [1, 0]


def test_trajectory_from_loopingprofile():
    _, tm = _pair(MODELS["3 states, anisotropic"])
    prof = np.repeat([0, 1, 2, 0], 10)
    make = lambda seed: tm.trajectory_from_loopingprofile(  # noqa: E731
        prof, missing_frames=[3, 17], generator=torch.Generator().manual_seed(seed))
    a, b, c = make(4), make(4), make(5)
    assert a.data.shape == (40, 3) and a.data.dtype == F64
    assert torch.equal(a.data, b.data) and not torch.equal(a.data, c.data)
    assert a.valid.tolist() == [t not in (3, 17) for t in range(40)]
    assert np.isnan(a[:][3]).all() and np.array_equal(a.loopingprofile, prof)
    np.testing.assert_array_equal(a.localization_error, [0.1, 0.3, 0.1])
    lls = tm.logL_batch(np.stack([prof, np.zeros(40, int), np.ones(40, int)]), a)
    assert int(torch.argmax(lls)) == 0


def test_trajectory_generation_statistics():
    """The generated end-to-end variance matches the steady state."""
    _, tm = _pair(MODELS["2 states"])
    g = torch.Generator().manual_seed(0)
    x = np.concatenate([tm.trajectory_from_loopingprofile(
        np.zeros(5, int), localization_error=1e-6, generator=g)[:][0]
        for _ in range(800)])
    want = float(tm.w @ tm.C0s[0] @ tm.w)
    assert abs(x.var() - want) < 4 * want * np.sqrt(2 / x.size)


def test_toFactorized_not_ported():
    """`toFactorized` (once not ported) builds the same per-state Maxwell
    distributions as bild_tpu's, on the model's device and dtype."""
    jm, tm = _pair(MODELS["2 states"])
    tf, jf = tm.toFactorized(), jm.toFactorized()
    assert isinstance(tf, bt.models.FactorizedModel) and tf.dtype == F64
    for t, j in zip(tf.distributions, jf.distributions):
        assert t.kwds["scale"] == pytest.approx(j.kwds["scale"], rel=1e-12)


def test_trajectory_coercion():
    arr = np.arange(12.0).reshape(2, 3, 2)
    arr[1, 1, 0] = np.nan
    t = bt.make_trajectory(arr, dtype=F64)
    np.testing.assert_array_equal(t.data.numpy(), [[6, 6], [0, 0], [6, 6]])
    assert t.valid.tolist() == [True, False, True] and t.count_valid_frames() == 2
    assert bt.make_trajectory(t, dtype=torch.float32).data.dtype == torch.float32
    one = bt.make_trajectory(np.array([1.0, 2.0]), localization_error=0.5)
    assert one.d == 1 and len(one) == 2
    np.testing.assert_array_equal(one.localization_error, [0.5])
    with pytest.raises(ValueError):
        bt.Trajectory.create(np.zeros((3, 2)), localization_error=[1, 2, 3])
    with pytest.raises(ValueError):
        bt.make_trajectory(np.zeros((3, 4, 2)))


DEFAULT_BUILDS = {
    "MultiStateRouse": lambda: bt.models.MultiStateRouse(8, 1.0, 4.0, d=3),
    "from_arrays": lambda: bt.models.MultiStateRouse.from_arrays(
        *(np.asarray(getattr(bj.models.MultiStateRouse(6, 1.0, 4.0), a))
          for a in ARRAYS), localization_error=0.1,
        transitions=~np.eye(2, dtype=bool)),
    "FactorizedModel": lambda: bt.models.FactorizedModel([]),
    "RouseModel": lambda: bt.physics.rouse.RouseModel(N=5, D=1.0, k=3.0,
                                                       d=3, dt=1.0),
}


@pytest.mark.parametrize("build", list(DEFAULT_BUILDS))
def test_models_default_to_the_gpu(build):
    """Built without device=, a model lives on the GPU; without a GPU it
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        assert DEFAULT_BUILDS[build]().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DEFAULT_BUILDS[build]()


def test_sample_defaults_to_the_gpu():
    """sample() with a model that names no device takes the GPU: without
    one it raises."""
    if torch.cuda.is_available():
        assert config.resolve_device(config.DEFAULT_DEVICE).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bt.sample(np.zeros((5, 3)), object())
