"""bild_tpu_torch.fit_ggm against bild_tpu.fit_ggm and against the float64
host oracle (`logL_host`): the differentiable objective and its gradient
on the same seeded data (float64, device="cpu"), the spec validation, a
small recovery, and `calibrate_ggm` with both engines at tiny sizes."""
import jax
import numpy as np
import pytest
import torch

import bild_tpu as bj
import bild_tpu_torch as bt
from bild_tpu.fit import make_ggm_nll as j_make_ggm_nll
from bild_tpu.models import GenericGaussianModel as JG
from bild_tpu_torch import fit as tfit
from bild_tpu_torch.fit import (GGMCalibrationResult, GGMFitResult, MSDFamily,
                                POWERLAW, TWO_LOCUS_ROUSE, calibrate_ggm,
                                fit_ggm, make_ggm_nll)
from bild_tpu_torch.models import GenericGaussianModel as TG
from bild_tpu_torch.parallel import stack_trajectories
import test_torch_kalman  # noqa: F401  (one torch thread per worker)

F64 = torch.float64
CPU = dict(device="cpu", dtype=F64)
RTOL_HOST = 1e-8      # objective against the summed logL_host
RTOL_NLL = 1e-8       # objective against bild_tpu's
RTOL_GRAD = 1e-6      # gradient against jax.grad of bild_tpu's


@pytest.fixture(scope="module")
def mixed():
    """Mixed ss_orders, nonzero means, noise, motion blur, d=2, gaps:
    every path of the window extraction at once. Data from `bild_tpu`'s
    generative model; both packages get the same arrays."""
    imaging = dict(noise2=0.02, motion_blur_f=0.3)
    spec = [
        [("twoLocusRouse", dict(G=1.0, J=5.0, **imaging), 0.1, 0)] * 2,
        [("powerlaw", dict(G=0.5, a=0.7, **imaging), -0.05, 1)] * 2,
    ]

    def model(G, **kw):
        return G([
            [(G.MSD_function_twoLocusRouse(G=1.0, J=5.0, **imaging), 0.1, 0)] * 2,
            [(G.MSD_function_powerlaw(G=0.5, a=0.7, **imaging), -0.05, 1)] * 2,
        ], **kw)

    jm, tm = model(JG), model(TG, **CPU)
    B, T = 4, 40
    profiles = np.zeros((B, T), dtype=int)
    profiles[0, 10:25] = 1
    profiles[1, :8] = 1
    profiles[2, 30:] = 1
    profiles[3, 5:12] = 1
    profiles[3, 20:33] = 1
    arrays = []
    for b in range(B):
        arr = np.asarray(jm.trajectory_from_loopingprofile(
            profiles[b], rng=np.random.default_rng(b))[:])
        if b == 2:   # gaps, including the overlap frame of an interval
            arr[[7, 29, 31]] = np.nan
        arrays.append(arr)
    jtrajs = [bj.make_trajectory(a) for a in arrays]
    ttrajs = [bt.make_trajectory(a, dtype=F64) for a in arrays]
    return spec, tm, profiles, jtrajs, ttrajs


def test_nll_matches_host_oracle(mixed):
    spec, tm, profiles, _, ttrajs = mixed
    nll, p0 = make_ggm_nll(spec, ttrajs, profiles, **CPU)
    n_obs = sum(np.isfinite(t[:]).sum() for t in ttrajs)
    ours = -float(nll(p0)) * n_obs
    host = sum(tm.logL_host(profiles[b], ttrajs[b]) for b in range(4))
    np.testing.assert_allclose(ours, host, rtol=RTOL_HOST)
    assert p0["s0"]["log_G"].dtype == F64 and set(p0["s1"]) == {"log_G", "log_a"}
    # a TrajectoryBatch and a single Trajectory are accepted too
    nll_b, _ = make_ggm_nll(spec, stack_trajectories(ttrajs), profiles, **CPU)
    assert float(nll_b(p0)) == float(nll(p0))
    nll_1, _ = make_ggm_nll(spec, ttrajs[0], profiles[0], **CPU)
    np.testing.assert_allclose(
        -float(nll_1(p0)) * np.isfinite(ttrajs[0][:]).sum(),
        tm.logL_host(profiles[0], ttrajs[0]), rtol=RTOL_HOST)


@pytest.mark.parametrize("fit_noise", [False, True])
def test_nll_and_gradient_match_bild_tpu(mixed, fit_noise):
    spec, _, profiles, jtrajs, ttrajs = mixed
    jnll, jp0 = j_make_ggm_nll(spec, jtrajs, profiles, fit_noise=fit_noise)
    tnll, tp0 = make_ggm_nll(spec, ttrajs, profiles, fit_noise=fit_noise, **CPU)
    assert {s: set(e) for s, e in tp0.items()} == {s: set(e) for s, e in jp0.items()}
    # away from the start, so that every parameter matters
    shift = {"log_G": 0.2, "log_J": -0.1, "log_a": 0.05, "log_noise2": 0.3}
    jp = {s: {k: v + shift[k] for k, v in e.items()} for s, e in jp0.items()}
    tp = {s: {k: (v + shift[k]).requires_grad_(True) for k, v in e.items()}
          for s, e in tp0.items()}
    val = tnll(tp)
    np.testing.assert_allclose(float(val.detach()), float(jnll(jp)),
                               rtol=RTOL_NLL)
    val.backward()
    jg = jax.grad(jnll)(jp)
    for s in tp:
        for k in tp[s]:
            np.testing.assert_allclose(float(tp[s][k].grad), float(jg[s][k]),
                                       rtol=RTOL_GRAD, atol=1e-10,
                                       err_msg=f"{s}/{k}")


def test_gradient_matches_finite_differences(mixed):
    spec, _, profiles, _, ttrajs = mixed
    nll, p0 = make_ggm_nll(spec, ttrajs, profiles, **CPU)
    leaves = {s: {k: v.clone().requires_grad_(True) for k, v in e.items()}
              for s, e in p0.items()}
    nll(leaves).backward()
    eps = 1e-6
    for s in p0:
        for k in p0[s]:
            pp = {a: dict(b) for a, b in p0.items()}
            pm = {a: dict(b) for a, b in p0.items()}
            pp[s][k] = p0[s][k] + eps
            pm[s][k] = p0[s][k] - eps
            fd = (float(nll(pp)) - float(nll(pm))) / (2 * eps)
            np.testing.assert_allclose(float(leaves[s][k].grad), fd, rtol=1e-4,
                                       atol=1e-7, err_msg=f"{s}/{k}")


def test_spec_validation():
    t = bt.make_trajectory(np.random.default_rng(0).normal(size=(10, 1)), dtype=F64)
    prof = np.zeros(10, dtype=int)
    pl = dict(G=1.0, a=0.5)
    cases = [
        ("no plateau", [[("powerlaw", pl, 0.0, 0)]], [t], prof, {}),
        ("unknown MSD family", [[("brownian", dict(G=1.0), 0.0, 1)]], [t], prof, {}),
        ("missing", [[("powerlaw", dict(G=1.0), 0.0, 1)]], [t], prof, {}),
        ("unknown parameters", [[("powerlaw", dict(pl, q=2), 0.0, 1)]], [t], prof, {}),
        ("positive", [[("powerlaw", dict(G=-1.0, a=0.5), 0.0, 1)]], [t], prof, {}),
        ("tied across dims",
         [[("powerlaw", pl, 0.0, 1), ("powerlaw", dict(G=2.0, a=0.5), 0.0, 1)]],
         [bt.make_trajectory(np.zeros((10, 2)) + 0.5, dtype=F64)], prof, {}),
        ("positive starting noise2", [[("powerlaw", pl, 0.0, 1)]], [t], prof,
         dict(fit_noise=True)),
        ("data has d", [[("powerlaw", pl, 0.0, 1)] * 2], [t], prof, {}),
        ("out of range", [[("powerlaw", pl, 0.0, 1)]], [t], prof + 1, {}),
        ("ss_order should be", [[("powerlaw", pl, 0.0, 2)]], [t], prof, {}),
    ]
    for match, spec, data, profiles, kw in cases:
        with pytest.raises(ValueError, match=match):
            make_ggm_nll(spec, data, profiles, **kw, **CPU)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_ggm_nll([[("powerlaw", pl, 0.0, 1)]], [t], prof)
    # the calibration namespace and the family objects
    assert tfit.fit_ggm is fit_ggm and isinstance(POWERLAW, MSDFamily)
    assert TWO_LOCUS_ROUSE.fields == ("G", "J") and POWERLAW.plateau is None
    nll, p0 = make_ggm_nll([[(POWERLAW, pl, 0.0, 1)]], [t], prof, **CPU)
    assert np.isfinite(float(nll(p0)))


def test_ragged_profile_lists():
    """Ragged per-trajectory profile lists (what
    ``sample_dataset(...).best_profile()`` returns) score exactly like the
    equivalently padded (B, T) array."""
    noise = dict(noise2=0.02)
    tm = TG([[(TG.MSD_function_twoLocusRouse(G=1.0, J=5.0, **noise), 0.0, 0)],
             [(TG.MSD_function_powerlaw(G=0.5, a=0.7, **noise), 0.0, 1)]], **CPU)
    spec = [[("twoLocusRouse", dict(G=1.0, J=5.0, **noise), 0.0, 0)],
            [("powerlaw", dict(G=0.5, a=0.7, **noise), 0.0, 1)]]
    lens = [20, 32, 26]
    rng = np.random.default_rng(5)
    ragged, trajs = [], []
    for b, T in enumerate(lens):
        p = np.zeros(T, dtype=int)
        t0 = rng.integers(0, T // 2)
        p[t0:t0 + rng.integers(5, T // 2)] = 1
        ragged.append(p)
        trajs.append(tm.trajectory_from_loopingprofile(
            p, rng=np.random.default_rng(b)))
    padded = np.zeros((3, max(lens)), dtype=int)
    for b, p in enumerate(ragged):
        padded[b, : len(p)] = p
    nll_r, p0 = make_ggm_nll(spec, trajs, ragged, **CPU)
    nll_p, _ = make_ggm_nll(spec, trajs, padded, **CPU)
    assert float(nll_r(p0)) == float(nll_p(p0))
    with pytest.raises(ValueError, match="frames"):
        make_ggm_nll(spec, trajs, [p[:-2] for p in ragged], **CPU)


@pytest.fixture(scope="module")
def two_state():
    true0, true1 = dict(G=1.0, J=5.0), dict(G=0.2, J=1.0)
    tm = TG([[(TG.MSD_function_twoLocusRouse(**true0, noise2=0.01), 0.0, 0)],
             [(TG.MSD_function_twoLocusRouse(**true1, noise2=0.01), 0.0, 0)]],
            **CPU)
    B, T = 8, 50
    rng = np.random.default_rng(0)
    profiles = np.zeros((B, T), dtype=int)
    for b in range(B):
        t0 = rng.integers(0, T // 2)
        profiles[b, t0:t0 + rng.integers(12, 25)] = 1
    trajs = [tm.trajectory_from_loopingprofile(
        profiles[b], rng=np.random.default_rng(b)) for b in range(B)]
    return (true0, true1), tm, profiles, trajs


def test_fit_ggm_recovery(two_state):
    truths, _, profiles, trajs = two_state
    spec = [[("twoLocusRouse", dict(G=1.6, J=3.0, noise2=0.01), 0.0, 0)],
            [("twoLocusRouse", dict(G=0.12, J=1.8, noise2=0.01), 0.0, 0)]]
    fit = fit_ggm(spec, trajs, profiles, steps=150, learning_rate=0.05, **CPU)
    assert isinstance(fit, GGMFitResult) and len(fit.nll_trace) == 151
    assert np.isfinite(fit.nll_trace).all()
    assert fit.nll_trace[-1] < fit.nll_trace[0] and fit.grad_norm < 1e-2
    for s, tru in enumerate(truths):
        for k, v in tru.items():
            assert abs(np.log(fit.parameters[s][k] / v)) < np.log(1.6), \
                (s, k, fit.parameters[s][k], v)
        assert fit.parameters[s]["noise2"] == 0.01          # frozen
    # the rebuilt model lives where the fit ran and prefers the truth
    assert isinstance(fit.model, TG) and fit.model.dtype == F64
    lls = fit.model.logL_batch(np.stack([profiles[0], 0 * profiles[0]]),
                               trajs[0])
    assert lls[0] > lls[1]
    assert set(fit.params) == {"s0", "s1"}
    assert float(fit.params["s0"]["log_G"]) == pytest.approx(
        np.log(fit.parameters[0]["G"]))


def test_fit_noise_and_powerlaw_increments():
    tm = TG([[(TG.MSD_function_powerlaw(G=1.0, a=0.6, noise2=0.05), 0.0, 1)],
             [(TG.MSD_function_powerlaw(G=0.3, a=1.2, noise2=0.05), 0.0, 1)]],
            **CPU)
    T = 60
    profile = np.zeros(T, dtype=int)
    profile[20:45] = 1
    trajs = [tm.trajectory_from_loopingprofile(
        profile, rng=np.random.default_rng(b)) for b in range(6)]
    spec = [[("powerlaw", dict(G=1.4, a=0.5, noise2=0.03), 0.0, 1)],
            [("powerlaw", dict(G=0.2, a=1.4, noise2=0.03), 0.0, 1)]]
    fit = fit_ggm(spec, trajs, profile, fit_noise=True, steps=120, **CPU)
    assert np.isfinite(fit.nll_trace).all()
    assert fit.nll_trace[-1] < fit.nll_trace[0]
    for s in range(2):
        assert fit.parameters[s]["noise2"] > 0
        assert "log_noise2" in fit.params[f"s{s}"]


@pytest.mark.parametrize("engine", ["batch", "dataset"])
def test_calibrate_ggm(two_state, engine):
    truths, _, profiles, trajs = two_state
    spec = [[("twoLocusRouse", dict(G=1.3, J=3.8, noise2=0.01), 0.0, 0)],
            [("twoLocusRouse", dict(G=0.15, J=1.4, noise2=0.01), 0.0, 0)]]
    sample_kwargs = dict(k_max=2, steps_per_k=4, N=24)
    if engine == "dataset":
        sample_kwargs.update(bucket_edges=(50, 64), chunk_size=4)
    kw = dict(rounds=2, engine=engine, sample_kwargs=sample_kwargs,
              fit_kwargs=dict(steps=40, learning_rate=0.05), **CPU)
    cal = calibrate_ggm(spec, trajs, **kw,
                        generator=torch.Generator().manual_seed(1))
    assert isinstance(cal, GGMCalibrationResult) and len(cal.fits) == 2
    assert cal.parameters is cal.fits[-1].parameters
    if engine == "batch":
        assert cal.profiles.shape == profiles.shape
        acc = np.mean(cal.profiles == profiles)
    else:
        assert [len(p) for p in cal.profiles] == [50] * 8
        acc = np.mean(np.concatenate(cal.profiles) == profiles.ravel())
    assert acc > 0.7
    for f in cal.fits:
        assert f.nll_trace[-1] < f.nll_trace[0]
    # the second round starts from the first round's parameters
    assert cal.fits[1].nll_trace[0] != cal.fits[0].nll_trace[0]
    assert cal.model is cal.fits[-1].model and cal.model.device.type == "cpu"
    # the same generator seed gives the same calibration
    again = calibrate_ggm(spec, trajs, **kw,
                          generator=torch.Generator().manual_seed(1))
    assert again.parameters == cal.parameters


def test_calibrate_ggm_argument_guards(two_state):
    _, _, _, trajs = two_state
    spec = [[("twoLocusRouse", dict(G=1.3, J=3.8), 0.0, 0)],
            [("twoLocusRouse", dict(G=0.15, J=1.4), 0.0, 0)]]
    with pytest.raises(ValueError, match="Trajectory"):
        calibrate_ggm(spec, stack_trajectories(trajs), engine="dataset", **CPU)
    with pytest.raises(ValueError, match="engine"):
        calibrate_ggm(spec, trajs, engine="chunked", **CPU)
