"""bild_tpu_torch.models.ggm against bild_tpu.models.ggm and against its own
float64 host oracle (`logL_host`), on the same seeded data (float64,
device="cpu"): the three table builds, the gather-sums, the band
control, the caches, and a GGM through `sample`, `sample_batch` and
`sample_batch_adaptive`. The parity shapes stay small (T <= 23 for the
bucketed tables): `bild_tpu` compiles one program per bucket."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

import bild_tpu as bj
import bild_tpu_torch as bt
from bild_tpu.models import GenericGaussianModel as JG
from bild_tpu.parallel.batch import TrajectoryBatch as JBatch
from bild_tpu_torch.infer.adaptive import sample_batch_adaptive
from bild_tpu_torch.models import GenericGaussianModel as TG
from bild_tpu_torch.models import ggm as tggm
from bild_tpu_torch.parallel import (TrajectoryBatch, sample_batch,
                                     stack_trajectories)
from bild_tpu_torch.postproc import optimize_boundary_batch
from bild_tpu_torch.utils import load_results, save_results
import test_torch_kalman  # noqa: F401  (one torch thread per worker)

F64 = torch.float64
CPU = dict(device="cpu", dtype=F64)
ATOL_TABLE = 1e-9     # interval tables against bild_tpu's (float64 both)
RTOL_LOGL = 1e-9      # likelihoods against bild_tpu's and against logL_host


def mixed_spec(G):
    """ss_order 0 and 1, two dims, nonzero means."""
    return [
        [(G.MSD_function_twoLocusRouse(G=1.0, J=5.0), 0.3, 0),
         (G.MSD_function_powerlaw(G=1.0, a=0.7), 0.0, 1)],
        [(G.MSD_function_twoLocusRouse(G=2.0, J=1.0), -0.1, 0),
         (G.MSD_function_powerlaw(G=0.5, a=1.0), 0.1, 1)],
    ]


def band_spec(G):
    return [
        [(G.MSD_function_twoLocusRouse(G=1.0, J=5.0), 0.1, 0),
         (G.MSD_function_powerlaw(G=0.5, a=0.5), 0.0, 1)],
        [(G.MSD_function_twoLocusRouse(G=0.2, J=1.0), 0.0, 0),
         (G.MSD_function_powerlaw(G=1.5, a=0.8), 0.1, 1)],
    ]


def two_state_spec(G, J0=20.0):
    return [[(G.MSD_function_twoLocusRouse(G=1.0, J=J0), 0.0, 0)],
            [(G.MSD_function_twoLocusRouse(G=1.0, J=0.5), 0.0, 0)]]


def gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def models():
    return JG(mixed_spec(JG)), TG(mixed_spec(TG), **CPU)


def gapped(rng, B, T):
    """``(data, valid)``: row 0 gap-free, the others with missing frames,
    row 1's first frame among them."""
    data = rng.normal(size=(B, T, 2))
    valid = np.ones((B, T), dtype=bool)
    valid[1, [0, 3, 4, 11]] = False
    for b in range(2, B):
        valid[b, rng.choice(T, size=3, replace=False)] = False
    return np.where(valid[:, :, None], data, 0.0), valid


# -- host parts ---------------------------------------------------------------

def test_fingerprint_equals_bild_tpu(models):
    jm, tm = models
    assert tm.likelihood_fingerprint() == jm.likelihood_fingerprint()
    for kw in (dict(T_band=64), dict(T_band="auto", band_tol=0.2)):
        assert (TG(mixed_spec(TG), **kw, **CPU).likelihood_fingerprint()
                == JG(mixed_spec(JG), **kw).likelihood_fingerprint())
    assert (TG(two_state_spec(TG), **CPU).likelihood_fingerprint()
            != tm.likelihood_fingerprint())


def test_constructor_validation():
    with pytest.raises(ValueError, match="T_band must be >= 8"):
        TG(mixed_spec(TG), T_band=4, **CPU)
    with pytest.raises(ValueError, match="'auto'"):
        TG(mixed_spec(TG), T_band="wide", **CPU)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TG(mixed_spec(TG))          # models live on the GPU unless asked
    tm = TG(mixed_spec(TG), **CPU)
    assert tm.nStates == 2 and tm.d == 2 and tm.device.type == "cpu"


def test_same_normals_same_trajectory(models):
    """Both packages draw one ``standard_normal(len)`` per (interval, dim)
    from the numpy Generator they are given."""
    jm, tm = models
    prof = np.zeros(30, dtype=int)
    prof[8:19] = 1
    prof[25:] = 1
    jt = jm.trajectory_from_loopingprofile(prof, missing_frames=[3, 9],
                                           rng=np.random.default_rng(5))
    tt = tm.trajectory_from_loopingprofile(prof, missing_frames=[3, 9],
                                           rng=np.random.default_rng(5))
    np.testing.assert_allclose(tt[:], np.asarray(jt[:]), rtol=1e-12,
                               atol=1e-12, equal_nan=True)
    assert tt.data.dtype == F64 and not bool(tt.valid[3])
    np.testing.assert_array_equal(tt.loopingprofile, prof)
    # a torch.Generator drives it too, reproducibly
    a = tm.trajectory_from_loopingprofile(prof, generator=gen(1))
    b = tm.trajectory_from_loopingprofile(prof, generator=gen(1))
    np.testing.assert_array_equal(a[:], b[:])


# -- table builds against bild_tpu ---------------------------------------------

def test_stationary_tables_equal_bild_tpu(models, rng):
    jm, tm = models
    data = rng.normal(size=(3, 23, 2))
    Vj = np.asarray(jm._stationary_tables_batch(data))
    Vt = tm._stationary_tables_batch(data).numpy()
    assert Vt.shape == (3, 2, 23, 24)
    np.testing.assert_allclose(Vt, Vj, atol=ATOL_TABLE)
    # the Toeplitz fast path against the bucketed path, gap-free
    Vb = tm._bucketed_tables_batch(data, np.ones((3, 23), bool)).numpy()
    np.testing.assert_allclose(Vt, Vb, atol=ATOL_TABLE)


def test_bucketed_tables_with_gaps_equal_bild_tpu(models, rng):
    jm, tm = models
    data, valid = gapped(rng, 3, 17)
    Vj = np.asarray(jm._bucketed_tables_batch(data, valid))
    Vt = tm._bucketed_tables_batch(data, valid).numpy()
    np.testing.assert_allclose(Vt, Vj, atol=ATOL_TABLE)
    # the dispatcher: Toeplitz rows and bucketed rows merged
    Vm = tm._build_interval_tables_batch(data, valid).numpy()
    np.testing.assert_allclose(Vm, Vj, atol=ATOL_TABLE)


def test_interval_table_equals_bild_tpu(models, rng):
    jm, tm = models
    data, valid = gapped(rng, 2, 14)
    d = np.where(valid[1][:, None], data[1], np.nan)
    Vj = np.asarray(jm.interval_table(bj.Trajectory.create(d)))
    tt = bt.Trajectory.create(d, dtype=F64)
    Vt = tm.interval_table(tt)
    assert Vt.shape == (2, 14, 15) and tm.interval_table(tt) is Vt
    np.testing.assert_allclose(Vt.numpy(), Vj, atol=ATOL_TABLE)


def test_padded_tail_is_built_without_it(models, rng):
    """Frames past every row's last observation (a length bucket's
    padding) go through the gap-free path at the real length; the
    padded table equals the bucketed path's on the padded data."""
    _, tm = models
    data = rng.normal(size=(2, 12, 2))
    pad = np.concatenate([data, np.zeros((2, 5, 2))], axis=1)
    valid = np.arange(17)[None, :] < np.array([12, 12])[:, None]
    V = tm._build_interval_tables_batch(pad, valid).numpy()
    np.testing.assert_allclose(
        V, tm._bucketed_tables_batch(pad, valid).numpy(), atol=ATOL_TABLE)
    np.testing.assert_array_equal(
        V[:, :, :12, :13], tm._stationary_tables_batch(data).numpy())


def test_banded_tables_equal_bild_tpu(rng):
    jm, tm = JG(band_spec(JG), T_band=48), TG(band_spec(TG), T_band=48, **CPU)
    data = rng.normal(size=(2, 120, 2))
    got = tm._banded_tables_batch(data, 48)
    want = jm._banded_tables_batch(data, 48)
    for g, w, shape in zip(got, want, [(2, 2, 120, 48), (2, 2, 120),
                                       (2, 2, 120)]):
        assert g.shape == shape and g.dtype == F64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL_TABLE)


def test_degenerate_covariance_falls_back_to_bucketed(rng):
    """A stationary covariance that does not factor (a flat MSD): one
    `cholesky_ex` status fetch per build, then the bucketed path, as
    `bild_tpu` falls back on `LinAlgError`."""
    flat = bt.physics.gp.MSDfun(lambda dt: 0.0 * dt)
    tm = TG([[(flat, 0.0, 1)], [(TG.MSD_function_powerlaw(), 0.0, 1)]], **CPU)
    data = rng.normal(size=(1, 9, 1))
    with pytest.raises(np.linalg.LinAlgError):
        tm._stationary_tables_batch(data)
    V = tm._build_interval_tables_batch(data, np.ones((1, 9), bool))
    assert torch.isnan(V[0, 0, 0, 3]) and torch.isfinite(V[0, 1]).all()


# -- likelihoods ---------------------------------------------------------------

def test_logL_batch_matches_host_and_bild_tpu(models, rng):
    """Mixed orders, missing frames including the first."""
    jm, tm = models
    T = 23
    data = rng.normal(size=(T, 2))
    data[[0, 3, 4, 11], :] = np.nan
    jt, tt = bj.Trajectory.create(data), bt.Trajectory.create(data, dtype=F64)
    profiles = rng.integers(0, 2, size=(30, T))
    got = tm.logL_batch(profiles, tt)
    assert got.dtype == F64 and got.shape == (30,)
    host = np.array([tm.logL_host(p, tt) for p in profiles])
    np.testing.assert_allclose(got.numpy(), host, rtol=RTOL_LOGL)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jm.logL_batch(profiles, jt)),
                               rtol=RTOL_LOGL)
    np.testing.assert_allclose(host, [jm.logL_host(p, jt) for p in profiles],
                               rtol=1e-12)
    assert tm.logL(profiles[0], tt) == pytest.approx(host[0], rel=RTOL_LOGL)


def test_three_states_with_imaging_match_host(rng):
    tm = TG([[(TG.MSD_function_twoLocusRouse(G=g, J=j, noise2=0.01,
                                             motion_blur_f=0.5), 0.0, 0)]
             for g, j in [(1.0, 5.0), (2.0, 1.0), (0.5, 0.5)]], **CPU)
    tt = bt.Trajectory.create(rng.normal(size=(17, 1)), dtype=F64)
    profiles = rng.integers(0, 3, size=(20, 17))
    host = np.array([tm.logL_host(p, tt) for p in profiles])
    np.testing.assert_allclose(tm.logL_batch(profiles, tt).numpy(), host,
                               rtol=RTOL_LOGL)


def test_lockstep_fns_lanes_match_host_and_bild_tpu(models, rng):
    """The lane form: profiles (L, P, T) against each lane's own tables."""
    jm, tm = models
    B, T, P = 3, 12, 7
    data, valid = gapped(rng, B, T)
    tb = TrajectoryBatch(data=torch.as_tensor(data), valid=torch.as_tensor(valid))
    jb = JBatch(data=jnp.asarray(data), valid=jnp.asarray(valid))
    profiles = rng.integers(0, 2, size=(B, P, T))
    for bound in (None, T):
        per_traj, fn = tm.lockstep_fns(tb, max_intervals=bound)
        got = fn(torch.as_tensor(profiles), per_traj)
        assert got.shape == (B, P)
        jper, jfn = jm.lockstep_fns(jb)
        for b in range(B):
            tt = bt.Trajectory.create(np.where(valid[b][:, None], data[b], np.nan),
                                      dtype=F64)
            want = [tm.logL_host(p, tt) for p in profiles[b]]
            np.testing.assert_allclose(got[b].numpy(), want, rtol=RTOL_LOGL)
            np.testing.assert_allclose(
                got[b].numpy(),
                np.asarray(jfn(jnp.asarray(profiles[b]),
                               jax.tree_util.tree_map(lambda x: x[b], jper))),
                rtol=RTOL_LOGL)
    # a lane's value does not depend on its partners (lane-exact sums)
    per_traj, fn = tm.lockstep_fns(tb, max_intervals=T)
    all_l = fn(torch.as_tensor(profiles), per_traj)
    one = fn(torch.as_tensor(profiles[1:2]), tuple(x[1:2] for x in per_traj))
    np.testing.assert_array_equal(all_l[1].numpy(), one[0].numpy())


@pytest.mark.parametrize("mode", ["full", "banded"])
def test_sparse_sums_equal_dense(mode, rng):
    """The sums at interval starts only against the sums over all frames,
    with a leading lane axis (rtol 1e-12: other summation order)."""
    T, L, P, Kcap = 60, 3, 9, 6
    tm = TG(band_spec(TG), T_band=16 if mode == "banded" else None, **CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")           # the band-error warning
        m, arrs, Lb = tm._tables_payload_batch(rng.normal(size=(L, T, 2)),
                                               np.ones((L, T), bool))
    assert m == mode
    profiles = np.zeros((L, P, T), dtype=int)
    for l in range(L):
        for p in range(P):
            cuts = np.sort(rng.choice(np.arange(1, T), size=p % Kcap,
                                      replace=False))
            for c in cuts:
                profiles[l, p, c:] = 1 - profiles[l, p, c - 1]
    profiles = torch.as_tensor(profiles)
    if mode == "full":
        dense = tggm._profile_table_sum(profiles, *arrs, 2)
        sparse = tggm._profile_table_sum_sparse(profiles, *arrs, 2, Kcap)
        tight = tggm._profile_table_sum_sparse(profiles, *arrs, 2, 3)
    else:
        dense = tggm._profile_table_sum_banded(profiles, *arrs, 2, Lb)
        sparse = tggm._profile_table_sum_banded_sparse(profiles, *arrs, 2,
                                                       Lb, Kcap)
        tight = tggm._profile_table_sum_banded_sparse(profiles, *arrs, 2,
                                                      Lb, 3)
    assert torch.isfinite(dense).all()
    np.testing.assert_allclose(sparse.numpy(), dense.numpy(), rtol=1e-12)
    # a profile with more intervals than the stated bound: NaN, not a
    # wrong sum
    n_iv = 1 + (profiles[..., 1:] != profiles[..., :-1]).sum(-1)
    np.testing.assert_array_equal(torch.isnan(tight).numpy(), (n_iv > 3).numpy())


def test_nan_contract(models, rng):
    """A state outside [0, n) gives NaN on every path; nothing raises."""
    _, tm = models
    tt = bt.Trajectory.create(rng.normal(size=(8, 2)), dtype=F64)
    profiles = np.array([[0, 1, 1, 0, 0, 1, 0, 0],
                         [0, 1, 2, 0, 0, 1, 0, 0],
                         [0, 1, 1, 0, 0, 1, 0, -1]])
    out = tm.logL_batch(profiles, tt).numpy()
    assert np.isfinite(out[0]) and np.all(np.isnan(out[1:]))
    tb = TrajectoryBatch(data=tt.data[None], valid=tt.valid[None])
    per, fn = tm.lockstep_fns(tb, max_intervals=8)
    out = fn(torch.as_tensor(profiles)[None], per)[0].numpy()
    assert np.isfinite(out[0]) and np.all(np.isnan(out[1:]))


# -- banded mode -----------------------------------------------------------------

def test_banded_exact_in_band_and_bounded_beyond(rng):
    T, band = 120, 48
    exact, banded = TG(band_spec(TG), **CPU), TG(band_spec(TG), T_band=band, **CPU)
    truth = np.zeros(T, dtype=int)
    truth[40:80] = 1              # every interval is 40 frames < band
    traj = exact.trajectory_from_loopingprofile(truth, rng=rng)
    p = np.zeros(T, int)
    for j in range(0, T, 40):
        p[j + 20: j + 40] = 1
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for prof in (truth, p):
            ll_e, ll_b = exact.logL(prof, traj), banded.logL(prof, traj)
            assert abs(ll_b - ll_e) < 1e-8 * max(1.0, abs(ll_e))
        # beyond the band: within the predicted worst-case tail error
        bound = banded.band_tail_error(T)
        assert bound > 0
        for prof in (np.zeros(T, int), np.ones(T, int)):
            err = abs(banded.logL(prof, traj) - exact.logL_host(prof, traj))
            assert err <= bound
    # T <= T_band: the banded model uses the exact tables
    short = bt.Trajectory.create(traj[:][:32], dtype=F64)
    assert banded.logL(truth[:32], short) == exact.logL(truth[:32], short)


def test_band_control(rng):
    spec = band_spec(TG)
    tm = TG(spec, T_band=16, band_tol=0.1, **CPU)
    jm = JG(band_spec(JG), T_band=16, band_tol=0.1)
    assert tm.band_tail_error(200) == pytest.approx(jm.band_tail_error(200),
                                                    rel=1e-12)
    assert tm.band_tail_error(10) == 0.0
    with pytest.warns(UserWarning, match="exceeds band_tol"):
        assert tm._resolve_band(200) == 16
    assert tm.band_error_estimate > 0.1
    with pytest.raises(ValueError, match="concrete"):
        TG(spec, T_band="auto", **CPU).band_tail_error(100)
    # 'auto': the smallest power-of-two band within tolerance, as bild_tpu
    auto = TG(spec, T_band="auto", band_tol=2.0, **CPU)
    jauto = JG(band_spec(JG), T_band="auto", band_tol=2.0)
    for T in (40, 200):
        W = auto._resolve_band(T)
        assert W == jauto._resolve_band(T)
        assert W is None or auto.band_tail_error(T, W) <= 2.0
    assert auto._auto_band_cache.keys() == {40, 200}
    assert TG(spec, T_band="auto", band_tol=1e-9, **CPU)._resolve_band(40) is None


def test_gapped_data_with_band_raises(rng):
    tm = TG(band_spec(TG), T_band=8, band_tol=1e9, **CPU)
    data = rng.normal(size=(20, 2))
    data[5] = np.nan
    with pytest.raises(ValueError, match="gap-free"):
        tm.logL(np.zeros(20, int), bt.Trajectory.create(data, dtype=F64))


# -- hooks and caches ------------------------------------------------------------

def test_initial_profile_and_segment_guess(rng):
    spec = lambda G: [[(G.MSD_function_twoLocusRouse(G=1.0, J=5.0), 0.1, 0)],
                      [(G.MSD_function_twoLocusRouse(G=0.05, J=1.0), 0.1, 0)]]
    jm, tm = JG(spec(JG)), TG(spec(TG), **CPU)
    true = np.zeros(40, dtype=int)
    true[15:30] = 1
    tt = tm.trajectory_from_loopingprofile(true, rng=rng)
    jt = bj.Trajectory.create(tt[:])
    np.testing.assert_allclose(tm._segment_table(tt), jm._segment_table(jt),
                               atol=ATOL_TABLE)
    guess = np.asarray(tm.initial_loopingprofile(tt)[:])
    assert np.mean(guess == true) > 0.8
    np.testing.assert_array_equal(guess, np.asarray(jm.initial_loopingprofile(jt)[:]))
    fr_t, th_t = tm.segment_guess(tt, 2)
    fr_j, th_j = jm.segment_guess(jt, 2)
    np.testing.assert_allclose(fr_t, fr_j, rtol=1e-12)
    np.testing.assert_array_equal(th_t, th_j)
    tb = stack_trajectories([tt, tt])
    seg = tm.lockstep_segment_tables(tb)
    assert seg.shape == (2, 2, 40)
    np.testing.assert_array_equal(seg[1], tm._segment_table(tt))
    # banded: the l = 1 column of the band
    bm = TG(spec(TG), T_band=16, band_tol=1e9, **CPU)
    np.testing.assert_allclose(bm._segment_table(tt), tm._segment_table(tt),
                               atol=ATOL_TABLE)


def test_tables_are_built_once_per_batch(rng):
    """Two `sample_batch` calls on one batch build the tables once, also
    when the runner has to move and trim the batch (new tensors each
    time); `clear_memo` and other data rebuild."""
    tm = TG(two_state_spec(TG), **CPU)
    trajs = [tm.trajectory_from_loopingprofile(np.zeros(12, int), rng=rng)
             for _ in range(2)]
    # float32 input, padded to 16: moved to float64 and trimmed to 12
    batch = stack_trajectories(trajs, T_pad=16, dtype=torch.float32)
    kw = dict(k_max=1, steps_per_k=2, N=8, informed_init=True)
    a = sample_batch(tm, batch, **kw, generator=gen(1))
    assert tm.table_builds == 1
    b = sample_batch(tm, batch, **kw, generator=gen(1))
    sample_batch_adaptive(tm, batch, k_max=1, N=8, max_steps_per_k=4,
                          init_steps=2, generator=gen(1))
    assert tm.table_builds == 1
    np.testing.assert_array_equal(a.evidence, b.evidence)
    assert a.map_profiles.shape == (2, 2, 16)
    tm.clear_memo()
    sample_batch(tm, batch, **kw, generator=gen(1))
    assert tm.table_builds == 2
    batch.data[0, 0] += 1.0                  # in place: a new version
    sample_batch(tm, batch, **kw, generator=gen(1))
    assert tm.table_builds == 3
    # the single-trajectory cache: every sampler of a sample() shares it
    tm.logL(np.zeros(12, int), trajs[0])
    tm.logL_batch(np.zeros((3, 12), int), trajs[0])
    assert tm.table_builds == 4
    tm.logL(np.zeros(12, int), trajs[1])
    assert tm.table_builds == 5


# -- the runners with a GGM ------------------------------------------------------

@pytest.fixture(scope="module")
def ggm_batch():
    tm = TG(two_state_spec(TG), **CPU)
    truths = np.zeros((3, 15), dtype=int)
    truths[1, 5:11] = 1
    truths[2, 8:] = 1
    trajs = [tm.trajectory_from_loopingprofile(truths[b],
                                               rng=np.random.default_rng(b))
             for b in range(3)]
    return tm, truths, trajs, stack_trajectories(trajs)


def test_no_nan_for_valid_profiles_at_k_max_34(rng):
    """`bild_tpu` caps the sparse sum at 33 interval slots and returns NaN
    beyond; here the slot count follows the runner's own bound."""
    tm = TG(two_state_spec(TG), **CPU)
    T = 40
    traj = tm.trajectory_from_loopingprofile(np.zeros(T, int), rng=rng)
    tb = stack_trajectories([traj])
    alternating = torch.as_tensor((np.arange(T) % 2)[None, None, :])   # 40 intervals
    per, fn = tm.lockstep_fns(tb, max_intervals=35)     # K1 at k_max = 34
    prof35 = alternating.clone()
    prof35[..., 34:] = prof35[..., 34]                  # 35 intervals
    got = fn(prof35, per)
    assert torch.isfinite(got).all()
    assert float(got[0, 0]) == pytest.approx(
        tm.logL_host(prof35[0, 0].numpy(), traj), rel=RTOL_LOGL)
    assert torch.isnan(fn(alternating, per)).all()       # beyond the bound
    assert torch.isfinite(tm.lockstep_fns(tb)[1](alternating, per)).all()
    bad = prof35.clone()
    bad[0, 0, 3] = 2
    assert torch.isnan(fn(bad, per)).all()               # state out of range
    res = sample_batch(tm, tb, k_max=34, steps_per_k=2, N=8, generator=gen(0))
    assert res.evidence.shape == (1, 35)
    assert np.isfinite(res.evidence).all() and res.mom_ok.all()


def test_sample_batch_schedules_agree_bit_for_bit(ggm_batch, tmp_path):
    tm, truths, _, tb = ggm_batch
    kw = dict(k_max=3, steps_per_k=5, N=16, informed_init=True, marginals=True)
    fused = sample_batch(tm, tb, **kw, generator=gen(0))
    assert fused.evidence.shape == (3, 4) and np.isfinite(fused.evidence).all()
    per_k = sample_batch(tm, tb, **kw, checkpoint=str(tmp_path / "ck.npz"),
                         generator=gen(0))
    two_phase = sample_batch(tm, tb, **kw, scout_steps=5, refine_top=2,
                             generator=gen(0))
    for other in (per_k, two_phase):
        np.testing.assert_array_equal(other.evidence, fused.evidence)
        np.testing.assert_array_equal(other.map_profiles, fused.map_profiles)
        np.testing.assert_array_equal(other.marginals, fused.marginals)
    # a sub-batch: a lane does not depend on the trajectories beside it
    sub = TrajectoryBatch(data=tb.data[1:], valid=tb.valid[1:],
                          lengths=tb.lengths[1:])
    lane_keys = sample_batch(tm, tb, **kw, ensemble=4, generator=gen(0))
    assert lane_keys.top_profiles.shape == (4, 3, 4, 15)
    assert sample_batch(tm, sub, **kw, generator=gen(0)).evidence.shape == (2, 4)


def test_matches_bild_tpu_sample_batch(ggm_batch):
    """The same batch through both packages (other random streams: the
    evidence curves agree within their spread, the decisions match)."""
    tm, truths, trajs, tb = ggm_batch
    jm = JG(two_state_spec(JG))
    jb = bj.parallel.stack_trajectories([bj.Trajectory.create(t[:])
                                         for t in trajs])
    kw = dict(k_max=2, steps_per_k=8, N=32)
    rj = bj.parallel.sample_batch(jm, jb, **kw, key=jax.random.key(0))
    rt = sample_batch(tm, tb, **kw, generator=gen(0))
    np.testing.assert_allclose(rt.evidence, rj.evidence, atol=1.0)
    np.testing.assert_array_equal(rt.best_k(dE=2.0), rj.best_k(dE=2.0))


def test_adaptive_lane_equals_lockstep_lane(ggm_batch):
    tm, _, _, tb = ggm_batch
    res = sample_batch_adaptive(tm, tb, k_max=3, N=16, max_steps_per_k=8,
                                init_steps=3, steps_per_round=2,
                                samplesize=512, informed_init=True,
                                generator=gen(4))
    np.testing.assert_array_equal(res.evals, 16 * res.steps.sum(1))
    for n in sorted(set(res.steps.ravel()) - {0}):
        lock = sample_batch(tm, tb, k_max=3, N=16, informed_init=True,
                            steps_per_k=int(n), generator=gen(4))
        sel = res.steps == n
        np.testing.assert_array_equal(res.evidence[sel], lock.evidence[sel])
        np.testing.assert_array_equal(
            res.map_profiles.transpose(1, 0, 2)[sel],
            lock.map_profiles.transpose(1, 0, 2)[sel])


def test_sample_dataset_and_boundary_climb(ggm_batch, tmp_path):
    tm, truths, trajs, tb = ggm_batch
    kw = dict(k_max=2, steps_per_k=4, N=16, optimize_boundaries=True,
              chunk_size=2, checkpoint_dir=str(tmp_path))
    a = bt.parallel.sample_dataset(tm, trajs, **kw, generator=gen(2))
    b = bt.parallel.sample_dataset(tm, trajs, **kw, generator=gen(2))
    np.testing.assert_array_equal(a.evidence, b.evidence)
    ad = bt.parallel.sample_dataset(tm, trajs, k_max=2, N=16,
                                    schedule="adaptive", init_steps=2,
                                    max_steps_per_k=6, samplesize=256,
                                    generator=gen(2))
    assert np.isfinite(ad.evidence[:, 0]).all()
    # the batched climb: row b equals the single-trajectory climb
    start = np.zeros((3, 15), dtype=int)
    start[:, 7:] = 1
    opt, elim = optimize_boundary_batch(start, tb, tm)
    assert not elim.any()
    for b_ in range(3):
        single = bt.postproc.optimize_boundary(start[b_], trajs[b_], tm)
        np.testing.assert_array_equal(opt[b_], np.asarray(single[:]))


def test_boundary_climb_on_banded_tables_in_a_padded_bucket(rng):
    """Banded tables refuse missing frames; the chunk's bucket padding is
    not one: the climb runs on the trimmed batch that sampling ran on, and
    its profiles come back at the trajectories' lengths."""
    tm = TG(two_state_spec(TG), T_band=8, band_tol=1e9, **CPU)
    true = np.zeros(12, dtype=int)
    true[4:9] = 1
    trajs = [tm.trajectory_from_loopingprofile(true, rng=rng) for _ in range(3)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        res = bt.parallel.sample_dataset(
            tm, trajs, k_max=2, steps_per_k=4, N=16, optimize_boundaries=True,
            bucket_edges=(16,), chunk_size=4, generator=gen(3))
    assert [len(p) for p in res.optimized] == [12, 12, 12]
    assert np.isfinite(res.evidence).all() and res.eliminated.shape == (3,)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        want, elim = optimize_boundary_batch(np.stack(res.best_profile()),
                                             stack_trajectories(trajs), tm)
    np.testing.assert_array_equal(np.stack(res.optimized), want)
    np.testing.assert_array_equal(res.eliminated, elim)


def test_sample_end_to_end_and_checkpoint(tmp_path):
    """`sample()` with a GGM, saved, loaded and resumed bit for bit."""
    tm = TG(two_state_spec(TG), **CPU)
    true = np.zeros(20, dtype=int)
    true[8:15] = 1
    traj = tm.trajectory_from_loopingprofile(true, rng=np.random.default_rng(5))
    res = bt.sample(traj, tm, init_runs=5, sampler_kw={"N": 20, "max_fev": 400},
                    k_max=4, generator=gen(2))
    assert len(res.k) >= 2 and np.all(np.isfinite(res.evidence))
    assert np.asarray(res.best_profile()[:]).shape == (20,)
    assert tm.table_builds == 1               # one table for every sampler
    # the exhaustive k = 0 evidence is the constant profiles' likelihood
    jm = JG(two_state_spec(JG))
    rj = bj.sample(bj.Trajectory.create(traj[:]), jm, init_runs=5,
                   sampler_kw={"N": 20, "max_fev": 400}, k_max=4,
                   key=jax.random.key(2))
    np.testing.assert_allclose(res.evidence[:2], rj.evidence[:2], rtol=1e-9)

    path = tmp_path / "ggm.npz"
    save_results(path, res)
    loaded = load_results(path, tm)
    np.testing.assert_array_equal(loaded.evidence, res.evidence)
    i = next(i for i, s in enumerate(res.samplers) if not s.exhausted)
    for s in (res.samplers[i], loaded.samplers[i]):
        assert s.steps(1) == 1
    assert res.samplers[i].evidences == loaded.samplers[i].evidences
    other = TG(two_state_spec(TG, J0=10.0), **CPU)
    with pytest.raises(ValueError, match="fingerprint"):
        load_results(path, other)


@pytest.mark.parametrize("kind", ["factorized", "ggm"])
def test_sample_goes_through_lockstep_fns_single(kind, rng, monkeypatch):
    """The single-trajectory sampler scores through the model's lockstep
    function (for a GGM the sparse sum), never through `logL_batch`: its
    lane form (`lockstep_fns_lane`), with the padded slot count K1 = k_max
    + 1 as every sampler's interval bound and one closure for all of
    them; `lockstep_fns_single` gives the same likelihoods."""
    if kind == "ggm":
        tm = TG(two_state_spec(TG), **CPU)
        traj = tm.trajectory_from_loopingprofile(np.zeros(14, int), rng=rng)
    else:
        tm = bt.models.FactorizedModel(
            [scipy.stats.maxwell(scale=0.3), scipy.stats.maxwell(scale=1.0)],
            d=3, **CPU)
        traj = bt.Trajectory.create(rng.normal(size=(14, 3)), dtype=F64)
    seen, fns = [], []
    real = type(tm).lockstep_fns_lane

    def spy(self, traj, max_intervals=None):
        seen.append(max_intervals)
        out = real(self, traj, max_intervals=max_intervals)
        fns.append(out[1])
        return out

    def forbidden(*a, **k):
        raise AssertionError("sample() must not call logL_batch")

    monkeypatch.setattr(type(tm), "lockstep_fns_lane", spy)
    single = tm.lockstep_fns_single(traj, max_intervals=4)
    lane = real(tm, traj, max_intervals=4)
    profiles = rng.integers(0, 2, size=(5, 14))
    profiles[:, 6:] = profiles[:, 6:7]            # at most 4 intervals each
    profiles[:, 1:5] = profiles[:, 1:2]
    want = tm.logL_batch(profiles, traj).numpy()
    np.testing.assert_allclose(single[1](profiles, single[0]).numpy(), want,
                               rtol=1e-12)
    np.testing.assert_allclose(
        lane[1](torch.as_tensor(profiles)[None], lane[0])[0].numpy(), want,
        rtol=1e-12)
    monkeypatch.setattr(type(tm), "logL_batch", forbidden)
    seen.clear()
    fns.clear()
    res = bt.sample(traj, tm, k_max=2, init_runs=2,
                    sampler_kw={"N": 8, "max_fev": 64, "max_fcomplete": 20},
                    generator=gen(0))
    assert seen == [3] * len(res.samplers)
    assert all(fn is fns[0] for fn in fns)
    assert np.isfinite(res.evidence).all()
