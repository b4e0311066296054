"""bild_tpu_torch.parallel.sample_batch end to end against
bild_tpu.parallel.sample_batch on one shared 6-trajectory batch made by
bild_tpu (float64), and the runner's schedules: the all-k lane set, the
per-k checkpointed one and the scout/refine one give the same numbers for
the same generator."""
import jax
import numpy as np
import pytest
import torch

import bild_tpu as bj
import bild_tpu_torch as bt
from bild_tpu.parallel import sample_batch as j_sample_batch
from bild_tpu_torch.parallel import TrajectoryBatch, sample_batch
import test_torch_kalman  # noqa: F401  (one torch thread per worker)

F64 = torch.float64
KW = dict(k_max=3, steps_per_k=8, N=48, informed_init=True)


def truths(B=6, T=40):
    prof = np.zeros((B, T), dtype=int)
    prof[1, 12:30] = 1
    prof[2, 20:] = 1
    prof[3, 4:16] = 1
    prof[3, 28:] = 1
    prof[4, :] = 1
    prof[5, 8:22] = 1
    return prof


@pytest.fixture(scope="module")
def shared():
    """Models of both packages and one batch made by bild_tpu."""
    kw = dict(N=8, D=1.0, k=5.0, d=3, localization_error=0.1)
    jm = bj.models.MultiStateRouse(**kw)
    tm = bt.models.MultiStateRouse(**kw, device="cpu", dtype=F64)
    prof = truths()
    jb = jm.trajectories_from_loopingprofiles(prof, key=jax.random.key(0))
    tb = TrajectoryBatch(data=torch.as_tensor(np.array(jb.data)),
                         valid=torch.as_tensor(np.array(jb.valid)),
                         lengths=np.asarray(jb.lengths))
    return jm, tm, prof, jb, tb


@pytest.fixture(scope="module")
def fused(shared):
    _, tm, _, _, tb = shared
    return sample_batch(tm, tb, **KW, marginals=True,
                        generator=torch.Generator().manual_seed(5))


def test_matches_bild_tpu(shared, fused):
    jm, _, prof, jb, _ = shared
    rj = j_sample_batch(jm, jb, **KW, key=jax.random.key(5))
    rt = fused
    assert rt.evidence.shape == rj.evidence.shape == (6, 4)
    assert rt.map_profiles.shape == rj.map_profiles.shape == (4, 6, 40)
    np.testing.assert_array_equal(rt.best_k(dE=2), rj.best_k(dE=2))
    true_k = np.sum(prof[:, 1:] != prof[:, :-1], axis=1)
    np.testing.assert_array_equal(rt.best_k(dE=2), true_k)
    for res in (rj, rt):
        assert np.mean(res.best_profile(dE=2) == prof) >= 0.95
        assert res.mom_ok.all()
    assert np.isfinite(rt.evidence).all()
    assert rt.marginals.shape == (4, 6, 2, 40)
    np.testing.assert_allclose(np.exp(rt.marginals).sum(2), 1.0, rtol=1e-10)
    post = rt.log_marginal_posterior(dE="average")
    assert post.shape == (6, 2, 40)
    np.testing.assert_allclose(np.exp(post).sum(1), 1.0, rtol=1e-10)


def test_per_k_checkpoint_equals_fused_and_resumes(shared, fused, tmp_path):
    _, tm, _, _, tb = shared
    ck = str(tmp_path / "ck.npz")
    run = lambda seed=5, **kw: sample_batch(  # noqa: E731
        tm, tb, **{**KW, **kw}, marginals=True, checkpoint=ck,
        generator=torch.Generator().manual_seed(seed))
    per_k = run()
    for f in ("evidence", "evidence_se", "map_profiles", "marginals", "mom_ok"):
        np.testing.assert_array_equal(getattr(per_k, f), getattr(fused, f))
    # simulate a run killed after k=1: resume redoes k=2, 3 only
    ck_arrays = dict(np.load(ck))
    assert int(ck_arrays["next_k"]) == 4
    np.savez(ck, **{**ck_arrays, "next_k": 2,
                    **{f: ck_arrays[f][:2] for f in ("evs", "maps", "margs", "moms")}})
    resumed = run()
    np.testing.assert_array_equal(resumed.evidence, fused.evidence)
    np.testing.assert_array_equal(resumed.marginals, fused.marginals)
    with pytest.raises(ValueError, match="configuration"):
        run(k_max=2)
    with pytest.raises(ValueError, match="tag"):
        run(seed=6)


def test_scout_refine_continues_the_straight_run(shared, fused):
    """A refined (trajectory, k) ends exactly as a straight steps_per_k run;
    the others keep their scout result."""
    _, tm, _, _, tb = shared
    gen = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    scout = sample_batch(tm, tb, **KW, marginals=True, scout_steps=3,
                         refine_top=0, generator=gen())
    refined = sample_batch(tm, tb, **KW, marginals=True, scout_steps=3,
                           refine_top=2, generator=gen())
    straight = refined.evidence == fused.evidence
    kept = refined.evidence == scout.evidence
    assert np.all(straight | kept)
    assert np.all(straight.sum(1) >= 2)
    np.testing.assert_array_equal(refined.map_profiles.transpose(1, 0, 2)[straight],
                                  fused.map_profiles.transpose(1, 0, 2)[straight])
    np.testing.assert_array_equal(refined.marginals.transpose(1, 0, 2, 3)[straight],
                                  fused.marginals.transpose(1, 0, 2, 3)[straight])


def test_tail_trim_and_length_guard(shared, fused):
    """A batch padded past every true length runs trimmed (same numbers)
    and is edge-padded back; k at or beyond a trajectory's length is -inf."""
    _, tm, _, _, tb = shared
    pad = TrajectoryBatch(
        data=torch.cat([tb.data, torch.zeros((6, 8, 3), dtype=F64)], dim=1),
        valid=torch.cat([tb.valid, torch.zeros((6, 8), dtype=torch.bool)], dim=1),
        lengths=tb.lengths)
    res = sample_batch(tm, pad, **KW, marginals=True,
                       generator=torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(res.evidence, fused.evidence)
    assert res.map_profiles.shape == (4, 6, 48)
    np.testing.assert_array_equal(res.map_profiles[..., :40], fused.map_profiles)
    assert np.all(res.map_profiles[..., 40:] == res.map_profiles[..., 39:40])
    np.testing.assert_allclose(np.exp(res.marginals[..., 40:]), 0.5)

    short = TrajectoryBatch(data=tb.data[:2, :3], valid=tb.valid[:2, :3],
                            lengths=np.array([3, 2]))
    r = sample_batch(tm, short, k_max=4, steps_per_k=2, N=16,
                     generator=torch.Generator().manual_seed(0))
    assert np.isneginf(r.evidence[0, 3:]).all() and np.isfinite(r.evidence[0, :3]).all()
    assert np.isneginf(r.evidence[1, 2:]).all() and np.isfinite(r.evidence[1, :2]).all()
    assert r.map_profiles.shape == (5, 2, 3)


def test_ensemble_and_argument_checks(shared, tmp_path):
    _, tm, _, _, tb = shared
    res = sample_batch(tm, tb, k_max=2, steps_per_k=3, N=16, ensemble=5,
                       generator=torch.Generator().manual_seed(1))
    assert res.top_profiles.shape == (3, 6, 5, 40)
    profs, w = res.profile_ensemble()
    assert profs.shape == (6, 5, 40)
    np.testing.assert_allclose(w.sum(1), 1.0, rtol=1e-12)
    for bad in (dict(mesh=object()), dict(row_keys=[1]),
                dict(lockstep=(None, None)), dict(informed_arrays=(1, 2, 3))):
        with pytest.raises(NotImplementedError, match="queue 1 item 16"):
            sample_batch(tm, tb, k_max=1, steps_per_k=2, N=8, **bad)
    with pytest.raises(ValueError, match="checkpoint"):
        sample_batch(tm, tb, k_max=1, steps_per_k=4, N=8, scout_steps=2,
                     checkpoint=str(tmp_path / "x.npz"))
    with pytest.raises(ValueError, match="scout_steps"):
        sample_batch(tm, tb, k_max=1, steps_per_k=4, N=8, scout_steps=0)
    with pytest.raises(ValueError, match="ensemble"):
        sample_batch(tm, tb, k_max=1, steps_per_k=2, N=8, ensemble=100)


def test_batch_helpers_match_bild_tpu(rng):
    from bild_tpu.parallel import batch as jbatch
    from bild_tpu_torch.parallel import batch as tbatch
    datas = [rng.normal(size=(T, 2)) for T in (5, 9, 3, 12, 9)]
    datas[1][[0, 4]] = np.nan
    jt = [bj.Trajectory.create(x) for x in datas]
    tt = [bt.Trajectory.create(x, dtype=F64) for x in datas]
    for (ji, jb), (ti, tb) in zip(jbatch.bucket_trajectories(jt, (4, 10)),
                                  tbatch.bucket_trajectories(tt, (4, 10))):
        np.testing.assert_array_equal(ti, ji)
        jp, tp = jbatch.pad_batch_rows(jb, 2), tbatch.pad_batch_rows(tb, 2)
        for f in ("data", "valid", "lengths"):
            np.testing.assert_array_equal(np.asarray(getattr(tp, f)),
                                          np.asarray(getattr(jp, f)))
    with pytest.raises(ValueError, match="T_pad"):
        tbatch.stack_trajectories(tt, T_pad=4)
    assert tbatch.pad_batch_rows(tb, 0) is tb


def test_factorized_model_matches_bild_tpu():
    """The runner with the factorized likelihood (a gather-sum per lane),
    on trajectories made by bild_tpu, informed init on."""
    import scipy.stats
    dists = [scipy.stats.maxwell(scale=0.3), scipy.stats.maxwell(scale=1.0)]
    jm = bj.models.FactorizedModel(dists, d=3)
    tm = bt.models.FactorizedModel(dists, d=3, device="cpu", dtype=F64)
    prof = truths(T=30)[:5]
    datas = [jm.trajectory_from_loopingprofile(p, key=jax.random.key(i))[:]
             for i, p in enumerate(prof)]
    jb = bj.parallel.stack_trajectories([bj.Trajectory.create(x) for x in datas])
    tb = bt.parallel.stack_trajectories([bt.Trajectory.create(x, dtype=F64)
                                         for x in datas])
    kw = dict(k_max=3, steps_per_k=6, N=32, informed_init=True)
    rj = j_sample_batch(jm, jb, **kw, key=jax.random.key(1))
    rt = sample_batch(tm, tb, **kw, generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(rt.best_k(dE=2), rj.best_k(dE=2))
    for res in (rj, rt):
        assert np.mean(res.best_profile(dE=2) == prof) >= 0.9
        assert res.mom_ok.all() and np.isfinite(res.evidence).all()
