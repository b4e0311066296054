"""Config 4's structure (`bench_e2e.py::config4`: a three-state
`MultiStateRouse` with ``looppositions=(None, (0, -1), (0, 10))``, T=1000)
at a small width on the CPU in float64: the likelihood's plain recursions,
which the CUDA kernels are held to on the card, against `bild_tpu` at
T=1000 and three states; and the lockstep runner's informed init on
three-state score tables."""
import jax
import numpy as np
import pytest
import torch

import bild_tpu as bj
import bild_tpu_torch as bt
from bild_tpu.ops.kalman import msrouse_logL_batch as j_logL
from bild_tpu.parallel.batch import _informed_proposals_all_k_impl as j_informed
from bild_tpu_torch.infer.segment import dp_segment_all_batch
from bild_tpu_torch.ops import kalman
from bild_tpu_torch.ops.kalman_dense import msrouse_logL_dense_torch
from bild_tpu_torch.ops.kalman_sym import msrouse_logL_sym_torch
from bild_tpu_torch.parallel import TrajectoryBatch, sample_batch
from bild_tpu_torch.parallel.batch import _informed_proposals_all_k_impl
import test_torch_kalman  # noqa: F401  (one torch thread per worker)

F64 = torch.float64
RTOL = 1e-10
THREE = (None, (0, -1), (0, 10))
N_MONO = 12


def models():
    kw = dict(d=3, looppositions=THREE, localization_error=0.1)
    return (bj.models.MultiStateRouse(N_MONO, 1.0, 5.0, **kw),
            bt.models.MultiStateRouse(N_MONO, 1.0, 5.0, **kw, device="cpu",
                                      dtype=F64))


def segments(rng, T, n, k):
    """A profile of ``k`` switches at random frames, no state repeated
    across a switch."""
    cuts = np.sort(rng.choice(np.arange(1, T), size=k, replace=False))
    states = [int(rng.integers(n))]
    for _ in range(k):
        states.append(int(rng.choice([s for s in range(n) if s != states[-1]])))
    return np.asarray(states)[np.searchsorted(cuts, np.arange(T), side="right")]


@pytest.fixture(scope="module")
def long_case():
    """T=1000 data made by bild_tpu from a 4-switch truth, and 8 profiles:
    the truth, constants of each state, segment profiles, every-frame
    random."""
    rng = np.random.default_rng(4)
    T = 1000
    jm, tm = models()
    truth = segments(rng, T, 3, 4)
    traj = jm.trajectory_from_loopingprofile(truth, key=jax.random.key(4))
    prof = np.stack([truth] + [np.full(T, s) for s in range(3)]
                    + [segments(rng, T, 3, k) for k in (1, 3, 6)]
                    + [rng.integers(0, 3, size=T)]).astype(np.int32)
    return jm, tm, traj, prof


def test_plain_recursions_match_bild_tpu_at_T1000(long_case):
    """`ops.kalman` (the model's CPU path), the sym and the dense plain
    versions against bild_tpu's likelihood on 8 profiles."""
    jm, tm, jtraj, prof = long_case
    s2, Cind = jm._noise_arrays(jtraj)
    want = np.asarray(j_logL(jm.Bs, jm.Gs, jm.Sigs, jm.M0s, jm.C0s, jm.w, s2,
                             Cind, prof, jtraj.data, jtraj.valid))
    traj = bt.Trajectory.create(jtraj[:], dtype=F64)
    ts2, tCind = tm._noise_arrays(traj)
    prof_t = torch.as_tensor(prof)
    args = (tm.Bs, tm.Gs, tm.Sigs, tm.M0s, tm.C0s, tm.w, ts2, tCind, prof_t,
            traj.data, traj.valid)
    got = {
        "model": tm.logL_batch(prof_t, traj),
        "ops.kalman": kalman.msrouse_logL_batch(*args),
        "sym plain": msrouse_logL_sym_torch(tm.sym_operators(), ts2, tCind,
                                            prof_t, traj.data, traj.valid),
        "dense plain": msrouse_logL_dense_torch(*args),
    }
    assert want.shape == (8,) and np.all(np.isfinite(want))
    assert np.argmax(want) == 0                  # the truth wins
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want, rtol=RTOL, err_msg=name)


@pytest.fixture(scope="module")
def lockstep_case():
    """Two trajectories of T=300 (2 and 4 switches) made by bild_tpu, as a
    batch of each package."""
    rng = np.random.default_rng(5)
    T = 300
    jm, tm = models()
    truths = np.stack([segments(rng, T, 3, 2), segments(rng, T, 3, 4)])
    jbatch = jm.trajectories_from_loopingprofiles(truths, key=jax.random.key(5))
    tbatch = TrajectoryBatch(data=torch.as_tensor(np.array(jbatch.data)),
                             valid=torch.as_tensor(np.array(jbatch.valid)),
                             lengths=np.full(2, T))
    return jm, tm, jbatch, tbatch, truths


def test_informed_init_matches_bild_tpu(lockstep_case):
    """Three-state score tables, their DP segmentations for every k and the
    informed proposals built from them equal bild_tpu's."""
    jm, tm, jbatch, tbatch, truths = lockstep_case
    K1, n, T = 4, 3, tbatch.T
    tables = np.asarray(tm.lockstep_segment_tables(tbatch))
    jtables = np.asarray(jm.lockstep_segment_tables(jbatch))
    assert tables.shape == (2, n, T)
    np.testing.assert_allclose(tables, jtables, rtol=RTOL, atol=1e-12)

    from bild_tpu.infer.segment import dp_segment_all_batch as j_dp
    profs, feas = dp_segment_all_batch(tables, K1 - 1, tm.transitions)
    jprofs, jfeas = j_dp(tables, K1 - 1, jm.transitions)
    assert np.array_equal(feas, jfeas) and feas.all()
    for k in range(K1):
        assert np.array_equal(profs[k], jprofs[k])
        assert np.all(np.sum(np.diff(profs[k], axis=1) != 0, axis=1) == k)
    # the informed 2-switch segmentation finds the first truth's states
    assert np.mean(profs[2][0] == truths[0]) > 0.9

    got = _informed_proposals_all_k_impl(tm, tbatch, K1, n, T)
    want = j_informed(jm, jbatch, K1, n, T)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g, float), np.asarray(w, float),
                                   rtol=RTOL, atol=1e-12)


def test_sample_batch_three_states(lockstep_case):
    """The lockstep runner with informed init on the three-state batch:
    finite evidences for every k, profiles of the batch's shape."""
    _, tm, _, tbatch, truths = lockstep_case
    res = sample_batch(tm, tbatch, k_max=3, steps_per_k=3, N=16,
                       informed_init=True,
                       generator=torch.Generator().manual_seed(6))
    assert res.evidence.shape == (2, 4)
    assert np.all(np.isfinite(res.evidence)) and res.mom_ok.all()
    best = res.best_profile()
    assert best.shape == truths.shape
    assert set(np.unique(best)) <= {0, 1, 2}
