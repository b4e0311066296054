"""bild_tpu_torch.infer.adaptive against bild_tpu.infer.adaptive (float64):
the batched decision rule on shared evidence states and noise, the
adaptive runner on the shared 6-trajectory batch of test_torch_batch.py,
its lanes against the lockstep runner's bit for bit, the evaluation count
(exact where budget reallocation repeats a trajectory in one round), and
sample_dataset(schedule='adaptive') with chunk checkpoints."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bild_tpu as bj
import bild_tpu_torch as bt
from bild_tpu.infer.adaptive import decide_batch as j_decide
from bild_tpu.infer.adaptive import sample_batch_adaptive as j_adaptive
from bild_tpu_torch.infer import adaptive
from bild_tpu_torch.infer.adaptive import decide_batch, sample_batch_adaptive
from bild_tpu_torch.parallel import (TrajectoryBatch, sample_batch,
                                     sample_dataset, stack_trajectories)
from bild_tpu_torch.parallel import dataset as tds
import test_torch_kalman  # noqa: F401  (one torch thread per worker)
from test_torch_batch import truths

F64 = torch.float64
KW = dict(k_max=3, N=32, max_steps_per_k=10, init_steps=3, steps_per_round=2,
          samplesize=512, informed_init=True)
N_BOOT = 3            # lanes k = 0..k_lookahead bootstrapped


def gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def shared():
    """Models of both packages and the batch of test_torch_batch.py."""
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
def result(shared):
    _, tm, _, _, tb = shared
    return sample_batch_adaptive(tm, tb, **KW, marginals=True, generator=gen(5))


def random_states(rng, B, K_host, k_max):
    """Per-trajectory evidence states: every opened count from 1 to k_max +
    1 (bootstrap rows and rows at k_max), exhausted lanes and -inf lanes."""
    logE = np.full((B, K_host), -np.inf)
    varE = np.full((B, K_host), 1e-20)
    nst = np.full((B, K_host), np.inf)
    opened = np.arange(B) % (k_max + 1) + 1
    for b in range(B):
        for k in range(opened[b]):
            if rng.random() < 0.15:          # a k >= T sampler: -inf
                continue
            logE[b, k] = -100 * rng.random() - k * rng.random() * 5
            varE[b, k] = (0.1 + 2 * rng.random()) ** 2
            nst[b, k] = np.inf if rng.random() < 0.2 else rng.integers(1, 40)
    return logE, varE, nst, opened


def test_decide_batch_matches_bild_tpu(rng):
    K_host, k_max, k_lookahead, S = 8, 6, 2, 600
    logE, varE, nst, opened = random_states(rng, 56, K_host, k_max)
    noise = rng.standard_normal((S, K_host))
    kw = dict(margin=0.7, certainty=0.99, k_lookahead=k_lookahead, k_max=k_max)
    want = j_decide(jnp.asarray(logE), jnp.asarray(varE), jnp.asarray(nst),
                    jnp.asarray(opened), jnp.asarray(noise), **kw)
    got = decide_batch(*(torch.as_tensor(x) for x in (logE, varE, nst)),
                       torch.as_tensor(opened), torch.as_tensor(noise), **kw)
    for key in ("k_next", "is_open", "keep_going"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    for key in ("pk", "KLD", "I_la"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=1e-12, err_msg=key)
    # the cases cover opening, continuing and stopping
    assert got["is_open"].any() and (~got["is_open"]).any()
    assert (~got["keep_going"]).any()
    packed = adaptive._decide_packed(
        *(torch.as_tensor(x) for x in (logE, varE, nst)),
        torch.as_tensor(opened), torch.as_tensor(noise), **kw)
    assert packed.shape == (56, K_host + 3)
    np.testing.assert_array_equal(packed[:, 3:].numpy(), got["KLD"].numpy())


def test_matches_bild_tpu(shared, result):
    jm, _, prof, jb, _ = shared
    rj = j_adaptive(jm, jb, **KW, key=jax.random.key(5))
    rt = result
    assert rt.evidence.shape == rj.evidence.shape == (6, 4)
    assert rt.map_profiles.shape == rj.map_profiles.shape == (4, 6, 40)
    np.testing.assert_array_equal(rt.best_k(dE=2), rj.best_k(dE=2))
    true_k = np.sum(prof[:, 1:] != prof[:, :-1], axis=1)
    np.testing.assert_array_equal(rt.best_k(dE=2), true_k)
    for res in (rj, rt):
        assert np.mean(res.best_profile(dE=2) == prof) >= 0.95
        assert res.mom_ok.all() and res.rounds >= 1
    assert np.isfinite(rt.evidence[:, 0]).all()
    post = rt.log_marginal_posterior(dE="average")
    np.testing.assert_allclose(np.exp(post).sum(1), 1.0, rtol=1e-10)


def test_lanes_equal_the_lockstep_runner_bit_for_bit(shared, result):
    """A lane that ran n steps (bootstrap, then rounds that advanced it
    beside slots at other step counts) equals lane (k, b) of the lockstep
    runner run n steps with the same generator."""
    _, tm, _, _, tb = shared
    kw = {k: KW[k] for k in ("k_max", "N", "informed_init")}
    ns = sorted(set(result.steps.ravel()) - {0})
    assert max(ns) > KW["init_steps"]
    for n in ns:
        lock = sample_batch(tm, tb, **kw, steps_per_k=int(n), marginals=True,
                            generator=gen(5))
        sel = result.steps == n
        np.testing.assert_array_equal(result.evidence[sel], lock.evidence[sel])
        np.testing.assert_array_equal(result.evidence_se[sel],
                                      lock.evidence_se[sel])
        np.testing.assert_array_equal(result.map_profiles.transpose(1, 0, 2)[sel],
                                      lock.map_profiles.transpose(1, 0, 2)[sel])
        np.testing.assert_allclose(result.marginals.transpose(1, 0, 2, 3)[sel],
                                   lock.marginals.transpose(1, 0, 2, 3)[sel],
                                   rtol=1e-12, atol=1e-12)


def test_run_slots_at_mixed_steps_equals_run_lanes(shared):
    """Two copies of one lane, the second started two steps later, in one
    run_slots call: each equals run_lanes at its own step count."""
    from bild_tpu_torch.amis.cfc import CFC
    from bild_tpu_torch.amis.sampler import AmisState
    from bild_tpu_torch.lanes import LaneRNG
    from bild_tpu_torch.parallel.batch import run_lanes
    _, tm, _, _, tb = shared
    per_traj, logL_fn = tm.lockstep_fns(tb)
    cfc = CFC(tm.transitions)
    n, S, N, k = cfc.n, 6, 16, 2
    a0 = np.ones((1, 3))
    logp0 = np.asarray(cfc.logp_uniform(k))[None]
    act = torch.ones((1, 3), dtype=torch.bool)
    args = (torch.as_tensor(tm.transitions), act, torch.zeros(1), 0.16, 0.016)
    data = tuple(x[2:3] for x in per_traj)
    rng = LaneRNG.from_seeds([123], "cpu")

    def fresh():
        return AmisState.create(S, N, k, n, a0, logp0, device="cpu",
                                dtype=F64, lanes=1)

    ref = {s: run_lanes(logL_fn, data, fresh(), rng, *args, N=N, T=40,
                        start=0, stop=s) for s in (2, 5)}
    two = ref[2]
    two.n_steps = torch.tensor([2])
    zero = fresh()
    zero.n_steps = torch.tensor([0])
    both = adaptive._cat(two, zero)
    out = adaptive.run_slots(
        logL_fn, tuple(torch.cat([x, x]) for x in data), both,
        LaneRNG(torch.cat([rng.keys, rng.keys])),
        args[0], torch.cat([act, act]), torch.zeros(2), *args[3:],
        N=N, T=40, steps=3, live=torch.tensor([True, True]))
    for lane, want in ((0, ref[5]), (1, run_lanes(
            logL_fn, data, fresh(), rng, *args, N=N, T=40, start=0, stop=3))):
        assert int(out.n_steps[lane]) == want.n_steps
        for f in ("ss", "thetas", "logLs", "logdeltas", "a_params", "logps",
                  "evidences", "mom_ok"):
            assert torch.equal(getattr(out, f)[lane], getattr(want, f)[0]), f
    # a dead slot and a full lane come back unchanged
    held = adaptive.run_slots(
        logL_fn, tuple(torch.cat([x, x]) for x in data), out,
        LaneRNG(torch.cat([rng.keys, rng.keys])), args[0],
        torch.cat([act, act]), torch.zeros(2), *args[3:], N=N, T=40, steps=2,
        live=torch.tensor([True, False]))
    assert held.n_steps.tolist() == [6, 3]
    assert torch.equal(held.logLs[1], out.logLs[1])
    full = adaptive.run_slots(
        logL_fn, data, held.select(torch.tensor([0])), rng, args[0], act,
        torch.zeros(1), *args[3:], N=N, T=40, steps=1, live=torch.tensor([True]))
    assert int(full.n_steps[0]) == S
    assert torch.equal(full.a_params, held.a_params[:1])


def test_evals_count_with_reallocation(shared, result):
    """evals[b] == N * sum_k steps[b, k], also where reallocation advanced
    several lanes of one trajectory in one round (bild_tpu's `+=` counted
    only one of them)."""
    steps, N = result.steps, KW["N"]
    np.testing.assert_array_equal(result.evals, N * steps.sum(axis=1))
    one_slot_max = N_BOOT * KW["init_steps"] + KW["steps_per_round"] * result.rounds
    assert (steps.sum(axis=1) > one_slot_max).any()
    assert (steps[:, :N_BOOT] >= KW["init_steps"]).all()


def test_same_generator_same_bits(shared, result):
    _, tm, _, _, tb = shared
    again = sample_batch_adaptive(tm, tb, **KW, marginals=True, generator=gen(5))
    for f in ("evidence", "evidence_se", "map_profiles", "marginals",
              "mom_ok", "evals", "steps"):
        np.testing.assert_array_equal(getattr(again, f), getattr(result, f))
    assert again.rounds == result.rounds


def test_reallocate_off(shared):
    _, tm, prof, _, tb = shared
    res = sample_batch_adaptive(tm, tb, **KW, reallocate=False, generator=gen(6))
    assert np.isfinite(res.evidence[:, 0]).all()
    assert np.mean(res.best_profile(dE=2) == prof) >= 0.9
    one_slot_max = N_BOOT * KW["init_steps"] + KW["steps_per_round"] * res.rounds
    assert (res.steps.sum(axis=1) <= one_slot_max).all()
    np.testing.assert_array_equal(res.evals, KW["N"] * res.steps.sum(axis=1))


def test_length_guard():
    tm = bt.models.MultiStateRouse(8, 1.0, 5.0, d=2, localization_error=0.1,
                                   device="cpu", dtype=F64)
    rng = np.random.default_rng(4)
    trajs = [bt.Trajectory.create(rng.standard_normal((T, 2)), dtype=F64)
             for T in (3, 40)]
    res = sample_batch_adaptive(tm, stack_trajectories(trajs), k_max=4, N=16,
                                max_steps_per_k=8, init_steps=2,
                                steps_per_round=2, samplesize=256,
                                informed_init=False, generator=gen(5))
    assert np.all(res.evidence[0, 3:] == -np.inf)
    assert np.all(np.isfinite(res.evidence[0, :1]))
    assert np.all(np.isfinite(res.evidence[1, :3]))
    assert res.map_profiles.shape == (5, 2, 40)


def test_argument_guards(shared):
    _, tm, _, _, tb = shared
    with pytest.raises(ValueError, match="init_steps"):
        sample_batch_adaptive(tm, tb, init_steps=0)
    with pytest.raises(ValueError, match="init_steps"):
        sample_batch_adaptive(tm, tb, init_steps=30, max_steps_per_k=8)
    with pytest.raises(ValueError, match="steps_per_round"):
        sample_batch_adaptive(tm, tb, steps_per_round=0)


def test_sample_dataset_adaptive(shared, tmp_path, monkeypatch):
    _, tm, prof, _, tb = shared
    trajs = [bt.Trajectory(data=tb.data[i], valid=tb.valid[i]) for i in range(6)]
    kw = dict(**KW, schedule="adaptive", chunk_size=3,
              checkpoint_dir=str(tmp_path))
    res = sample_dataset(tm, trajs, **kw, generator=gen(12))
    assert len(os.listdir(tmp_path)) == 2
    assert res.evals.shape == (6,) and (res.evals > 0).all()
    assert np.mean(np.concatenate(res.best_profile(dE=2)) == prof.ravel()) >= 0.95

    def no_run(*a, **k):
        raise AssertionError("a chunk was recomputed")

    monkeypatch.setattr(tds, "sample_batch_adaptive", no_run)
    again = sample_dataset(tm, trajs, **kw, generator=gen(12))
    np.testing.assert_array_equal(again.evidence, res.evidence)
    np.testing.assert_array_equal(again.evals, res.evals)
    for a, b in zip(again.profiles_by_k, res.profiles_by_k):
        np.testing.assert_array_equal(a, b)
