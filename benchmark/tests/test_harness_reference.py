"""The reference against bild_tpu_torch at a tiny size on the CPU: the same
operators, the same likelihoods, the same profiles from the same AMIS
parameters, the same prior. The reference itself imports nothing of the
program; only this test does."""
import json
import math

import numpy as np
import torch

import bild_tpu_torch as bt
from bild_tpu_torch.amis.cfc import CFC
from bild_tpu_torch.profiles import st2profile
from benchmark import harness
from benchmark.reference import check, kalman, rouse
from conftest import ROOT

LOOPS = {2: (None, (0, -1)), 3: (None, (0, -1), (0, 10))}
CONFIGS = {2: "rouse2-readme", 3: "rouse3-config4"}


def model(n):
    """The program's model of the ``n``-state configuration, in float64,
    as its model kind builds it."""
    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{CONFIGS[n]}.json").read_text())
    cfg["dtype"] = "float64"
    kind = harness.model_kind(ROOT, cfg)(bt, cfg, "cpu")
    return kind.model


def test_operators_are_the_programs():
    for n in (2, 3):
        got = rouse.operators(20, 1.0, 5.0, 3, 1.0, LOOPS[n])
        host = model(n).host
        for name in ("Bs", "Gs", "Sigs", "M0s", "C0s", "L_sigs", "L_sss", "w"):
            assert np.allclose(got[name], host[name], rtol=1e-12, atol=1e-14), name


def test_likelihoods_match_the_program():
    rng = np.random.default_rng(5)
    for n in (2, 3):
        m = model(n)
        T = 40
        truth = np.repeat(rng.integers(0, n, 4), T // 4)
        traj = m.trajectory_from_loopingprofile(
            truth, generator=torch.Generator().manual_seed(n))
        profiles = np.concatenate([truth[None], rng.integers(0, n, (15, T))])
        want = m.logL_batch(torch.as_tensor(profiles, dtype=torch.int32), traj).numpy()
        ops = kalman.Operators(rouse.operators(20, 1.0, 5.0, 3, 1.0, LOOPS[n]),
                               np.full(3, 0.1), "cpu")
        got = kalman.logL(ops, profiles, traj.data.numpy())
        assert np.max(np.abs(got - want) / np.abs(want)) < 1e-10
        # rows: one trajectory per profile gives the same
        rows = kalman.logL(ops, profiles, traj.data.numpy()[None].repeat(2, 0),
                           rows=np.arange(16) % 2)
        assert np.array_equal(rows, got)


def test_profiles_from_amis_parameters_bit_for_bit():
    g = torch.Generator().manual_seed(11)
    for k, K1, T in ((0, 3, 50), (1, 4, 100), (4, 21, 100), (6, 7, 1000)):
        ss = torch.distributions.Dirichlet(torch.ones(k + 1)).sample((500,)).float()
        ss = torch.cat([ss, torch.zeros(500, K1 - k - 1)], dim=1)
        th = torch.randint(0, 3, (500, K1), generator=g, dtype=torch.int32)
        active = torch.arange(K1) < k + 1
        want = st2profile(ss, th, T, active=active, exact=True).numpy()
        got = check.st2profile_f32(ss.numpy(), th.numpy(), T, k)
        assert np.array_equal(got, want)


def test_enumeration_and_prior():
    for n, k, T in ((2, 0, 30), (2, 1, 100), (3, 1, 20), (3, 2, 12)):
        every = check.enumerate_profiles(n, k, T)
        assert len(every) == rouse.n_traces(n, k) * math.comb(T - 1, k)
        assert len({tuple(p) for p in every}) == len(every)
        assert np.all(np.count_nonzero(np.diff(every, axis=1), axis=1) == k)
        cfc = CFC(model(n).transitions)
        assert math.isclose(rouse.log_prior(n, k),
                            math.lgamma(k + 1) - cfc.N_total(k, log=True))


def test_marginals_match_the_program():
    from bild_tpu_torch.amis.sampler import _marginal_posterior
    g = torch.Generator().manual_seed(13)
    for n, k, K1, T in ((2, 0, 3, 30), (2, 2, 5, 40), (3, 3, 7, 60)):
        ss = torch.distributions.Dirichlet(torch.ones(k + 1)).sample((300,)).float()
        ss = torch.cat([ss, torch.zeros(300, K1 - k - 1)], dim=1)
        th = torch.randint(0, n, (300, K1), generator=g, dtype=torch.int32)
        log_w = torch.randn(300, generator=g, dtype=torch.float64) * 3
        log_w[::7] = float("nan")
        active = torch.arange(K1) < k + 1
        want = _marginal_posterior(ss, th, log_w, T=T, nStates=n, active=active).exp().numpy()
        got = check._marginals(check.st2profile_f32(ss.numpy(), th.numpy(), T, k),
                               log_w.numpy(), n)
        assert np.max(np.abs(got - want)) < 1e-12


def test_an_undefined_draw_is_judged_by_its_weight():
    """A draw whose interval fractions are NaN has no defined profile: it is
    left out of the likelihoods where the program gives it no weight, and
    reads infinite where it does."""
    ss = np.array([[[0.3, 0.7], [np.nan, np.nan]]], dtype=np.float32)
    s = {"ss": ss, "thetas": np.array([[[0, 1], [1, 0]]]),
         "logLs": np.array([[-10.0, -99.0]]), "logdeltas": np.array([[0.5, np.nan]])}
    profiles, defined = check._sample_profiles(s, 10, 1)
    assert defined.tolist() == [True, False]
    assert np.array_equal(profiles[0], [0, 0, 0, 1, 1, 1, 1, 1, 1, 1])
    ref = np.array([-10.0, -12.0])
    assert check._scored_rel(s, ref, defined) == 0.0
    s["logdeltas"] = np.array([[0.5, 0.7]])
    assert check._scored_rel(s, ref, defined) == np.inf
