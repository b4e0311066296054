"""bild_tpu_torch.utils.checkpoint: a sample() result saved and loaded
gives the same evidence, best profile and marginals, and a loaded sampler
resumes with the step the saved one would have taken, bit for bit."""
import json

import jax
import numpy as np
import pytest
import torch

import bild_tpu as bj
import bild_tpu_torch as bt
from bild_tpu_torch.utils import load_results, save_results
import test_torch_kalman  # noqa: F401  (one torch thread per worker)

F64 = torch.float64


@pytest.fixture(scope="module")
def case():
    """N=10 monomers, T=40, a loop at frames 12-25, data made by bild_tpu
    (as test_torch_core.py)."""
    true = np.zeros(40, dtype=int)
    true[12:25] = 1
    jm = bj.models.MultiStateRouse(10, 1, 5, d=3, localization_error=0.1)
    tm = bt.models.MultiStateRouse(10, 1, 5, d=3, localization_error=0.1,
                                   device="cpu", dtype=F64)
    data = jm.trajectory_from_loopingprofile(true, key=jax.random.key(0))[:]
    return tm, data


def assert_same_results(a, b):
    np.testing.assert_array_equal(a.k, b.k)
    np.testing.assert_array_equal(a.evidence, b.evidence)
    np.testing.assert_array_equal(a.evidence_se, b.evidence_se)
    assert a.best_k() == b.best_k()
    np.testing.assert_array_equal(a.best_profile()[:], b.best_profile()[:])
    np.testing.assert_array_equal(a.log_marginal_posterior(dE=2),
                                  b.log_marginal_posterior(dE=2))
    for key in a.log:
        np.testing.assert_array_equal(a.log[key], b.log[key])


def test_roundtrip_and_resume(case, tmp_path):
    tm, data = case
    res = bt.sample(data, tm, k_max=3, init_runs=4,
                    sampler_kw={"informed_init": True},
                    generator=torch.Generator().manual_seed(3))
    path = tmp_path / "ck.npz"
    save_results(path, res)
    with np.load(path) as zf:
        meta = json.loads(bytes(zf["__meta__"]).decode())
        assert meta["model_fingerprint"] == tm.likelihood_fingerprint()
        assert {"traj_data", "traj_valid", "log_k",
                "s2_ss", "s2_key", "s0_ex_logLs"} <= set(zf.files)
    loaded = load_results(path, tm)
    assert_same_results(res, loaded)
    assert [s.exhausted for s in loaded.samplers] == [s.exhausted for s in res.samplers]

    # a non-exhausted sampler resumes with the uninterrupted step
    i = next(i for i, s in enumerate(res.samplers) if not s.exhausted)
    before = len(res.samplers[i].evidences)
    for s in (res.samplers[i], loaded.samplers[i]):
        assert s.steps(2) == 2
    a, b = res.samplers[i], loaded.samplers[i]
    assert len(a.evidences) == before + 2 and a.evidences == b.evidences
    for f, v in a.state.to_numpy().items():
        np.testing.assert_array_equal(v, b.state.to_numpy()[f], err_msg=f)


def test_unstepped_and_degenerate_samplers(case, tmp_path):
    """A sampler saved before its first step still injects its informed
    proposal after it; samplers with k >= T round-trip."""
    tm, data = case
    traj = bt.make_trajectory(data, dtype=F64)
    s = bt.amis.FixedkSampler(traj, tm, k=3, N=20, informed_init=True,
                              generator=torch.Generator().manual_seed(1))
    res = bt.SamplingResults(traj, tm, 0, [s], log=None)
    save_results(tmp_path / "s.npz", res)
    loaded = load_results(tmp_path / "s.npz", tm).samplers[0]
    s.step()
    loaded.step()
    np.testing.assert_array_equal(s.state.a_params.numpy(),
                                  loaded.state.a_params.numpy())
    assert s.evidences == loaded.evidences

    short = bt.make_trajectory(data[:3], dtype=F64)
    samplers = [bt.amis.FixedkSampler(short, tm, k=k) for k in range(4)]
    assert samplers[3].exhausted and not hasattr(samplers[3], "_lane")
    res = bt.SamplingResults(short, tm, 0, samplers, log=None)
    save_results(tmp_path / "short.npz", res)
    assert_same_results(res, load_results(tmp_path / "short.npz", tm))


def test_fingerprint_mismatch_raises(case, tmp_path):
    tm, data = case
    res = bt.sample(data[:8], tm, k_max=1, init_runs=2,
                    generator=torch.Generator().manual_seed(2))
    save_results(tmp_path / "f.npz", res)
    other = bt.models.MultiStateRouse(10, 1, 6, d=3, localization_error=0.1,
                                      device="cpu", dtype=F64)
    with pytest.raises(ValueError, match="fingerprint"):
        load_results(tmp_path / "f.npz", other)
