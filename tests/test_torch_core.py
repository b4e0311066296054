"""The whole slice: bild_tpu_torch.sample against bild_tpu.sample on the
same data, and the package's import boundary."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import bild_tpu as bj
import bild_tpu_torch as bt
from bild_tpu_torch.amis.sampler import FixedkSampler
import test_torch_kalman  # noqa: F401  (one torch thread per worker)

F64 = torch.float64
REPO = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module")
def case():
    """N=10 monomers, T=40, a loop at frames 12-25, data made by bild_tpu."""
    true = np.zeros(40, dtype=int)
    true[12:25] = 1
    jm = bj.models.MultiStateRouse(10, 1, 5, d=3, localization_error=0.1)
    tm = bt.models.MultiStateRouse(10, 1, 5, d=3, localization_error=0.1,
                                   device="cpu", dtype=F64)
    data = jm.trajectory_from_loopingprofile(true, key=jax.random.key(0))[:]
    return true, jm, tm, data


def test_sample_matches_bild_tpu(case):
    true, jm, tm, data = case
    rj = bj.sample(bj.Trajectory.create(data), jm, k_max=4,
                   key=jax.random.key(7))
    rt = bt.sample(data, tm, k_max=4, generator=torch.Generator().manual_seed(7))
    # the exhaustive k=0, 1 evidences are deterministic
    np.testing.assert_allclose(rt.evidence[:2], rj.evidence[:2], rtol=1e-10)
    assert rt.best_k(dE=2) == rj.best_k(dE=2)
    for res in (rj, rt):
        assert np.mean(np.asarray(res.best_profile()[:]) == true) >= 0.85
    post = rt.log_marginal_posterior(dE="average")
    assert post.shape == (2, 40)
    np.testing.assert_allclose(np.exp(post).sum(0), 1.0, rtol=1e-10)
    assert rt.log["k"].shape == rt.log["pk"].shape[:1]


def test_sample_reproducible_from_generator(case):
    _, _, tm, data = case
    a, b = (bt.sample(data, tm, k_max=3, init_runs=4,
                      generator=torch.Generator().manual_seed(3))
            for _ in range(2))
    np.testing.assert_array_equal(a.evidence, b.evidence)
    np.testing.assert_array_equal(a.log["k"], b.log["k"])


def test_fixedk_sampler_views(case):
    true, _, tm, data = case
    traj = bt.make_trajectory(data, dtype=F64)
    s = FixedkSampler(traj, tm, k=2, N=50, max_fev=500, k_pad=4,
                      generator=torch.Generator().manual_seed(1))
    assert not s.exhausted and s.n_steps_host == 0
    assert s.steps(3) == 3 and s.step()
    assert s.n_steps_host == 4 and len(s.evidences) == 4
    samples = s.samples
    assert len(samples) == 4 and samples[0]["ss"].shape == (50, 5)
    assert len(s.parameters) == 5
    assert len(s.MAP_profile()) == 40
    lp = s.log_proposal(s.parameters[0], samples[0]["ss"], samples[0]["thetas"])
    assert lp.shape == (50,)
    # the stored samples are padded to k_pad slots; logL takes exact-size ones
    np.testing.assert_allclose(
        s.logL(samples[0]["ss"][:, :3], samples[0]["thetas"][:, :3]).numpy(),
        samples[0]["logLs"], rtol=1e-12)
    while s.step():
        pass
    assert s.exhausted and s.n_steps_host == s.S == 9
    ex = FixedkSampler(traj, tm, k=1, generator=torch.Generator().manual_seed(1))
    assert ex.exhausted and ex.samples[0]["logLs"].shape == (2 * 39,)
    assert np.mean(np.asarray(ex.MAP_profile()[:]) == true) > 0.5
    assert FixedkSampler(traj, tm, k=40).evidences[0][0] == -np.inf


def test_informed_init_matches_bild_tpu(case):
    """sample() runs with informed init, and FixedkSampler's informed
    mixture component (the DP segmentation of the factorized scores) equals
    bild_tpu's for the same trajectory."""
    true, jm, tm, data = case
    res = bt.sample(data, tm, k_max=3, init_runs=4,
                    sampler_kw={"informed_init": True},
                    generator=torch.Generator().manual_seed(2))
    assert np.mean(np.asarray(res.best_profile()[:]) == true) >= 0.85
    traj = bt.make_trajectory(data, dtype=F64)
    for k in (2, 3):
        ts = FixedkSampler(traj, tm, k=k, k_pad=5, informed_init=True,
                           generator=torch.Generator().manual_seed(1))
        js = bj.amis.FixedkSampler(bj.Trajectory.create(data), jm, k=k,
                                   k_pad=5, informed_init=True,
                                   key=jax.random.key(1))
        for got, want in zip(ts._informed, js._informed):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-12)


def test_import_pulls_in_neither_jax_nor_bild_tpu():
    code = ("import sys; import bild_tpu_torch; "
            "from bild_tpu_torch.ops import _build; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'bild_tpu')); "
            "assert not bad, bad; assert _build.build_seconds == {}; print('ok')")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=os.path.abspath(REPO),
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_sources_import_no_jax():
    pkg = os.path.join(REPO, "bild_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    src = fh.read()
                for bad in ("import jax", "from jax", "import bild_tpu\n",
                            "from bild_tpu ", "from bild_tpu.", "import bild_tpu."):
                    assert bad not in src, (f, bad)


def test_nvcc_lookup_fails_cleanly(monkeypatch, tmp_path):
    from bild_tpu_torch.ops import _build
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
