"""A model the user writes (only ``nStates``, ``transitions`` and
``logL_batch``) through the port's `FixedkSampler` and `sample()`: the
sampler's fallback path, which converts whatever array-like the model
returns (a tensor of either float type, a numpy array, a list) to the
trajectory's device and dtype, as `bild_tpu` converts with
``np.asarray``/``jnp.asarray``. Exhaustive evidences are held against
`bild_tpu` on the same model and data; built-in models keep their bits."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bild_tpu as bj
import bild_tpu_torch as bt
from bild_tpu.amis.sampler import FixedkSampler as JFixedkSampler
from bild_tpu_torch.amis.sampler import FixedkSampler
import test_torch_kalman  # noqa: F401  (one torch thread per worker)

F64 = torch.float64
KINDS = ("tensor64", "tensor32", "numpy", "list")
MUS = (0.0, 3.0)


class IIDGaussianModel:
    """Two-state iid model (as `tests/test_custom_model.py`'s): state s
    emits N(mu_s, 1) per frame. ``kind`` picks what `logL_batch` returns;
    ``calls`` counts its calls and ``seen`` records the profiles' dtype,
    device and shape."""

    def __init__(self, kind):
        self.kind = kind
        self.mus = torch.tensor(MUS, dtype=F64)
        self.nStates = len(MUS)
        self.transitions = ~np.eye(self.nStates, dtype=bool)
        self.device = "cpu"
        self.dtype = F64
        self.calls = 0
        self.seen = set()

    def logL_batch(self, profiles, traj):
        self.calls += 1
        self.seen.add((profiles.dtype, profiles.device, profiles.dim()))
        y = traj.data[:, 0].to(F64)
        mu = self.mus.to(y.device)[profiles.long()]
        ll = (-0.5 * ((y[None, :] - mu) ** 2 + math.log(2 * math.pi))
              * traj.valid[None, :]).sum(dim=1)
        if self.kind == "tensor32":
            return ll.float()
        if self.kind == "numpy":
            return ll.cpu().numpy()
        if self.kind == "list":
            return ll.tolist()
        return ll


class JaxIIDGaussianModel:
    """The same model for `bild_tpu`, rounding to float32 where the port's
    ``tensor32`` variant does."""

    def __init__(self, kind):
        self.kind = kind
        self.mus = np.asarray(MUS, dtype=float)
        self.nStates = len(MUS)
        self.transitions = ~np.eye(self.nStates, dtype=bool)

    def logL_batch(self, profiles, traj):
        y = np.asarray(traj.data)[:, 0]
        mu = self.mus[np.asarray(profiles)]
        ll = (-0.5 * ((y[None, :] - mu) ** 2 + np.log(2 * np.pi))
              * np.asarray(traj.valid)[None, :]).sum(axis=1)
        if self.kind == "tensor32":
            ll = ll.astype(np.float32)
        return jnp.asarray(ll)


@pytest.fixture(scope="module")
def iid_data():
    rng = np.random.default_rng(7)
    true = np.zeros(20, dtype=int)
    true[8:14] = 1
    y = np.asarray(MUS)[true] + 0.6 * rng.normal(size=20)
    return y, true


def _traj(y):
    return bt.Trajectory.create(y, dtype=F64)


@pytest.mark.parametrize("kind", KINDS)
def test_fallback_steps_and_map(iid_data, kind):
    y, true = iid_data
    model = IIDGaussianModel(kind)
    s = FixedkSampler(_traj(y), model, k=2, N=32, max_fev=4000,
                      max_fcomplete=0,
                      generator=torch.Generator().manual_seed(3))
    assert not hasattr(model, "lockstep_fns_single")
    before = model.calls
    assert s.steps(6) == 6
    assert model.calls == before + 6                 # the fallback ran
    assert model.seen == {(torch.int32, torch.device("cpu"), 2)}
    ev = np.array(s.evidences)
    assert ev.shape == (6, 3) and np.all(np.isfinite(ev[:, :2]))
    assert s.state.logLs.dtype == F64
    assert np.mean(np.asarray(s.MAP_profile()[:]) == true) > 0.85
    lls = s.logL(s.state.ss[0].numpy(), s.state.thetas[0].numpy())
    assert lls.shape == (32,) and lls.dtype == F64


@pytest.mark.parametrize("kind", KINDS)
def test_steps_equal_repeated_step(iid_data, kind):
    """``steps(n)`` equals n x ``step()`` bit for bit from the same
    generator."""
    y, _ = iid_data
    a, b = (FixedkSampler(_traj(y), IIDGaussianModel(kind), k=1, N=16,
                          max_fev=2000, max_fcomplete=0,
                          generator=torch.Generator().manual_seed(5))
            for _ in range(2))
    a.steps(4)
    for _ in range(4):
        b.step()
    assert a.evidences == b.evidences
    sa, sb = a.state.to_numpy(), b.state.to_numpy()
    assert all(np.array_equal(sa[f], sb[f]) for f in sa)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [0, 1, 2])
def test_exhaustive_matches_bild_tpu(iid_data, kind, k):
    """Exhaustive enumeration draws nothing: the port's evidence, KL and
    enumerated likelihoods equal `bild_tpu`'s on the same model and data."""
    y, _ = iid_data
    model = IIDGaussianModel(kind)
    s = FixedkSampler(_traj(y), model, k=k, N=32, max_fev=4000,
                      max_fcomplete=1000,
                      generator=torch.Generator().manual_seed(0))
    js = JFixedkSampler(bj.Trajectory.create(y), JaxIIDGaussianModel(kind),
                        k=k, N=32, max_fev=4000, max_fcomplete=1000)
    assert s.exhausted and js.exhausted and model.calls == 1
    np.testing.assert_allclose(s._exhaustive["logLs"],
                               js._exhaustive["logLs"], rtol=1e-10)
    (ev, dev, kl), (jev, jdev, jkl) = s.evidences[0], js.evidences[0]
    np.testing.assert_allclose([ev, kl], [jev, jkl], rtol=1e-10, atol=1e-10)
    assert dev == jdev


@pytest.mark.parametrize("kind", KINDS)
def test_exhaustive_keeps_the_models_precision(iid_data, kind):
    """A float32 sampler steps in float32, but its exhaustive enumeration
    keeps the float64 likelihoods a model returns, as `bild_tpu`'s does."""
    y, _ = iid_data
    model = IIDGaussianModel(kind)
    model.dtype = torch.float32
    traj = bt.Trajectory.create(y, dtype=torch.float32)
    s = FixedkSampler(traj, model, k=1, N=16, max_fev=4000,
                      max_fcomplete=1000,
                      generator=torch.Generator().manual_seed(0))
    assert s.exhausted and s.dtype == torch.float32
    want = model.logL_batch(torch.as_tensor(s._exhaustive["profiles"]), traj)
    want = np.asarray(torch.as_tensor(want, dtype=F64))
    assert s._exhaustive["logLs"].dtype == np.float64
    assert np.array_equal(s._exhaustive["logLs"], want)
    if kind != "tensor32":
        assert not np.array_equal(want, want.astype(np.float32))


@pytest.mark.parametrize("kind", KINDS)
def test_sample_runs_a_custom_model(iid_data, kind):
    """`sample()` reads the model's ``device`` and ``dtype`` attributes and
    runs the fallback for every k."""
    y, true = iid_data
    model = IIDGaussianModel(kind)
    res = bt.sample(y, model, k_max=4,
                    generator=torch.Generator().manual_seed(11))
    assert model.calls > 0
    assert np.all(np.isfinite(res.evidence))
    assert res.samplers[0].dtype == F64
    assert np.mean(np.asarray(res.best_profile()[:]) == true) > 0.85
    post = res.log_marginal_posterior(dE="average")
    with np.errstate(under="ignore"):
        np.testing.assert_allclose(np.exp(post).sum(0), 1.0, rtol=1e-10)


def test_builtin_model_keeps_its_bits():
    """A built-in model's likelihoods already have the sampler's device and
    dtype: the conversion changes no bit of the AMIS steps or of the
    exhaustive enumeration (against a sampler that skips it)."""
    model = bt.models.MultiStateRouse(6, 1, 5, d=3, localization_error=0.1,
                                      device="cpu", dtype=F64)
    true = np.zeros(30, dtype=int)
    true[10:20] = 1
    traj = model.trajectory_from_loopingprofile(
        true, generator=torch.Generator().manual_seed(2))

    def run(k):
        s = FixedkSampler(traj, model, k=k, N=16, max_fev=2000,
                          generator=torch.Generator().manual_seed(4))
        s.steps(3)
        return s

    converted = [run(k) for k in (0, 1, 2)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(FixedkSampler, "_as_logLs", lambda self, x: x)
        mp.setattr(FixedkSampler, "_host_logLs",
                   staticmethod(lambda x: x.cpu().numpy().astype(float)))
        raw = [run(k) for k in (0, 1, 2)]
    assert converted[0].exhausted and not converted[2].exhausted
    for a, b in zip(converted, raw):
        assert a.evidences == b.evidences
        if a._exhaustive is not None:
            assert np.array_equal(a._exhaustive["logLs"], b._exhaustive["logLs"])
        sa, sb = a.state.to_numpy(), b.state.to_numpy()
        assert all(np.array_equal(sa[f], sb[f]) for f in sa)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_cpu_results_for_a_trajectory_on_the_card(iid_data, cuda, kind):
    """A model that computes on the CPU while the trajectory lies on the
    card: its results are moved to the card."""
    y, true = iid_data

    class HostModel(IIDGaussianModel):
        def logL_batch(self, profiles, traj):
            host = bt.Trajectory(data=traj.data.cpu(), valid=traj.valid.cpu())
            return super().logL_batch(profiles.cpu(), host)

    model = HostModel(kind)
    s = FixedkSampler(bt.Trajectory.create(y, device=cuda, dtype=F64), model,
                      k=2, N=32, max_fev=4000, max_fcomplete=0,
                      generator=torch.Generator(device=cuda).manual_seed(3))
    assert s.steps(6) == 6
    assert s.state.logLs.is_cuda
    assert np.mean(np.asarray(s.MAP_profile()[:]) == true) > 0.85
