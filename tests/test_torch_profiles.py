"""bild_tpu_torch.profiles against bild_tpu.profiles."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bild_tpu.profiles as jprof
import bild_tpu_torch.profiles as tprof
import test_torch_kalman  # noqa: F401  (one torch thread per worker)


def _jax_st2profile(ss, th, T, active=None):
    act = None if active is None else jnp.asarray(active)
    return np.asarray(jax.vmap(lambda s, t: jprof.st2profile(s, t, T, active=act))(
        jnp.asarray(ss), jnp.asarray(th, dtype=jnp.int32)))


@pytest.mark.parametrize("k", [0, 1, 3, 7])
@pytest.mark.parametrize("T", [5, 40, 100])
def test_st2profile_integer_identical(rng, k, T):
    n = 3
    ss = rng.dirichlet(np.ones(k + 1), size=300)
    th = rng.integers(0, n, size=(300, k + 1))
    got = tprof.st2profile(torch.as_tensor(ss), torch.as_tensor(th), T)
    assert got.dtype == torch.int32 and got.shape == (300, T)
    np.testing.assert_array_equal(got.numpy(), _jax_st2profile(ss, th, T))


@pytest.mark.parametrize("k", [0, 2, 5])
def test_st2profile_padded_k_identical(rng, k):
    """Padded slots carry fraction 0; the active mask must suppress the
    spurious last-frame switch from round-off, exactly as in bild_tpu."""
    K1, T = 9, 60
    ss = np.zeros((200, K1))
    ss[:, :k + 1] = rng.dirichlet(np.ones(k + 1), size=200)
    th = rng.integers(0, 2, size=(200, K1))
    active = np.arange(K1) < k + 1
    got = tprof.st2profile(torch.as_tensor(ss), torch.as_tensor(th), T,
                           active=torch.as_tensor(active))
    want = _jax_st2profile(ss, th, T, active=active)
    np.testing.assert_array_equal(got.numpy(), want)
    # the padded profile equals the exact-size one
    exact = tprof.st2profile(torch.as_tensor(ss[:, :k + 1]),
                             torch.as_tensor(th[:, :k + 1]), T)
    np.testing.assert_array_equal(got.numpy(), exact.numpy())


def test_st2profile_exhaustive_midpoints():
    """The exhaustive enumeration's midpoint switches land on every frame."""
    T = 30
    pos = (np.arange(T - 1) + 0.5) / (T - 1)
    ss = np.stack([pos, 1 - pos], axis=1)
    th = np.tile([0, 1], (T - 1, 1))
    got = tprof.st2profile(torch.as_tensor(ss), torch.as_tensor(th), T).numpy()
    np.testing.assert_array_equal(got, _jax_st2profile(ss, th, T))
    assert sorted(np.argmax(got, axis=1).tolist()) == list(range(1, T))


def test_count_switches(rng):
    states = rng.integers(0, 3, size=(50, 20))
    got = tprof.count_switches(torch.as_tensor(states)).numpy()
    want = [int(jprof.count_switches(jnp.asarray(s))) for s in states]
    np.testing.assert_array_equal(got, want)


def test_loopingprofile_api_matches_bild_tpu():
    states = [0, 0, 1, 1, 1, 0, 2, 2]
    a, b = tprof.Loopingprofile(states), jprof.Loopingprofile(states)
    assert a.count_switches() == b.count_switches() == 3
    assert a.intervals() == b.intervals()
    for x, y in zip(a.plottable(), b.plottable()):
        np.testing.assert_array_equal(x, y)
    assert a == states and a != states[:-1]
    c = a.copy()
    c[0] = 2
    assert a[0] == 0 and c[0] == 2
    with pytest.raises(TypeError):
        c[1] = 0.5
    assert tprof.Loopingprofile(torch.tensor(states)) == a


def test_state_probabilities_matches_bild_tpu(rng):
    profs = [rng.integers(0, 3, size=12) for _ in range(40)]
    np.testing.assert_array_equal(tprof.state_probabilities(profs),
                                  jprof.state_probabilities(profs))
    np.testing.assert_array_equal(tprof.state_probabilities(profs, nStates=4),
                                  jprof.state_probabilities(profs, nStates=4))
