"""The square-root Rouse-Kalman likelihood (`bild_tpu_torch.ops.kalman_sqrt`)
against bild_tpu.ops.kalman_sqrt (run under x64 on the CPU, as its own
tests run it) and the float64 oracle, at the parity case of
tests/test_kalman_sqrt.py (N=20, d=3, T=100, frames 7, 50, 51 missing)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bild_tpu.models import MultiStateRouse
from bild_tpu.ops.kalman_sqrt import msrouse_logL_sqrt as j_sqrt
from bild_tpu.ops.oracle import msrouse_logL_numpy
import bild_tpu_torch as bt
from bild_tpu_torch.ops.kalman_sqrt import _lq, msrouse_logL_sqrt, psd_factor
import test_torch_kalman  # noqa: F401  (one torch thread per worker)

torch.set_num_threads(1)

# localization errors: one for every dimension (q=1), a per-dimension
# vector with two distinct values (q=2) and three (q=3)
NOISES = {"q=1": 0.1, "q=2": [0.1, 0.2, 0.1], "q=3": [0.1, 0.2, 0.15]}


def _parity_case(rng, P=8, T=100, localization_error=0.1):
    """(numpy arguments, oracle) of tests/test_kalman_sqrt.py's case."""
    model = MultiStateRouse(20, 1.0, 5.0, d=3,
                            localization_error=localization_error)
    truth = np.zeros(T, dtype=int)
    truth[T // 3: T // 2] = 1
    truth[3 * T // 4: 9 * T // 10] = 1
    traj = model.trajectory_from_loopingprofile(
        truth, missing_frames=[7, T // 2, T // 2 + 1], key=jax.random.key(42))
    profiles = rng.integers(0, 2, size=(P, T))
    s2, Cind = model._noise_arrays(traj)
    args = tuple(np.array(x) for x in (
        model.Bs, model.Gs, model.Sigs, model.M0s, model.C0s, model.w, s2,
        Cind, profiles, traj.data, traj.valid))
    oracle = np.array([
        msrouse_logL_numpy(*args[:6], model._get_noise(traj), p, traj[:])
        for p in profiles])
    return args, oracle


def _port(args, dtype=torch.float64):
    return tuple(torch.as_tensor(a, dtype=dtype) if a.dtype == np.float64
                 else torch.as_tensor(a) for a in args)


@pytest.mark.parametrize("noise", list(NOISES))
def test_sqrt_f64_matches_bild_tpu_and_oracle(rng, noise):
    args, oracle = _parity_case(rng, localization_error=NOISES[noise])
    want = np.asarray(j_sqrt(*(jnp.asarray(a) for a in args)))
    got = msrouse_logL_sqrt(*_port(args)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_allclose(got, oracle, rtol=1e-12)


def test_steady_state_null_mode_factor(rng):
    """The Rouse steady state has a zero-variance mode (the free centre of
    mass): no Cholesky factor exists, the eigh factor does (the parity
    cases above start from it)."""
    args, _ = _parity_case(rng, P=2, T=20)
    C0s = args[4]
    lam = np.linalg.eigvalsh(C0s)
    assert np.all(np.abs(lam[:, 0]) < 1e-12 * lam[:, -1])
    with pytest.raises(np.linalg.LinAlgError):
        np.linalg.cholesky(C0s)
    L = psd_factor(C0s)
    np.testing.assert_allclose(L @ L.transpose(0, 2, 1), C0s,
                               rtol=0, atol=1e-12 * np.abs(C0s).max())
    # a stack is factored matrix by matrix, bit for bit
    np.testing.assert_array_equal(np.stack([psd_factor(C) for C in C0s]), L)


@pytest.mark.parametrize("shape", [(20, 40), (21, 21), (4, 3, 20, 40),
                                   (5, 7, 9)])
def test_lq_matches_qr(shape):
    """`_lq` is lower triangular with ``L L^T = A A^T`` (float64, 1e-12),
    and equals the transposed R of `torch.linalg.qr` of ``A^T``."""
    A = torch.as_tensor(np.random.default_rng(3).normal(size=shape))
    L = _lq(A)
    assert L.shape == shape[:-1] + (shape[-2],)
    assert torch.equal(L, torch.tril(L))
    torch.testing.assert_close(L @ L.mT, A @ A.mT, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(L, torch.linalg.qr(A.mT)[1].mT, rtol=0, atol=0)


def test_sqrt_f32_within_1e6_of_oracle(rng):
    """float32 on the CPU within 1e-6 relative of the float64 oracle:
    bild_tpu's `test_sqrt_f32_meets_north_star` bar."""
    args, oracle = _parity_case(rng)
    got32 = msrouse_logL_sqrt(*_port(args, torch.float32))
    assert got32.dtype == torch.float32
    assert np.max(np.abs((got32.double().numpy() - oracle) / oracle)) < 1e-6


def test_sqrt_out_of_range_nan(rng):
    args, _ = _parity_case(rng, P=3, T=20)
    profiles = args[8].copy()
    profiles[1, 5] = 7
    out = msrouse_logL_sqrt(*_port(args[:8] + (profiles,) + args[9:])).numpy()
    assert np.isnan(out[1])
    assert np.all(np.isfinite(out[[0, 2]]))
    want = msrouse_logL_sqrt(*_port(args)).numpy()
    np.testing.assert_array_equal(out[[0, 2]], want[[0, 2]])


def test_full_fp32_restores_the_tf32_setting():
    """The filter runs its products with TF32 off and leaves the global
    setting as it found it."""
    flag = torch.backends.cuda.matmul.allow_tf32
    try:
        for value in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = value
            with bt.config.full_fp32():
                assert torch.backends.cuda.matmul.allow_tf32 is False
            assert torch.backends.cuda.matmul.allow_tf32 is value
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.mark.cuda
def test_sqrt_on_the_card_matches_the_cpu(rng, cuda):
    args, oracle = _parity_case(rng)
    got = msrouse_logL_sqrt(*(x.to(cuda) for x in _port(args)))
    assert got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(), oracle, rtol=1e-12)
