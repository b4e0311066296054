"""bild_tpu_torch.physics.rouse against bild_tpu.physics.rouse (float64)."""
import numpy as np
import pytest
import torch

from bild_tpu.physics import rouse as jrouse
from bild_tpu_torch.physics import rouse as trouse
import test_torch_kalman  # noqa: F401  (one torch thread per worker)

F64 = torch.float64

CHAINS = [
    (10, None),
    (12, ((0, -1),)),
    (9, ((2, 6, 0.5), (0, 3))),
    (8, ((3, 4, -1),)),          # backbone bond removed: two free modes
    (20, ((0, -1), (5, 5))),     # vacuous bond ignored
]


@pytest.mark.parametrize("N,bonds", CHAINS)
def test_operators_match_bild_tpu(N, bonds):
    want = jrouse.RouseModel(N=N, D=1.3, k=4.0, d=3, dt=0.7, add_bonds=bonds)
    got = trouse.RouseModel(N=N, D=1.3, k=4.0, d=3, dt=0.7, add_bonds=bonds,
                            device="cpu", dtype=F64)
    for name in ("B", "G", "Sig", "C_ss", "M_ss", "L_ss", "L_sig"):
        t = getattr(got, name)
        assert t.dtype == F64 and t.device.type == "cpu"
        np.testing.assert_allclose(t.numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-12, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("N,bonds", CHAINS)
def test_laplacian_matches_bild_tpu(N, bonds):
    np.testing.assert_array_equal(trouse._build_laplacian(N, bonds),
                                  jrouse._build_laplacian(N, bonds))


def test_factors_reproduce_covariances():
    m = trouse.RouseModel(N=15, D=1.0, k=5.0, d=3, dt=1.0,
                          add_bonds=((0, -1),), device="cpu", dtype=F64)
    np.testing.assert_allclose((m.L_ss @ m.L_ss.T).numpy(), m.C_ss.numpy(),
                               atol=1e-12)
    np.testing.assert_allclose((m.L_sig @ m.L_sig.T).numpy(), m.Sig.numpy(),
                               atol=1e-12)
    # the steady state is stationary, seen from a vector orthogonal to the
    # free (center-of-mass) mode, such as the end-to-end distance
    w = torch.zeros(15, dtype=F64)
    w[0], w[-1] = -1, 1
    np.testing.assert_allclose(float(w @ m.propagate_C(m.C_ss) @ w),
                               float(w @ m.C_ss @ w), rtol=1e-12)


def test_sampling_shapes_and_reproducibility():
    m = trouse.RouseModel(N=6, D=1.0, k=2.0, d=2, dt=1.0, device="cpu", dtype=F64)
    a = m.evolve(m.conf_ss(torch.Generator().manual_seed(1)),
                 torch.Generator().manual_seed(2))
    b = m.evolve(m.conf_ss(torch.Generator().manual_seed(1)),
                 torch.Generator().manual_seed(2))
    assert a.shape == (6, 2) and a.dtype == F64
    assert torch.equal(a, b)


def test_steady_state_sample_covariance():
    m = trouse.RouseModel(N=5, D=1.0, k=3.0, d=1, dt=1.0, device="cpu", dtype=F64)
    g = torch.Generator().manual_seed(0)
    x = torch.stack([m.conf_ss(g)[:, 0] for _ in range(4000)])
    np.testing.assert_allclose(np.cov(x.numpy().T), m.C_ss.numpy(), atol=0.03)


@pytest.mark.parametrize("dt", [0.0, 0.3, np.array([0.1, 2.0, np.inf]),
                                np.logspace(-3, 3, 13)])
def test_two_locus_msd_matches_bild_tpu(dt):
    np.testing.assert_allclose(trouse.two_locus_msd(dt, G=2.0, J=0.7),
                               jrouse.two_locus_msd(dt, G=2.0, J=0.7),
                               rtol=1e-14)
