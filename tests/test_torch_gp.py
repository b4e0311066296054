"""bild_tpu_torch.physics.gp against bild_tpu.physics.gp: the same MSD
callables through both packages' decorators and `msd2C` (float64 host
numpy on both sides, rtol/atol 1e-12)."""
import numpy as np
import pytest

from bild_tpu.physics import gp as jgp
from bild_tpu.models import GenericGaussianModel as JG
from bild_tpu_torch.physics import gp as tgp
from bild_tpu_torch.models import GenericGaussianModel as TG

TOL = dict(rtol=1e-12, atol=1e-12)

CASES = [
    ("powerlaw", dict(G=1.3, a=0.7)),
    ("powerlaw", dict(G=0.5, a=1.0, noise2=0.02)),
    ("powerlaw", dict(G=0.5, a=0.6, noise2=0.02, motion_blur_f=0.4)),
    ("twoLocusRouse", dict(G=1.0, J=5.0)),
    ("twoLocusRouse", dict(G=2.0, J=1.0, noise2=0.01, motion_blur_f=1.0)),
]


def _pair(kind, kw):
    name = f"MSD_function_{kind}"
    return getattr(JG, name)(**kw), getattr(TG, name)(**kw)


@pytest.mark.parametrize("kind,kw", CASES)
def test_lag_tables_equal(kind, kw):
    """What the interval tables consume: the MSD at integer lags 0..T, at
    a scalar, and at infinity for the bounded family."""
    jf, tf = _pair(kind, kw)
    lags = np.arange(0, 130, dtype=float)
    np.testing.assert_allclose(tf(lags), jf(lags), **TOL)
    assert tf(0.0) == 0.0 and np.ndim(tf(3.0)) == 0
    np.testing.assert_allclose(tf(-3.0), jf(3.0), **TOL)
    if kind == "twoLocusRouse":
        np.testing.assert_allclose(tf(np.inf), jf(np.inf), **TOL)
        np.testing.assert_allclose(
            tf(np.inf), 2 * kw["J"] + 2 * kw.get("noise2", 0.0), **TOL)


@pytest.mark.parametrize("kind,kw", CASES)
def test_msd2C_both_orders(kind, kw, rng):
    jf, tf = _pair(kind, kw)
    ti = np.sort(rng.choice(60, size=25, replace=False)).astype(float)
    orders = (0, 1) if kind == "twoLocusRouse" else (1,)
    for ss in orders:
        Cj, Ct = jgp.msd2C(jf, ti, ss), tgp.msd2C(tf, ti, ss)
        assert Ct.shape == (25 - ss, 25 - ss)
        np.testing.assert_allclose(Ct, Cj, **TOL)
        np.linalg.cholesky(Ct)          # a valid covariance
    assert tgp.msd2C_fun is tgp.msd2C


def test_decorators_on_a_custom_msd():
    """`MSDfun` and `imaging` applied to a plain callable, noise and blur
    together, in both packages."""
    def raw(dt, G=2.0):
        return G * dt ** 0.5

    jf = jgp.MSDfun(jgp.imaging(noise2=0.1, f=0.7, alpha0=0.5)(raw))
    tf = tgp.MSDfun(tgp.imaging(noise2=0.1, f=0.7, alpha0=0.5)(raw))
    dts = np.array([0.0, 0.3, 1.0, 2.5, 40.0])
    np.testing.assert_allclose(tf(dts), jf(dts), **TOL)
    # noise adds 2*noise2 on every nonzero lag; blur lowers the short lags
    assert tf(1.0) < raw(np.array([1.0]))[0] + 0.2
    np.testing.assert_allclose(tf(dts, G=3.0), jf(dts, G=3.0), **TOL)


def test_bad_arguments_raise():
    with pytest.raises(ValueError, match="exposure fraction"):
        tgp.imaging(f=1.5)
    with pytest.raises(ValueError, match="ss_order"):
        tgp.msd2C(TG.MSD_function_powerlaw(), np.arange(4.0), 2)
