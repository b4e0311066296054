"""bild_tpu_torch's host-side numpy modules against bild_tpu's: the DP
segmentation (`infer/segment.py`), the informed proposal and the
downstream statistics (`stats.py`). Same inputs, results equal."""
import numpy as np
import pytest

from bild_tpu import stats as jstats
from bild_tpu.amis import sampler as jsam
from bild_tpu.infer import segment as jseg
from bild_tpu_torch import stats as tstats
from bild_tpu_torch.amis import sampler as tsam
from bild_tpu_torch.infer import segment as tseg

TRANSITIONS = {
    "n=2": ~np.eye(2, dtype=bool),
    "n=3 cycle": np.array([[0, 1, 0], [0, 0, 1], [1, 0, 0]], dtype=bool),
}


def _tables(rng, B, n, T):
    tables = rng.normal(size=(B, n, T)) * 3
    tables[0, :, 4] = np.nan                  # a missing frame
    tables[-1, 0, 2] = -np.inf                # an impossible frame-state
    return tables


@pytest.mark.parametrize("tname", list(TRANSITIONS))
def test_dp_segment_all_equal(rng, tname):
    tr = TRANSITIONS[tname]
    table = _tables(rng, 1, tr.shape[0], 23)[0]
    got, got_s = tseg.dp_segment_all(table, 6, tr)
    want, want_s = jseg.dp_segment_all(table, 6, tr)
    assert got_s == want_s
    for g, w in zip(got, want):
        assert (g is None and w is None) or np.array_equal(g, w)
    for k in (0, 3, 30):
        g, gs = tseg.dp_segment(table, k, tr)
        w, ws = jseg.dp_segment(table, k, tr)
        assert gs == ws and ((g is None and w is None) or np.array_equal(g, w))


@pytest.mark.parametrize("tname", list(TRANSITIONS))
def test_dp_segment_all_batch_and_st_equal(rng, tname):
    tr = TRANSITIONS[tname]
    tables = _tables(rng, 5, tr.shape[0], 17)
    got, got_ok = tseg.dp_segment_all_batch(tables, 5, tr)
    want, want_ok = jseg.dp_segment_all_batch(tables, 5, tr)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_ok, want_ok)
    for k in range(6):
        ok = got_ok[k]
        if ok.any():
            for g, w in zip(tseg.profiles_to_st_batch(got[k][ok], k),
                            jseg.profiles_to_st_batch(want[k][ok], k)):
                np.testing.assert_array_equal(g, w)
    for g, w in zip(tseg.profile_to_st(got[3][0]), jseg.profile_to_st(got[3][0])):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n,T", [(2, 40), (3, 7)])
def test_informed_proposal_batch_equal(rng, n, T):
    B, k1 = 6, 4
    fracs = rng.dirichlet(np.ones(k1), size=B)
    theta = rng.integers(0, n, size=(B, k1))
    got = tsam.informed_proposal_batch(fracs, theta, n, T)
    want = jsam.informed_proposal_batch(fracs, theta, n, T)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(tsam.informed_proposal(fracs[2], theta[2], n, T),
                    jsam.informed_proposal(fracs[2], theta[2], n, T)):
        np.testing.assert_array_equal(g, w)


def test_stats_equal(rng):
    profiles = [rng.integers(0, 2, size=T) for T in (30, 12, 45)]
    for state in (0, 1):
        got = tstats.dwell_times(profiles, state, dt=0.5)
        want = jstats.dwell_times(profiles, state, dt=0.5)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    data = rng.exponential(3.0, size=60)
    cens = rng.random(60) < 0.3
    with np.errstate(divide="ignore", invalid="ignore"):
        np.testing.assert_array_equal(tstats.KM_survival(data, cens),
                                      jstats.KM_survival(data, cens))
    np.testing.assert_array_equal(tstats.MLE_censored_exponential(data, cens),
                                  jstats.MLE_censored_exponential(data, cens))
