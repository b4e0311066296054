"""The packed-symmetric likelihood (`bild_tpu_torch.ops.kalman_sym`): its
plain version against bild_tpu's Pallas kernel in interpret mode, the
operator construction, the wrapper's dispatch, and (on a GPU) the CUDA
kernel against the plain version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bild_tpu.ops.kalman_sym import (_build_sym_operators,
                                     msrouse_logL_pallas_sym)
from bild_tpu_torch.ops import kalman_dense, kalman_sym
from test_torch_kalman import make_case, make_lane_case

# the bound of tests/test_kalman_sym.py: the packed form is exact algebra
RTOL = 1e-9

CASES = {
    "q=3 missing frames": dict(locerr=(0.1, 0.2, 0.1), missing=(0, 5, 17)),
    "n=3": dict(loops=(None, (0, -1), (0, 4)), N=10, T=30),
    "small P": dict(P=3, T=12),
    "NaN rows": dict(bad_rows=(1, 4), P=9),
    "d=1": dict(d=1, locerr=0.3, N=8),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_pallas_interpret(rng, case):
    jargs, targs, prof, *_ = make_case(rng, **CASES[case])
    want = np.asarray(msrouse_logL_pallas_sym(*jargs, interpret=True))
    ops = kalman_sym.SymOperators.build(*targs[:6], device="cpu",
                                        dtype=torch.float64)
    got = kalman_sym.msrouse_logL_sym_torch(ops, *targs[6:]).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert np.array_equal(np.isnan(got), np.isnan(want))


@pytest.mark.parametrize("N,n", [(9, 2), (6, 3), (1, 2)])
def test_operators_equal_bild_tpu(rng, N, n):
    Bs = rng.normal(size=(n, N, N))
    Sigs = rng.normal(size=(n, N, N))
    C0s = rng.normal(size=(n, N, N))
    Gs, M0s = rng.normal(size=(n, N, 2)), rng.normal(size=(n, N, 2))
    w = rng.normal(size=N)
    got = kalman_sym.build_sym_operators(Bs, Gs, Sigs, M0s, C0s, w)
    want = _build_sym_operators(Bs, Gs, Sigs, M0s, C0s, w)
    assert got[7:] == want[7:]                      # PPp, (S_OFF, N1p)
    for g, wnt in zip(got[:7], want[:7]):
        np.testing.assert_array_equal(g, np.asarray(wnt))


def test_wrapper_on_cpu_runs_the_plain_version(rng):
    _, targs, *_ = make_case(rng, T=8, P=4)
    launches = kalman_sym.msrouse_logL_sym.launches
    calls = kalman_sym.msrouse_logL_sym_torch.calls
    got = kalman_sym.msrouse_logL_sym(*targs)
    assert kalman_sym.msrouse_logL_sym_torch.calls == calls + 1
    assert kalman_sym.msrouse_logL_sym.launches == launches
    ops = kalman_sym.SymOperators.build(*targs[:6], device="cpu",
                                        dtype=torch.float64)
    assert torch.equal(got, kalman_sym.msrouse_logL_sym_torch(ops, *targs[6:]))


@pytest.mark.parametrize("n,N,itemsize,fits", [
    (2, 20, 4, True), (2, 53, 4, True), (2, 54, 4, False),
    (3, 48, 4, True), (3, 49, 4, False), (2, 44, 8, True), (2, 45, 8, False)])
def test_sym_fits_operator_budget(n, N, itemsize, fits):
    assert kalman_sym.sym_fits(n, N, 3, 1, itemsize) is fits


def test_large_chains_fall_back_to_dense(rng):
    """Above the operator budget the wrapper runs the dense likelihood (on
    the CPU its plain version), without building packed operators."""
    _, targs, *_ = make_case(rng, N=70, T=3, P=2, d=1)
    calls = kalman_dense.msrouse_logL_dense_torch.calls
    got = kalman_sym.msrouse_logL_sym(*targs, ops=None)
    assert kalman_dense.msrouse_logL_dense_torch.calls == calls + 1
    want = kalman_dense.msrouse_logL_dense_torch(*targs)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 2e-5), (torch.float64, 1e-9)])
def test_cuda_kernel_matches_plain(rng, cuda, dtype, rtol):
    _, targs, *_ = make_case(rng, N=20, T=100, P=100, missing=(0, 9),
                             locerr=(0.1, 0.2, 0.1), bad_rows=(7,))
    targs = [x.to(cuda, dtype) if isinstance(x, torch.Tensor)
             and x.is_floating_point() else x for x in targs]
    targs[8] = targs[8].to(cuda, torch.int32)
    targs[10] = targs[10].to(cuda)
    ops = kalman_sym.SymOperators.build(*targs[:6], device=cuda, dtype=dtype)
    launches = kalman_sym.msrouse_logL_sym.launches
    got = kalman_sym.msrouse_logL_sym(*targs, ops=ops).cpu()
    assert kalman_sym.msrouse_logL_sym.launches == launches + 1
    want = kalman_sym.msrouse_logL_sym_torch(ops, *targs[6:]).cpu()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol)
    assert torch.isnan(got[7]) and torch.isfinite(got[:7]).all()


def test_plain_lanes_match_pallas_interpret_per_lane(rng):
    """Lanes whose missing frames differ (one misses its first frame)."""
    jargs, targs, prof, ydata, valid, *_ = make_lane_case(rng, L=3, N=6,
                                                          T=12, P=5)
    lane_args = (torch.as_tensor(prof), torch.as_tensor(ydata),
                 torch.as_tensor(valid))
    ops = kalman_sym.SymOperators.build(*targs[:6], device="cpu",
                                        dtype=torch.float64)
    got = kalman_sym.msrouse_logL_sym_torch(ops, *targs[6:], *lane_args).numpy()
    for lane in range(3):
        want = np.asarray(msrouse_logL_pallas_sym(*jargs, jnp.asarray(prof[lane]), jnp.asarray(ydata[lane]), jnp.asarray(valid[lane]), interpret=True))
        np.testing.assert_allclose(got[lane], want, rtol=RTOL)
        assert np.array_equal(np.isnan(got[lane]), np.isnan(want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 2e-5), (torch.float64, 1e-9)])
def test_cuda_lanes_match_plain_and_single_lanes(rng, cuda, dtype, rtol):
    """One lane-batched launch against its plain version, and bit for bit
    against one single-lane launch per lane."""
    _, targs, prof, ydata, valid, *_ = make_lane_case(rng, L=6, N=20,
                                                      T=100, P=37)
    model = [x.to(cuda, dtype) for x in targs[:7]] + [targs[7]]
    lane_args = (torch.as_tensor(prof, device=cuda),
                 torch.as_tensor(ydata, device=cuda, dtype=dtype),
                 torch.as_tensor(valid, device=cuda))
    ops = kalman_sym.SymOperators.build(*model[:6], device=cuda, dtype=dtype)
    got = kalman_sym.msrouse_logL_sym(*model, *lane_args, ops=ops)
    want = kalman_sym.msrouse_logL_sym_torch(ops, *model[6:], *lane_args)
    singles = [kalman_sym.msrouse_logL_sym(*model, *(x[i] for x in lane_args), ops=ops)
               for i in range(6)]
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=rtol)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    for i, one in enumerate(singles):
        np.testing.assert_array_equal(one.cpu().numpy(), got[i])
