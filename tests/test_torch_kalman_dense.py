"""The dense-covariance likelihood (`bild_tpu_torch.ops.kalman_dense`): its
plain version against bild_tpu's Pallas kernel (`ops/kalman_pallas.py`) in
interpret mode, the wrapper's dispatch and shared-memory bound, and (on a
GPU) the CUDA kernel against the plain version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bild_tpu.ops.kalman_pallas import msrouse_logL_pallas
from bild_tpu_torch.ops import kalman_dense
from test_torch_kalman import make_case, make_lane_case

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
    jargs, targs, *_ = make_case(rng, **CASES[case])
    want = np.asarray(msrouse_logL_pallas(*jargs, interpret=True))
    got = kalman_dense.msrouse_logL_dense_torch(*targs).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert np.array_equal(np.isnan(got), np.isnan(want))


def test_wrapper_on_cpu_runs_the_plain_version(rng):
    _, targs, *_ = make_case(rng, T=8, P=4)
    launches = kalman_dense.msrouse_logL_dense.launches
    calls = kalman_dense.msrouse_logL_dense_torch.calls
    got = kalman_dense.msrouse_logL_dense(*targs)
    assert kalman_dense.msrouse_logL_dense_torch.calls == calls + 1
    assert kalman_dense.msrouse_logL_dense.launches == launches
    assert torch.equal(got, kalman_dense.msrouse_logL_dense_torch(*targs))


@pytest.mark.parametrize("N,d,q,itemsize,nbytes", [
    (20, 3, 1, 4, 3856), (20, 3, 3, 8, 14448), (119, 3, 3, 4, 231360)])
def test_shared_memory_bytes(N, d, q, itemsize, nbytes):
    assert kalman_dense.dense_smem_bytes(N, d, q, itemsize) == nbytes
    assert (nbytes <= kalman_dense.SMEM_LIMIT) is True


def test_shared_memory_limit_is_hopper_block_maximum():
    assert kalman_dense.SMEM_LIMIT == 227 * 1024
    assert kalman_dense.dense_smem_bytes(120, 3, 3, 4) > kalman_dense.SMEM_LIMIT


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 2e-5), (torch.float64, 1e-9)])
def test_cuda_kernel_matches_plain(rng, cuda, dtype, rtol):
    _, targs, *_ = make_case(rng, N=20, T=100, P=100, missing=(0, 9),
                             locerr=(0.1, 0.2, 0.1), bad_rows=(7,))
    targs = [x.to(cuda, dtype) if isinstance(x, torch.Tensor)
             and x.is_floating_point() else x for x in targs]
    targs[8] = targs[8].to(cuda, torch.int32)
    targs[10] = targs[10].to(cuda)
    launches = kalman_dense.msrouse_logL_dense.launches
    got = kalman_dense.msrouse_logL_dense(*targs).cpu()
    assert kalman_dense.msrouse_logL_dense.launches == launches + 1
    want = kalman_dense.msrouse_logL_dense_torch(*targs).cpu()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol)
    assert torch.isnan(got[7]) and torch.isfinite(got[:7]).all()


@pytest.mark.cuda
def test_cuda_rejects_oversized_shared_memory(rng, cuda):
    _, targs, *_ = make_case(rng, N=120, T=3, P=2, locerr=(0.1, 0.2, 0.3))
    targs = [x.to(cuda, torch.float32) if isinstance(x, torch.Tensor)
             and x.is_floating_point() else x for x in targs]
    targs[8] = targs[8].to(cuda, torch.int32)
    targs[10] = targs[10].to(cuda)
    with pytest.raises(ValueError, match="shared memory"):
        kalman_dense.msrouse_logL_dense(*targs)


def test_plain_lanes_match_pallas_interpret_per_lane(rng):
    """Lanes whose missing frames differ (one misses its first frame)."""
    jargs, targs, prof, ydata, valid, *_ = make_lane_case(rng, L=3, N=6,
                                                          T=12, P=5)
    lane_args = (torch.as_tensor(prof), torch.as_tensor(ydata),
                 torch.as_tensor(valid))
    got = kalman_dense.msrouse_logL_dense_torch(*targs, *lane_args).numpy()
    for lane in range(3):
        want = np.asarray(msrouse_logL_pallas(*jargs, jnp.asarray(prof[lane]), jnp.asarray(ydata[lane]), jnp.asarray(valid[lane]), interpret=True))
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
    got = kalman_dense.msrouse_logL_dense(*model, *lane_args)
    want = kalman_dense.msrouse_logL_dense_torch(*model, *lane_args)
    singles = [kalman_dense.msrouse_logL_dense(*model, *(x[i] for x in lane_args))
               for i in range(6)]
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=rtol)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    for i, one in enumerate(singles):
        np.testing.assert_array_equal(one.cpu().numpy(), got[i])
