"""The temporal-parallel likelihood (`bild_tpu_torch.experimental.
assoc_kalman`, `MultiStateRouse.logL_batch_assoc`) on the CPU in float64:
against bild_tpu's (run under x64, at the small T of its own tests),
against the port's sequential recursion (`ops.kalman`), the associative
scan against a left fold, and frames split over a two-rank ``time`` mesh
(two gloo processes) against one process."""
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bild_tpu import Trajectory as JTrajectory
from bild_tpu.models import MultiStateRouse as JRouse
from bild_tpu.ops.assoc_kalman import msrouse_logL_assoc as j_assoc
import bild_tpu_torch as bt
from bild_tpu_torch.experimental.assoc_kalman import (
    _compose, _first_element, _frame_elements, associative_scan,
    msrouse_logL_assoc, msrouse_logL_assoc_batch)
from test_torch_distributed import env, free_port, run_pair

torch.set_num_threads(1)
F64 = torch.float64


def _np_args(model, traj, profiles):
    s2, Cind = model._noise_arrays(traj)
    return tuple(np.array(x) for x in (
        model.Bs, model.Gs, model.Sigs, model.M0s, model.C0s, model.w, s2,
        Cind, profiles, traj.data, traj.valid))


def _port(args):
    return tuple(torch.as_tensor(a) for a in args)


def test_assoc_f64_matches_bild_tpu(rng):
    """tests/test_assoc_kalman.py's case: T=64, frames 0, 7 and 33 missing,
    a per-dimension noise vector; one profile at a time as in bild_tpu, and
    the batch."""
    model = JRouse(10, 1.0, 4.0, d=3, localization_error=[0.1, 0.2, 0.1])
    T = 64
    data = rng.normal(size=(T, 3))
    data[[0, 7, 33]] = np.nan
    traj = JTrajectory.create(data)
    args = _np_args(model, traj, rng.integers(0, 2, size=(6, T)))
    jargs = tuple(jnp.asarray(a) for a in args)
    want = np.array([float(j_assoc(*jargs[:8], p, *jargs[9:]))
                     for p in jargs[8]])
    targs = _port(args)
    got = msrouse_logL_assoc_batch(*targs).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10)
    one = [float(msrouse_logL_assoc(*targs[:8], p, *targs[9:]))
           for p in targs[8]]
    np.testing.assert_allclose(one, want, rtol=1e-10)


def _long_case(T):
    """tests/test_assoc_kalman.py's long cases: d=1, T=500 alternating
    every 100 frames; T=8192 alternating every 1024 with 200 missing
    frames. Port models and trajectories, float64 on the CPU."""
    rng = np.random.default_rng(5)
    model = bt.models.MultiStateRouse(8, 1.0, 3.0, d=1, localization_error=0.2,
                                      device="cpu", dtype=F64)
    data = rng.normal(size=(T, 1))
    if T == 500:
        prof = ((np.arange(T) // 100) % 2)[None]
    else:
        prof = ((np.arange(T) // 1024) % 2)
        prof = np.stack([prof, 1 - prof])
        data[rng.integers(0, T, size=200)] = np.nan
    return model, bt.Trajectory.create(data, dtype=F64), prof


@pytest.mark.parametrize("T", [500, 8192])
def test_assoc_matches_sequential(T):
    model, traj, prof = _long_case(T)
    got = model.logL_batch_assoc(prof, traj)
    want = model.logL_batch(prof, traj)
    assert got.dtype == F64 and got.shape == (len(prof),)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-8)
    assert T == 500 or not traj.valid.all()


def _elements(T, P=2, d=2, seed=0):
    """Filtering elements of a random trajectory of T frames (the first
    one frame 0's element), frames 1 and T//2 missing."""
    rng = np.random.default_rng(seed)
    model = bt.models.MultiStateRouse(6, 1.0, 3.0, d=d,
                                      localization_error=[0.1, 0.3][:d],
                                      device="cpu", dtype=F64)
    prof = torch.as_tensor(rng.integers(0, 2, size=(P, T)))
    y = torch.as_tensor(rng.normal(size=(T, d)))
    missing = {1, T // 2} - {0}
    valid = torch.tensor([t not in missing for t in range(T)])
    s2d = torch.tensor([0.01, 0.09][:d], dtype=F64)
    first, _ = _first_element(model.M0s[prof[:, 0]].transpose(1, 2),
                              model.C0s[prof[:, 0]], y[0], valid[0], model.w,
                              s2d)
    blk = prof[:, 1:].T
    rest, _, _ = _frame_elements(model.Bs[blk], model.Sigs[blk], y[1:],
                                 valid[1:], model.w, s2d)
    return tuple(torch.cat([f[None], e]) for f, e in zip(first, rest))


@pytest.mark.parametrize("T", [1, 2, 3, 5, 64, 100])
def test_associative_scan_matches_a_left_fold(T):
    elems = _elements(T)
    got = associative_scan(_compose, elems, dim=0)
    acc = tuple(e[0] for e in elems)
    want = [acc]
    for t in range(1, T):
        acc = _compose(acc, tuple(e[t] for e in elems))
        want.append(acc)
    for i, leaf in enumerate(got):
        assert leaf.shape == elems[i].shape
        torch.testing.assert_close(leaf, torch.stack([w[i] for w in want]),
                                   rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("T", [1, 2, 3, 5, 64, 100])
@pytest.mark.parametrize("dim", [0, 1])
def test_associative_scan_order(T, dim):
    """With a non-commutative operation (2 x 2 integer matrix products,
    exact in float64) the scan gives every prefix in order, along any
    axis."""
    rng = np.random.default_rng(T)
    M = torch.as_tensor(rng.integers(-1, 2, size=(T, 3, 2, 2)), dtype=F64)
    if dim == 1:
        M = M.transpose(0, 1)

    def product(a, b):
        return (a[0] @ b[0],)

    got, = associative_scan(product, (M,), dim=dim)
    acc = M.select(dim, 0)
    for t in range(T):
        if t:
            acc = acc @ M.select(dim, t)
        assert torch.equal(got.select(dim, t), acc)


def test_logL_batch_assoc_equals_logL_batch(rng):
    model = bt.models.MultiStateRouse(8, 1.0, 4.0, d=2,
                                      localization_error=0.3, device="cpu",
                                      dtype=F64)
    T = 64
    true = ((np.arange(T) // 16) % 2).astype(int)
    traj = model.trajectory_from_loopingprofile(
        true, missing_frames=[0, 9], generator=torch.Generator().manual_seed(0))
    profiles = rng.integers(0, 2, size=(5, T))
    got = model.logL_batch_assoc(profiles, traj)
    np.testing.assert_allclose(got.numpy(),
                               model.logL_batch(profiles, traj).numpy(),
                               rtol=1e-8)
    # a one-rank time mesh runs without a process group, as mesh=None
    mesh = bt.parallel.make_mesh((1,), axis_names=("time",), devices="cpu")
    assert torch.equal(model.logL_batch_assoc(profiles, traj, mesh=mesh), got)
    # out-of-range states give NaN in their row only
    bad = profiles.copy()
    bad[2, 30] = 2
    out = model.logL_batch_assoc(bad, traj).numpy()
    assert np.isnan(out[2]) and np.array_equal(np.delete(out, 2),
                                               np.delete(got.numpy(), 2))


def test_a_mesh_without_a_time_axis_raises():
    model, traj, prof = _long_case(500)
    with pytest.raises(ValueError, match="no 'time' axis"):
        model.logL_batch_assoc(prof, traj,
                               mesh=bt.parallel.make_mesh(devices="cpu"))


# the cases of the two-process test: executed here and, from a file, in
# every worker, so that both face the same inputs
_CASES = textwrap.dedent("""
    import numpy as np
    import torch
    import bild_tpu_torch as bt

    def cases():
        rng = np.random.default_rng(11)
        F64 = torch.float64
        m1 = bt.models.MultiStateRouse(8, 1.0, 4.0, d=2,
                                       localization_error=0.3,
                                       device="cpu", dtype=F64)
        true = ((np.arange(64) // 16) % 2).astype(int)
        traj1 = m1.trajectory_from_loopingprofile(
            true, generator=torch.Generator().manual_seed(0))
        p1 = rng.integers(0, 2, size=(5, 64))
        m2 = bt.models.MultiStateRouse(8, 1.0, 3.0, d=1,
                                       localization_error=0.2,
                                       device="cpu", dtype=F64)
        prof = (np.arange(8192) // 1024) % 2
        data = rng.normal(size=(8192, 1))
        data[rng.integers(0, 8192, size=200)] = np.nan
        traj2 = bt.Trajectory.create(data, dtype=F64)
        traj3 = bt.Trajectory.create(data[:63], dtype=F64)
        return {"T64": (m1, traj1, p1),
                "T8192": (m2, traj2, np.stack([prof, 1 - prof])),
                "T63": (m2, traj3, prof[None, :63])}
""")
exec(_CASES)

_WORKER = textwrap.dedent("""
    import datetime, os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    port, rank, outdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    from bild_tpu_torch.parallel import make_mesh
    mesh = make_mesh((2,), axis_names=("time",), devices="cpu",
                     distributed=True, coordinator_address=f"127.0.0.1:{port}",
                     num_processes=2, process_id=rank,
                     timeout=datetime.timedelta(seconds=60))
    assert mesh.backend == "gloo" and mesh.shape == {"time": 2}
    exec(open(os.path.join(outdir, "cases.py")).read())
    got = {}
    for name, (model, traj, prof) in cases().items():
        try:
            got[name] = model.logL_batch_assoc(prof, traj, mesh=mesh).numpy()
        except ValueError as exc:
            got[name] = np.array(str(exc))
    np.savez(os.path.join(outdir, f"res{rank}.npz"), **got)
    print(f"OK {rank}")
""")


def test_two_rank_time_mesh(tmp_path):
    """Frames split over two gloo processes: T=64 (d=2) and T=8192 with
    missing frames equal the one-process result (1e-10) and the sequential
    recursion (1e-8) on both ranks; T=63 raises on both."""
    (tmp_path / "cases.py").write_text(_CASES)
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    port = free_port()
    outs = run_pair([[sys.executable, str(worker), str(port), str(r),
                      str(tmp_path)] for r in range(2)], [env()] * 2,
                    str(tmp_path))
    for r, out in enumerate(outs):
        assert f"OK {r}" in out
    res = [dict(np.load(tmp_path / f"res{r}.npz")) for r in range(2)]
    for name, (model, traj, prof) in cases().items():
        if name == "T63":
            for r in range(2):
                assert "not divisible" in str(res[r][name])
            continue
        one = model.logL_batch_assoc(prof, traj).numpy()
        seq = model.logL_batch(prof, traj).numpy()
        for r in range(2):
            np.testing.assert_allclose(res[r][name], one, rtol=1e-10)
            np.testing.assert_allclose(res[r][name], seq, rtol=1e-8)
        np.testing.assert_array_equal(res[0][name], res[1][name])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.mark.cuda
def test_logL_batch_assoc_runs_on_the_card(cuda):
    """A model built without ``device=`` computes on the GPU and returns a
    CUDA tensor, equal to the CPU's in float64."""
    kw = dict(N=8, D=1.0, k=4.0, d=2, localization_error=0.3, dtype=F64)
    gpu = bt.models.MultiStateRouse(**kw)
    cpu = bt.models.MultiStateRouse(**kw, device="cpu")
    true = ((np.arange(64) // 16) % 2).astype(int)
    traj = cpu.trajectory_from_loopingprofile(
        true, generator=torch.Generator().manual_seed(0))
    prof = np.stack([true, 1 - true])
    got = gpu.logL_batch_assoc(prof, traj)
    assert got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(),
                               cpu.logL_batch_assoc(prof, traj).numpy(),
                               rtol=1e-10)
