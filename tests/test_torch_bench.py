"""bench_torch.py, the port's counterpart of bench.py, on the CPU: its
workload is bench.py's bit for bit, its likelihoods equal
bild_tpu.ops.kalman's in float64, its baseline is bild_tpu's float64
oracle, it measures nothing without a card, and it imports no JAX."""
import inspect
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402  (bench.py imports JAX only inside main())
import bench_torch  # noqa: E402
from bild_tpu import Trajectory  # noqa: E402
from bild_tpu.models import MultiStateRouse  # noqa: E402
from bild_tpu.ops.kalman import msrouse_logL_batch  # noqa: E402
from bild_tpu.ops.oracle import msrouse_logL_numpy  # noqa: E402
import test_torch_kalman  # noqa: E402,F401  (one torch thread per worker)

F64 = torch.float64
KERNELS = ("kalman_sym", "kalman_sym_split_cov", "kalman_sym_split", "kalman_dense")
NO_JAX = ("import json, sys; sys.path.insert(0, {repo!r}); import {mods}; "
          "print(json.dumps(sorted(m for m in sys.modules "
          "if m.split('.')[0] in ('jax', 'jaxlib', 'bild_tpu'))))")


def no_jax_modules(*mods):
    """The JAX and bild_tpu modules that importing ``mods`` loads, in a
    fresh process."""
    code = NO_JAX.format(repo=REPO, mods=", ".join(mods))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, cwd=REPO, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert p.returncode == 0, p.stderr
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def small():
    """bench_torch's workload at P=32 in float64 on the CPU, and
    bild_tpu's model and trajectory on the same data."""
    model, traj, prof = bench_torch.workload(P=32, device="cpu", dtype=F64)
    jm = MultiStateRouse(20, 1.0, 5.0, d=3, localization_error=0.1)
    return model, traj, prof, jm, Trajectory.create(traj[:])


def test_workload_is_bench_py_s():
    src = inspect.getsource(bench.main)
    for line in ("P, T = 8192, 100", "rng = np.random.default_rng(685441950)",
                 "MultiStateRouse(20, 1.0, 5.0, d=3, localization_error=0.1)",
                 "true_prof = ((np.arange(T) // 25) % 2).astype(int)",
                 "profiles = rng.integers(0, 2, size=(P, T)).astype(np.int32)"):
        assert line in src, line
    P, T = 8192, 100
    rng = np.random.default_rng(685441950)
    want = rng.integers(0, 2, size=(P, T)).astype(np.int32)
    got = bench_torch.bench_profiles()
    assert got.dtype == np.int32 and (bench_torch.P_BENCH, bench_torch.T_BENCH) == (P, T)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(bench_torch.true_profile(),
                                  ((np.arange(T) // 25) % 2).astype(int))
    model, traj, prof = bench_torch.workload(P=16, device="cpu", dtype=F64)
    np.testing.assert_array_equal(prof, want[:16])
    np.testing.assert_array_equal(np.asarray(traj.loopingprofile[:]),
                                  bench_torch.true_profile())


def test_likelihoods_match_bild_tpu(small):
    model, traj, prof, jm, jt = small
    got, counts = bench_torch.evaluate(model, traj, prof)
    s2, Cind = jm._noise_arrays(jt)
    want = np.asarray(msrouse_logL_batch(jm.Bs, jm.Gs, jm.Sigs, jm.M0s, jm.C0s,
                                         jm.w, s2, Cind, jnp.asarray(prof),
                                         jt.data, jt.valid))
    assert tuple(got) == KERNELS
    for name in KERNELS:
        assert got[name].shape == (32,)
        np.testing.assert_allclose(got[name], want, rtol=1e-9, err_msg=name)
    # on CPU tensors every wrapper ran its plain version and launched
    # nothing; the counts are the whole registry's, the layers' counters too
    assert counts == {"kalman_sym": 0, "kalman_sym_split": 0, "kalman_sym_cluster": 0,
                      "kalman_dense": 0,
                      "kalman_dense_cov32": 0, "plain_sym": 3, "plain_dense": 1,
                      "plain_torch": 0, "cfc_solve": 0, "plain_cfc": 0, "gamma_accept": 0,
                      "plain_gamma": 0, "graphs.captures": 0, "graphs.replays": 0,
                      "graphs.copies": 0, "run_steps.steps": 0, "run_lanes.steps": 0,
                      "run_lanes.lane_steps": 0, "optimize_boundary_batch.evaluations": 0,
                      "adaptive.slot_steps": 0, "adaptive.filler_slot_steps": 0}


def test_baseline_is_bild_tpu_oracle(small):
    model, traj, prof, jm, jt = small
    sec, vals = bench_torch.baseline(model, traj, prof)
    want = [msrouse_logL_numpy(np.asarray(jm.Bs), np.asarray(jm.Gs),
                               np.asarray(jm.Sigs), np.asarray(jm.M0s),
                               np.asarray(jm.C0s), np.asarray(jm.w),
                               jm._get_noise(jt), p, jt[:])
            for p in prof[:bench_torch.N_BASE]]
    assert sec > 0 and vals.shape == (16,)
    np.testing.assert_allclose(vals, want, rtol=1e-10)


def test_measure_needs_the_card(small):
    with pytest.raises(ValueError, match="CUDA device"):
        bench_torch.measure(*small[:3])


def test_bounds_follow_the_shape():
    shape = (1, 8192, 100, 2, 20, 3, 1, 100)
    flops, nbytes = bench_torch.kernel_work(*shape)
    bnd, by = bench_torch.bound_ms(flops, nbytes)
    assert by == "operations" and bnd == pytest.approx(flops / 67e12 * 1e3)
    split, by_split = bench_torch.split_bound_ms(*shape)
    assert by_split == "operations" and 0 < split < bnd
    # twice the profiles, twice the work
    assert bench_torch.kernel_work(1, 16384, *shape[2:])[0] == 2 * flops


def test_main_without_card_prints_no_line(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_torch.main() == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_script_without_card_exits_nonzero():
    p = subprocess.run([sys.executable, os.path.join(REPO, "bench_torch.py")],
                       capture_output=True, text=True, timeout=120, cwd=REPO,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": "",
                            "OMP_NUM_THREADS": "1"})
    assert p.returncode != 0 and not p.stdout.strip()
    assert "no CUDA device" in p.stderr


def test_imports_no_jax():
    assert no_jax_modules("bench_torch") == []
