"""bild_tpu_torch across two processes: a real two-rank torch.distributed
world on the CPU (gloo), as tests/test_distributed.py runs bild_tpu's
two-process cluster. Each case starts two workers and holds them to the
one-process run bit for bit:

1. `sample_dataset(mesh=)` with chunk checkpoints, the boundary climb and
   the scout schedule, and `sample_batch(mesh=, checkpoint=)`; files are
   written once, by rank 0; a dataset that differs on rank 1 raises on
   both ranks;
2. `sample_dataset_sharded` on two disjoint CSV shards against the
   one-process run on both;
3. the CLI, ``--process-local --mesh``, against the one-process
   ``--process-local`` run on the concatenated CSV.
"""
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import bild_tpu_torch as bt
from bild_tpu_torch.io import load_trajectories_csv
from bild_tpu_torch.parallel import (sample_batch, sample_dataset,
                                     sample_dataset_sharded, stack_trajectories)
import test_torch_kalman  # noqa: F401  (one torch thread per worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
TIMEOUT = 180          # seconds, per worker
CLI_ARGS = ["--device", "cpu", "--dtype", "float64", "--monomers", "8",
            "--k-max", "2", "--steps-per-k", "4", "--proposals", "16",
            "--scout-steps", "2", "--refine-top", "2",
            "--localization-error", "0.15", "--chunk-size", "4",
            "--marginals", "--seed", "3", "--quiet"]

# the dataset, model and settings of every case: executed here and, from a
# file, in every worker, so that both face the same inputs
_SHARED = textwrap.dedent("""
    import os
    import numpy as np
    import torch
    from scipy import stats as sp_stats
    import bild_tpu_torch as bt

    LENGTHS = (8, 14, 8, 11, 14, 8, 11, 8)
    DATASET_KW = dict(k_max=3, steps_per_k=6, N=24, bucket_edges=(8, 16),
                      chunk_size=3, informed_init=True, marginals=True,
                      optimize_boundaries=True)
    SCOUT_KW = dict(k_max=3, steps_per_k=6, N=24, bucket_edges=(8, 16),
                    chunk_size=4, scout_steps=2, refine_top=2,
                    informed_init=False)
    BATCH_KW = dict(k_max=2, steps_per_k=4, N=16, informed_init=True,
                    marginals=True)
    SHARD_KW = dict(k_max=3, steps_per_k=6, N=24, bucket_edges=(8, 16),
                    chunk_size=4, informed_init=True, marginals=True)

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    def factorized_model():
        return bt.models.FactorizedModel([sp_stats.maxwell(scale=0.1),
                                          sp_stats.maxwell(scale=1)], d=1,
                                         device="cpu", dtype=torch.float64)

    def load_dataset(outdir):
        data = np.load(os.path.join(outdir, "data.npy"))
        return [bt.Trajectory.create(row[:T], dtype=torch.float64)
                for row, T in zip(data, LENGTHS)]
""")
exec(_SHARED)

# what every worker runs first: one torch thread and a two-rank gloo world
# on the CPU
_PRELUDE = textwrap.dedent("""
    import datetime, os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    port, rank, outdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    from bild_tpu_torch.parallel import make_mesh
    mesh = make_mesh(axis_names=("data",), devices="cpu", distributed=True,
                     coordinator_address=f"127.0.0.1:{port}",
                     num_processes=2, process_id=rank,
                     timeout=datetime.timedelta(seconds=60))
    assert mesh.backend == "gloo" and mesh.shape == {"data": 2}
    exec(open(os.path.join(outdir, "shared.py")).read())
    ckdir = os.path.join(outdir, "ck")
    os.makedirs(ckdir, exist_ok=True)
    writes = []
    _replace = os.replace
    def counting_replace(src, dst):
        # exactly-once I/O: count the commits into the checkpoint directory
        if os.path.dirname(dst) == ckdir:
            writes.append(dst)
        return _replace(src, dst)
    os.replace = counting_replace
""")

_DATASET_WORKER = _PRELUDE + textwrap.dedent("""
    from bild_tpu_torch.parallel import sample_batch, sample_dataset, stack_trajectories
    model, trajs = factorized_model(), load_dataset(outdir)
    res = sample_dataset(model, trajs, mesh=mesh, checkpoint_dir=ckdir,
                         generator=gen(7), **DATASET_KW)
    res2 = sample_dataset(model, trajs, mesh=mesh, generator=gen(8), **SCOUT_KW)
    res3 = sample_batch(model, stack_trajectories(trajs[:3]), mesh=mesh,
                        checkpoint=os.path.join(ckdir, "per_k.npz"),
                        generator=gen(3), **BATCH_KW)
    if rank == 1:
        trajs[2] = type(trajs[2]).create(trajs[2][:] * 1.5, dtype=torch.float64)
    try:
        sample_dataset(model, trajs, mesh=mesh, generator=gen(8), **SCOUT_KW)
        diverged = ""
    except ValueError as exc:
        diverged = str(exc)
    np.savez(os.path.join(outdir, f"res{rank}.npz"),
             evidence=res.evidence, evidence_se=res.evidence_se,
             profiles=np.concatenate([p.ravel() for p in res.profiles_by_k]),
             marginals=np.concatenate([m.ravel() for m in res.marginals]),
             optimized=np.concatenate(res.optimized), eliminated=res.eliminated,
             mom_ok=res.mom_ok, s_evidence=res2.evidence,
             s_profiles=np.concatenate([p.ravel() for p in res2.profiles_by_k]),
             b_evidence=res3.evidence, b_maps=res3.map_profiles,
             b_marginals=res3.marginals, n_ck_writes=len(writes),
             diverged=diverged)
    torch.distributed.destroy_process_group()
    print(f"OK {rank}", flush=True)
""")

_SHARD_WORKER = _PRELUDE + textwrap.dedent("""
    from bild_tpu_torch.io import load_trajectories_csv
    from bild_tpu_torch.parallel import sample_dataset_sharded
    # this rank's shard only: the other file is never read
    trajs, ids = load_trajectories_csv(os.path.join(outdir, f"shard{rank}.csv"),
                                       return_ids=True, dtype=torch.float64)
    res = sample_dataset_sharded(factorized_model(), trajs, ids, mesh=mesh,
                                 checkpoint_dir=ckdir, generator=gen(9),
                                 **SHARD_KW)
    np.savez(os.path.join(outdir, f"res{rank}.npz"), ids=res.ids,
             evidence=res.evidence, evidence_se=res.evidence_se,
             profiles=np.concatenate([p.ravel() for p in res.profiles_by_k]),
             marginals=np.concatenate([m.ravel() for m in res.marginals]),
             mom_ok=res.mom_ok, n_ck_writes=len(writes))
    torch.distributed.destroy_process_group()
    print(f"OK {rank}", flush=True)
""")


def write_dataset(outdir):
    """Eight factorized trajectories (d=1): ``data.npy`` with NaN padding,
    and the CSV shards ``shard0.csv`` (even positions) and ``shard1.csv``
    (odd), ids 100 + position."""
    np.random.seed(180356)
    model = factorized_model()
    data = np.full((len(LENGTHS), max(LENGTHS)), np.nan)
    rows = {0: [], 1: []}
    for i, T in enumerate(LENGTHS):
        prof = np.zeros(T, dtype=int)
        if i % 2 == 1:
            prof[T // 2:] = 1
        x = model.trajectory_from_loopingprofile(prof, generator=gen(60 + i))[:, 0]
        data[i, :T] = x
        rows[i % 2] += [f"{100 + i},{t},{float(v)!r}" for t, v in enumerate(x)]
    np.save(os.path.join(outdir, "data.npy"), data)
    for s, lines in rows.items():
        with open(os.path.join(outdir, f"shard{s}.csv"), "w") as f:
            f.write("traj_id,frame,x\n" + "\n".join(lines) + "\n")


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def env():
    out = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    out["OMP_NUM_THREADS"] = "1"
    out["PYTHONPATH"] = REPO
    return out


def run_pair(cmds, envs, cwd):
    """Start both commands at once; every process gets its own timeout."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=e, cwd=cwd)
             for c, e in zip(cmds, envs)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-4000:]}"
    return outs


def run_workers(src, tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(src)
    (tmp_path / "shared.py").write_text(_SHARED)
    port = free_port()
    outs = run_pair([[sys.executable, str(worker), str(port), str(r),
                      str(tmp_path)] for r in range(2)], [env()] * 2,
                    str(tmp_path))
    for r, out in enumerate(outs):
        assert f"OK {r}" in out
    return [dict(np.load(tmp_path / f"res{r}.npz")) for r in range(2)]


def assert_ranks_agree(res, differ=("n_ck_writes",)):
    for f in res[0]:
        if f not in differ:
            np.testing.assert_array_equal(res[0][f], res[1][f], err_msg=f)


def test_two_process_sample_dataset(tmp_path):
    write_dataset(str(tmp_path))
    res = run_workers(_DATASET_WORKER, tmp_path)
    # exactly-once checkpoint I/O: 4 chunk files (two buckets of four
    # trajectories in chunks of 3 and 1, padded to 4 and 2 rows) and 3
    # per-k commits (k = 0, 1, 2), all by rank 0
    assert int(res[0]["n_ck_writes"]) == 7 and int(res[1]["n_ck_writes"]) == 0
    assert len(list((tmp_path / "ck").glob("chunk_*.npz"))) == 4
    assert_ranks_agree(res, differ=("n_ck_writes", "diverged"))
    for r in res:
        assert "diverged" in str(r["diverged"]), r["diverged"]

    model, trajs = factorized_model(), load_dataset(str(tmp_path))
    ref = sample_dataset(model, trajs, generator=gen(7), **DATASET_KW)
    ref2 = sample_dataset(model, trajs, generator=gen(8), **SCOUT_KW)
    ref3 = sample_batch(model, stack_trajectories(trajs[:3]), generator=gen(3),
                        **BATCH_KW)
    want = dict(
        evidence=ref.evidence, evidence_se=ref.evidence_se,
        profiles=np.concatenate([p.ravel() for p in ref.profiles_by_k]),
        marginals=np.concatenate([m.ravel() for m in ref.marginals]),
        optimized=np.concatenate(ref.optimized), eliminated=ref.eliminated,
        mom_ok=ref.mom_ok, s_evidence=ref2.evidence,
        s_profiles=np.concatenate([p.ravel() for p in ref2.profiles_by_k]),
        b_evidence=ref3.evidence, b_maps=ref3.map_profiles,
        b_marginals=ref3.marginals)
    assert np.isfinite(ref.evidence).all() and ref.mom_ok.all()
    for f, x in want.items():
        np.testing.assert_array_equal(res[0][f], x, err_msg=f)


def test_two_process_sharded_ingestion(tmp_path):
    write_dataset(str(tmp_path))
    res = run_workers(_SHARD_WORKER, tmp_path)
    assert int(res[0]["n_ck_writes"]) > 0 and int(res[1]["n_ck_writes"]) == 0
    assert_ranks_agree(res)

    t0, i0 = load_trajectories_csv(str(tmp_path / "shard0.csv"),
                                   return_ids=True, dtype=F64)
    t1, i1 = load_trajectories_csv(str(tmp_path / "shard1.csv"),
                                   return_ids=True, dtype=F64)
    ref = sample_dataset_sharded(factorized_model(), t0 + t1,
                                 np.concatenate([i0, i1]), generator=gen(9),
                                 **SHARD_KW)
    np.testing.assert_array_equal(res[0]["ids"], 100 + np.arange(8))
    assert np.isfinite(ref.evidence).all()
    for f, x in dict(
            ids=ref.ids, evidence=ref.evidence, evidence_se=ref.evidence_se,
            profiles=np.concatenate([p.ravel() for p in ref.profiles_by_k]),
            marginals=np.concatenate([m.ravel() for m in ref.marginals]),
            mom_ok=ref.mom_ok).items():
        np.testing.assert_array_equal(res[0][f], x, err_msg=f)


def rouse_shards(outdir):
    """Six Rouse trajectories (d=1, T 12..20) as two CSV shards of
    interleaved ids and as their concatenation."""
    model = bt.models.MultiStateRouse(8, 1.0, 4.0, d=1, localization_error=0.15,
                                      device="cpu", dtype=F64)
    lines = {0: [], 1: []}
    for i, T in enumerate((16, 12, 20, 16, 12, 18)):
        prof = np.zeros(T, dtype=int)
        prof[T // 3: 2 * T // 3] = i % 2
        x = model.trajectory_from_loopingprofile(prof, generator=gen(30 + i))[:, 0]
        lines[i % 2] += [f"{7 * i + 1},{t},{float(v)!r}" for t, v in enumerate(x)]
    paths = []
    for name, rows in (("shard0", lines[0]), ("shard1", lines[1]),
                       ("all", lines[0] + lines[1])):
        paths.append(os.path.join(outdir, f"{name}.csv"))
        with open(paths[-1], "w") as f:
            f.write("traj_id,frame,x\n" + "\n".join(rows) + "\n")
    return paths


def test_two_process_cli(tmp_path):
    shards = rouse_shards(str(tmp_path))
    port = free_port()
    envs = [dict(env(), RANK=str(r), WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=str(port)) for r in range(2)]
    run_pair([[sys.executable, "-m", "bild_tpu_torch", shards[r],
               "--process-local", "--mesh", *CLI_ARGS,
               "--checkpoint-dir", str(tmp_path / "ck"),
               "--out", str(tmp_path / f"out{r}.npz")] for r in range(2)],
             envs, str(tmp_path))
    from bild_tpu_torch.__main__ import main
    assert main([shards[2], "--process-local", *CLI_ARGS,
                 "--out", str(tmp_path / "one.npz")]) == 0
    outs = [np.load(tmp_path / f, allow_pickle=True)
            for f in ("out0.npz", "out1.npz", "one.npz")]
    assert set(outs[0].files) == set(outs[2].files)
    assert outs[0]["evidence"].shape == (6, 3)
    for out in outs[1:]:
        for key in outs[0].files:
            a, b = outs[0][key], out[key]
            if a.dtype == object:
                assert all(np.array_equal(x, y) for x, y in zip(a, b)), key
            else:
                np.testing.assert_array_equal(a, b, err_msg=key)


@pytest.fixture(autouse=True)
def _no_world_left():
    yield
    assert not torch.distributed.is_initialized()
