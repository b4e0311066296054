"""The ``'auto'`` kernel selector: `ops.kalman_sym.auto_kernel`'s choice
from a launch's shape, the model's dispatch by it, and on the card (tests
marked ``cuda``) the kernels each entry point then launches. No JAX here:
the card's tests run without it."""
import numpy as np
import pytest
import torch

import bild_tpu_torch as bt
from bild_tpu_torch import config
from bild_tpu_torch.models import msrouse
from bild_tpu_torch.ops import counters
from bild_tpu_torch.ops.kalman_dense import H100_SMS, dense_cov_itemsize
from bild_tpu_torch.ops.kalman_sym import auto_kernel, sym_fits, sym_plan

torch.set_num_threads(1)        # one torch thread per test worker

# the benchmark cells' launches, (n, L, P): the lockstep scout (k = 0..k_max
# as lanes) and refine steps of 1,024 trajectories at T=100 and of 64 at
# T=1000 (three states, k_max=6), the adaptive cell's bootstrap and slot
# rounds, and the climb's first iterations (every lane, 2 Kb + 1 profiles)
CELL_LAUNCHES = [(2, 5120, 128), (2, 3072, 128), (2, 1024, 128), (2, 1024, 9),
                 (3, 448, 128), (3, 192, 128), (3, 64, 13)]
# launches that cannot fill the SMs: sample()'s step (L=1, P=100), its k=0
# enumeration (one profile a state) and a climb's last active lanes
SMALL_LAUNCHES = [(2, 1, 100), (2, 1, 2), (3, 1, 3), (2, 3, 7), (2, 1, 131)]


@pytest.fixture
def selection():
    """Restores the kernel selection the test found."""
    old = config.rouse_kernel()
    yield old
    config.set_rouse_kernel(old)


def test_auto_is_the_default_selector():
    assert "auto" in config.KERNELS
    assert config.rouse_kernel() == "auto"


@pytest.mark.parametrize("n,L,P", CELL_LAUNCHES)
def test_dataset_launches_take_dense(n, L, P):
    """The README model's widths (N=20, d=3, q=1), float32, the exact
    tier: each cell's launches run the dense kernel, with its float64
    covariance."""
    assert dense_cov_itemsize(n, 20, 3, 1, 4) == 8
    assert auto_kernel(L, P, n, 20, 3, 1, 4) == "dense"
    # sample()'s k=1 enumeration at T=100: 2 x 99 profiles
    assert auto_kernel(1, 198, n, 20, 3, 1, 4) == "dense"


@pytest.mark.parametrize("n,L,P", SMALL_LAUNCHES)
@pytest.mark.parametrize("itemsize", [4, 8])
def test_launches_below_the_sms_keep_the_cluster_plan(n, L, P, itemsize):
    """Where L P < 132 the packed kernel takes its cluster plan, and
    'auto' keeps it; one profile more on each SM's row gives the dense
    kernel."""
    assert L * P < H100_SMS
    assert sym_plan(L, P, n, 20, 3, 1, itemsize).cluster
    assert auto_kernel(L, P, n, 20, 3, 1, itemsize) == "sym"
    assert auto_kernel(L, -(-H100_SMS // L), n, 20, 3, 1, itemsize) == "dense"


@pytest.mark.parametrize("tier", ["split", "split_cov"])
@pytest.mark.parametrize("L,P", [(1, 100), (640, 128), (5120, 128)])
def test_split_tiers_stay_on_sym(tier, L, P):
    """The dense kernel has no split tier."""
    assert auto_kernel(L, P, 2, 20, 3, 1, 4, tier) == "sym"


@pytest.mark.parametrize("N,q", [(121, 1), (85, 3)])
def test_float32_covariance_of_dense_stays_on_sym(N, q):
    """Where the dense kernel would keep a float32 covariance, 'auto' runs
    what 'sym' runs (at these N the packed kernel hands the launch to the
    dense kernel itself); one monomer fewer, the dense kernel carries a
    float64 covariance and 'auto' takes it."""
    assert dense_cov_itemsize(2, N, 3, q, 4) == 4
    assert dense_cov_itemsize(2, N - 1, 3, q, 4) == 8
    assert not sym_fits(2, N - 1, 3, q, 4)
    assert auto_kernel(640, 128, 2, N, 3, q, 4) == "sym"
    assert auto_kernel(640, 128, 2, N - 1, 3, q, 4) == "dense"


def test_cpu_dispatch_by_launch_shape(monkeypatch, selection):
    """The model's 'auto' likelihood runs `auto_kernel`'s choice per call,
    from the profiles' shape: driven on the CPU with the model made to
    read as a CUDA one (its packed operators built first), so that the
    wrappers run their plain versions. Each call equals the forced
    selector's, bit for bit."""
    model = bt.models.MultiStateRouse(8, 1.0, 5.0, d=3, localization_error=0.1,
                                      device="cpu", dtype=torch.float64)
    model.sym_operators()
    gen = torch.Generator().manual_seed(3)
    batch = model.trajectories_from_loopingprofiles(np.zeros((3, 12), int),
                                                    generator=gen)
    s2, Cind = model._noise_arrays(batch)
    args = (model.Bs, model.Gs, model.Sigs, model.M0s, model.C0s, model.w,
            s2, Cind)
    monkeypatch.setattr(model, "device", torch.device("cuda"))
    monkeypatch.setattr(msrouse, "sm_count", lambda index: H100_SMS)
    names = ("plain_sym", "plain_dense")
    got = {}
    for sel in ("auto", "sym", "dense"):
        config.set_rouse_kernel(sel)
        fn = model._kernel("exact")
        for L, P, want in ((1, 100, "plain_sym"), (3, 50, "plain_dense"),
                           (2, 60, "plain_sym")):
            profiles = torch.randint(0, 2, (L, P, 12), dtype=torch.int32,
                                     generator=torch.Generator().manual_seed(P))
            before = counters.read(names)
            got[sel, L] = fn(*args, profiles, batch.data[:L], batch.valid[:L])
            ran = {k: v - before[k] for k, v in counters.read(names).items()}
            if sel == "auto":
                assert ran == {k: int(k == want) for k in names}, (L, P)
    for L in (1, 2):
        assert torch.equal(got["auto", L], got["sym", L])
    assert torch.equal(got["auto", 3], got["dense", 3])


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def card_model(cuda, N=8):
    return bt.models.MultiStateRouse(N, 1.0, 5.0, d=3, localization_error=0.1,
                                     device=cuda, dtype=torch.float32)


@pytest.mark.cuda
def test_cuda_lockstep_dataset_runs_dense(cuda, selection):
    """Under the default, a small lockstep `sample_dataset` call (its
    scout and refine launches fill the SMs: 16 and 8 lanes of 32
    profiles) launches only the dense kernel."""
    config.set_rouse_kernel("auto")
    model = card_model(cuda)
    truth = np.zeros((4, 40), int)
    truth[:, 15:25] = 1
    batch = model.trajectories_from_loopingprofiles(
        truth, generator=torch.Generator(device=cuda).manual_seed(1))
    trajs = [bt.Trajectory.create(batch.data[b].cpu().numpy(),
                                  localization_error=0.1) for b in range(4)]
    counters.reset()
    bt.parallel.sample_dataset(model, trajs, k_max=3, steps_per_k=6, N=32,
                               scout_steps=2, refine_top=2,
                               generator=torch.Generator().manual_seed(2))
    ran = counters.read()
    assert ran["kalman_dense"] > 0 and ran["kalman_sym"] == 0
    assert ran["kalman_dense_cov32"] == 0


@pytest.mark.cuda
def test_cuda_sample_steps_keep_the_cluster_plan(cuda, selection):
    """Under the default, every AMIS step of `sample()` (L=1, P=100)
    launches the packed kernel's cluster plan, as under 'sym'."""
    config.set_rouse_kernel("auto")
    model = card_model(cuda)
    true = np.zeros(60, dtype=int)
    true[20:40] = 1
    traj = model.trajectory_from_loopingprofile(
        true, generator=torch.Generator(device=cuda).manual_seed(0))
    counters.reset()
    res = bt.sample(traj, model, k_max=4,
                    generator=torch.Generator(device=cuda).manual_seed(7))
    steps = sum(s.n_steps_host for s in res.samplers)
    ran = counters.read()
    assert steps > 0 and ran["kalman_sym_cluster"] >= steps


@pytest.mark.cuda
def test_cuda_auto_equals_the_forced_kernels(cuda, selection):
    """'auto' gives forced 'dense''s bits at a dataset launch (8 lanes of
    128 profiles) and forced 'sym''s at sample()'s step (1, 100)."""
    model = card_model(cuda, N=20)
    gen = torch.Generator(device=cuda).manual_seed(5)
    batch = model.trajectories_from_loopingprofiles(np.zeros((8, 50), int),
                                                    generator=gen)
    profiles = torch.randint(0, 2, (8, 128, 50), dtype=torch.int32,
                             device=cuda, generator=gen)
    step = profiles[0, :100]
    traj = bt.Trajectory.create(batch.data[0].cpu().numpy(),
                                localization_error=0.1, device=cuda)
    got = {}
    for sel in ("auto", "dense", "sym"):
        config.set_rouse_kernel(sel)
        per_lane, fn = model.lockstep_fns(batch)
        got[sel] = (fn(profiles, per_lane), model.logL_batch(step, traj))
    assert torch.equal(got["auto"][0], got["dense"][0])
    assert torch.equal(got["auto"][1], got["sym"][1])
    assert not torch.equal(got["sym"][0], got["dense"][0])
