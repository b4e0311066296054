"""The port's public surface covers bild_tpu's: every public name of
`bild_tpu`, `bild_tpu.parallel` and `bild_tpu.experimental`, of the
modules `config`, `ops`, `models`, `amis`, `physics` and `trajectory`
(with the submodules that hold the kernels, the AMIS distributions and the
Rouse chain), and every public attribute of their public classes exists in
`bild_tpu_torch`, apart from the names below that stay out (with their
reasons) and those that have a counterpart under another name. The names
added for it are held against bild_tpu in float64."""
import importlib
import inspect
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bild_tpu as bj
import bild_tpu_torch as bt
from bild_tpu.amis import cfc as jcfc
from bild_tpu.ops.kalman import msrouse_logL_single as j_single
from bild_tpu_torch.amis import cfc as tcfc
from bild_tpu_torch.amis import dirichlet as tdir
from test_torch_amis import TRANSITIONS, T_, assert_close
from test_torch_kalman import make_case

DO_NOT_PORT = {
    # no global dtype switch: every constructor takes dtype= (README)
    "config.fdtype", "config.idtype",
    # JAX's persistent compilation cache
    "config.enable_compilation_cache",
    # a JAX matmul precision; the port's counterpart is config.exact_fp32()
    "config.MATMUL_PRECISION",
}
# bild_tpu's name -> the port's
RENAMED = {
    "ops.kalman_pallas": "kalman_dense",
    "ops.msrouse_logL_pallas": "msrouse_logL_dense",
    "ops.msrouse_logL_pallas_sym": "msrouse_logL_sym",
    "ops.kalman_sym.msrouse_logL_pallas_sym": "msrouse_logL_sym",
    "ops.kalman_sym.sym_operators": "SymOperators.build",
}
MODULES = ["config", "ops", "ops.kalman", "ops.kalman_sym", "models", "amis",
           "amis.dirichlet", "amis.cfc", "physics", "physics.rouse",
           "trajectory"]


def public_names(mod):
    """``__all__`` where the module has it; else every name that is not
    private, not an imported module and not imported from outside
    bild_tpu."""
    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    out = set()
    for name in dir(mod):
        obj = getattr(mod, name)
        if name.startswith("_"):
            continue
        if isinstance(obj, types.ModuleType):
            if obj.__name__.startswith(mod.__name__ + "."):
                out.add(name)
        elif getattr(obj, "__module__", "bild_tpu").startswith("bild_tpu"):
            out.add(name)
    return out


def resolve(mod, dotted):
    """``mod.<dotted>``; a submodule is imported if need be (a package's
    submodules appear in its namespace only once imported)."""
    obj = mod
    for part in dotted.split("."):
        try:
            obj = getattr(obj, part)
        except AttributeError:
            if not isinstance(obj, types.ModuleType):
                raise
            try:
                obj = importlib.import_module(f"{obj.__name__}.{part}")
            except ModuleNotFoundError:
                raise AttributeError(part) from None
    return obj


@pytest.mark.parametrize("name", ["", "parallel", "experimental"])
def test_public_names_exist_in_the_port(name):
    ref = getattr(bj, name) if name else bj
    port = getattr(bt, name) if name else bt
    public = {n for n in dir(ref) if not n.startswith("_")}
    assert sorted(public - set(dir(port))) == []


@pytest.mark.parametrize("name", MODULES)
def test_module_surface_exists_in_the_port(name):
    """Every public name of the module and every public attribute of its
    public classes, but `DO_NOT_PORT`, under its own name or its
    `RENAMED` counterpart."""
    ref = importlib.import_module(f"bild_tpu.{name}")
    port = importlib.import_module(f"bild_tpu_torch.{name}")
    missing = []
    for attr in sorted(public_names(ref)):
        key = f"{name}.{attr}"
        if key in DO_NOT_PORT:
            assert not hasattr(port, attr), f"{key} is ported after all"
            continue
        try:
            there = resolve(port, RENAMED.get(key, attr))
        except AttributeError:
            missing.append(key)
            continue
        obj = getattr(ref, attr)
        if inspect.isclass(obj):
            missing += [f"{key}.{m}" for m in dir(obj)
                        if not m.startswith("_") and not hasattr(there, m)]
    assert missing == []


def test_trajectory_abs_matches_bild_tpu(rng):
    data = rng.normal(size=(12, 3))
    data[[2, 7]] = np.nan
    want = bj.Trajectory.create(data, localization_error=0.1,
                                loopingprofile=np.arange(12) % 2).abs()
    got = bt.Trajectory.create(data, localization_error=0.1,
                               loopingprofile=np.arange(12) % 2,
                               dtype=torch.float64).abs()
    assert got.d == 1 and got.localization_error is None
    np.testing.assert_array_equal(got.loopingprofile, want.loopingprofile)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got[:], want[:], rtol=1e-14)


def test_rouse_check_dynamics():
    assert bt.physics.RouseModel(N=5, D=1.0, k=2.0, d=3, dt=1.0,
                                 device="cpu").check_dynamics() is True
    assert bj.physics.RouseModel(N=5, D=1.0, k=2.0, d=3,
                                 dt=1.0).check_dynamics() is True


def test_msrouse_logL_single_matches_bild_tpu(rng):
    jargs, targs, prof, *_ = make_case(rng, T=20, P=3, missing=(4,))
    for p in range(2):
        got = bt.ops.msrouse_logL_single(*targs[:8], prof[p], *targs[9:])
        assert got.dim() == 0
        want = j_single(*jargs[:8], jnp.asarray(prof[p]), *jargs[9:])
        np.testing.assert_allclose(float(got), float(want), rtol=1e-10)
        assert float(got) == float(bt.ops.msrouse_logL_batch(*targs)[p])


def test_dirichlet_class_matches_bild_tpu(rng, monkeypatch):
    """logpdf and estimate against bild_tpu's class; sample with injected
    gamma draws (normalized, exactly), and its moments against bild_tpu's
    draws."""
    a = np.array([0.7, 2.0, 3.5])
    ss = rng.dirichlet(a, size=300)
    lw = rng.normal(size=300)
    jd, td = bj.amis.Dirichlet(), bt.amis.Dirichlet()
    assert_close(td.logpdf(T_(a), T_(ss)), jd.logpdf(jnp.asarray(a), jnp.asarray(ss)))
    assert_close(td.estimate(T_(ss), T_(lw)),
                 jd.estimate(jnp.asarray(ss), jnp.asarray(lw)))
    g = rng.gamma(a, size=(5, 3))
    with monkeypatch.context() as m:
        m.setattr(tdir, "standard_gamma", lambda alpha, gen: T_(g))
        got = td.sample(T_(a), N=5)
    np.testing.assert_allclose(got.numpy(), g / g.sum(1, keepdims=True), rtol=1e-15)
    draws = td.sample(T_(a), N=20000, generator=torch.Generator().manual_seed(1))
    ref = np.asarray(jd.sample(jax.random.key(1), jnp.asarray(a), N=20000))
    assert draws.shape == (20000, 3) and draws.dtype == torch.float64
    se = ref.std(axis=0) / np.sqrt(20000)
    np.testing.assert_array_less(np.abs(draws.numpy().mean(0) - ref.mean(0)), 5 * se)


@pytest.mark.parametrize("tname", list(TRANSITIONS))
def test_cfc_methods_match_bild_tpu(rng, tname):
    """logpmf, estimate, logp_from_marginals and solve_marginals_single
    against bild_tpu's CFC in float64."""
    tr = TRANSITIONS[tname]
    n, K = tr.shape[0], 4
    jc, tc = jcfc.CFC(tr), tcfc.CFC(tr)
    thetas = jc.full_sample(K - 1)
    thetas = thetas[rng.integers(0, len(thetas), size=300)]
    lw = rng.normal(size=300)
    logp = np.log(rng.dirichlet(np.ones(n), size=K).T)
    assert_close(tc.logpmf(T_(logp), T_(thetas)),
                 jc.logpmf(jnp.asarray(logp), jnp.asarray(thetas)))
    est = tc.estimate(T_(thetas), T_(lw))
    assert_close(est, jc.estimate(jnp.asarray(thetas), jnp.asarray(lw)))
    marg = np.asarray(jc.uniform_marginals(K - 1), dtype=float)
    assert_close(tc.logp_from_marginals(T_(marg)),
                 jc.logp_from_marginals(jnp.asarray(marg)))
    logf, logg = marg[:, 2], marg[:, 1]
    assert_close(tc.solve_marginals_single(T_(logf), T_(logg)),
                 jc.solve_marginals_single(jnp.asarray(logf), jnp.asarray(logg)))
    tc.MOM_maxiter = jc.MOM_maxiter = 0          # no iteration: no convergence
    for c, x in ((tc, T_), (jc, jnp.asarray)):
        with pytest.raises(RuntimeError, match="converge"):
            c.estimate(x(thetas), x(lw))
        with pytest.raises(RuntimeError, match="converge"):
            c.logp_from_marginals(x(marg))


def test_cfc_sample_with_injected_draws(rng, monkeypatch):
    """`CFC.sample` is Gumbel-max sampling slot by slot: with its uniform
    draws injected, each trace is the argmax of the allowed weights plus
    that noise (as bild_tpu's `jax.random.categorical` draws); its trace
    frequencies match bild_tpu's sampler's."""
    tr = TRANSITIONS["n=3 chain"]
    logp = np.log(rng.dirichlet(np.ones(3), size=4).T)
    u = rng.uniform(size=(1, 4, 6, 3))
    tc = tcfc.CFC(tr)
    with monkeypatch.context() as m:
        m.setattr(tcfc, "uniform", lambda gen, shape, *a: T_(u).reshape(shape))
        got = tc.sample(T_(logp), N=6).numpy()
    gumbel = -np.log(-np.log(u[0]))                      # (k+1, N, n)
    for i in range(6):
        prev = None
        for slot in range(4):
            logits = logp[:, slot] if prev is None else np.where(
                tr[prev], logp[:, slot], -np.inf)
            prev = int(np.argmax(logits + gumbel[slot, i]))
            assert got[i, slot] == prev
    draws = tc.sample(T_(logp), N=20000, generator=torch.Generator().manual_seed(3))
    ref = np.asarray(jcfc.CFC(tr).sample(jax.random.key(3), jnp.asarray(logp), N=20000))
    for slot in range(4):
        f_port = np.bincount(draws[:, slot].numpy(), minlength=3) / 20000
        f_ref = np.bincount(ref[:, slot], minlength=3) / 20000
        np.testing.assert_allclose(f_port, f_ref, atol=0.02)


def test_util_is_profiles():
    assert bt.util is bt.profiles and bj.util is bj.profiles
