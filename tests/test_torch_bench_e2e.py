"""bench_e2e_torch.py, the port's counterpart of bench_e2e.py, on the CPU:
the same truths, every config at a tiny size in float64 with bench_e2e.py's
result keys plus the port's, bench_e2e.py's CLI errors and tier suffixes,
no run without a card, and no JAX."""
import ast
import inspect
import os
import sys
import textwrap
import warnings

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench_e2e  # noqa: E402  (bench_e2e.py imports JAX only inside its configs)
import bench_e2e_torch as be  # noqa: E402
import bild_tpu_torch as bt  # noqa: E402
from test_torch_bench import no_jax_modules  # noqa: E402
import test_torch_kalman  # noqa: E402,F401  (one torch thread per worker)

F64 = torch.float64
NEW_KEYS = {"device", "kernel", "matmul_tier"}
SMALL = dict(k_max=2, steps_per_k=4, N=16, scout_steps=2, refine_top=2)
# each config at a tiny size: the port's keyword arguments
TINY = {
    "2": dict(n_parity=4, k_max=2, init_runs=2, sampler_kw=dict(N=16)),
    "3": dict(B=4, T=30, **SMALL),
    "4": dict(B=3, T=40, **SMALL),
    "5": dict(B_total=8, chunk=4, T=30, **SMALL),
    "5p": dict(B_total=8, chunk=4, T=30, **SMALL),
    "6": dict(B=4, T=20, **SMALL),
    "7": dict(B=3, T=48, T_band=32, **SMALL),
}
# bench_e2e.py's truths: (seed, B, T, states, chunks drawn one after another)
TRUTHS = {3: (128, 100, 2, 1), 4: (16, 1000, 3, 1), 5: (1024, 100, 2, 10),
          6: (64, 100, 2, 1), 7: (16, 1000, 2, 1)}


def bench_e2e_keys(config):
    """The result keys of bench_e2e.py's ``config`` ("2" .. "7", "5p"),
    read from its source, and the "matmul" its main() adds."""
    fn = getattr(bench_e2e, f"config{config[0]}")
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    keys = {"matmul"}
    for node in ast.walk(tree):
        if isinstance(node, (ast.Return, ast.Assign)) and isinstance(node.value, ast.Dict):
            keys |= {k.value for k in node.value.keys}
        if (config == "5p" and isinstance(node, ast.Assign)
                and isinstance(node.targets[0], ast.Subscript)):
            keys.add(node.targets[0].slice.value)
    return keys


@pytest.mark.parametrize("seed", sorted(TRUTHS))
def test_truths_are_bench_e2e_s(seed):
    B, T, n, chunks = TRUTHS[seed]
    mine, theirs = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(chunks):
        got = be.truth_profiles(mine, B, T, n)
        np.testing.assert_array_equal(got, bench_e2e._truth_profiles(theirs, B, T, n))
        assert got.shape == (B, T) and set(np.unique(got)) <= set(range(n))
        np.testing.assert_array_equal(be.switch_counts(got),
                                      np.sum(got[:, 1:] != got[:, :-1], axis=1))


@pytest.mark.parametrize("config", list(be.RUNNERS))
def test_config_keys(config):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)    # config 7's short band
        out = be.run_configs([config], "exact", device="cpu",
                             **{config: dict(dtype=F64, **TINY[config])})
    assert list(out) == [config]
    r = out[config]
    assert set(r) == bench_e2e_keys(config) | NEW_KEYS
    assert r["config"] == int(config[0]) and r["matmul"] == "exact"
    assert r["device"] == {"name": "cpu", "power_limit": None}
    rouse = config not in ("6", "7")
    assert r["kernel"] == ("auto" if rouse else None)
    assert r["matmul_tier"] == ("exact" if rouse else None)
    assert 0.0 <= r["frame_accuracy"] <= 1.0
    if config == "2":
        assert r["kernel_parity_rel_vs_f64_oracle"] < 1e-9    # float64


def test_tier_suffix_and_restore():
    assert bt.config.rouse_matmul() == "exact"
    kw = {"3": dict(dtype=F64, **TINY["3"])}
    out = be.run_configs(["3"], "auto", device="cpu", **kw)
    assert list(out) == ["3_auto"] and out["3_auto"]["matmul"] == "auto"
    # 'auto' on the lockstep path resolves to 'split' (float64 computes it exactly)
    assert out["3_auto"]["matmul_tier"] == "split"
    assert bt.config.rouse_matmul() == "exact"
    assert list(be.run_configs(["3"], "exact", device="cpu", **kw)) == ["3"]


def test_unknown_config_fails_as_bench_e2e(tmp_path):
    assert "unknown config {c!r}; valid configs: " in inspect.getsource(bench_e2e.main)
    with pytest.raises(SystemExit) as e:
        be.main(["--configs", "3,9", "--out", str(tmp_path / "x.json")])
    assert str(e.value) == "unknown config '9'; valid configs: 2, 3, 4, 5, 5p, 6, 7"
    assert not (tmp_path / "x.json").exists()


def test_parse_args_defaults():
    args = be.parse_args([])
    assert args.configs == ["2", "3", "4", "6", "7"]
    assert args.matmul == "exact" and args.out == "PERF_torch.json"
    with pytest.raises(SystemExit):
        be.parse_args(["--matmul", "fast"])


def test_main_without_card_runs_nothing(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "r.json"
    assert be.main(["--configs", "6", "--out", str(out)]) == 1
    printed = capsys.readouterr()
    assert printed.out == "" and "no CUDA device" in printed.err
    assert not out.exists()


def test_imports_no_jax():
    assert no_jax_modules("bench_e2e_torch") == []
    assert no_jax_modules("chip_smoke") == []
    assert "jax" in no_jax_modules("bench_e2e, bild_tpu")    # the check sees JAX
