"""The CLI `python -m bild_tpu_torch` against `python -m bild_tpu` on the
tiny CSV of tests/test_cli.py: parser, npz keys and shapes, best_k at a dE
margin, checkpoint reruns, the adaptive schedule, calibration, dwell
times and the options that are not ported."""
import numpy as np
import pytest

from bild_tpu.__main__ import _parse_looppositions as j_parse
from bild_tpu.__main__ import build_parser as j_build_parser
from bild_tpu.__main__ import main as j_main
from bild_tpu_torch.__main__ import _parse_looppositions as parse
from bild_tpu_torch.__main__ import build_parser, main
import test_torch_kalman  # noqa: F401  (one torch thread per worker)
from test_cli import CLI_FAST, tiny_csv  # noqa: F401  (the shared fixture)

CPU = ["--device", "cpu", "--dtype", "float64"]


def best_k(evidence, dE=2.0):
    return np.argmax(evidence >= evidence.max(axis=1, keepdims=True) - dE, axis=1)


def test_parser_matches_bild_tpu():
    got = vars(build_parser().parse_args(["data.csv"]))
    want = vars(j_build_parser().parse_args(["data.csv"]))
    assert got.pop("device") == "cuda" and got.pop("dtype") == "float32"
    assert got == want


@pytest.mark.parametrize("spec", ["none;0,-1", "none;0,-1;0,10", "none;0,-1,0.5",
                                  "none;0,-1+3,5", "none", "none;0"])
def test_parse_looppositions_matches_bild_tpu(spec):
    try:
        want = j_parse(spec)
    except ValueError:
        with pytest.raises(ValueError):
            parse(spec)
        return
    assert parse(spec) == want


@pytest.fixture(scope="module")
def both_runs(tiny_csv, tmp_path_factory):  # noqa: F811
    d = tmp_path_factory.mktemp("cli_runs")
    extra = ["--marginals", "--optimize-boundaries", "--dwell-times"]
    outs = {}
    for name, fn, args in (("jax", j_main, []), ("torch", main, CPU)):
        outs[name] = str(d / f"{name}.npz")
        assert fn([tiny_csv, "--out", outs[name], *CLI_FAST, *extra, *args]) == 0
    return ({k: dict(np.load(v, allow_pickle=True)) for k, v in outs.items()})


def test_cli_matches_bild_tpu(both_runs):
    got, want = both_runs["torch"], both_runs["jax"]
    assert set(got) == set(want)
    for key in want:
        assert np.shape(got[key]) == np.shape(want[key]), key
    np.testing.assert_array_equal(got["lengths"], [16, 16, 16, 24])
    assert [len(p) for p in got["best_profiles"]] == [16, 16, 16, 24]
    np.testing.assert_array_equal(best_k(got["evidence"]), best_k(want["evidence"]))
    for m, p in zip(got["log_marginal_posterior"], got["best_profiles"]):
        assert m.shape == (2, len(p))
        np.testing.assert_allclose(np.exp(m.astype(float)).sum(axis=0), 1.0, rtol=1e-10)
    assert got["optimized_profiles"][0].shape == (16,)
    for s in (0, 1):
        dur, cen = got[f"dwell_durations_state{s}"], got[f"dwell_censored_state{s}"]
        assert dur.shape == cen.shape and cen.dtype == bool


def test_checkpoint_rerun_identical(tiny_csv, tmp_path):  # noqa: F811
    ck = str(tmp_path / "ck")
    outs = [str(tmp_path / f"r{i}.npz") for i in range(2)]
    for out in outs:
        assert main([tiny_csv, "--out", out, *CLI_FAST, *CPU,
                     "--checkpoint-dir", ck]) == 0
    a, b = (np.load(o, allow_pickle=True) for o in outs)
    for key in ("evidence", "evidence_se", "best_k", "lengths"):
        np.testing.assert_array_equal(a[key], b[key])
    for x, y in zip(a["best_profiles"], b["best_profiles"]):
        np.testing.assert_array_equal(x, y)


def test_empty_input_fails(tmp_path, capsys):
    path = tmp_path / "empty.csv"
    path.write_text("traj_id,frame,v0\n")
    assert main([str(path), "--quiet", *CPU]) == 1
    assert "no trajectories" in capsys.readouterr().err


def test_warns_when_k_max_binds(tiny_csv, tmp_path, capsys):  # noqa: F811
    rc = main([tiny_csv, "--out", str(tmp_path / "cap.npz"), "--monomers", "8",
               "--k-max", "0", "--steps-per-k", "2", "--proposals", "8",
               "--scout-steps", "0", "--localization-error", "0.15",
               "--chunk-size", "4", "--quiet", *CPU])
    assert rc == 0
    assert "consider raising --k-max" in capsys.readouterr().err


def test_adaptive_fit_params_and_dwell_times(tiny_csv, tmp_path, capsys):  # noqa: F811
    out = str(tmp_path / "ad.npz")
    assert main([tiny_csv, "--out", out, *CLI_FAST, *CPU, "--adaptive",
                 "--fit-params", "1", "--fit-subset", "4", "--dwell-times"]) == 0
    res = np.load(out, allow_pickle=True)
    assert res["likelihood_evals"].shape == (4,)
    assert (res["likelihood_evals"] > 0).all()
    assert res["likelihood_evals"].dtype.kind == "i"
    D, k = float(res["fitted_D"]), float(res["fitted_k"])
    assert D > 0 and k > 0 and (D, k) != (1.0, 5.0)
    assert res["best_k"].shape == (4,)
    assert any(np.count_nonzero(~res[f"dwell_censored_state{s}"]) > 0
               for s in (0, 1))
    # narrated without --quiet
    assert main([tiny_csv, "--out", out, *CLI_FAST[:-1], *CPU]) == 0
    text = capsys.readouterr().out
    assert "4 trajectories, d=1" in text and f"wrote {out}" in text


@pytest.mark.parametrize("flag", ["--mesh", "--process-local"])
def test_sharded_options_name_item_16(flag, tiny_csv, tmp_path, capsys):  # noqa: F811
    """Without a process group in the environment ``--mesh`` is a one-rank
    mesh: the mesh-free run's npz. ``--process-local`` runs the sharded
    driver on this process's file and refuses ``--adaptive`` as bild_tpu
    does. The two-process runs are in tests/test_torch_distributed.py."""
    one, ref = str(tmp_path / "one.npz"), str(tmp_path / "ref.npz")
    assert main([tiny_csv, "--out", one, *CLI_FAST, *CPU, flag]) == 0
    got = np.load(one, allow_pickle=True)
    assert got["evidence"].shape == (4, 3) and np.isfinite(got["evidence"]).all()
    assert [len(p) for p in got["best_profiles"]] == [16, 16, 16, 24]
    if flag == "--mesh":
        assert main([tiny_csv, "--out", ref, *CLI_FAST, *CPU]) == 0
        want = np.load(ref, allow_pickle=True)
        np.testing.assert_array_equal(got["evidence"], want["evidence"])
        for x, y in zip(got["best_profiles"], want["best_profiles"]):
            np.testing.assert_array_equal(x, y)
    else:
        assert main([tiny_csv, flag, "--adaptive", *CPU]) == 1
        assert "does not combine with --adaptive" in capsys.readouterr().err


def test_no_gpu_does_not_fall_back(tmp_path, capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "one.csv"
    path.write_text("0,0,1.0\n0,1,2.0\n")
    assert main([str(path), "--quiet"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
