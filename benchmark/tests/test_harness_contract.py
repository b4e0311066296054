"""BENCHMARK.json against its rules (keys, names, units, bounds), the
import guard, and a whole run of each entry on the CPU at a tiny size: the
last line's keys, and a cell added as files and an entry only."""
import json
import re
import subprocess
import sys

import pytest

from benchmark import guard, harness
from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_spec_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and 1 <= SPEC["run_seconds"] <= 51
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    configs = {c["name"] for c in SPEC["configs"]}
    cells = [w["name"] for w in SPEC["workloads"]]
    assert len(set(cells)) == len(cells)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
        traffic = json.loads((ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json")
                             .read_text())
        assert (ROOT / "benchmark" / "entries" / f"{traffic['entry']}.py").exists()
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()
        moved = harness._named(SPEC["end_to_end"], m["moves"], "end-to-end metric")
        assert all(harness.applies(moved, cell) for cell in m.get("workloads", cells))
    for cell in cells:
        reported = [m for m in SPEC["end_to_end"] if harness.applies(m, cell)]
        assert len(reported) >= 2
        assert any(harness.applies(m, cell) for m in SPEC["per_layer"])


def test_import_guard():
    assert guard.forbidden_loaded(["bild_tpu_torch", "bild_tpu_torch.ops", "numpy"]) == []
    assert guard.forbidden_loaded(["bild_tpu", "bild_tpu_torch"]) == ["bild_tpu"]
    assert guard.forbidden_loaded(["jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib"]
    assert guard.forbidden_loaded(["bild_tpu.models"]) == ["bild_tpu"]


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_a_whole_run_on_the_cpu(small_checkout, cell, capsys):
    code, res = harness.run(cell, 2**31 + 5, 1.0, False, root=small_checkout, device="cpu")
    assert code == 0
    assert list(res) == KEYS
    assert res["correct"] is True and res["attempted"] > 0 and res["failed"] == 0
    wanted = {m["name"] for m in SPEC["end_to_end"] if harness.applies(m, cell)}
    assert set(res["metrics"]) == wanted
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    err = capsys.readouterr().err.strip().splitlines()
    assert all(line.startswith("check ") for line in err[-len(res["checks"]):])


def test_a_cell_is_added_by_files_alone(small_checkout):
    """A second traffic file and an entry in BENCHMARK.json: no file of the
    harness changes."""
    traffic = small_checkout / "benchmark" / "traffic"
    extra = json.loads((traffic / "sample-T100.json").read_text())
    extra.update(T=12, max_switches=2)
    (traffic / "sample-T12-extra.json").write_text(json.dumps(extra))
    spec = json.loads((small_checkout / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "rouse3-sample-T12", "config": "rouse3-config4",
                              "traffic": "sample-T12-extra", "chips": 1, "why": "a test"})
    (small_checkout / "BENCHMARK.json").write_text(json.dumps(spec))
    code, res = harness.run("rouse3-sample-T12", 77, 1.0, False, root=small_checkout,
                            device="cpu")
    assert code == 0 and res["correct"] is True
    assert set(res["metrics"]) == {"frame_accuracy", "setup_s"}


def test_no_card_no_result(small_checkout):
    """Without a CUDA device, or in a directory with only the benchmark,
    a run exits with another code than 0 and prints no result."""
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "rouse2-sample-T100",
         "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=small_checkout, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_a_window_that_uses_up_its_traffic_is_not_correct(small_checkout):
    """A window far longer than its two calls ends on the used-up traffic,
    however slowly the calls run."""
    path = small_checkout / "benchmark" / "traffic" / "sample-T100.json"
    traffic = json.loads(path.read_text())
    traffic["pool"] = 2
    path.write_text(json.dumps(traffic))
    code, res = harness.run("rouse2-sample-T100", 5, 1e9, False, root=small_checkout,
                            device="cpu")
    assert code == 0 and res["correct"] is False
    assert res["attempted"] == 2 and res["failed"] == 0
