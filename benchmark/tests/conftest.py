"""Shared pieces of the benchmark's CPU tests: a temporary checkout of
``BENCHMARK.json`` and ``benchmark/`` whose traffic files are cut to a size
the CPU runs in seconds, and the ``cuda`` marker's fixture."""
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# tiny sizes of each entry's traffic (the configurations keep their widths);
# at them a dataset row's evidence carries more Monte Carlo error than at
# the cells' sizes, so its limit is wider here
SMALL = {
    "sample": {"T": 20, "pool": 512, "warmup_calls": 1,
               "call": {"k_max": 3, "init_runs": 4}, "check": {"calls": 3}},
    "sample_dataset": {"T": 20, "per_call": 16, "max_calls": 256,
                       "call": {"k_max": 2, "steps_per_k": 4, "N": 32, "scout_steps": 2,
                                "refine_top": 2, "max_steps_per_k": 6, "init_steps": 2},
                       "check": {"rows": 8, "limits": {"evidence_nats": 5.0}}},
}


def shrink(traffic):
    small = SMALL[traffic["entry"]]
    out = {**traffic, **{k: v for k, v in small.items() if k not in ("call", "check")}}
    out["call"] = {**traffic["call"],
                   **{k: v for k, v in small["call"].items() if k in traffic["call"]}}
    out["check"] = {**traffic["check"], **small["check"],
                    "limits": {**traffic["check"]["limits"],
                               **small["check"].get("limits", {})}}
    return out


@pytest.fixture
def small_checkout(tmp_path):
    """A copy of the benchmark with every traffic file cut to a CPU size."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for path in (tmp_path / "benchmark" / "traffic").glob("*.json"):
        path.write_text(json.dumps(shrink(json.loads(path.read_text()))))
    return tmp_path


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")


@pytest.fixture(autouse=True)
def _numpy_errors():
    with np.errstate(all="ignore"):
        yield
