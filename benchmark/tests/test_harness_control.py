"""The control on the card: each cell run with the program's bfloat16 tier
of the Rouse likelihood (``set_rouse_matmul("split")``, one precision below
the configurations' float32) comes out not correct, and the same seed at
float32 correct. A short window at the cell's own sizes; needs the card."""
import json

import pytest

from benchmark import harness
from conftest import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cuda, cell):
    seed = 2**31 + 4242
    code, res = harness.run(cell, seed, 10.0, False, matmul="split")
    assert code == 0 and res["correct"] is False, res["checks"]
    code, res = harness.run(cell, seed, 10.0, False)
    assert code == 0 and res["correct"] is True, res["checks"]
