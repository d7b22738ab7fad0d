"""The harness end to end on the card, at the size each cell's runner
shrinks it to for the card (LR 128 x 256, which the fused kernels take):
the path check passes, every listed per-layer metric reads, and the run
is correct.  Skips without a card.

    python3 -m pytest srbench/tests/test_srbench_card.py -q
"""

import json

import pytest
import torch

from srbench import run
from srbench.cells import HERE, Cell

CELLS = [w["name"] for w in
         json.loads((HERE.parent / "BENCHMARK.json").read_text())[
             "workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    run.point_caches()


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_small_run_on_the_card(card, name):
    cell = Cell(name)
    cell.runner_module().Runner.shrink(cell, card=True)
    lines = []
    traced = run.run_cell(cell, 2 ** 31 + 5, 0.5, True, emit=lines.append)
    path = json.loads(lines[1])
    assert path["one_call"] == path["implied"]
    assert traced["correct"], traced["checks"]
    assert set(traced["metrics"]) == {m["name"] for m in cell.per_layer}
    assert traced["device"]["busy_s"] > 0
    assert traced["breakdown"]["device_ops"]
    plain = run.run_cell(cell, 2 ** 31 + 6, 0.5, False, emit=lines.append)
    assert plain["correct"], plain["checks"]
    assert set(plain["metrics"]) == {m["name"] for m in cell.e2e}
