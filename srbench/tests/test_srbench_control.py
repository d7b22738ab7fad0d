"""The check that decides ``correct`` fails what it must, on the CPU at
the size each cell's runner shrinks it to: the control (the reference in
the precision below the one the mix states, the runner's ``control``)
comes out not correct under each cell's limits, and the same run unbroken
comes out correct.  For the classical cells, so does a whole run of the
harness (the look for a card skipped) with the program's timed path
broken underneath, once for each fault a cell can have; another runner's
faults are in ``test_srbench_runner_<name>.py``.

    python3 -m pytest srbench/tests/test_srbench_control.py -q
"""

import json

import numpy as np
import pytest
import torch

from enph459_super_resolution_tpu_torch.ops.fused_ibp import FusedIBP
from enph459_super_resolution_tpu_torch.sr import classical
from srbench import generator, reference, run, runners
from srbench.cells import HERE, Cell

# the benchmark's cells, and the bf16 mix on rgb_barcodes, whose cell has
# its calibrated limits but no entry (PERF.md, Open questions)
CELLS = [w["name"] for w in
         json.loads((HERE.parent / "BENCHMARK.json").read_text())[
             "workloads"]] + ["rgb_barcodes.bf16"]
# those whose configuration names no runner, or the classical one
CLASSICAL = [n for n in CELLS
             if Cell(n).config.get("runner", "classical") == "classical"]


def small(name):
    """The cell at the size its runner's ``shrink`` gives."""
    cell = Cell(name)
    cell.runner_module().Runner.shrink(cell)
    return cell


@pytest.fixture(autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 4))
    yield
    torch.set_num_threads(saved)


def _run(cell):
    return run.run_cell(cell, 2 ** 31 + 9, 0.2, False, device="cpu",
                        emit=lambda line: None)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_comes_out_not_correct(name):
    cell = small(name)
    runner = cell.runner("cpu")
    runner.load(2 ** 31 + 3)
    gaps = runner.control(0)
    assert set(gaps) == set(runner.GAPS)
    assert any(v > cell.limits[k] for k, v in gaps.items()), gaps


@pytest.mark.parametrize("name", CLASSICAL)
def test_the_classical_control_is_the_reference_in_the_mixs_arithmetic(
        name):
    """The classical runner's control, number for number: the reference
    in the mix's ``control`` arithmetic against float64, on the first
    session of the seed's pool; at the base runner's CPU size (LR 24 x
    32), since the control runs no kernel of the program."""
    cell = Cell(name)
    runners.Runner.shrink(cell)
    runner = cell.runner("cpu")
    runner.load(2 ** 31 + 3)
    session = generator.render_session(cell.config, 2 ** 31 + 3, 0)
    units = session[: cell.units]
    want = reference.solve_call(
        units, reference.device_operators(cell.ops, "f64", "cpu"),
        cell.config)
    control = cell.traffic["control"]
    got = reference.solve_call(
        units, reference.device_operators(cell.ops, control, "cpu"),
        cell.config, control)
    assert runner.control(0) == reference.gaps(got, want)


@pytest.mark.parametrize("name", CELLS)
def test_the_reference_matches_the_programs_plain_path(name):
    """A whole run on the CPU, where the program runs its kernels' plain
    versions, comes out correct."""
    result = _run(small(name))
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1


def _unchanged(monkeypatch):
    """A step that returns its state unchanged."""
    banded = classical._banded_update

    def step(hr, *args):
        return hr, banded(hr, *args)[1]

    monkeypatch.setattr(classical, "_banded_update", step)
    monkeypatch.setattr(FusedIBP, "bwd_update",
                        lambda self, hr, err, *a, **k: hr)


def _half(monkeypatch):
    """Half of the frames left out of the update, the mean taken over the
    rest."""
    banded = classical._banded_update
    fused = FusedIBP.bwd_update

    def step(hr, lr_stack, frames, step, clip, reps, plain):
        k = lr_stack.shape[0] // 2
        return banded(hr, lr_stack[:k], frames[:k], step, clip, reps, plain)

    def update(self, hr, err, scale, clip, plain=False):
        k = err.shape[0] // 2
        kept = err.clone()
        kept[k:] = 0
        return fused(self, hr, kept, scale * err.shape[0] / k, clip, plain)

    monkeypatch.setattr(classical, "_banded_update", step)
    monkeypatch.setattr(FusedIBP, "bwd_update", update)


def _altered(monkeypatch):
    """An answer altered where it is produced: one IBP pixel of every
    call, as it leaves the card."""
    to_host = classical._to_host

    def altered(result):
        out = to_host(result)
        ibp = out["ibp"].reshape(-1)
        ibp[np.argmin(ibp)] += 64.0
        return out

    monkeypatch.setattr(classical, "_to_host", altered)


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
@pytest.mark.parametrize("name", CLASSICAL)
def test_a_broken_timed_path_comes_out_not_correct(name, fault,
                                                   monkeypatch):
    cell = small(name)
    fault(monkeypatch)
    result = _run(cell)
    assert not result["correct"], result["checks"]
