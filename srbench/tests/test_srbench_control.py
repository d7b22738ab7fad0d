"""The check that decides ``correct`` fails what it must, on the CPU at a
size a test run holds: the control (the reference in the precision below
the one the mix states) comes out not correct under each cell's limits,
and so does a whole run of the harness (the look for a card skipped) with
the program's timed path broken underneath, once for each fault a cell
can have.  The same run unbroken comes out correct.

    python3 -m pytest srbench/tests/test_srbench_control.py -q
"""

import json

import numpy as np
import pytest
import torch

from enph459_super_resolution_tpu_torch.ops.fused_ibp import FusedIBP
from enph459_super_resolution_tpu_torch.sr import classical
from srbench import generator, reference, run
from srbench.cells import HERE, Cell

# the benchmark's cells, and the bf16 mix on rgb_barcodes, whose cell has
# its calibrated limits but no entry (PERF.md, Open questions)
CELLS = [w["name"] for w in
         json.loads((HERE.parent / "BENCHMARK.json").read_text())[
             "workloads"]] + ["rgb_barcodes.bf16"]


def small(name):
    """The cell at a small size: LR 128 x 256 where the mix takes the fused
    kernels (the smallest shape they qualify at), 24 x 32 otherwise."""
    cell = Cell(name)
    fused = any(e == "fused" for e, _, _ in cell.traffic["launches"]["ibp"])
    cell.config["lr_shape"] = [128, 256] if fused else [24, 32]
    cell.traffic["pool_sessions"] = 2
    cell.traffic["check_calls"] = 2
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
    session = generator.render_session(cell.config, 2 ** 31 + 3, 0)
    units = session[: cell.units]
    want = reference.solve_call(
        units, reference.device_operators(cell.ops, "f64", "cpu"),
        cell.config)
    control = cell.traffic["control"]
    got = reference.solve_call(
        units, reference.device_operators(cell.ops, control, "cpu"),
        cell.config, control)
    gaps = reference.gaps(got, want)
    assert any(v > cell.limits[k] for k, v in gaps.items()), gaps


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
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_comes_out_not_correct(name, fault,
                                                   monkeypatch):
    cell = small(name)
    fault(monkeypatch)
    result = _run(cell)
    assert not result["correct"], result["checks"]
