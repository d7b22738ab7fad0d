"""Runners on the CPU: a configuration names the runner its cells drive
(``srbench/runners/<runner>.py``, found by file name), and a runner that
is only new files runs through the shared window, check and result line;
a configuration that names none gets the classical runner, with the path
line and checks the benchmark has always printed.  A cell of a new runner
is new files and new entries of ``BENCHMARK.json``: the benchmark's own
tests pass on a copy with one added, its limits can be calibrated, and
a cell whose runner has no fault tests is found.

    python3 -m pytest srbench/tests/test_srbench_runners.py -q
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

from srbench import calibrate, reference, run, runners
from srbench.cells import HERE, Cell
from srbench.work import calls

ROOT = HERE.parent

TOY = '''"""A toy runner: the program doubles a small tensor."""

import torch

from srbench.runners import Runner as _Runner

PROGRAM = "torch"


class Runner(_Runner):
    GAPS = ("double_max_abs",)

    def __init__(self, cell, device):
        super().__init__(cell, device)
        self.pixels = cell.config["n"]

    def load(self, seed):
        gen = torch.Generator().manual_seed(seed)
        self.pool = [torch.rand(self.cell.config["n"], generator=gen)
                     for _ in range(self.cell.traffic["pool_sessions"])]

    def call(self, x):
        return x * 2

    def keep(self, out):
        return out.clone()

    def check(self, kept):
        worst = 0.0
        for sid, out in kept.values():
            ref = self.pool[sid] + self.pool[sid]
            worst = max(worst, float((out - ref).abs().max()))
        return {"double_max_abs": worst}

    def control(self, sid):
        x = self.pool[sid]
        low = {"bf16": torch.bfloat16, "f16": torch.float16}[
            self.cell.traffic["control"]]
        got = (x.to(low) * 2).float()
        return {"double_max_abs": float((got - (x + x)).abs().max())}
'''

TOY_CONFIG = {"name": "toy", "runner": "toy", "n": 64}
TOY_MIX = {"name": "double", "pool_sessions": 3, "check_calls": 2,
           "control": "bf16"}

# The toy runner's fault tests, as a cell of a new runner brings them.
TOY_FAULTS = '''"""The toy runner's fault: a call that returns its input."""

from srbench import run
from srbench.cells import Cell


def test_a_call_that_returns_its_input_comes_out_not_correct(monkeypatch):
    cell = Cell("toy.double")
    module = cell.runner_module()
    monkeypatch.setattr(cell, "runner_module", lambda: module)
    monkeypatch.setattr(module.Runner, "call", lambda self, x: x)
    result = run.run_cell(cell, 2 ** 31 + 29, 0.2, False, device="cpu",
                          emit=lambda line: None)
    assert not result["correct"], result["checks"]
'''

# A per-layer metric of the toy cell's own: every cell reports one.
TOY_READER = '''"""Device time per call of every operation traced, ms."""


def read(trace, cell):
    return trace.ms_per_call(lambda name: True)
'''


def _toy_root(tmp_path):
    """A root holding a BENCHMARK.json with one toy cell, its files and
    the benchmark's end-to-end readers."""
    d = tmp_path / "srbench"
    for sub in ("configs", "traffic", "limits", "runners"):
        (d / sub).mkdir(parents=True)
    shutil.copytree(HERE / "e2e_metrics", d / "e2e_metrics")
    bench = {"configs": [{"name": "toy", "file": "srbench/configs/toy.json"}],
             "workloads": [{"name": "toy.double", "config": "toy",
                            "traffic": "double", "chips": 1}],
             "end_to_end": [{"name": "hr_mpix_per_s", "unit": "Mpix/s"},
                            {"name": "setup_s", "unit": "s"}],
             "per_layer": []}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (d / "configs" / "toy.json").write_text(json.dumps(TOY_CONFIG))
    (d / "traffic" / "double.json").write_text(json.dumps(TOY_MIX))
    (d / "limits" / "toy.double.json").write_text(json.dumps(
        {"double_max_abs": 0.0}))
    (d / "runners" / "toy.py").write_text(TOY)
    return tmp_path


def test_a_new_runner_is_new_files_only(tmp_path):
    cell = Cell("toy.double", root=_toy_root(tmp_path))
    assert cell.runner_module().PROGRAM == "torch"
    lines = []
    result = run.run_cell(cell, 2 ** 31 + 17, 0.2, False, device="cpu",
                          emit=lines.append)
    assert json.loads(lines[0]) == {"srbench": "path", "one_call": {},
                                    "implied": {}}
    timing = json.loads(lines[1])
    assert timing["srbench"] == "timing" and len(timing["kept"]) == 2
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] == timing["calls"] >= 1
    assert set(result["metrics"]) == {"hr_mpix_per_s", "setup_s"}
    assert result["metrics"]["hr_mpix_per_s"]["value"] == pytest.approx(
        64 * result["attempted"] / 1e6 / timing["window_s"])
    assert result["checks"] == {"double_max_abs": {"value": 0.0,
                                                   "limit": 0.0}}
    assert list(result)[-1] == "checks"


def test_a_toy_runner_that_is_wrong_comes_out_not_correct(tmp_path,
                                                          monkeypatch):
    cell = Cell("toy.double", root=_toy_root(tmp_path))
    module = cell.runner_module()
    monkeypatch.setattr(cell, "runner_module", lambda: module)
    monkeypatch.setattr(module.Runner, "call", lambda self, x: x * 2 + 1e-3)
    result = run.run_cell(cell, 2 ** 31 + 18, 0.2, False, device="cpu",
                          emit=lambda line: None)
    assert not result["correct"]
    assert result["checks"]["double_max_abs"]["value"] == pytest.approx(
        1e-3, rel=1e-3)


def test_a_missing_runner_names_its_file(tmp_path):
    root = _toy_root(tmp_path)
    (root / "srbench" / "runners" / "toy.py").unlink()
    with pytest.raises(FileNotFoundError, match="runner 'toy'"):
        Cell("toy.double", root=root).runner("cpu")


@pytest.mark.parametrize("name", ["mono_cal_target.f32", "rgb_barcodes.f32",
                                  "mono_cal_target.f32_fused"])
def test_a_configuration_without_a_runner_gets_the_classical_one(name):
    cell = Cell(name)
    assert "runner" not in cell.config
    module = cell.runner_module()
    assert module.PROGRAM == "enph459_super_resolution_tpu_torch.sr.classical"
    runner = cell.runner("cpu")
    assert runner.expected == calls.launches(cell.config, cell.traffic)
    assert runner.launch_counts().keys() >= {
        "banded_row_apply.launches", "banded_row_apply.launches_bf16",
        "fused_fwd_err.launches", "fused_bwd_update.launches"}
    assert module.Runner.GAPS == tuple(n for _, n in reference.GAPS)
    assert set(cell.limits) == set(module.Runner.GAPS)


def test_the_classical_runner_prints_the_path_and_checks_it_always_has():
    """The path line and the checks of a classical run on the CPU, at a
    small size: the keys the benchmark printed before runners."""
    cell = Cell("mono_cal_target.f32")
    cell.config["lr_shape"] = [24, 32]
    cell.traffic["pool_sessions"] = 2
    cell.traffic["check_calls"] = 2
    lines = []
    result = run.run_cell(cell, 2 ** 31 + 19, 0.2, False, device="cpu",
                          emit=lines.append)
    path = json.loads(lines[0])
    assert path == {"srbench": "path", "one_call": {},
                    "implied": {"banded_row_apply.launches": 807}}
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert set(result["checks"]) == {
        "lr_mean_max_abs", "native_max_abs", "saa_max_abs", "ibp_max_abs",
        "mse_max_rel"}
    assert result["correct"], result["checks"]
    timing = json.loads(lines[1])
    assert set(timing) == {"srbench", "setup_s", "window_s", "calls",
                           "check_s", "kept", "latencies_ms"}


def runners_without_fault_tests(root):
    """The runners that cells of ``root``'s ``BENCHMARK.json`` name, other
    than the classical one, with no ``test_srbench_runner_<name>.py``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    names = {Cell(w["name"], root=root).config.get("runner", "classical")
             for w in bench["workloads"]}
    tests = root / "srbench" / "tests"
    return sorted(n for n in names - {"classical"}
                  if not (tests / f"test_srbench_runner_{n}.py").exists())


def test_every_runner_of_a_cell_has_its_fault_tests():
    assert runners_without_fault_tests(ROOT) == []


def _copy_with_a_new_cell(tmp_path, fault_tests=True):
    """``BENCHMARK.json`` and ``srbench/`` copied, and the toy cell added
    to them as a new runner's cell is: new files, and one entry each in
    ``configs``, ``workloads`` and ``per_layer``."""
    root = tmp_path / "copy"
    root.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", root)
    shutil.copytree(HERE, root / "srbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    d = root / "srbench"
    files = {"runners/toy.py": TOY,
             "configs/toy.json": json.dumps(TOY_CONFIG),
             "traffic/double.json": json.dumps(TOY_MIX),
             "limits/toy.double.json": json.dumps({"double_max_abs": 0.0}),
             "layer_metrics/toy_device_ms.py": TOY_READER}
    if fault_tests:
        files["tests/test_srbench_runner_toy.py"] = TOY_FAULTS
    for name, text in files.items():
        assert not (d / name).exists(), name
        (d / name).write_text(text)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "toy", "source": "https://pytorch.org",
        "file": "srbench/configs/toy.json", "reduced": [],
        "why": "a tensor doubled"})
    bench["workloads"].append({
        "name": "toy.double", "config": "toy", "traffic": "double",
        "chips": 1, "why": "64 numbers doubled a call"})
    bench["per_layer"].append({
        "name": "toy_device_ms", "unit": "ms", "better": "lower",
        "source": "device_trace", "layer": "device",
        "moves": "hr_mpix_per_s", "workloads": ["toy.double"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def test_a_cell_of_a_new_runner_passes_the_benchmarks_own_tests(tmp_path):
    """The benchmark's tests, run on a copy with the toy cell added as new
    files and entries, pass every case of that cell."""
    root = _copy_with_a_new_cell(tmp_path)
    assert runners_without_fault_tests(root) == []
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "srbench/tests", "-q", "-rA",
         "-k", "toy", "-p", "no:cacheprovider", "-p", "no:randomly"],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    out = proc.stdout
    assert proc.returncode == 0, out[-4000:] + proc.stderr[-2000:]
    assert "FAILED" not in out and "ERROR" not in out
    for case in (
            "test_srbench_harness.py::"
            "test_every_cell_finds_its_files_by_name[toy.double]",
            "test_srbench_control.py::"
            "test_the_control_comes_out_not_correct[toy.double]",
            "test_srbench_control.py::"
            "test_the_reference_matches_the_programs_plain_path[toy.double]",
            "test_srbench_runner_toy.py::"
            "test_a_call_that_returns_its_input_comes_out_not_correct"):
        assert f"PASSED srbench/tests/{case}" in out, (case, out[-4000:])
    assert ("SKIPPED" in out and "test_srbench_card.py" in out), out[-4000:]


def test_a_runner_without_fault_tests_is_found(tmp_path):
    root = _copy_with_a_new_cell(tmp_path, fault_tests=False)
    assert runners_without_fault_tests(root) == ["toy"]


def test_limits_of_a_new_runner_are_calibrated(tmp_path):
    """``readings`` takes the toy runner's program and control readings,
    and ``propose`` sets its limit from them."""
    cell = Cell("toy.double", root=_toy_root(tmp_path))
    lines = []
    calibrate.readings(cell.runner("cpu"), [2 ** 31 + 23, 2 ** 31 + 24],
                       [2 ** 31 + 25], 0.1, emit=lines.append)
    rows = [json.loads(line) for line in lines]
    assert [r["reading"] for r in rows] == ["program"] * 2 + \
        ["control bf16"] * 2
    assert all(set(r["gaps"]) == {"double_max_abs"} for r in rows)
    got = calibrate.propose(lines)["double_max_abs"]
    # the program doubles exactly: an exact comparison, which bf16 fails
    assert got["lower"] == 0.0 and got["upper"] > 0.0
    assert got["limit"] == 0.0


def test_program_control_is_refused_for_another_runner(tmp_path,
                                                       monkeypatch, capsys):
    root = _toy_root(tmp_path)
    monkeypatch.setattr(calibrate, "Cell", lambda name: Cell(name, root))
    assert calibrate.main(["--workload", "toy.double", "--control-seeds",
                           "1", "--program-control", "TF32_TF32_F32"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "'toy'" in out.err


def test_a_runner_without_a_control_names_itself():
    class Runner(runners.Runner):
        pass

    Runner.__module__ = "srbench.runners.plain"
    with pytest.raises(NotImplementedError, match="runner 'plain'"):
        Runner(None, "cpu").control(0)
