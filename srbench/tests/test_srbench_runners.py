"""Runners on the CPU: a configuration names the runner its cells drive
(``srbench/runners/<runner>.py``, found by file name), and a runner that
is only new files runs through the shared window, check and result line;
a configuration that names none gets the classical runner, with the path
line and checks the benchmark has always printed.

    python3 -m pytest srbench/tests/test_srbench_runners.py -q
"""

import json
import shutil

import pytest

from srbench import reference, run
from srbench.cells import HERE, Cell
from srbench.work import calls

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
    (d / "configs" / "toy.json").write_text(json.dumps(
        {"name": "toy", "runner": "toy", "n": 64}))
    (d / "traffic" / "double.json").write_text(json.dumps(
        {"name": "double", "pool_sessions": 3, "check_calls": 2}))
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
