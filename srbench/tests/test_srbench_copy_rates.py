"""The copy-rate readers (``h2d_gb_per_s``, ``d2h_gb_per_s``) on the CPU:
the program's copy counters per call over the copies' device time per
call, exactly, and nothing for a program without the counters or a trace
without the copy.

    python3 -m pytest srbench/tests/test_srbench_copy_rates.py -q
"""

import pytest

from enph459_super_resolution_tpu_torch.sr import classical
from srbench import trace
from srbench.cells import Cell

CELLS = ["mono_cal_target.f32", "rgb_barcodes.f32",
         "mono_cal_target.f32_fused"]


def _readers(cell):
    return {m["name"]: r for m, r in cell.readers("layer_metrics")
            if m["name"] in ("h2d_gb_per_s", "d2h_gb_per_s")}


def _trace(ops):
    return trace.Trace([trace.Op(*o) for o in ops], [], 0, 200_000, 2)


@pytest.mark.parametrize("name", CELLS)
def test_copy_rates_are_counted_bytes_over_copy_time(name, monkeypatch):
    cell = Cell(name)
    read = _readers(cell)
    assert set(read) == {"h2d_gb_per_s", "d2h_gb_per_s"}
    # 4 calls of 62,914,560 bytes up and 163,578,176 back
    monkeypatch.setattr(classical._prepare, "calls", 4)
    monkeypatch.setattr(classical._prepare, "h2d_bytes", 4 * 62_914_560)
    monkeypatch.setattr(classical._to_host, "d2h_bytes", 4 * 163_578_176)
    # 2 calls: 10 ms of upload and 80 ms of copy back each (us)
    t = _trace([("Memcpy HtoD (Pageable -> Device)", 0, 20_000),
                ("Memcpy DtoH (Device -> Pageable)", 20_000, 180_000)])
    assert read["h2d_gb_per_s"].read(t, cell) == pytest.approx(
        62_914_560 / 10e-3 / 1e9)
    assert read["d2h_gb_per_s"].read(t, cell) == pytest.approx(
        163_578_176 / 80e-3 / 1e9)
    no_copies = _trace([("sgemm", 0, 100)])
    assert read["h2d_gb_per_s"].read(no_copies, cell) is None
    assert read["d2h_gb_per_s"].read(no_copies, cell) is None


def test_a_program_without_the_counters_reads_nothing(monkeypatch):
    cell = Cell("mono_cal_target.f32")
    read = _readers(cell)
    t = _trace([("Memcpy HtoD (Pageable -> Device)", 0, 20_000),
                ("Memcpy DtoH (Device -> Pageable)", 20_000, 180_000)])
    for attr in ("calls", "h2d_bytes"):
        monkeypatch.delattr(classical._prepare, attr)
    monkeypatch.delattr(classical._to_host, "d2h_bytes")
    assert read["h2d_gb_per_s"].read(t, cell) is None
    assert read["d2h_gb_per_s"].read(t, cell) is None
