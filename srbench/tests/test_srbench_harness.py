"""The benchmark harness on the CPU: every cell's files found by name, the
work counters against a brute-force count, the generator, the operators,
the trace readers and the guards.

    python3 -m pytest srbench/tests -q
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from srbench import generator, reference, run, trace
from srbench.cells import HERE, Cell
from srbench.work import calls, fused, k1, peaks
from srbench.work.nonzeros import SHARE

ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
# those whose configuration names no runner, or the classical one
CLASSICAL = [n for n in CELLS
             if Cell(n).config.get("runner", "classical") == "classical"]
PORT_DIR = ROOT / "enph459_super_resolution_tpu_torch"


def tiny(name, shape=(12, 16)):
    cell = Cell(name)
    cell.config["lr_shape"] = list(shape)
    return cell


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files_by_name(name):
    cell = Cell(name)
    assert cell.limits is not None
    assert set(cell.limits) == set(cell.runner_module().Runner.GAPS)
    assert cell.traffic["name"] == next(
        w["traffic"] for w in BENCH["workloads"] if w["name"] == name)
    for kind in ("e2e_metrics", "layer_metrics"):
        readers = cell.readers(kind)
        assert readers and all(callable(r.read) for _, r in readers)
    assert {m["name"] for m in cell.e2e} == {
        m["name"] for m in BENCH["end_to_end"]
        if name in m.get("workloads", [name])}
    assert "setup_s" in {m["name"] for m in cell.e2e} and len(cell.e2e) > 1


def test_benchmark_file_names_only_files_under_its_paths():
    for c in BENCH["configs"]:
        assert c["file"].startswith("srbench/") and (ROOT / c["file"]).exists()
    assert BENCH["paths"] == ["srbench"]


@pytest.mark.parametrize("name, want", [
    ("mono_cal_target.f32", {"banded_row_apply.launches": 807}),
    ("rgb_barcodes.f32", {"banded_row_apply.launches": 646}),
    ("mono_cal_target.f32_fused", {"banded_row_apply.launches": 7,
                                   "fused_fwd_err.launches": 80,
                                   "fused_bwd_update.launches": 80}),
    ("rgb_barcodes.bf16", {"banded_row_apply.launches_bf16": 6,
                           "fused_fwd_err.launches_bf16": 80,
                           "fused_bwd_update.launches_bf16": 80})])
def test_launch_plan_of_each_mix(name, want):
    cell = Cell(name)
    assert calls.launches(cell.config, cell.traffic) == want


def _columns(fn, n_in):
    """The matrix of a linear ``fn`` built one impulse at a time."""
    cols = []
    for j in range(n_in):
        e = np.zeros(n_in)
        e[j] = 1.0
        cols.append(fn(e))
    return np.stack(cols, axis=1)


@pytest.mark.parametrize("n, delta", [(300, 1.0), (300, -1.0), (150, 0.37),
                                      (260, 0.0)])
def test_shift_matrix_equals_the_impulse_responses(n, delta):
    want = _columns(lambda v: ndi.shift(v, delta, order=3, mode="nearest"),
                    n)
    assert np.abs(reference.shift_matrix(n, delta) - want).max() < 1e-14


@pytest.mark.parametrize("n", [40, 300])
def test_zoom_matrix_equals_the_impulse_responses(n):
    want = _columns(lambda v: ndi.zoom(v, 2, order=3), n)
    assert np.abs(reference.zoom_matrix(n, 2) - want).max() < 1e-14


def test_blur_compositions_equal_the_dense_products():
    rng = np.random.default_rng(0)
    taps = reference.gaussian_taps(7, 1.0) * np.arange(1, 8)
    a, b = rng.random((9, 40)), rng.random((40, 11))
    m = reference.blur_matrix(40, taps)
    assert np.abs(reference.blur_right(a, taps) - a @ m).max() < 1e-13
    assert np.abs(reference.blur_left(taps, b) - m @ b).max() < 1e-13


def test_operators_apply_the_upstream_scipy_calls():
    """fwd and bwd against the upstream forward model and back-projection
    on a random image (fftconvolve, ndi.shift, decimation, stuffing)."""
    import scipy.signal

    cell = tiny("mono_cal_target.f32", (10, 14))
    cfg, ops = cell.config, cell.ops
    psf = reference.psf(cfg)
    rng = np.random.default_rng(1)
    hr = rng.uniform(0, 255, (20, 28))
    err = rng.normal(0, 5, (10, 14))
    for i, (dy, dx) in enumerate(cfg["shifts"]):
        b = scipy.signal.fftconvolve(hr, psf, mode="same")
        want = ndi.shift(b, (2 * dy, 2 * dx), order=3,
                         mode="nearest")[::2, ::2]
        got = ops["y"]["fwd"][i] @ hr @ ops["x"]["fwd"][i].T
        assert np.abs(got - want).max() < 1e-9
        up = np.zeros((20, 28))
        up[::2, ::2] = err
        sh = ndi.shift(up, (-2 * dy, -2 * dx), order=3, mode="nearest")
        want = scipy.signal.fftconvolve(sh, psf[::-1, ::-1], mode="same")
        got = ops["y"]["bwd"][i] @ err @ ops["x"]["bwd"][i].T
        assert np.abs(got - want).max() < 1e-9
    z = ops["y"]["zoom"] @ err @ ops["x"]["zoom"].T
    assert np.abs(z - ndi.zoom(err, 2, order=3)).max() < 1e-9


def _nonzeros_by_entry(m):
    count = 0
    for row in np.abs(m):
        top = row.max()
        count += sum(1 for v in row if v > 0 and v >= SHARE * top)
    return count


@pytest.mark.parametrize("name", CLASSICAL + ["rgb_barcodes.bf16"])
def test_work_counters_match_a_brute_force_count(name):
    """Every launch's multiply-adds and bytes, counted entry by entry on
    the dense operators and launch by launch as the solve runs them."""
    cell = tiny(name)
    cfg, mix, ops = cell.config, cell.traffic, cell.ops
    r, n = cell.units, len(cfg["shifts"])
    h, w = cfg["lr_shape"]
    hh, ww = 2 * h, 2 * w
    oy, ox = ops["y"], ops["x"]
    rows = mix["launches"]["rows"]
    nz = _nonzeros_by_entry
    want = [(2.0 * nz(oy["zoom"]) * w * r, rows),
            (2.0 * nz(oy["zoom"]) * w * n * r, rows)]
    want += [(2.0 * nz(oy["saa"][i]) * ww * r, rows) for i in range(n)]
    engine, store, _ = mix["launches"]["ibp"][0]
    if engine == "banded":
        for _ in range(cfg["ibp"]["iterations"]):
            for i in range(n):
                want += [(2.0 * nz(oy["fwd"][i]) * ww * r, store),
                         (2.0 * nz(oy["bwd"][i]) * w * r, store)]
    got = k1.launch_list(cfg, mix, ops)
    assert sorted((f, s) for _, f, _, s in got) == sorted(want)
    band = peaks.BYTES[rows]
    zoom_bytes = 4.0 * (h + hh) * w * r + band * nz(oy["zoom"])
    assert got[0][2] == zoom_bytes
    if engine == "fused":
        (k2f, k2b), (k3f, k3b) = fused.iteration_work(cfg, mix, ops, store)
        distinct_dy = sorted({s[0] for s in cfg["shifts"]})
        first = [[s[0] for s in cfg["shifts"]].index(d) for d in distinct_dy]
        assert k2f == (sum(2.0 * r * nz(oy["fwd"][i]) * ww for i in first)
                       + sum(2.0 * r * h * nz(ox["fwd"][i])
                             for i in range(n)))
        assert k3f == sum(2.0 * r * nz(oy["bwd"][i]) * w
                          + 2.0 * r * hh * nz(ox["bwd"][i])
                          for i in range(n))
        io = peaks.BYTES[store]
        assert k2b > 4.0 * r * hh * ww + 2 * io * n * r * h * w
        assert k3b > 8.0 * r * hh * ww + io * n * r * h * w
        assert fused.bound_ms(cfg, mix, ops) > 0
    else:
        assert fused.bound_ms(cfg, mix, ops) == 0


def test_generator_repeats_for_one_seed():
    cfg = tiny("rgb_barcodes.f32", (20, 24)).config
    a = generator.render_session(cfg, 2 ** 31 + 11, 3)
    b = generator.render_session(cfg, 2 ** 31 + 11, 3)
    c = generator.render_session(cfg, 2 ** 31 + 12, 3)
    d = generator.render_session(cfg, 2 ** 31 + 11, 4)
    assert a.shape == (4, 4, 20, 24) and a.dtype == np.float32
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c) and not np.array_equal(a, d)
    assert np.array_equal(a, np.round(a)) and a.min() >= 0 and a.max() <= 255


def test_generator_moves_the_scene_by_each_frames_shift():
    """Without noise, frames of opposite shifts are one LR pixel apart
    (one HR pixel each way)."""
    cfg = dict(tiny("mono_cal_target.f32", (20, 24)).config)
    cfg["read_noise_dn"] = 0.0
    s = generator.render_session(cfg, 5, 0)[0]
    # frame 2 (+0.5, +0.5) and frame 3 (-0.5, -0.5): 2 HR px apart, and
    # ndi.shift moves content by +m: frame 2 row i + 1 is frame 3 row i
    assert np.array_equal(s[2][1:, 1:], s[3][:-1, :-1])
    assert not np.array_equal(s[2], s[3])


def _trace():
    ops = [trace.Op("Memcpy HtoD (Pageable -> Device)", 0, 100),
           trace.Op("void (anonymous namespace)::banded_rows_kernel<float, "
                    "true>(x)", 150, 250),
           trace.Op("(anonymous namespace)::fused_bwd_mma_kernel(y)", 260,
                    300),
           trace.Op("sm80_xmma_gemm_f32f32_f32f32", 300, 360),
           trace.Op("Memcpy DtoH (Device -> Pageable)", 400, 600)]
    host = [trace.Op("aten::copy_", 90, 160), trace.Op("cudaMemcpyAsync",
                                                       120, 140)]
    return trace.Trace(ops, host, 0, 1000, 2,
                       trace.port_kernels(PORT_DIR))


def test_trace_readers_on_a_synthetic_stretch():
    t = _trace()
    cell = Cell("mono_cal_target.f32_fused")
    read = {m["name"]: r.read(t, cell)
            for m, r in cell.readers("layer_metrics")
            if not m["name"].endswith("roofline")
            and m["source"] != "host_clock"}
    assert read["h2d_ms"] == pytest.approx(0.05)
    assert read["k1_ms"] == pytest.approx(0.05)
    assert read["fused_ms"] == pytest.approx(0.02)
    assert read["aten_ms"] == pytest.approx(0.03)
    assert read["d2h_ms"] == pytest.approx(0.1)
    assert read["device_idle_share"] == pytest.approx(50.0)
    assert t.busy_s() == pytest.approx(500e-6)
    b = t.breakdown()
    assert b["device_ops"][0] == ["Memcpy DtoH (Device -> Pageable)",
                                  pytest.approx(200e-6)]
    assert b["idle_gaps"][0] == ["no host op", pytest.approx(400e-6)]
    assert ["cudaMemcpyAsync", pytest.approx(50e-6)] in b["idle_gaps"]


def test_a_reader_finds_nothing_where_nothing_ran():
    t = trace.Trace([trace.Op("Memcpy HtoD (Pageable -> Device)", 0, 10)],
                    [], 0, 100, 1, trace.port_kernels(PORT_DIR))
    cell = Cell("mono_cal_target.f32_fused")
    for m, r in cell.readers("layer_metrics"):
        if m["name"] in ("k1_ms", "fused_ms", "row_apply_roofline",
                         "fused_roofline", "aten_ms", "d2h_ms",
                         "col_apply_ms", "ibp_update_ms"):
            assert r.read(t, cell) is None


def test_host_clock_reader_leaves_out_the_traced_calls():
    cell = Cell("rgb_barcodes.f32")
    (m, r), = [(m, r) for m, r in cell.readers("layer_metrics")
               if m["name"] == "call_p90_ms"]
    assert m["source"] == "host_clock"
    lat = [0.1] * 18 + [0.2, 0.3]
    win = run.Window(lat + [9.0] * 3, 0, 1.0, 0.0, 23, 0, {}, None,
                     range(20, 23))
    assert r.read(win, cell) == pytest.approx(np.percentile(lat, 90) * 1e3)
    assert r.read(win._replace(latencies_s=[9.0] * 3,
                               traced_calls=range(3)), cell) is None


def test_port_kernels_are_the_programs_global_functions():
    names = trace.port_kernels(PORT_DIR)
    for k in ("banded_rows_kernel", "banded_rows_span_kernel",
              "fused_fwd_mma_kernel", "fused_fwd_f32_kernel",
              "fused_bwd_mma_kernel", "fused_bwd_f32_kernel"):
        assert k in names
    assert "__launch_bounds__" not in names


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    monkeypatch.setitem(sys.modules, "enph459_super_resolution_tpu_torch_x",
                        sys)
    assert "jax" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    monkeypatch.setitem(sys.modules, "enph459_super_resolution_tpu.sr", sys)
    assert run.forbidden_modules() == ["enph459_super_resolution_tpu",
                                       "jaxlib"]


def test_run_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc == 2 and out.out == "" and "CUDA" in out.err


def test_run_refuses_an_unknown_cell(capsys):
    assert run.main(["--workload", "nope", "--seed", "1",
                     "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_run_refuses_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and srbench/, the run
    exits non-zero and prints no result."""
    import shutil
    import subprocess

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "srbench", tmp_path / "srbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    proc = subprocess.run(
        [sys.executable, "-m", "srbench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1"], cwd=tmp_path,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def test_limits_are_set_between_the_readings():
    from srbench.calibrate import propose

    def line(reading, **gaps):
        full = {name: 0.0 for _, name in reference.GAPS}
        full.update(gaps)
        return json.dumps({"reading": reading, "gaps": full})

    lines = [line("program", ibp_max_abs=1e-4),
             line("program", ibp_max_abs=2e-4),
             line("control tf32", ibp_max_abs=0.2, lr_mean_max_abs=0.05),
             line("control tf32", ibp_max_abs=0.3),
             line("program TF32", ibp_max_abs=4e-4)]
    got = propose(lines)
    ibp = got["ibp_max_abs"]
    # the program's own TF32 path read under 3x the lower: no upper there
    assert ibp["lower"] == 2e-4 and ibp["upper"] == 0.2
    assert ibp["limit"] == pytest.approx((2e-4) ** (1 / 3) * 0.2 ** (2 / 3))
    assert 2e-4 < ibp["limit"] < 0.2
    # every program reading 0: an exact comparison
    assert got["lr_mean_max_abs"]["limit"] == 0.0
