"""The port's spans and copy counters on the CPU.

``utils.trace.span`` off: one shared object, nothing recorded, nothing
allocated.  On: nesting and order, the bounded buffer and its drop count,
and the profiler's clock (every ``aten::`` op of a block starts and ends
inside the block's span).  A CPU ``solve`` and ``solve_batch`` record the
span tree of ``sr.classical`` with one ``col_apply`` span per column apply;
``StageTimer`` stages and the kernels' first load are spans too.  The copy
counters count the float32 frames' bytes of an upload and nothing where
nothing crosses, and a CPU solve takes no page-locked copy back.
``bench_spans.py``'s attribution gives exact values on a synthetic trace.
"""

import collections
import importlib.util
import threading
import time
import tracemalloc
from pathlib import Path

import numpy as np
import pytest
import torch

from enph459_super_resolution_tpu_torch import _build
from enph459_super_resolution_tpu_torch.sr import classical
from enph459_super_resolution_tpu_torch.utils import trace
from enph459_super_resolution_tpu_torch.utils.timing import StageTimer

REPO = Path(__file__).resolve().parents[1]
SHIFTS = [(0.0, 0.0), (0.5, -0.5), (0.5, 0.5), (-0.5, -0.5), (-0.5, 0.5)]
N_ITER = 3


@pytest.fixture
def spans():
    """Spans on, at the default capacity, with an empty buffer; off and
    empty again afterwards."""
    trace.set_spans(True, capacity=trace.SPAN_CAPACITY)
    trace.drain_spans()
    yield
    trace.set_spans(False, capacity=trace.SPAN_CAPACITY)
    trace.drain_spans()


@pytest.fixture
def frames():
    rng = np.random.default_rng(3)
    return rng.uniform(0, 255, (len(SHIFTS), 12, 16)).astype(np.float32)


def _tree(got):
    return collections.Counter((s.name, s.parent) for s in got)


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def test_spans_off_record_nothing_and_allocate_nothing():
    assert trace.set_spans(False) is False
    trace.drain_spans()
    assert trace.span("a") is trace.span("b")
    with trace.span("warm"):
        pass
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with trace.span("solve") as s:
                with trace.span("col_apply"):
                    s.note(k=1)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    here = tracemalloc.Filter(True, trace.__file__)
    grew = [d for d in after.filter_traces([here]).compare_to(
        before.filter_traces([here]), "lineno") if d.size_diff > 0]
    assert grew == []
    assert trace.drain_spans() == ([], 0)


def test_spans_nest_in_the_order_they_close(spans):
    with trace.span("a"):
        with trace.span("b"):
            time.sleep(0.001)
        with trace.span("c") as c:
            c.note(kernel="k", compiled=False)
    got, dropped = trace.drain_spans()
    assert dropped == 0
    assert [(s.name, s.parent) for s in got] == [("b", "a"), ("c", "a"),
                                                 ("a", None)]
    b, c, a = got
    assert a.t0_ns <= b.t0_ns < b.t1_ns <= c.t0_ns <= c.t1_ns <= a.t1_ns
    assert b.t1_ns - b.t0_ns >= 1_000_000
    assert c.args == {"kernel": "k", "compiled": False} and a.args is None
    assert trace.drain_spans() == ([], 0)


def test_each_thread_nests_its_own_spans(spans):
    done = threading.Event()

    def other():
        with trace.span("worker"):
            done.set()

    with trace.span("main"):
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=10)
    assert not t.is_alive() and done.is_set()
    got, _ = trace.drain_spans()
    assert {(s.name, s.parent) for s in got} == {("worker", None),
                                                 ("main", None)}


def test_a_full_buffer_drops_the_oldest_and_counts_them(spans):
    trace.set_spans(True, capacity=3)
    for i in range(5):
        with trace.span(f"s{i}"):
            pass
    got, dropped = trace.drain_spans()
    assert [s.name for s in got] == ["s2", "s3", "s4"] and dropped == 2
    for i in range(3):
        with trace.span(f"t{i}"):
            pass
    trace.set_spans(True, capacity=2)   # shrinking keeps the newest
    got, dropped = trace.drain_spans()
    assert [s.name for s in got] == ["t1", "t2"] and dropped == 1
    with pytest.raises(ValueError):
        trace.set_spans(True, capacity=0)


def test_spans_share_the_profilers_clock_on_the_cpu(spans):
    """Every ``aten::`` op of a block starts and ends inside the block's
    span on kineto's clock (Unix ns), as a launch does on the card."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("ones"):
            a = torch.ones(128, 128)
        with trace.span("mm"):
            b = a.matmul(a)
        with trace.span("sum"):
            b.sum()
    got = {s.name: s for s in trace.drain_spans()[0]}
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("aten::")]
    top = {"aten::ones": "ones", "aten::matmul": "mm", "aten::mm": "mm",
           "aten::sum": "sum"}
    assert set(top) <= {e.name() for e in events}
    for e in events:
        inside = [n for n, s in got.items()
                  if s.t0_ns <= e.start_ns() and e.end_ns() <= s.t1_ns]
        assert len(inside) == 1, (e.name(), inside)
        if e.name() in top:
            assert inside == [top[e.name()]]


# ---------------------------------------------------------------------------
# where the program records them
# ---------------------------------------------------------------------------

def _solve_tree(n, n_iter, operators_miss):
    tree = collections.Counter({
        ("solve", None): 1, ("solve.prepare", "solve"): 1,
        ("solve.operators", "solve"): 1, ("solve.prologue", "solve"): 1,
        ("solve.ibp", "solve"): 1, ("solve.to_host", "solve"): 1,
        # native zoom, the frames' zoom and each frame's Shift-and-Add
        ("col_apply", "solve.prologue"): n + 2,
        # each frame's forward and back-projection, a rank-1 PSF
        ("col_apply", "solve.ibp"): 2 * n * n_iter})
    if operators_miss:
        tree[("operators.host", "solve.operators")] = 1
        tree[("operators.device", "solve.operators")] = 1
    return tree


@pytest.mark.parametrize("batch", [False, True])
def test_a_solve_records_its_span_tree(spans, frames, monkeypatch, batch):
    monkeypatch.setenv("SRTPU_OP_CACHE", "0")
    classical._device_matrices.cache_clear()
    psf = classical.make_gaussian_psf()

    def call():
        if batch:
            return classical.solve_batch(np.stack([frames, frames]), psf,
                                         SHIFTS, n_iter=N_ITER, device="cpu")
        return classical.solve(frames, psf, SHIFTS, n_iter=N_ITER,
                               device="cpu")

    try:
        for miss in (True, False):
            call()
            got, dropped = trace.drain_spans()
            assert dropped == 0
            assert _tree(got) == _solve_tree(len(SHIFTS), N_ITER, miss)
            by = {s.name: s for s in got if s.name != "col_apply"}
            phases = ["solve.prepare", "solve.operators", "solve.prologue",
                      "solve.ibp", "solve.to_host"]
            for a, b in zip(phases, phases[1:]):
                assert by[a].t1_ns <= by[b].t0_ns
            for s in got:
                if s.parent is not None:
                    p = by[s.parent]
                    assert p.t0_ns <= s.t0_ns <= s.t1_ns <= p.t1_ns
    finally:
        classical._device_matrices.cache_clear()


def test_the_fused_engine_has_column_applies_in_its_prologue_only(spans):
    """On the fused engine the IBP loop runs K2/K3 (their plain versions
    here): ``solve.ibp`` holds no ``col_apply``."""
    rng = np.random.default_rng(4)
    lr = rng.uniform(0, 255, (len(SHIFTS), 128, 256)).astype(np.float32)
    classical.solve(lr, classical.make_gaussian_psf(), SHIFTS, n_iter=2,
                    device="cpu", fused="on")
    tree = _tree(trace.drain_spans()[0])
    assert tree[("col_apply", "solve.prologue")] == len(SHIFTS) + 2
    assert tree[("col_apply", "solve.ibp")] == 0
    assert tree[("solve.ibp", "solve")] == 1


def test_conv_engine_and_landweber_record_their_top_spans(spans, frames):
    psf = classical.make_gaussian_psf()
    classical.solve(frames, psf, SHIFTS, n_iter=1, device="cpu",
                    engine="conv")
    tree = _tree(trace.drain_spans()[0])
    assert tree[("solve", None)] == 1 and tree[("solve.prepare", "solve")]
    hr0 = np.full((24, 32), 100.0, np.float32)
    classical.landweber_refine(hr0, frames, psf, SHIFTS, n_iter=2,
                               device="cpu")
    tree = _tree(trace.drain_spans()[0])
    assert tree[("landweber_refine", None)] == 1
    # two updates of a forward and an adjoint per frame, and the final fit
    assert tree[("col_apply", "landweber_refine")] == 5 * len(SHIFTS)


def test_stage_timer_stages_are_spans(spans):
    timer = StageTimer()
    with timer.stage("solve_batch"):
        with trace.span("solve"):
            pass
    timer.add("solve", 0.25)
    timer.add("solve", 0.5)
    got, _ = trace.drain_spans()
    assert [(s.name, s.parent) for s in got] == [("solve", "solve_batch"),
                                                 ("solve_batch", None)]
    t = timer.as_dict()
    assert t["solve"] == 0.75 and 0 < t["solve_batch"] < 1


def test_a_kernels_first_load_is_a_span(spans, monkeypatch, tmp_path):
    lib = tmp_path / "libk.so"
    built = []

    class Lib:
        k_launch = type("Fn", (), {})()

    def build(name):
        built.append(name)
        lib.write_bytes(b"")
        return "nvcc log"

    monkeypatch.setattr(_build, "_FUNCS", {})
    monkeypatch.setattr(_build, "library_path", lambda name: lib)
    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: Lib)
    assert _build.load_function("k", "k_launch", []) is Lib.k_launch
    assert _build.load_function("k", "k_launch", []) is Lib.k_launch
    got, _ = trace.drain_spans()
    assert built == ["k"]
    assert [(s.name, s.args) for s in got] == [
        ("kernels.load", {"kernel": "k", "symbol": "k_launch",
                          "compiled": True})]


# ---------------------------------------------------------------------------
# the copy counters
# ---------------------------------------------------------------------------

def test_the_upload_counter_counts_the_float32_frames(frames):
    calls, sent = classical._prepare.calls, classical._prepare.h2d_bytes
    psf = classical.make_gaussian_psf()
    u8 = frames.astype(np.uint8)
    lr, *_ = classical._prepare(u8, psf, SHIFTS, torch.device("meta"))
    assert lr.device.type == "meta" and lr.dtype == torch.float32
    assert classical._prepare.h2d_bytes - sent == u8.astype(
        np.float32).nbytes == len(SHIFTS) * 12 * 16 * 4
    sent = classical._prepare.h2d_bytes
    classical._prepare(lr, psf, SHIFTS, torch.device("meta"))
    classical._prepare(frames, psf, SHIFTS, "cpu")     # nothing crosses
    assert classical._prepare.h2d_bytes == sent
    assert classical._prepare.calls == calls + 3


def test_a_cpu_solve_copies_nothing_across(frames):
    sent = (classical._prepare.h2d_bytes, classical._to_host.d2h_bytes)
    out = classical.solve(frames, classical.make_gaussian_psf(), SHIFTS,
                          n_iter=1, device="cpu")
    assert sum(v.nbytes for v in out.values()) > 0
    assert (classical._prepare.h2d_bytes,
            classical._to_host.d2h_bytes) == sent


@pytest.mark.parametrize("units", [None, 2])
def test_a_cpu_solve_takes_no_pinned_copy(frames, units):
    """On the CPU the results are views of the solve's own tensors: no
    page-locked buffer, the same keys, shapes and dtype as ever."""
    pinned = classical._to_host.pinned_calls
    psf = classical.make_gaussian_psf()
    if units is None:
        out = classical.solve(frames, psf, SHIFTS, n_iter=N_ITER,
                              device="cpu")
        lead = ()
    else:
        out = classical.solve_batch(np.stack([frames] * units), psf, SHIFTS,
                                    n_iter=N_ITER, device="cpu")
        lead = (units,)
    assert classical._to_host.pinned_calls == pinned
    h, w = frames.shape[1:]
    assert {k: v.shape for k, v in out.items()} == {
        "lr_mean": lead + (h, w), "native": lead + (2 * h, 2 * w),
        "saa": lead + (2 * h, 2 * w), "ibp": lead + (2 * h, 2 * w),
        "mse_history": lead + (N_ITER,)}
    assert all(v.dtype == np.float32 and v.flags.writeable
               for v in out.values())


# ---------------------------------------------------------------------------
# bench_spans.py's attribution, on a synthetic trace
# ---------------------------------------------------------------------------

def _bench_spans():
    spec = importlib.util.spec_from_file_location("bench_spans",
                                                  REPO / "bench_spans.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _synthetic():
    S = trace.Span
    spans = [S("solve.prepare", "solve", 0, 100),
             S("col_apply", "solve.prologue", 110, 150),
             S("solve.prologue", "solve", 100, 200),
             S("col_apply", "solve.ibp", 210, 260),
             S("col_apply", "solve.ibp", 300, 350),
             S("solve.ibp", "solve", 200, 600),
             S("solve.to_host", "solve", 600, 700),
             S("solve", None, 0, 700),
             S("solve.prepare", "solve", 800, 900),
             S("solve", None, 800, 1000)]
    D = None
    ops = [("Memcpy HtoD (Pageable -> Device)", 50, 120, (40, 60)),
           ("void gather_kernel", 130, 160, (145, 155)),  # ends late
           ("banded_rows_kernel<float>", 170, 230, (160, 170)),
           ("sgemm_kernel", 240, 300, (220, 225)),
           ("elementwise_add", 300, 330, (270, 280)),    # the update
           ("sgemm_kernel", 400, 420, (310, 320)),
           ("elementwise_clamp", 420, 440, (400, 405)),
           ("Memcpy DtoH (Device -> Pageable)", 640, 690, (610, 612)),
           ("Memcpy HtoD (Pageable -> Device)", 850, 870, (820, 825)),
           ("orphan", 880, 890, D)]
    return spans, ops


def test_bench_spans_attribution_on_a_synthetic_trace():
    bs = _bench_spans()
    spans, raw = _synthetic()
    ops = [bs.DevOp(*o) for o in raw]

    def is_aten(name):
        return not name.startswith(("Memcpy", "banded_rows"))

    got = bs.split(ops, spans, 2, is_aten)
    # col_apply: gather 30 + the first sgemm 60 + the second 20, over 2
    assert got["col_apply_ms"] == pytest.approx(110 / 1e6 / 2)
    # solve.ibp outside col_apply: add 30 + clamp 20
    assert got["ibp_update_ms"] == pytest.approx(50 / 1e6 / 2)
    assert got["aten_by_span"]["none"] == pytest.approx(10 / 1e6 / 2)
    assert got["device_ms_by_span"]["solve.prologue"] == pytest.approx(
        60 / 1e6 / 2)
    # idle: 120-130 and 160-170 (prologue), 230-240 and 330-400 (ibp),
    # 440-640 (ibp 160, to_host 40), 690-850 (to_host 10, the caller 100,
    # prepare 50), 870-880 (the second solve)
    assert got["ibp_idle_ms"] == pytest.approx(240 / 1e6 / 2)
    assert got["entry_idle_ms"] == pytest.approx(130 / 1e6 / 2)
    assert got["caller_idle_ms"] == pytest.approx(100 / 1e6 / 2)
    assert got["idle_ms"] == pytest.approx(470 / 1e6 / 2)

    def is_k1(name):
        return name.startswith("banded_rows")

    chk = bs.clock_check(ops, spans, is_k1, True)
    # the gather's launch call (145, 155) outlasts its col_apply [110, 150)
    assert chk == {"no_launch_time": 1, "max_launch_outside_span_ns": 5,
                   "misplaced": {}}
    ops[2] = ops[2]._replace(launch=(120, 125))     # K1 inside col_apply
    ops[3] = ops[3]._replace(launch=(270, 275))     # a GEMM outside it
    ops[7] = ops[7]._replace(launch=(500, 505))     # a copy back in ibp
    assert bs.clock_check(ops, spans, is_k1, True)["misplaced"] == {
        "k1_in_col_apply": 1, "gemm_outside_col_apply": 1,
        "copy_back_outside_to_host": 1}
    assert bs.clock_check(ops, spans, is_k1, False)["misplaced"] == {
        "k1_in_col_apply": 1, "copy_back_outside_to_host": 1}
