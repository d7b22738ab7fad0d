"""The span readers on the CPU: device time of a synthetic traced
stretch put down to the program's spans, exactly; the
launch of each device operation from the profiler's correlation ids; the
window's routing of spans in a traced run, and the outputs it holds
between calls.

    python3 -m pytest srbench/tests/test_srbench_spans.py -q
"""

import types
import weakref

import pytest
import torch

from srbench import run, spans, trace
from srbench.cells import HERE, Cell

PORT_DIR = HERE.parent / "enph459_super_resolution_tpu_torch"
SPAN_METRICS = ("col_apply_ms", "ibp_update_ms")
CELLS = ["mono_cal_target.f32", "rgb_barcodes.f32",
         "mono_cal_target.f32_fused"]


def _synthetic():
    """Two calls, us: spans as the program nests them, and device
    operations with the host interval of their launch."""
    S = trace.Span
    spans_ = [S("solve.prepare", "solve", 0, 100),
              S("col_apply", "solve.prologue", 110, 150),
              S("solve.prologue", "solve", 100, 200),
              S("col_apply", "solve.ibp", 210, 260),
              S("col_apply", "solve.ibp", 300, 350),
              S("solve.ibp", "solve", 200, 600),
              S("solve.to_host", "solve", 600, 700),
              S("solve", None, 0, 700),
              S("solve.prepare", "solve", 800, 900),
              S("solve", None, 800, 1000)]
    ops = [("Memcpy HtoD (Pageable -> Device)", 50, 120, (40, 60)),
           ("void gather_kernel", 130, 160, (145, 155)),  # ends late
           ("void (anonymous namespace)::banded_rows_kernel<float, "
            "true>(x)", 170, 230, (160, 170)),
           ("sgemm_kernel", 240, 300, (220, 225)),
           ("elementwise_add", 300, 330, (270, 280)),    # the update
           ("sgemm_kernel", 400, 420, (310, 320)),
           ("elementwise_clamp", 420, 440, (400, 405)),
           ("Memcpy DtoH (Device -> Pageable)", 640, 690, (610, 612)),
           ("Memcpy HtoD (Pageable -> Device)", 850, 870, (820, 825)),
           ("orphan", 880, 890, None)]
    ops = [trace.Op(*o) for o in ops]
    return trace.Trace(ops, [], 50, 890, 2, trace.port_kernels(PORT_DIR),
                       spans_)


def test_split_puts_device_time_down_to_the_spans():
    t = _synthetic()
    aten = spans.device_ms_by_span(t, t.is_aten)
    # col_apply: gather 30 + the first sgemm 60 + the second 20, over 2
    assert aten["col_apply"] == pytest.approx(110 / 1e3 / 2)
    # solve.ibp outside col_apply: add 30 + clamp 20
    assert aten["solve.ibp"] == pytest.approx(50 / 1e3 / 2)
    assert aten[spans.NONE] == pytest.approx(10 / 1e3 / 2)
    assert set(aten) == {"col_apply", "solve.ibp", spans.NONE}
    every = spans.device_ms_by_span(t)
    assert every["solve.prologue"] == pytest.approx(60 / 1e3 / 2)
    assert sum(every.values()) == pytest.approx(
        sum(o.end - o.start for o in t.device) / 1e3 / 2)
    assert spans.no_launch(t) == 1


@pytest.mark.parametrize("name", CELLS)
def test_span_readers_read_the_split(name):
    cell = Cell(name)
    t = _synthetic()
    read = {m["name"]: r.read(t, cell) for m, r in
            cell.readers("layer_metrics") if m["name"] in SPAN_METRICS}
    assert read == pytest.approx({"col_apply_ms": 110 / 1e3 / 2,
                                  "ibp_update_ms": 50 / 1e3 / 2})
    # aten_ms = col_apply + ibp_update + the rest, by span
    aten = {m["name"]: r for m, r in cell.readers("layer_metrics")}[
        "aten_ms"].read(t, cell)
    assert aten == pytest.approx(sum(
        spans.device_ms_by_span(t, t.is_aten).values()))
    assert aten > read["col_apply_ms"] + read["ibp_update_ms"]


def test_span_readers_find_nothing_without_spans():
    cell = Cell("mono_cal_target.f32")
    t = _synthetic()
    bare = trace.Trace(t.device, [], t.start, t.end, 2,
                       trace.port_kernels(PORT_DIR))
    no_loop = trace.Trace(t.device, [], t.start, t.end, 2,
                          trace.port_kernels(PORT_DIR),
                          [s for s in t.spans if s.name == "solve.prepare"])
    for m, r in cell.readers("layer_metrics"):
        if m["name"] in SPAN_METRICS:
            assert r.read(bare, cell) is None
            assert r.read(no_loop, cell) is None


class _Event:
    """A ``FunctionEvent`` of a CUDA activity profile, as far as
    :func:`srbench.trace.from_profiler` reads it."""

    def __init__(self, name, start, end, cid, device):
        from torch.autograd import DeviceType

        self.name, self.id = name, cid
        self.time_range = types.SimpleNamespace(start=start, end=end)
        self.device_type = DeviceType.CUDA if device else DeviceType.CPU
        self.is_user_annotation = False


def test_from_profiler_gives_each_op_its_launch_and_spans_its_frame():
    events = [_Event("cudaLaunchKernel", 10.0, 14.0, 7, False),
              _Event("Activity Buffer Request", 11.0, 12.0, 7, False),
              _Event("cudaMemcpyAsync", 20.0, 22.0, 8, False),
              _Event("gemm", 15.0, 40.0, 7, True),
              _Event("Memcpy HtoD (Pageable -> Device)", 41.0, 45.0, 8,
                     True),
              _Event("Memset (Device)", 46.0, 47.0, 9, True)]
    base = 1_700_000_000_000_000_000
    prof = types.SimpleNamespace(
        events=lambda: events,
        profiler=types.SimpleNamespace(kineto_results=types.SimpleNamespace(
            trace_start_ns=lambda: base)))
    span = types.SimpleNamespace(name="solve", parent=None,
                                 t0_ns=base + 5_000, t1_ns=base + 50_500)
    t = trace.from_profiler(prof, 1, [], [span])
    assert [o.launch for o in t.device] == [(10.0, 14.0), (20.0, 22.0),
                                            None]
    assert (t.start, t.end) == (15.0, 47.0)
    assert t.spans == [trace.Span("solve", None, 5.0, 50.5)]
    # the host's operations inside the stretch, launches or not
    assert [o.name for o in t.host] == ["cudaMemcpyAsync"]


class _Recorder:
    """The program's span recorder, as the window drives it: every call
    closes one span named by its call index."""

    def __init__(self, dropped=0):
        self.buffer, self.dropped, self.on = [], dropped, False
        self.switched = []

    def set_spans(self, on, capacity=None):
        was, self.on = self.on, on
        self.switched.append(on)
        return was

    def drain_spans(self):
        out, self.buffer = self.buffer, []
        return out, self.dropped


class _Runner:
    def __init__(self, cell, recorder):
        self.cell, self.device, self.recorder = cell, "cpu", recorder
        self.pool, self.pixels, self.expected = [1, 2], 4, {}
        self.calls = 0

    def launch_counts(self):
        return {}

    def call(self, item):
        if self.recorder.on:
            self.recorder.buffer.append(types.SimpleNamespace(
                name=f"call{self.calls}"))
        self.calls += 1
        return item

    def keep(self, out):
        return out


def _traced_window(monkeypatch, recorder):
    cell = Cell("mono_cal_target.f32")
    seen = {}

    class _Profile:
        def __init__(self, **kw):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return None

    def from_profiler(prof, calls, kernels, traced):
        seen["traced"] = [s.name for s in traced]
        return "trace"

    monkeypatch.setattr(torch.profiler, "profile", _Profile)
    monkeypatch.setattr(trace, "from_profiler", from_profiler)
    runner = _Runner(cell, recorder)
    recorder.buffer.append(types.SimpleNamespace(name="setup"))
    win = run.window(runner, 0.0, 1, traced=True, recorder=recorder)
    return win, seen


def test_a_traced_window_routes_each_calls_spans(monkeypatch):
    recorder = _Recorder()
    win, seen = _traced_window(monkeypatch, recorder)
    # the stretch starts after the reservoir's first calls, each kept
    first = Cell("mono_cal_target.f32").traffic["check_calls"] \
        + run.TRACE_SETTLE
    last = first + run.TRACE_CALLS
    assert win.trace == "trace" and win.attempted == last
    assert win.traced_calls == range(first, last)
    # spans on for the stretch alone; what was in the buffer is dropped
    assert seen["traced"] == [f"call{i}" for i in range(first, last)]
    assert recorder.switched == [True, False] and not recorder.buffer


def test_a_dropped_span_fails_the_run(monkeypatch):
    with pytest.raises(run.SpanError):
        _traced_window(monkeypatch, _Recorder(dropped=3))


class _Out:
    """A call's output, as far as the window holds it."""


def test_the_window_holds_no_output_but_the_kept_between_calls():
    """So that from call ``check_calls`` + 1 on, a call's output reuses
    memory an earlier one freed, and the traced stretch
    (``check_calls`` + ``TRACE_SETTLE`` on) holds no first allocation."""
    cell = Cell("mono_cal_target.f32")
    live = weakref.WeakSet()
    held = []

    class _Holding(_Runner):
        def call(self, item):
            held.append(len(live))
            out = _Out()
            live.add(out)
            return out

    win = run.window(_Holding(cell, _Recorder()), 0.05, 3)
    k = cell.traffic["check_calls"]
    assert win.attempted > 2 * k and len(win.kept) == k
    assert held[:k + 1] == list(range(k + 1))
    assert max(held) == k
    assert run.TRACE_SETTLE >= 1
