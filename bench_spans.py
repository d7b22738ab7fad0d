"""Put a benchmark cell's device time and device idle down to the
program's spans, on the card.

    python3 bench_spans.py --workload mono_cal_target.f32 [--seed N] \\
        [--seconds S]

Sets the cell up as ``python3 -m srbench.run`` does (its session pool, one
warm call held to the traffic mix's launches), with spans on from the start
of set-up (``utils.trace.set_spans``).  It then runs four windows of
``--seconds`` each, spans off, on, on, off, and prints the median call of
each and the median host ms inside ``solve.ibp`` over the windows with spans
on (``ibp_host_ms``: the loop's dispatch, without the profiler's cost per
launch).  Then it profiles ``CALLS`` whole calls twice, as
``srbench.trace`` does (CUDA activity only), first with spans on and then
off, and reads both with the benchmark's own readers (``aten_ms``,
``k1_ms``, ``device_idle_share``, ...).  From the traced calls with spans
on it gives each device operation the innermost span open when its launch
call ran (kineto's runtime event of the same correlation id; spans and
kineto both stamp Unix ns), and prints per call:

* ``col_apply_ms``: operations launched inside ``col_apply`` that are
  neither a kernel of the program nor a copy (``aten_ms``'s operations);
* ``ibp_update_ms``: those launched inside ``solve.ibp`` outside
  ``col_apply``; and the rest of ``aten_ms`` by span (``aten_by_span``);
* ``ibp_idle_ms``, ``entry_idle_ms``, ``caller_idle_ms``: the device's idle
  time inside the traced stretch while the host was inside ``solve.ibp``,
  inside ``solve`` but not ``solve.ibp``, and outside every ``solve``;
* ``h2d_gb_per_s``, ``d2h_gb_per_s``: the copy counters' bytes per call
  (``classical._prepare.h2d_bytes``, ``_to_host.d2h_bytes``) over the
  copies' device time;
* the clock check: device operations without a launch time, the largest
  distance of a launch call from the span it is put in, and launches put
  where they cannot belong (K1 inside ``col_apply``, a GEMM outside it on
  the banded engine, an upload outside ``solve.prepare``, a copy back
  outside ``solve.to_host``).

Last, the cost of a span while spans are off and while they are on, in
ns, on this host.
Prints the card's name and power limit, then one JSON object
per line.  Exits 2 without a card.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import timeit  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple  # noqa

HERE = Path(__file__).resolve().parent
CALLS = 3       # whole calls under the profiler
SETTLE = 2      # calls before each traced stretch


class DevOp(NamedTuple):
    """A device operation, on the Unix-ns clock, with its launch call's
    host interval (None where the trace holds none)."""
    name: str
    start: int
    end: int
    launch: Optional[Tuple[int, int]]


def device_ops(prof) -> List[DevOp]:
    """The device operations of a finished ``torch.profiler`` profile, each
    with the host interval of the CUDA runtime call of the same correlation
    id."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    # the runtime API calls (cudaLaunchKernel, cudaMemcpyAsync, ...), not
    # CUPTI's own host events, which can share a call's correlation id
    runtime = {e.correlation_id(): (e.start_ns(), e.end_ns())
               for e in events if e.device_type() != DeviceType.CUDA
               and e.correlation_id() > 0 and e.name().startswith("cu")}
    return [DevOp(e.name(), e.start_ns(), e.end_ns(),
                  runtime.get(e.correlation_id()))
            for e in events if e.device_type() == DeviceType.CUDA]


class Segments:
    """The innermost span at each instant, for spans that nest: the
    boundaries in order and the span that is innermost from each boundary
    to the next (None outside every span)."""

    def __init__(self, spans: Sequence):
        # at one instant: ends before starts, and an outer span's start
        # (the longer) before an inner one's
        marks = sorted([(s.t0_ns, 1, s.t0_ns - s.t1_ns, i)
                        for i, s in enumerate(spans)]
                       + [(s.t1_ns, 0, 0, i) for i, s in enumerate(spans)])
        self.bounds: List[int] = []
        self.inner: List = []
        stack: List[int] = []
        for t, opens, _, i in marks:
            if opens:
                stack.append(i)
            else:
                stack.remove(i)
            self.bounds.append(t)
            self.inner.append(spans[stack[-1]] if stack else None)

    def at(self, t: int):
        """The innermost span open at ``t`` (a span holds [t0, t1))."""
        k = bisect.bisect_right(self.bounds, t) - 1
        return self.inner[k] if k >= 0 else None


def _union(intervals) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _overlap(xs, ys) -> int:
    """Length of the intersection of two lists of disjoint intervals."""
    total, j = 0, 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            total += max(0, min(b, ys[k][1]) - max(a, ys[k][0]))
            k += 1
    return total


def idle_gaps(ops: Sequence[DevOp]) -> List[Tuple[int, int]]:
    """The device's idle intervals from its first operation's start to its
    last one's end (``srbench.trace``'s stretch)."""
    busy = _union((o.start, o.end) for o in ops)
    return [(a[1], b[0]) for a, b in zip(busy, busy[1:])]


def split(ops: Sequence[DevOp], spans: Sequence, calls: int,
          is_aten) -> Dict:
    """The per-call metrics of the module docstring from the traced calls'
    device operations and the spans recorded meanwhile; ``is_aten(name)``
    says whether an operation counts in ``aten_ms``."""
    seg = Segments(spans)
    ms: Dict[str, float] = {}
    aten_by: Dict[str, float] = {}
    for o in ops:
        s = seg.at(o.launch[0]) if o.launch else None
        where = s.name if s is not None else "none"
        ms[where] = ms.get(where, 0.0) + (o.end - o.start) / 1e6 / calls
        if is_aten(o.name):
            aten_by[where] = aten_by.get(where, 0.0) + \
                (o.end - o.start) / 1e6 / calls
    gaps = idle_gaps(ops)
    solve = _union((s.t0_ns, s.t1_ns) for s in spans if s.name == "solve")
    ibp = _union((s.t0_ns, s.t1_ns) for s in spans
                 if s.name == "solve.ibp")
    idle = sum(b - a for a, b in gaps)
    in_solve, in_ibp = _overlap(gaps, solve), _overlap(gaps, ibp)
    return {"col_apply_ms": aten_by.get("col_apply", 0.0),
            "ibp_update_ms": aten_by.get("solve.ibp", 0.0),
            "aten_by_span": aten_by, "device_ms_by_span": ms,
            "ibp_idle_ms": in_ibp / 1e6 / calls,
            "entry_idle_ms": (in_solve - in_ibp) / 1e6 / calls,
            "caller_idle_ms": (idle - in_solve) / 1e6 / calls,
            "idle_ms": idle / 1e6 / calls}


def _is_gemm(name: str) -> bool:
    low = name.lower()
    return "gemm" in low or "xmma" in low or "cutlass" in low


def clock_check(ops: Sequence[DevOp], spans: Sequence, is_k1,
                banded: bool) -> Dict:
    """Operations without a launch time; the largest distance of a launch
    call's host interval from the span its start is put in (0 when the
    call lies inside it), ns; and the launches put where they cannot
    belong."""
    seg = Segments(spans)
    far, wrong = 0, {}
    for o in ops:
        if o.launch is None:
            continue
        s = seg.at(o.launch[0])
        if s is None:
            continue
        far = max(far, s.t0_ns - o.launch[0], o.launch[1] - s.t1_ns)
        rules = {"k1_in_col_apply": is_k1(o.name) and s.name == "col_apply",
                 "gemm_outside_col_apply": banded and _is_gemm(o.name)
                 and s.name != "col_apply",
                 "upload_outside_prepare": o.name.startswith("Memcpy HtoD")
                 and s.name != "solve.prepare",
                 "copy_back_outside_to_host":
                 o.name.startswith("Memcpy DtoH")
                 and s.name != "solve.to_host"}
        for k, bad in rules.items():
            if bad:
                wrong[k] = wrong.get(k, 0) + 1
    return {"no_launch_time": sum(o.launch is None for o in ops),
            "max_launch_outside_span_ns": max(far, 0), "misplaced": wrong}


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _window(bench, seconds: float, trace_mod, spans: bool) -> Dict:
    """Calls back to back for ``seconds``: the median call, and with spans
    the median host ms inside ``solve.ibp``."""
    trace_mod.set_spans(spans)
    trace_mod.drain_spans()
    lat: List[float] = []
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        start = time.perf_counter()
        bench.call(bench.pool[i % len(bench.pool)])
        lat.append(time.perf_counter() - start)
        i += 1
    got, dropped = trace_mod.drain_spans()
    out = {"spans": spans, "calls": i,
           "call_median_ms": statistics.median(lat) * 1e3}
    if spans:
        ibp = [(s.t1_ns - s.t0_ns) / 1e6 for s in got
               if s.name == "solve.ibp"]
        out.update(ibp_host_ms=statistics.median(ibp),
                   spans_per_call=len(got) / i, dropped=dropped)
    return out


def _traced(bench, torch, trace_mod, srtrace, kernels, spans: bool):
    """``CALLS`` calls under the profiler after ``SETTLE`` others; returns
    the profiler, the spans, the copy counters' change and the latencies."""
    from enph459_super_resolution_tpu_torch.sr import classical

    trace_mod.set_spans(spans)
    for i in range(SETTLE):
        bench.call(bench.pool[i % len(bench.pool)])
    trace_mod.drain_spans()
    before = (classical._prepare.h2d_bytes, classical._to_host.d2h_bytes)
    lat = []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for i in range(CALLS):
            start = time.perf_counter()
            bench.call(bench.pool[i % len(bench.pool)])
            lat.append((time.perf_counter() - start) * 1e3)
    got, _ = trace_mod.drain_spans()
    moved = (classical._prepare.h2d_bytes - before[0],
             classical._to_host.d2h_bytes - before[1])
    trace_mod.set_spans(False)
    tr = srtrace.from_profiler(prof, CALLS, kernels)
    return prof, got, moved, lat, tr


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 11)
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    import torch

    if not torch.cuda.is_available():
        print("bench_spans: needs a CUDA card", file=sys.stderr)
        return 2
    from enph459_super_resolution_tpu_torch.utils import trace as trace_mod
    trace_mod.set_spans(True, capacity=1 << 20)
    import enph459_super_resolution_tpu_torch as port
    from srbench import run, trace as srtrace
    from srbench.cells import Cell

    run.point_caches()
    cell = Cell(args.workload)
    _emit(run.card_line(torch))
    bench = run.Bench(cell, "cuda")
    bench.load(args.seed)
    bench.warm()
    setup, dropped = trace_mod.drain_spans()
    _emit({"bench_spans": "setup", "workload": cell.name,
           "setup_s": time.perf_counter() - T_START, "dropped": dropped,
           "program": str(Path(port.__file__).parent),
           "spans": [[s.name, s.parent, (s.t1_ns - s.t0_ns) / 1e6, s.args]
                     for s in setup if s.name != "col_apply"]})
    for spans in (False, True, True, False):
        _emit(dict(_window(bench, args.seconds, trace_mod, spans),
                   bench_spans="window"))
    kernels = srtrace.port_kernels(Path(port.__file__).parent)
    readers = cell.readers("layer_metrics")
    for spans in (True, False):
        prof, got, moved, lat, tr = _traced(bench, torch, trace_mod,
                                            srtrace, kernels, spans)
        line = {"bench_spans": "traced", "spans": spans,
                "call_ms": lat, "busy_s": tr.busy_s(),
                "window_s": tr.window_s,
                "readers": {m["name"]: r.read(tr, cell) for m, r in readers
                            if m["source"] != "host_clock"}}
        if spans:
            ops = device_ops(prof)

            def is_aten(name):
                return tr.port_kernel(name) is None \
                    and not name.startswith("Memcpy")

            def is_k1(name):
                return (tr.port_kernel(name) or "").startswith("banded_rows")

            line.update(split(ops, got, CALLS, is_aten))
            line["clock"] = clock_check(
                ops, got, is_k1, cell.traffic["solve"]["fused"] != "on")
            line["h2d_bytes_per_call"] = moved[0] / CALLS
            line["d2h_bytes_per_call"] = moved[1] / CALLS
            h2d, d2h = line["readers"]["h2d_ms"], line["readers"]["d2h_ms"]
            line["h2d_gb_per_s"] = moved[0] / CALLS / (h2d * 1e6)
            line["d2h_gb_per_s"] = moved[1] / CALLS / (d2h * 1e6)
            line["spans_per_call"] = len(got) / CALLS
        _emit(line)
    cost = {}
    for on in (False, True):
        trace_mod.set_spans(on)
        cost["ns_per_span_" + ("on" if on else "off")] = min(timeit.repeat(
            "with span('x'): pass", globals={"span": trace_mod.span},
            number=100000, repeat=5)) / 100000 * 1e9
        trace_mod.drain_spans()
    trace_mod.set_spans(False)
    _emit(dict(cost, bench_spans="span_cost"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
