"""Run one cell of the port's benchmark and print its result line.

    python3 -m srbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``srbench/``
and the program, ``enph459_super_resolution_tpu_torch``.  One client sends
calls back to back (a closed loop) to the program through the runner the
cell's configuration names (:mod:`srbench.runners`; ``classical``, the
solve entry ``sr.classical.solve`` / ``solve_batch``, where it names
none), each call on the next input of a pool made from ``--seed``.
Set-up is everything before the first timed call: the imports, the
kernels' build or load, the program's state, the pool and one warm call,
whose launches are held to those the runner says one call implies.

With ``--trace 0`` the result line carries the cell's end-to-end metrics
on the host clock, with the program's spans off; with ``--trace 1`` its
per-layer metrics, read from a ``torch.profiler`` trace of the CUDA
activity of ``TRACE_CALLS`` whole calls inside the window
(:mod:`srbench.trace`) with the program's spans (``utils.trace.span``)
on for those calls alone, or from the latencies of the window's other
calls; and a ``breakdown``.  Either way, once the window has closed, a
sample of its calls drawn from the seed is compared with the plain
reference by the runner's check, and ``correct`` says whether every
number stayed within its limit (``srbench/limits/<cell>.json``).  Each
number is printed beside its limit, last on standard error and last in
the line.

It exits 2 without a result where the card, the cell's files or the
program are missing, 1 where a call took another path than the runner
implies or the span buffer dropped a span, and 3 where the process has
loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, NamedTuple, Optional  # noqa: E402

import numpy as np  # noqa: E402

from . import spans, trace  # noqa: E402
from .cells import Cell  # noqa: E402
from .runners import PathError, delta  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "srbench" / "_cache"
PORT = "enph459_super_resolution_tpu_torch"
SPANS = PORT + ".utils.trace"      # the program's span recorder
# Top-level module names the process may not hold once the window closes.
FORBIDDEN = ("jax", "jaxlib", "flax", "enph459_super_resolution_tpu")
# The traced stretch starts this many calls after the ``check_calls`` that
# the reservoir keeps whatever follows.  Between calls the window holds no
# output but the kept ones, so from call ``check_calls`` + 1 on a call's
# output reuses memory an earlier one freed (the program's page-locked
# result blocks among it) and the stretch holds no first allocation.
TRACE_SETTLE = 2
TRACE_CALLS = 3    # whole calls in the traced stretch
# Spans the program's buffer holds: those of the traced stretch (~810 a
# classical call).
SPAN_CAPACITY = 1 << 20


class SpanError(RuntimeError):
    """The program's span buffer dropped spans of a traced run."""


class Window(NamedTuple):
    latencies_s: List[float]
    hr_pixels: int
    seconds: float
    setup_s: float
    attempted: int
    failed: int
    kept: Dict[int, tuple]          # call index -> (pool index, kept output)
    trace: Optional[trace.Trace]
    traced_calls: range             # the calls under the profiler


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is forbidden, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def program_spans():
    """The program's span recorder (``set_spans``, ``drain_spans``), or None
    for a program without one."""
    try:
        mod = importlib.import_module(SPANS)
    except ImportError:
        return None
    if getattr(mod, "set_spans", None) and getattr(mod, "drain_spans", None):
        return mod
    return None


def _drain(recorder) -> list:
    """The spans closed since the last drain; raises :class:`SpanError`
    where the buffer dropped any."""
    got, dropped = recorder.drain_spans()
    if dropped:
        raise SpanError(f"the program's span buffer dropped {dropped} "
                        f"spans (it holds {SPAN_CAPACITY})")
    return got


def point_caches() -> None:
    """Every build and operator cache at a fixed directory inside the
    checkout.  The program's kernels build into its own ``_build_out/``
    and its host operators go to ``SRTPU_OP_CACHE_DIR``; the torch
    extension and Triton caches are pointed there too, for kernels a later
    change builds that way."""
    for var, sub in (("SRTPU_OP_CACHE_DIR", "ops"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)


def Bench(cell: Cell, device: str):
    """The cell's runner on ``device`` (the name ``bench_spans.py``
    drives it by)."""
    return cell.runner(device)


def window(runner, seconds: float, seed: int, traced: bool = False,
           setup_s: float = 0.0, recorder=None) -> Window:
    """Calls back to back until ``seconds`` have passed, the last one
    ending after; with ``traced``, ``TRACE_CALLS`` calls under the
    profiler, ``TRACE_SETTLE`` calls after the first ``check_calls`` (the
    window runs on until they are done), with the program's spans on
    meanwhile where it has a span ``recorder``: the spans those calls
    close go to the trace.  Keeps ``runner.keep`` of the output of
    ``check_calls`` calls drawn uniformly from the seed (reservoir
    sampling)."""
    import torch

    k = runner.cell.traffic["check_calls"]
    rng = np.random.default_rng([int(seed), 7])
    slots: List[int] = []           # the kept calls' indices
    kept: Dict[int, tuple] = {}
    lat: List[float] = []
    traced_spans: list = []
    first = k + TRACE_SETTLE        # the traced stretch's calls
    stop = first + TRACE_CALLS
    failed = 0
    prof = None
    before = runner.launch_counts()
    t0 = end = time.perf_counter()
    i = 0
    while end - t0 < seconds or (traced and i < stop):
        sid = i % len(runner.pool)
        if traced and i == first:
            if recorder is not None:
                recorder.drain_spans()
                recorder.set_spans(True, capacity=SPAN_CAPACITY)
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        start = time.perf_counter()
        try:
            out = runner.call(runner.pool[sid])
        except Exception as exc:  # noqa: BLE001 -- counted as failed
            print(f"call {i} failed: {exc!r}", file=sys.stderr)
            failed += 1
            out = None
        end = time.perf_counter()
        lat.append(end - start)
        if traced and i == stop - 1:
            prof.__exit__(None, None, None)
            if recorder is not None:
                recorder.set_spans(False)
                traced_spans = _drain(recorder)
        # reservoir sampling: call i replaces a kept one w.p. k / (i+1)
        slot = i if i < k else int(rng.integers(0, i + 1))
        if slot < k and out is not None:
            if slot < len(slots):
                kept.pop(slots[slot])
                slots[slot] = i
            else:
                slots.append(i)
            kept[i] = (sid, runner.keep(out))
        out = None      # between calls the window holds the kept alone
        i += 1
    done = delta(runner.launch_counts(), before)
    want = {key: v * i for key, v in runner.expected.items()}
    if runner.device == "cuda" and failed == 0 and done != want:
        raise PathError(f"the window's {i} calls launched {done}, the "
                        f"traffic mix implies {want}")
    tr = None
    if prof is not None:
        import enph459_super_resolution_tpu_torch as port

        tr = trace.from_profiler(
            prof, TRACE_CALLS,
            trace.port_kernels(Path(port.__file__).parent), traced_spans)
    return Window(lat, (i - failed) * runner.pixels, end - t0, setup_s, i,
                  failed, kept, tr,
                  range(first, stop) if traced else range(0))


def _number(v: float) -> Optional[float]:
    return float(v) if np.isfinite(v) else None


def card_line(torch) -> Dict:
    """The card, its power limit and the peaks the rooflines divide by."""
    from .work import peaks

    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        smi = f"nvidia-smi: {exc!r}"
    return {"srbench": "card", "kind": torch.cuda.get_device_name(0),
            "nvidia_smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "peak_flops": peaks.FLOPS,
            "hbm_bytes_per_s": peaks.HBM_BYTES_PER_S}


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device: str = "cuda", emit=print) -> Dict:
    """Set up, warm, measure and check one run of ``cell``; returns the
    result line's object (``emit`` gets the earlier lines)."""
    import torch

    if device == "cuda":
        emit(json.dumps(card_line(torch)))
    runner = cell.runner(device)
    runner.load(seed)
    emit(json.dumps({"srbench": "path", "one_call": runner.warm(),
                     "implied": runner.expected}))
    win = window(runner, seconds, seed, traced,
                 setup_s=time.perf_counter() - T_START,
                 recorder=program_spans() if traced else None)
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else "cpu"),
           "count": cell.chips,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                 if device == "cuda" else 0)}
    metrics, breakdown = {}, None
    if traced:
        for m, reader in cell.readers("layer_metrics"):
            value = reader.read(win if m["source"] == "host_clock"
                                else win.trace, cell)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = win.trace.busy_s()
        dev["window_s"] = win.trace.window_s
        breakdown = win.trace.breakdown()
        emit(json.dumps({
            "srbench": "spans", "traced": len(win.trace.spans),
            "device_ms_by_span": spans.device_ms_by_span(win.trace),
            "aten_by_span": spans.device_ms_by_span(win.trace,
                                                    win.trace.is_aten),
            "no_launch": spans.no_launch(win.trace)}))
    else:
        for m, reader in cell.readers("e2e_metrics"):
            metrics[m["name"]] = {"value": reader.read(win, cell),
                                  "unit": m["unit"]}
    runner.release()
    t_check = time.perf_counter()
    worst = runner.check(win.kept)
    emit(json.dumps({"srbench": "timing", "setup_s": win.setup_s,
                     "window_s": win.seconds,
                     "calls": win.attempted,
                     "check_s": time.perf_counter() - t_check,
                     "kept": sorted(win.kept),
                     "latencies_ms": [round(v * 1e3, 3)
                                      for v in win.latencies_s]}))
    limits = cell.limits or {}
    checks = {name: {"value": _number(v), "limit": limits.get(name)}
              for name, v in worst.items()}
    correct = (win.failed == 0 and len(win.kept) > 0
               and all(limits.get(name) is not None and v <= limits[name]
                       for name, v in worst.items()))
    result = {"correct": correct, "attempted": win.attempted,
              "failed": win.failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = Cell(args.workload)
    except (KeyError, FileNotFoundError, json.JSONDecodeError) as exc:
        print(f"srbench: {exc}", file=sys.stderr)
        return 2
    if cell.limits is None:
        print(f"srbench: no limits file for {cell.name}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"srbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    point_caches()
    try:
        program = cell.runner_module().PROGRAM
        importlib.import_module(program)
    except (ImportError, FileNotFoundError) as exc:
        print(f"srbench: the program cannot be imported: {exc}",
              file=sys.stderr)
        return 2
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    except (PathError, SpanError) as exc:
        print(f"srbench: {exc}", file=sys.stderr)
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"srbench: the process holds forbidden modules {bad}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
