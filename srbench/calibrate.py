"""Readings the limits of ``srbench/limits/<cell>.json`` are set from.
The benchmark's own runs do not run this.

    python3 -m srbench.calibrate --workload <cell> --seeds 11,12,... \\
        --control-seeds 21,22,23 [--seconds 3] [--program-control PRESET]

In one process on the card, for the runner the cell's configuration
names: for each of ``--seeds``, a window of the cell at its own load
(``--seconds`` long) and the worst of each number over its kept calls, as
a run reads them (the runner's ``check``: the lower readings); for each
of ``--control-seeds``, the same numbers of the control, the reference
put in the program's place and computed in the precision below the one
the mix states (the mix's ``control``: TF32 below strict float32, fp8
below bf16 operands), on the first ``check_calls`` items of the pool (the
runner's ``control``: the upper readings).  ``--program-control``, for
the classical runner alone, adds the program itself on those sessions
with its own lower-precision path switched on (an ``mm_precision``
preset, such as ``TF32_TF32_F32``).  One JSON line per reading.

    python3 -m srbench.calibrate --summarize readings.jsonl

prints, per number, the lower reading (the largest over the program's
seeds), the upper (the smallest a control gives, among the controls that
read at least three times the lower) and the limit those two set: two
thirds of the way from the lower to the upper on a log scale, so the
more room lies above the lower; 0 where every program reading is 0 (an
exact comparison).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .cells import Cell
from .run import point_caches, window


def _ints(text: str):
    return [int(v) for v in text.split(",") if v]


def readings(bench, seeds, control_seeds, seconds: float,
             program_control=None, emit=print) -> None:
    """``bench`` is the cell's runner (:mod:`srbench.runners`);
    ``program_control`` is for the classical runner alone."""
    cell = bench.cell
    control = cell.traffic["control"]
    k = cell.traffic["check_calls"]
    for seed in seeds:
        bench.load(seed)
        win = window(bench, seconds, seed)
        emit(json.dumps({"seed": seed, "reading": "program",
                         "calls": win.attempted, "failed": win.failed,
                         "kept": sorted(win.kept),
                         "gaps": bench.check(win.kept)}))
    for seed in control_seeds:
        bench.load(seed)
        for sid in range(k):
            emit(json.dumps({"seed": seed, "session": sid,
                             "reading": f"control {control}",
                             "gaps": bench.control(sid)}))
            if program_control:
                out = bench.keep(bench.call(
                    bench.pool[sid], mm_precision=program_control))
                emit(json.dumps({"seed": seed, "session": sid,
                                 "reading": f"program {program_control}",
                                 "gaps": bench.check({sid: (sid, out)})}))


def propose(lines) -> dict:
    """Lower and upper readings and the limit of each number, from the
    JSON lines :func:`readings` printed.  The numbers are those the
    readings carry: the runner's ``GAPS``, which its ``check`` and
    ``control`` key them by."""
    rows = [json.loads(line) for line in lines if '"reading"' in line]
    out = {}
    for name in rows[0]["gaps"]:
        lower = max(r["gaps"][name] for r in rows
                    if r["reading"] == "program")
        uppers = {}
        for r in rows:
            if r["reading"] != "program":
                v = r["gaps"][name]
                uppers[r["reading"]] = min(uppers.get(r["reading"], v), v)
        moved = [v for v in uppers.values() if v > 0 and v >= 3 * lower]
        upper = min(moved) if moved else None
        if lower == 0:
            limit = 0.0
        elif upper is None:
            limit = None
        else:
            limit = lower ** (1 / 3) * upper ** (2 / 3)
        out[name] = {"lower": lower, "upper": upper, "controls": uppers,
                     "limit": limit}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--summarize", nargs="+")
    ap.add_argument("--workload")
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--program-control")
    args = ap.parse_args(argv)
    if args.summarize:
        lines = [ln for path in args.summarize for ln in open(path)]
        print(json.dumps(propose(lines), indent=1))
        return 0
    cell = Cell(args.workload)
    runner = cell.config.get("runner", "classical")
    if args.program_control and runner != "classical":
        print(f"srbench.calibrate: --program-control is for the classical "
              f"runner; {args.workload} runs {runner!r}", file=sys.stderr)
        return 2
    point_caches()
    t0 = time.perf_counter()
    bench = cell.runner("cuda")
    bench.load(args.seeds[0] if args.seeds else args.control_seeds[0])
    bench.warm()
    print(json.dumps({"workload": args.workload,
                      "setup_s": time.perf_counter() - t0}), flush=True)
    readings(bench, args.seeds, args.control_seeds, args.seconds,
             args.program_control,
             emit=lambda line: print(line, flush=True))
    print(json.dumps({"workload": args.workload,
                      "total_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
