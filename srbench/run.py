"""Run one cell of the port's benchmark and print its result line.

    python3 -m srbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``srbench/``
and the program, ``enph459_super_resolution_tpu_torch``.  One client sends
calls back to back (a closed loop) to the program's solve entry,
``sr.classical.solve`` for one unit and ``solve_batch`` for several, each
with the frames of one session of a pool rendered from ``--seed``, as
numpy on the host (as the session loader gives them), and each returning
numpy results.  Set-up is everything before the first timed call: the
imports, the kernels' build or load, the operators, the pool and one warm
call, whose launches are held to those the traffic mix implies.

With ``--trace 0`` the result line carries the cell's end-to-end metrics
on the host clock; with ``--trace 1`` its per-layer metrics, read from a
``torch.profiler`` trace of the CUDA activity of ``TRACE_CALLS`` whole
calls inside the window (:mod:`srbench.trace`), and a ``breakdown``.  Either way, once the window has closed, a sample of
its calls drawn from the seed is compared with the plain reference
(:mod:`srbench.reference`), and ``correct`` says whether every number
stayed within its limit (``srbench/limits/<cell>.json``).  Each number is
printed beside its limit, last on standard error and last in the line.

It exits 2 without a result where the card, the cell's files or the
program are missing, 1 where a call took another path than the mix
implies, and 3 where the process has loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, NamedTuple, Optional  # noqa: E402

import numpy as np  # noqa: E402

from . import generator, reference, trace  # noqa: E402
from .cells import Cell  # noqa: E402
from .work import calls  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "srbench" / "_cache"
PORT = "enph459_super_resolution_tpu_torch"
# Top-level module names the process may not hold once the window closes.
FORBIDDEN = ("jax", "jaxlib", "flax", "enph459_super_resolution_tpu")
TRACE_AFTER = 2    # calls of the window before the traced stretch
TRACE_CALLS = 3    # whole calls in the traced stretch


class PathError(RuntimeError):
    """A call launched other kernels than the traffic mix implies."""


class Window(NamedTuple):
    latencies_s: List[float]
    hr_pixels: int
    seconds: float
    setup_s: float
    attempted: int
    failed: int
    kept: Dict[int, tuple]          # call index -> (session, numpy result)
    trace: Optional[trace.Trace]
    traced_calls: range             # the calls under the profiler


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is forbidden, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def launch_counts() -> Dict[str, int]:
    """The program's launch counters (``launches*`` of each kernel
    wrapper), by ``<wrapper>.<counter>``."""
    from enph459_super_resolution_tpu_torch.ops.banded_rows import \
        banded_row_apply
    from enph459_super_resolution_tpu_torch.ops.fused_ibp import (
        fused_bwd_update, fused_fwd_err)

    return {f"{fn.__name__}.{k}": v
            for fn in (banded_row_apply, fused_fwd_err, fused_bwd_update)
            for k, v in vars(fn).items() if k.startswith("launches")}


def _delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


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


class Bench:
    """The program driven as the cell's traffic mix says, on ``device``."""

    def __init__(self, cell: Cell, device: str):
        from enph459_super_resolution_tpu_torch.sr import classical

        self.classical = classical
        self.cell, self.device = cell, device
        cfg, mix = cell.config, cell.traffic
        self.psf = reference.psf(cfg)
        self.shifts = tuple((float(dy), float(dx)) for dy, dx in
                            cfg["shifts"])
        self.opts = dict(factor=cfg["factor"],
                         n_iter=cfg["ibp"]["iterations"],
                         step=cfg["ibp"]["step"],
                         clip_max=cfg["ibp"]["clip_max"], device=device,
                         **mix["solve"])
        self.units = cell.units
        self.pixels = (self.units * cfg["factor"] ** 2
                       * cfg["lr_shape"][0] * cfg["lr_shape"][1])
        self.expected = calls.launches(cfg, mix)
        self.pool: List[np.ndarray] = []

    def call(self, session: np.ndarray, **overrides):
        """One call of the program's solve entry on a session's units."""
        opts = dict(self.opts, **overrides)
        if self.units == 1:
            return self.classical.solve(session[0], self.psf, self.shifts,
                                        **opts)
        return self.classical.solve_batch(session[: self.units], self.psf,
                                          self.shifts, **opts)

    def load(self, seed: int) -> None:
        """The session pool of ``seed``."""
        self.pool = generator.render_pool(self.cell.config, self.cell.traffic,
                                          seed, self.device)

    def warm(self) -> Dict[str, int]:
        """One call of the cell's shape; on the card, raises
        :class:`PathError` unless its launches are those the mix implies
        (on the CPU the program runs its kernels' plain versions and
        launches none)."""
        before = launch_counts()
        self.call(self.pool[0])
        counts = _delta(launch_counts(), before)
        if self.device == "cuda" and counts != self.expected:
            raise PathError(f"one call launched {counts}, the traffic mix "
                            f"implies {self.expected}")
        return counts

    def window(self, seconds: float, seed: int, traced: bool = False,
               setup_s: float = 0.0) -> Window:
        """Calls back to back until ``seconds`` have passed, the last one
        ending after; with ``traced``, calls ``TRACE_AFTER`` ..
        ``TRACE_AFTER + TRACE_CALLS - 1`` under the profiler (the window
        runs on until they are done).  Keeps the results of
        ``check_calls`` calls drawn uniformly from the seed (reservoir
        sampling)."""
        import torch

        k = self.cell.traffic["check_calls"]
        rng = np.random.default_rng([int(seed), 7])
        slots: List[int] = []           # the kept calls' indices
        kept: Dict[int, tuple] = {}
        lat: List[float] = []
        failed = 0
        prof = None
        before = launch_counts()
        t0 = end = time.perf_counter()
        i = 0
        while end - t0 < seconds or (traced and i < TRACE_AFTER
                                     + TRACE_CALLS):
            sid = i % len(self.pool)
            if traced and i == TRACE_AFTER:
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
            start = time.perf_counter()
            try:
                out = self.call(self.pool[sid])
            except Exception as exc:  # noqa: BLE001 -- counted as failed
                print(f"call {i} failed: {exc!r}", file=sys.stderr)
                failed += 1
                out = None
            end = time.perf_counter()
            lat.append(end - start)
            if traced and i == TRACE_AFTER + TRACE_CALLS - 1:
                prof.__exit__(None, None, None)
            # reservoir sampling: call i replaces a kept one w.p. k / (i+1)
            slot = i if i < k else int(rng.integers(0, i + 1))
            if slot < k and out is not None:
                if slot < len(slots):
                    kept.pop(slots[slot])
                    slots[slot] = i
                else:
                    slots.append(i)
                kept[i] = (sid, reference.with_units_axis(out))
            i += 1
        done = _delta(launch_counts(), before)
        want = {key: v * i for key, v in self.expected.items()}
        if self.device == "cuda" and failed == 0 and done != want:
            raise PathError(f"the window's {i} calls launched {done}, the "
                            f"traffic mix implies {want}")
        tr = None
        if prof is not None:
            import enph459_super_resolution_tpu_torch as port

            tr = trace.from_profiler(
                prof, TRACE_CALLS,
                trace.port_kernels(Path(port.__file__).parent))
        return Window(lat, (i - failed) * self.pixels, end - t0, setup_s, i,
                      failed, kept, tr,
                      range(TRACE_AFTER, TRACE_AFTER + TRACE_CALLS)
                      if traced else range(0))

    def release(self) -> None:
        """Drop the program's device state (its operator tree)."""
        self.classical._device_matrices.cache_clear()
        gc.collect()
        if self.device == "cuda":
            import torch

            torch.cuda.empty_cache()

    def check(self, kept: Dict[int, tuple],
              arith: str = "f64") -> Dict[str, float]:
        """The worst of each number over the kept calls, against the
        reference computed in ``arith`` on this device."""
        dops = reference.device_operators(self.cell.ops, arith, self.device)
        worst = {name: 0.0 for _, name in reference.GAPS}
        refs: Dict[int, dict] = {}
        for _, (sid, out) in sorted(kept.items()):
            if sid not in refs:
                refs[sid] = reference.solve_call(
                    self.pool[sid][: self.units], dops, self.cell.config,
                    arith)
            for name, v in reference.gaps(out, refs[sid]).items():
                worst[name] = max(worst[name], v)
        return worst


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
    bench = Bench(cell, device)
    bench.load(seed)
    emit(json.dumps({"srbench": "path", "one_call": bench.warm(),
                     "implied": bench.expected}))
    win = bench.window(seconds, seed, traced,
                       setup_s=time.perf_counter() - T_START)
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
    else:
        for m, reader in cell.readers("e2e_metrics"):
            metrics[m["name"]] = {"value": reader.read(win, cell),
                                  "unit": m["unit"]}
    bench.release()
    t_check = time.perf_counter()
    worst = bench.check(win.kept)
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
        __import__(PORT + ".sr.classical")
    except ImportError as exc:
        print(f"srbench: the program {PORT} cannot be imported: {exc}",
              file=sys.stderr)
        return 2
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    except PathError as exc:
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
