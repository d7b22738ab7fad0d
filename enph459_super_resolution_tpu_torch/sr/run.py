"""CLI: classical multi-frame SR over capture sessions, on the card.

Counterpart of ``enph459_super_resolution_tpu/sr/run.py``:

    python -m enph459_super_resolution_tpu_torch.sr.run \\
        --workload mono_cal_target --data-dir .../data --output-dir results

Runs on CUDA unless ``--device cpu`` is given; asking for CUDA without a
card is an error, never a quiet CPU run.  Flags mirror the reference CLI
(``mono_barcodes/run_sr.py:356-367``): ``--psf {gaussian,measured}``,
``--psf-dir``, ``--data-dir``, ``--output-dir``; plus ``--no-figures`` /
``--force`` / ``--session``, rep batching, the IBP overrides, the band
store (``--band-store {f32,bf16,hybrid[:tail]}``), the fused engine
(``--fused-ibp {auto,on,off}``), ``--engine {mm,conv}``, ``--solver
{ibp,adjoint}``, ``--mm-precision``, serve mode (``--watch SECONDS``,
``--watch-polls N``) and the learned burst engine (``--fusion-run RUN``,
``--fusion-refine N``, ``--fusion-dtype``, ``--fusion-refine-engine``,
``--fusion-refine-step``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time


def fingerprint(sdir: str) -> frozenset:
    """(name, size, mtime_ns) of every entry of a session directory: a
    collector adding, removing or rewriting a file changes it (an entry that
    vanishes while it is listed reads (name, -1, -1))."""
    out = set()
    for name in os.listdir(sdir):
        try:
            st = os.stat(os.path.join(sdir, name))
            out.add((name, st.st_size, st.st_mtime_ns))
        except OSError:
            out.add((name, -1, -1))
    return frozenset(out)


def watch(list_sessions, serve, interval: float, polls=None) -> int:
    """Serve mode: poll the sessions ``list_sessions()`` returns every
    ``interval`` seconds and ``serve`` (a list of session dirs -> units
    processed) those new or changed since their last successful pass.

    A processed session is skipped while its listing's :func:`fingerprint`
    is unchanged; one that gains files (late reps) is served again, and
    ``done.flag`` keeps its finished units idempotent.  When a poll's batch
    fails, each of its sessions is served alone, and one that fails again
    (still being written) is deferred to the next poll.  Stops after
    ``polls`` polls (``None``: never).  Returns the units processed.
    """
    seen: dict = {}  # session dir -> fingerprint at its last good pass
    total = n_polls = 0
    while True:
        changed = []
        for sdir in list_sessions():
            try:
                fp = fingerprint(sdir)
            except OSError:
                continue  # the session dir vanished since it was listed
            if seen.get(sdir) != fp:
                changed.append((sdir, fp))
        if changed:
            print("[watch]", end=" ")
            try:
                # one stream over every changed session keeps
                # cross-session batching in serve mode
                total += serve([s for s, _ in changed])
                seen.update(changed)
            except Exception:  # noqa: BLE001 -- isolate the broken session
                for sdir, fp in changed:
                    try:
                        total += serve([sdir])
                        seen[sdir] = fp
                    except Exception as exc:  # noqa: BLE001 -- keep serving
                        print(f"  [defer] {os.path.basename(sdir)}: {exc}")
        n_polls += 1
        if polls is not None and n_polls >= polls:
            break
        time.sleep(interval)
    print(f"watch done: {total} unit(s) processed over {n_polls} poll(s)")
    return total


def main(argv=None) -> int:
    from ..data.sessions import discover_sessions
    from ..device import DEVICES, resolve_device
    from ..psf.kernels import load_measured_psf, make_gaussian_psf
    from ..ops.opmatrix import MM_PRECISIONS
    from .classical import ENGINES, FUSED_MODES, SOLVERS, check_config
    from .config import WORKLOADS
    from .pipeline import process_workload

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True, choices=sorted(WORKLOADS))
    p.add_argument("--psf", choices=["gaussian", "measured"], default="gaussian")
    p.add_argument("--psf-dir", default=None,
                   help="beam-shift calibration data dir (measured PSF)")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--session", default=None,
                   help="process only this session directory name")
    p.add_argument("--no-figures", action="store_true")
    p.add_argument("--force", action="store_true",
                   help="ignore done.flag sentinels")
    p.add_argument("--batch-reps", dest="batch_reps", action="store_true",
                   default=True,
                   help="solve same-shaped reps as one batched device call "
                        "(default; rep-tiled row operators, per-rep-exact)")
    p.add_argument("--no-batch-reps", dest="batch_reps", action="store_false",
                   help="solve reps sequentially instead")
    p.add_argument("--max-batch", type=int, default=4,
                   help="max units per batched device solve (cross-session "
                        "batching)")
    p.add_argument("--ibp-iters", type=int, default=None,
                   help="override the workload's iteration count")
    p.add_argument("--ibp-step", type=float, default=None,
                   help="override the update step size")
    p.add_argument("--band-store", default="f32",
                   metavar="{f32,bf16,hybrid[:tail]}",
                   help="banded-operator storage: f32 = strict default "
                        "(+-1 uint8 of the reference); hybrid = bf16 "
                        "operators for the bulk of the IBP loop and an f32 "
                        "finishing tail (default 16), +-1 of f32; bf16 = "
                        "every operator bf16, +-2 of f32")
    p.add_argument("--fused-ibp", default="auto", choices=FUSED_MODES,
                   help="fused whole-iteration kernels: auto = on for bf16 "
                        "at shapes that qualify, else the banded engine; "
                        "on = always (an error for a shape that does not "
                        "qualify); off = never")
    p.add_argument("--engine", default="mm", choices=ENGINES,
                   help="mm = the banded operators (default); conv = the "
                        "cross-check engine of separable correlations, "
                        "strict f32, one unit at a time (it ignores "
                        "--band-store, --fused-ibp and --mm-precision)")
    p.add_argument("--solver", default="ibp", choices=SOLVERS,
                   help="ibp = the reference's heuristic back-projection "
                        "(default); adjoint = true-adjoint Landweber on the "
                        "transposed forward operators (banded mm engine), "
                        "stable at step 2.0; it defaults --ibp-iters to the "
                        "workload's / 4 and --ibp-step to 2.0")
    p.add_argument("--mm-precision", default="HIGHEST",
                   metavar="{" + ",".join(MM_PRECISIONS) + "}",
                   help="matmul precision of the float32-band applies: "
                        "HIGHEST = strict (default); HIGH / BF16_BF16_F32_X3 "
                        "= the 3-pass bf16 split of the row applies, +-1 "
                        "uint8 of HIGHEST; DEFAULT / BF16_BF16_F32 = one "
                        "bf16 pass, +-3. Their speed on the card against "
                        "HIGHEST is in PERF.md")
    p.add_argument("--watch", type=float, default=None, metavar="SECONDS",
                   help="serve mode: after the existing sessions, poll "
                        "--data-dir every SECONDS for new or changed ones "
                        "(done.flag keeps finished units idempotent; a "
                        "session that fails to load is deferred to the next "
                        "poll)")
    p.add_argument("--watch-polls", type=int, default=None,
                   help="stop serve mode after this many polls (default: "
                        "never)")
    p.add_argument("--fusion-run", default=None, metavar="RUN_DIR",
                   help="also run the learned burst engine (a trained "
                        "train.burst run directory) on every unit, writing "
                        "fusion.png and its forward-model MSE beside the "
                        "classical artifacts")
    p.add_argument("--fusion-refine", type=int, default=0, metavar="N",
                   help="append N data-consistency (Landweber) iterations "
                        "seeded from the fusion output (metrics.json then "
                        "also reports fusion_forward_mse_raw)")
    p.add_argument("--fusion-dtype", default="f32", choices=["f32", "bf16"],
                   help="compute type of the burst net's convs; "
                        "registration and refinement stay f32")
    p.add_argument("--fusion-refine-engine", default="banded",
                   choices=["banded", "vjp"],
                   help="engine of --fusion-refine: banded = the adjoint "
                        "banded operators of the unit's static shifts "
                        "(landweber_refine; the scipy-exact forward "
                        "model); vjp = autograd through the Keys-cubic "
                        "forward model")
    p.add_argument("--fusion-refine-step", type=float, default=2.0,
                   help="Landweber step for --fusion-refine (2.0 is stable "
                        "under the exact adjoint)")
    p.add_argument("--device", default="cuda", choices=DEVICES,
                   help="where the solve runs (default cuda; no fallback)")
    args = p.parse_args(argv)
    try:
        check_config(args.engine, args.solver, args.band_store,
                     args.fused_ibp, args.mm_precision)
    except ValueError as exc:
        p.error(str(exc))
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        p.error(str(exc))

    cfg = WORKLOADS[args.workload]
    n_iter, ibp_step = args.ibp_iters, args.ibp_step
    if args.solver == "adjoint":
        # the true adjoint converges ~4x faster per iteration at the same
        # truth quality, and is stable at step 2.0
        if n_iter is None:
            n_iter = max(1, round(cfg.ibp_iterations / 4))
        if ibp_step is None:
            ibp_step = 2.0
    if n_iter is not None or ibp_step is not None:
        cfg = dataclasses.replace(
            cfg,
            ibp_iterations=n_iter if n_iter is not None
            else cfg.ibp_iterations,
            ibp_step=ibp_step if ibp_step is not None else cfg.ibp_step)
    fusion = None
    if args.fusion_run:
        from .fusion import FusionEngine
        fusion = FusionEngine(args.fusion_run, refine=args.fusion_refine,
                              refine_step=args.fusion_refine_step,
                              dtype=args.fusion_dtype,
                              refine_engine=args.fusion_refine_engine,
                              device=device)
        if fusion.factor != cfg.upsample_factor:
            p.error(f"--fusion-run was trained at x{fusion.factor}; "
                    f"workload {cfg.name} is x{cfg.upsample_factor}")
    if args.psf == "measured":
        if not args.psf_dir:
            p.error("--psf measured requires --psf-dir")
        psf = load_measured_psf(args.psf_dir, halfwidth=cfg.psf_size // 2)
    else:
        psf = make_gaussian_psf(cfg.psf_size, cfg.psf_sigma)

    def list_sessions():
        found = discover_sessions(args.data_dir)
        if args.session:
            found = [s for s in found if s.endswith(args.session)]
        return found

    def serve(dirs):
        return process_workload(
            dirs, psf, cfg, args.output_dir, figures=not args.no_figures,
            force=args.force, batch_reps=args.batch_reps,
            max_batch=args.max_batch, device=device,
            band_store=args.band_store, fused=args.fused_ibp,
            mm_precision=args.mm_precision, solver=args.solver,
            engine=args.engine, fusion=fusion)

    if args.watch is not None:
        watch(list_sessions, serve, args.watch, args.watch_polls)
        return 0
    sessions = list_sessions()
    if not sessions:
        print(f"no sessions found in {args.data_dir}", file=sys.stderr)
        return 1
    t0 = time.time()
    total = serve(sessions)
    print(f"{total} unit(s) processed in {time.time() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
