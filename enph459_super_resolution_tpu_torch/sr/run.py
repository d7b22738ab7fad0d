"""CLI: classical multi-frame SR over capture sessions, on the card.

Counterpart of ``enph459_super_resolution_tpu/sr/run.py``:

    python -m enph459_super_resolution_tpu_torch.sr.run \\
        --workload mono_cal_target --data-dir .../data --output-dir results

Runs on CUDA unless ``--device cpu`` is given; asking for CUDA without a
card is an error, never a quiet CPU run.  Flags mirror the reference CLI
(``mono_barcodes/run_sr.py:356-367``): ``--psf {gaussian,measured}``,
``--psf-dir``, ``--data-dir``, ``--output-dir``; plus ``--no-figures`` /
``--force`` / ``--session``, rep batching, the IBP overrides, the band
store (``--band-store {f32,bf16,hybrid[:tail]}``) and the engine
(``--fused-ibp {auto,on,off}``).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time


def main(argv=None) -> int:
    from ..data.sessions import discover_sessions
    from ..device import DEVICES, resolve_device
    from ..psf.kernels import load_measured_psf, make_gaussian_psf
    from .classical import FUSED_MODES, parse_band_store
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
    p.add_argument("--device", default="cuda", choices=DEVICES,
                   help="where the solve runs (default cuda; no fallback)")
    args = p.parse_args(argv)
    try:
        parse_band_store(args.band_store)
    except ValueError as exc:
        p.error(str(exc))
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        p.error(str(exc))

    cfg = WORKLOADS[args.workload]
    if args.ibp_iters is not None or args.ibp_step is not None:
        cfg = dataclasses.replace(
            cfg,
            ibp_iterations=args.ibp_iters if args.ibp_iters is not None
            else cfg.ibp_iterations,
            ibp_step=args.ibp_step if args.ibp_step is not None
            else cfg.ibp_step)
    if args.psf == "measured":
        if not args.psf_dir:
            p.error("--psf measured requires --psf-dir")
        psf = load_measured_psf(args.psf_dir, halfwidth=cfg.psf_size // 2)
    else:
        psf = make_gaussian_psf(cfg.psf_size, cfg.psf_sigma)

    sessions = discover_sessions(args.data_dir)
    if args.session:
        sessions = [s for s in sessions if s.endswith(args.session)]
    if not sessions:
        print(f"no sessions found in {args.data_dir}", file=sys.stderr)
        return 1
    t0 = time.time()
    total = process_workload(sessions, psf, cfg, args.output_dir,
                             figures=not args.no_figures, force=args.force,
                             batch_reps=args.batch_reps,
                             max_batch=args.max_batch, device=device,
                             band_store=args.band_store,
                             fused=args.fused_ibp)
    print(f"{total} unit(s) processed in {time.time() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
