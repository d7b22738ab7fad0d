"""Prewarm the classical engine's cold-start costs for known workloads.

Counterpart of ``enph459_super_resolution_tpu/sr/prewarm.py``.  A fresh
``sr.run`` process pays one-time costs before its first solve: the ``nvcc``
builds of the CUDA kernels (``_build.py``; a library already built for the
same source is reused), the host operator build, and the upload of each
solve config's operator tree.  This tool front-loads them:

  * builds and DISK-CACHES the banded operator sets for each workload's
    geometry (``sr.classical.op_cache_dir()``), for single solves and each
    ``--reps`` batch size the pipeline's unit batching will request, and
    uploads them to the device;
  * unless ``--build-only``: builds every CUDA kernel (on cuda) and runs one
    solve of a zeros burst of each geometry, which runs every kernel of
    that config once.

Usage::

    python -m enph459_super_resolution_tpu_torch.sr.prewarm \\
        [--workloads mono_cal_target,rgb_barcodes] [--reps 1,4] \\
        [--data-dir DIR] [--build-only] [--solver adjoint] [--device cpu]

Shapes and shifts default to the reference's nominal geometry per workload.
``rgb_cal_target`` reads its shifts from each session's ``metadata.json``,
so it can only be warmed from real data: ``--data-dir`` derives every
(shape, shifts, reps) spec from the actual sessions.  Like ``sr.run`` it
runs on cuda unless ``--device cpu`` is given, and asking for cuda without
a card is an error.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np

#: Reference nominal LR geometry per workload: workload -> (n_frames,
#: (h_lr, w_lr)).  The rgb workloads are the red Bayer plane of a 1536x2048
#: sensor.
NOMINAL_GEOMETRY = {
    "mono_cal_target": (5, (1536, 2048)),
    "mono_barcodes": (4, (1536, 2048)),
    "rgb_barcodes": (4, (768, 1024)),
    # rgb_cal_target: metadata-driven shifts; needs --data-dir
}


def warm_specs(cfg, reps_list, data_dir=None, max_batch: int = 4):
    """[(lr_shape, shifts, reps), ...] to warm for one workload.

    With ``data_dir`` the specs come from the real sessions (exact shapes,
    metadata shifts, and the batch sizes unit batching will form);
    otherwise from the reference's nominal geometry.
    """
    from ..data.sessions import (CENTER_SHIFT_FILES, CORNER_SHIFTS_LR,
                                 discover_sessions)

    specs = []
    if data_dir:
        from collections import Counter

        groups: Counter = Counter()
        for sdir in discover_sessions(data_dir):
            for unit in cfg.load(sdir):
                groups[(tuple(int(v) for v in unit.frames.shape[-2:]),
                        unit.shifts)] += 1
        for (shape, shifts), count in sorted(groups.items()):
            sizes = {1}
            # the pipeline batches runs of identical units in chunks of
            # max_batch with a remainder chunk
            if count > 1:
                sizes.add(min(count, max_batch))
                if count > max_batch and count % max_batch:
                    sizes.add(count % max_batch)
            for r in sorted(sizes):
                specs.append((shape, shifts, r))
        return specs

    if cfg.name not in NOMINAL_GEOMETRY:
        return []  # metadata-driven shifts: only warmable from real data
    n_frames, shape = NOMINAL_GEOMETRY[cfg.name]
    shifts = (tuple(s for _, s in CENTER_SHIFT_FILES) if n_frames == 5
              else CORNER_SHIFTS_LR)
    for r in sorted(set(int(r) for r in reps_list)):
        specs.append((shape, shifts, r))
    return specs


def prewarm_spec(cfg, psf, lr_shape, shifts, reps: int,
                 build_only: bool = False, **solve_opts) -> float:
    """Warm one (shape, shifts, reps) spec; returns elapsed seconds.
    ``solve_opts`` are :func:`~.classical.solve`'s ``device``,
    ``band_store``, ``fused``, ``mm_precision`` and ``solver``, as the
    serving run will pass them."""
    from .classical import _build_packs, _solve_matrices, solve, solve_batch

    t0 = time.time()
    if build_only:
        # host build + disk cache + upload: no solve
        opts = dict(solve_opts)
        device = opts.pop("device")
        _build_packs(_solve_matrices(
            np.asarray(psf, np.float64),
            tuple(tuple(float(v) for v in s) for s in shifts),
            cfg.upsample_factor, tuple(lr_shape), reps, device, **opts))
        return time.time() - t0
    zeros = np.zeros((reps, len(shifts)) + tuple(lr_shape), np.float32)
    kw = dict(factor=cfg.upsample_factor, n_iter=cfg.ibp_iterations,
              step=cfg.ibp_step, **solve_opts)
    if reps == 1:
        out = solve(zeros[0], psf, shifts, **kw)
    else:
        out = solve_batch(zeros, psf, shifts, **kw)
    if not np.isfinite(out["mse_history"]).all():
        raise RuntimeError(f"prewarm solve of {lr_shape} x{reps} gave a "
                           "non-finite MSE")
    return time.time() - t0


def main(argv=None) -> int:
    from .. import _build
    from ..device import DEVICES, resolve_device
    from ..ops.opmatrix import MM_PRECISIONS
    from ..psf.kernels import load_measured_psf, make_gaussian_psf
    from .classical import FUSED_MODES, SOLVERS, check_config, op_cache_dir
    from .config import WORKLOADS

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workloads", default=None,
                   help="comma-separated subset (default: all)")
    p.add_argument("--data-dir", default=None,
                   help="derive exact shapes/shifts/batch sizes from the "
                        "real sessions in this directory (required to warm "
                        "rgb_cal_target's metadata shifts); applies to the "
                        "single --workloads entry")
    p.add_argument("--reps", default="1,4",
                   help="comma-separated batch sizes to warm (nominal mode)")
    p.add_argument("--max-batch", type=int, default=4,
                   help="pipeline --max-batch the serving run will use "
                        "(shapes the --data-dir batch-size specs)")
    p.add_argument("--build-only", action="store_true",
                   help="host operator build + disk cache + upload only; no "
                        "kernel build and no solve")
    p.add_argument("--psf", choices=["gaussian", "measured"],
                   default="gaussian")
    p.add_argument("--psf-dir", default=None)
    p.add_argument("--solver", default="ibp", choices=SOLVERS)
    p.add_argument("--ibp-iters", type=int, default=None)
    p.add_argument("--band-store", default="f32",
                   metavar="{f32,bf16,hybrid[:tail]}")
    p.add_argument("--fused-ibp", default="auto", choices=FUSED_MODES)
    p.add_argument("--mm-precision", default="HIGHEST",
                   metavar="{" + ",".join(MM_PRECISIONS) + "}")
    p.add_argument("--device", default="cuda", choices=DEVICES,
                   help="where the warm runs (default cuda; no fallback)")
    args = p.parse_args(argv)
    try:
        check_config("mm", args.solver, args.band_store, args.fused_ibp,
                     args.mm_precision)
    except ValueError as exc:
        p.error(str(exc))
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        p.error(str(exc))
    names = (args.workloads.split(",") if args.workloads
             else sorted(WORKLOADS))
    unknown = sorted(set(names) - set(WORKLOADS))
    if unknown:
        p.error(f"unknown workloads {unknown}: use {sorted(WORKLOADS)}")
    if args.data_dir and len(names) != 1:
        p.error("--data-dir applies to exactly one --workloads entry")
    if args.psf == "measured" and not args.psf_dir:
        p.error("--psf measured requires --psf-dir")
    reps_list = [int(r) for r in args.reps.split(",")]
    opts = dict(device=device, band_store=args.band_store,
                fused=args.fused_ibp, mm_precision=args.mm_precision,
                solver=args.solver)

    if not args.build_only and device.type == "cuda":
        t0 = time.time()
        _build.build_all()
        print(f"kernels built: {', '.join(_build.kernel_names())} "
              f"({time.time() - t0:.1f}s)")
    total = 0
    for name in names:
        cfg = WORKLOADS[name]
        adjoint = args.solver == "adjoint"
        n_iter = (args.ibp_iters if args.ibp_iters is not None
                  else max(1, round(cfg.ibp_iterations / 4)) if adjoint
                  else cfg.ibp_iterations)
        cfg = dataclasses.replace(
            cfg, ibp_iterations=n_iter,
            ibp_step=2.0 if adjoint and args.ibp_iters is None
            else cfg.ibp_step)
        if args.psf == "measured":
            psf = load_measured_psf(args.psf_dir,
                                    halfwidth=cfg.psf_size // 2)
        else:
            psf = make_gaussian_psf(cfg.psf_size, cfg.psf_sigma)
        specs = warm_specs(cfg, reps_list, data_dir=args.data_dir,
                           max_batch=args.max_batch)
        if not specs:
            print(f"[{name}] metadata-driven shifts: pass --data-dir to "
                  "warm from real sessions; skipped")
            continue
        for shape, shifts, reps in specs:
            dt = prewarm_spec(cfg, psf, shape, shifts, reps,
                              build_only=args.build_only, **opts)
            total += 1
            kind = "built" if args.build_only else "built+solved"
            print(f"[{name}] {kind} {shape[0]}x{shape[1]} x{len(shifts)} "
                  f"frames reps={reps} solver={args.solver}: {dt:.1f}s")
    print(f"prewarmed {total} spec(s); op cache: {op_cache_dir()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
