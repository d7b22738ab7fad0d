#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Needs a CUDA card, the CUDA toolkit (``nvcc``) and this repository's
``enph459_super_resolution_tpu_torch`` package; it imports nothing of JAX
or of the JAX package.  Phases, one JSON line each:

1. device -- ``nvidia-smi`` name and power limit, SM count and max clock,
   the PNG codec in use; builds every kernel under ``csrc/``.
2. kernel -- the banded-row kernel against its plain PyTorch version on
   the card at every shape the two runs below give it (``zoom_r``,
   ``saa_r``, ``fwd_r``, ``bwd_r`` at LR 1536x2048, and the 4-rep tiled
   ``zoom_r``, ``saa_r``, ``fwd_r``, ``bwd_r`` at LR 768x1024), inputs
   uniform in [0, 255), max|diff| <= 1e-3; with the kernel's, the plain
   version's and a dense ``torch.matmul``'s times and the card's bound for
   the same work.
3. mono_cal_target at full size -- a synthetic center+4 session (5 x
   1536x2048 -> 3072x4096, 80 IBP iterations) through ``sr.run`` on cuda:
   artifacts, falling MSE, the kernel's launch count against the count the
   solve's structure implies, ``native_2x`` within +-1 of
   ``scipy.ndimage.zoom(order=3)``, ``SAA_IBP`` within +-1 of the same
   solve with the plain row apply on the card; warm and cold solve times
   and one profiled solve (device busy time and idle share).
4. rgb_barcodes batched -- 4 corners x 4 reps of 1536x2048 RGGB mosaics
   (768x1024 red planes) through ``sr.run``'s rep-tiled ``solve_batch``:
   every rep's artifacts, the launch count, and every rep's ``SAA_IBP``
   within +-1 of the batched solve with the plain row apply on the card.

Then the ``kernels`` summary line, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure raises and exits non-zero with no result line.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
WORK = REPO / "_smoke_work"
SEED = 0
KERNEL_ATOL = 1e-3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def nvidia_smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA
    events, after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device(torch):
    from enph459_super_resolution_tpu_torch import _build
    from enph459_super_resolution_tpu_torch.data import io

    card = nvidia_smi("name,power.limit")
    print(card, flush=True)
    max_sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t0 = time.perf_counter()
    logs = {name: _build.build(name) for name in _build.kernel_names()}
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in logs.items()}
    # float32 FMA peak of the CUDA cores: 128 lanes per SM, 2 FLOP per FMA
    f32_peak = sms * 128 * 2 * max_sm_mhz * 1e6
    emit({"phase": "device", "card": card,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "sms": sms,
          "max_sm_mhz": max_sm_mhz, "f32_peak_tflops": f32_peak / 1e12,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "png_codec": "PIL" if io._pil() is not None else "zlib",
          "kernels_built": sorted(logs), "build_s": build_s,
          "ptxas": ptxas})
    return card, f32_peak


def _dense(op) -> np.ndarray:
    m = np.zeros((op.n_out, op.n_in), dtype=np.float32)
    r0 = 0
    for blk, (lo, hi) in zip(op.blocks, op.col_ranges):
        m[r0:r0 + blk.shape[0], lo:hi] = blk
        r0 += blk.shape[0]
    return m


def phase_kernel(torch, f32_peak):
    """K1 against its plain version at the main path's shapes."""
    from enph459_super_resolution_tpu_torch.ops.banded_rows import (
        banded_row_apply, banded_row_apply_reference)
    from enph459_super_resolution_tpu_torch.sr.classical import (
        _host_solve_matrices, make_gaussian_psf)
    from enph459_super_resolution_tpu_torch.data.sessions import (
        CENTER_SHIFT_FILES, CORNER_SHIFTS_LR)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    psf = make_gaussian_psf()
    shifts = tuple(s for _, s in CENTER_SHIFT_FILES)
    full = _host_solve_matrices(psf, shifts, 2, (1536, 2048))
    tiled = _host_solve_matrices(psf, CORNER_SHIFTS_LR, 2, (768, 1024),
                                 reps=4)
    # frame 1 has a nonzero sub-pixel shift; (op, input batch, input width)
    cases = {
        # the zoom runs on the 5-frame stack and on the LR mean
        "zoom_r": (full["zoom_r"], 5, 2048),
        "zoom_r_mean": (full["zoom_r"], 1, 2048),
        "saa_r": (full["saa"][1][0], 1, 4096),
        "fwd_r": (full["frames"][1][0][0], 1, 4096),
        "bwd_r": (full["frames"][1][2][0], 1, 2048),
        # the rgb_barcodes batched solve: 4 reps stacked along H
        "zoom_r_tiled4": (tiled["zoom_r"], 4, 1024),
        "zoom_r_tiled4_mean": (tiled["zoom_r"], 1, 1024),
        "saa_r_tiled4": (tiled["saa"][1][0], 1, 2048),
        "fwd_r_tiled4": (tiled["frames"][1][0][0], 1, 2048),
        "bwd_r_tiled4": (tiled["frames"][1][2][0], 1, 1024),
    }
    rng = np.random.default_rng(SEED)
    rows = []
    for name, (host_op, batch, width) in cases.items():
        op = host_op.to(dev)
        pack = op.row_pack
        x = torch.as_tensor(rng.uniform(0, 255, (batch, op.n_in, width)),
                            dtype=torch.float32, device=dev)
        got = banded_row_apply(pack, x)
        want = banded_row_apply_reference(pack, x)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        check(err <= KERNEL_ATOL, f"{name}: max|kernel - plain| {err} > "
                                  f"{KERNEL_ATOL}")
        dense = torch.as_tensor(_dense(host_op), device=dev)
        kernel_ms = time_ms(torch, lambda: banded_row_apply(pack, x), 20)
        plain_ms = time_ms(torch, lambda: banded_row_apply_reference(pack, x),
                           5)
        library_ms = time_ms(torch, lambda: torch.matmul(dense, x), 5)
        true_win = sum(b.shape[0] * (hi - lo) for b, (lo, hi)
                       in zip(host_op.blocks, host_op.col_ranges))
        flops = 2.0 * true_win * width * batch
        nbytes = 4.0 * (x.numel() + batch * op.n_out * width
                        + pack.bands.numel() + pack.meta.numel())
        t_ops, t_bytes = flops / f32_peak, nbytes / HBM_BYTES_PER_S
        row = {"phase": "kernel", "op": name,
               "x": [batch, op.n_in, width], "out_rows": op.n_out,
               "blocks": len(host_op.blocks),
               "true_window": max(hi - lo for lo, hi in host_op.col_ranges),
               "packed_window": int(pack.bands.shape[-1]),
               "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
               "max_abs_err": err, "kernel_ms": kernel_ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": max(t_ops, t_bytes) * 1e3,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "kernel_tflops": flops / kernel_ms / 1e9}
        emit(row)
        rows.append(row)
        del dense, x, got, want
    return rows


def phase_profile(torch, run_solve):
    """Where one warm full-size solve spends the card's time: device time
    by kernel (torch.profiler) against the same solve's wall clock, whose
    ratio is the device's idle share (the profiler's own host overhead is
    in that wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_solve()
        wall_s = time.perf_counter() - t0
    # device-side events only (kernels, copies): the aten ops that launch
    # them carry the same device time again
    kernels = [(e.key, e.self_device_time_total, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_us = sum(t for _, t, _ in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:12]
    busy_s = busy_us / 1e6
    emit({"phase": "profile", "what": "one warm mono_cal_target solve",
          "profiled_wall_s": wall_s, "device_busy_s": busy_s,
          "device_idle_share": 1.0 - busy_s / wall_s,
          "top_kernels": [{"name": k[:90], "device_ms": t / 1e3, "count": c}
                          for k, t, c in top]})
    check(busy_s > 0, "the profiler saw no device time")
    return busy_s, wall_s


def _smooth_scene(rng, shape):
    import scipy.ndimage as ndi

    scene = ndi.gaussian_filter(rng.uniform(0, 255, shape), 1.5)
    lo, hi = scene.min(), scene.max()
    return (scene - lo) * (230.0 / (hi - lo)) + 10.0


def _noisy_u8(rng, scene):
    return np.clip(scene + rng.normal(0, 2.0, scene.shape), 0,
                   255).astype(np.uint8)


def _check_unit(out_dir: Path, lr_mean_name: str):
    for f in ("native_2x.png", "SAA.png", "SAA_IBP.png", lr_mean_name,
              "shifts.json", "metrics.json", "done.flag"):
        check((out_dir / f).exists(), f"missing artifact {out_dir / f}")
    metrics = json.loads((out_dir / "metrics.json").read_text())
    mse = metrics["mse_history"]
    check(all(np.isfinite(mse)), f"{out_dir}: non-finite MSE")
    check(mse[-1] < mse[0], f"{out_dir}: MSE did not fall "
                            f"({mse[0]} -> {mse[-1]})")
    return metrics


def _expected_launches(psf, n_frames, n_iter):
    """K1 launches of one (batched) solve: the LR-mean zoom, the stack zoom
    (one batched launch), one Shift-and-Add row apply per frame, and per
    IBP iteration and frame one forward and one back-projection row apply
    per PSF rank term."""
    from enph459_super_resolution_tpu_torch.ops.opmatrix import \
        psf_separable_factors

    rank = len(psf_separable_factors(psf)[0])
    return 1 + 1 + n_frames + n_iter * n_frames * 2 * rank


def phase_mono(torch):
    import scipy.ndimage as ndi

    from enph459_super_resolution_tpu_torch.data.io import load_gray, save_png
    from enph459_super_resolution_tpu_torch.data.sessions import \
        load_center_shift_session
    from enph459_super_resolution_tpu_torch.ops.banded_rows import \
        banded_row_apply
    from enph459_super_resolution_tpu_torch.sr import classical, run
    from enph459_super_resolution_tpu_torch.sr.classical import (
        make_gaussian_psf, solve, to_uint8)
    from enph459_super_resolution_tpu_torch.sr.config import WORKLOADS

    cfg = WORKLOADS["mono_cal_target"]
    rng = np.random.default_rng(SEED + 1)
    sdir = WORK / "mono" / "data" / "session0"
    scene = _smooth_scene(rng, (1536, 2048))
    for fname in ("center.png", "shift_0.png", "shift_1.png", "shift_2.png",
                  "shift_3.png"):
        save_png(_noisy_u8(rng, scene), str(sdir / fname))
    out = WORK / "mono" / "results"

    banded_row_apply.launches = 0
    t0 = time.perf_counter()
    rc = run.main(["--workload", "mono_cal_target", "--data-dir",
                   str(sdir.parent), "--output-dir", str(out), "--device",
                   "cuda", "--no-figures"])
    run_s = time.perf_counter() - t0
    launches = banded_row_apply.launches
    check(rc == 0, f"sr.run exited {rc}")
    psf = make_gaussian_psf(cfg.psf_size, cfg.psf_sigma)
    expected = _expected_launches(psf, 5, cfg.ibp_iterations)
    check(launches == expected,
          f"K1 launches {launches}, solve structure implies {expected}")
    unit = out / "session0"
    metrics = _check_unit(unit, cfg.lr_mean_name)
    check(metrics["hr_shape"] == [3072, 4096], f"hr {metrics['hr_shape']}")

    session = load_center_shift_session(str(sdir))
    lr_mean = session.frames.astype(np.float64).mean(axis=0)
    ref_native = to_uint8(ndi.zoom(lr_mean, 2, order=3))
    native = load_gray(str(unit / "native_2x.png")).astype(np.int16)
    native_diff = int(np.abs(native - ref_native).max())
    check(native_diff <= 1, f"native_2x vs scipy zoom: {native_diff} > 1")

    # the same solve again: warm (operator tree kept in process since
    # sr.run), then cold (tree dropped: read back from the disk cache and
    # every pack uploaded again), then profiled, then with the plain row
    # apply on the card
    frames = torch.as_tensor(session.frames, device="cuda")

    def timed_solve():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve(frames, psf, session.shifts, device="cuda")
        return res, time.perf_counter() - t0

    solve_runs = []
    for _ in range(3):
        kern, dt = timed_solve()
        solve_runs.append(dt)
    solve_s = sorted(solve_runs)[1]
    classical._device_matrices.cache_clear()
    _, cold_solve_s = timed_solve()
    busy_s, profiled_s = phase_profile(
        torch, lambda: solve(frames, psf, session.shifts, device="cuda"))
    t0 = time.perf_counter()
    plain = solve(frames, psf, session.shifts, device="cuda", plain_rows=True)
    plain_solve_s = time.perf_counter() - t0
    ibp_png = load_gray(str(unit / "SAA_IBP.png")).astype(np.int16)
    ibp_diff = int(np.abs(ibp_png - to_uint8(plain["ibp"])).max())
    check(ibp_diff <= 1, f"SAA_IBP kernel vs plain rows: {ibp_diff} > 1")
    rerun_diff = int(np.abs(ibp_png - to_uint8(kern["ibp"])).max())
    hr_mpix = 3072 * 4096 / 1e6
    emit({"phase": "mono_cal_target", "lr": [5, 1536, 2048],
          "hr": [3072, 4096], "ibp_iterations": cfg.ibp_iterations,
          "k1_launches": launches, "k1_launches_expected": expected,
          "native_vs_scipy_max_diff": native_diff,
          "ibp_kernel_vs_plain_max_diff": ibp_diff,
          "ibp_rerun_max_diff": rerun_diff,
          "mse_first": metrics["mse_history"][0],
          "mse_last": metrics["mse_history"][-1],
          "sr_run_s": run_s, "sr_run_solve_s": metrics["timings_s"]["solve"],
          "solve_s_runs": solve_runs, "solve_s": solve_s,
          "hr_mpix_per_s": hr_mpix / solve_s,
          "cold_solve_s": cold_solve_s,
          "operator_prologue_s": cold_solve_s - solve_s,
          "profiled_solve_s": profiled_s, "device_busy_s": busy_s,
          "device_idle_share": 1.0 - busy_s / profiled_s,
          "plain_rows_solve_s": plain_solve_s})
    return launches


def phase_rgb(torch):
    from enph459_super_resolution_tpu_torch.data.io import load_gray, save_png
    from enph459_super_resolution_tpu_torch.ops.banded_rows import \
        banded_row_apply
    from enph459_super_resolution_tpu_torch.sr import run
    from enph459_super_resolution_tpu_torch.sr.classical import (
        make_gaussian_psf, solve_batch, to_uint8)
    from enph459_super_resolution_tpu_torch.sr.config import WORKLOADS

    cfg = WORKLOADS["rgb_barcodes"]
    rng = np.random.default_rng(SEED + 2)
    sdir = WORK / "rgb" / "data" / "barcodes0"
    scene = _smooth_scene(rng, (1536, 2048))
    n_reps = 4
    for ci in range(4):
        for ri in range(n_reps):
            save_png(_noisy_u8(rng, scene),
                     str(sdir / f"corner{ci}_rep{ri:02d}.png"))
    out = WORK / "rgb" / "results"

    banded_row_apply.launches = 0
    t0 = time.perf_counter()
    rc = run.main(["--workload", "rgb_barcodes", "--data-dir",
                   str(sdir.parent), "--output-dir", str(out), "--device",
                   "cuda", "--no-figures"])
    run_s = time.perf_counter() - t0
    launches = banded_row_apply.launches
    check(rc == 0, f"sr.run exited {rc}")
    psf = make_gaussian_psf(cfg.psf_size, cfg.psf_sigma)
    expected = _expected_launches(psf, 4, cfg.ibp_iterations)
    check(launches == expected, f"K1 launches {launches} for one batched "
                                f"solve, structure implies {expected}")
    # the same batched solve with the plain row apply on the card
    units = cfg.load(str(sdir))
    check(len(units) == n_reps, f"{len(units)} units, expected {n_reps}")
    t0 = time.perf_counter()
    plain = solve_batch(np.stack([u.frames for u in units]), psf,
                        units[0].shifts, factor=cfg.upsample_factor,
                        n_iter=cfg.ibp_iterations, step=cfg.ibp_step,
                        device="cuda", plain_rows=True)
    plain_batch_s = time.perf_counter() - t0
    batch_s, ibp_diffs = None, []
    for ri, unit in enumerate(units):
        unit_dir = out / "barcodes0" / f"rep{unit.rep}"
        m = _check_unit(unit_dir, cfg.lr_mean_name)
        check(m["hr_shape"] == [1536, 2048], f"rep{ri} hr {m['hr_shape']}")
        batch_s = m["timings_s"]["solve_batch_total"]
        ibp_png = load_gray(str(unit_dir / "SAA_IBP.png")).astype(np.int16)
        ibp_diffs.append(int(np.abs(ibp_png
                                    - to_uint8(plain["ibp"][ri])).max()))
    check(max(ibp_diffs) <= 1,
          f"SAA_IBP kernel vs plain rows, per rep: {ibp_diffs}")
    emit({"phase": "rgb_barcodes", "reps": n_reps, "lr": [4, 768, 1024],
          "hr": [1536, 2048], "k1_launches": launches,
          "k1_launches_expected": expected,
          "ibp_kernel_vs_plain_max_diff_per_rep": ibp_diffs,
          "sr_run_s": run_s, "solve_batch_s": batch_s,
          "hr_mpix_per_s": n_reps * 1536 * 2048 / 1e6 / batch_s,
          "plain_rows_solve_batch_s": plain_batch_s})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2

    shutil.rmtree(WORK, ignore_errors=True)
    try:
        card, f32_peak = phase_device(torch)
        rows = phase_kernel(torch, f32_peak)
        launches = phase_mono(torch)
        phase_rgb(torch)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    head = next(r for r in rows if r["op"] == "fwd_r")
    emit({"kernels": [{
        "name": "banded_rows", "route": "cuda",
        "source": "enph459_super_resolution_tpu_torch/csrc/banded_rows.cu",
        "replaces": "enph459_super_resolution_tpu/ops/pallas_kernels.py:34",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": head["kernel_ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "at": "fwd_r, LR 1536x2048 (x 3072x4096 f32)", "card": card}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
