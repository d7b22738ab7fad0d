"""Beam-shift calibration: commanded mirror tilt vs measured pixel shift.

The port's counterpart of ``enph459_super_resolution_tpu/hw/calibrate.py``.
Re-implementation of ``calibration_beam_shift/calibrate_shift_grid.py``
against the hardware protocols, so it runs on the simulator or real rig:
sweep tilt magnitudes per axis over a 9-position grid, locate the pinhole
with a sub-pixel Gaussian fit (CoM fallback), average shifts relative to
the grid centre over repeats, and emit ``centers.csv`` / ``shifts.csv`` /
``results.json`` in the reference's exact schemas (they are consumed
downstream by collection and SR).

The pinhole's peak filter and Gaussian fit (``psf.toolkit``) run on
``device``, CUDA unless the caller asks for the CPU.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.io import save_png
from ..device import resolve_device
from ..psf.toolkit import extract_psf, find_peak, fit_gaussian_psf_batch
from .protocols import BeamSteering, Camera

# 9-position grid, row-major top(+y) to bottom(-y)
# (``calibrate_shift_grid.py:57-63``).
GRID_SIGNS = [(sx, sy) for sy in (1, 0, -1) for sx in (-1, 0, 1)]
GRID_LABELS = ["(-x,+y)", "(0,+y)", "(+x,+y)",
               "(-x, 0)", "(0, 0)", "(+x, 0)",
               "(-x,-y)", "(0,-y)", "(+x,-y)"]
CENTER_IDX = 4

PSF_CROP_RADIUS = 30
SETTLING_TIME_MS = 10.0
NUM_REPEATS = 5


def find_pinhole_center(img: np.ndarray,
                        crop_radius: int = PSF_CROP_RADIUS,
                        device="cuda") -> Tuple[float, float]:
    """Sub-pixel (cx, cy) via 2-D Gaussian fit, thresholded-CoM fallback
    (``calibrate_shift_grid.py:66-102``); the peak filter and the fit on
    ``device``."""
    return find_pinhole_centers([img], crop_radius, device)[0]


def find_pinhole_centers(imgs: Sequence[np.ndarray],
                         crop_radius: int = PSF_CROP_RADIUS,
                         device="cuda") -> List[Tuple[float, float]]:
    """:func:`find_pinhole_center` of each image, with the Gaussian fits of
    all of them (of each crop shape) as one batched Levenberg-Marquardt
    solve on ``device``: every fit is independent of the others in the
    batch, so each centre is the one fit alone gives."""
    device = resolve_device(device)
    crops = []
    for img in imgs:
        gray = np.asarray(img, dtype=np.float64)
        peak_r, peak_c = find_peak(gray, device=device)
        psf = extract_psf(gray, (peak_r, peak_c), crop_radius,
                          noise_floor_sigma=None)
        crops.append((psf, max(peak_r - crop_radius, 0),
                      max(peak_c - crop_radius, 0), peak_r, peak_c))
    by_shape: Dict[Tuple[int, int], List[int]] = {}
    for i, crop in enumerate(crops):
        by_shape.setdefault(crop[0].shape, []).append(i)
    params: List[Optional[np.ndarray]] = [None] * len(crops)
    for idx in by_shape.values():
        fitted = fit_gaussian_psf_batch(np.stack([crops[i][0] for i in idx]),
                                        device)
        for i, popt in zip(idx, fitted):
            params[i] = popt
    return [_centre(popt, *crop) for popt, crop in zip(params, crops)]


def _centre(popt, psf, roi_r0, roi_c0, peak_r, peak_c) -> Tuple[float, float]:
    """The fitted centre in frame px, or the thresholded centre of mass of
    the crop where the fit failed."""
    if np.all(np.isfinite(popt)):
        return float(popt[1] + roi_c0), float(popt[2] + roi_r0)

    bg = np.median(psf)
    t = np.clip(psf - bg, 0, None)
    t[t < t.max() * 0.1] = 0
    total = t.sum()
    if total == 0:
        return float(peak_c), float(peak_r)
    yy, xx = np.mgrid[: t.shape[0], : t.shape[1]]
    return float((t * xx).sum() / total + roi_c0), \
        float((t * yy).sum() / total + roi_r0)


def closed_loop_auto_exposure(cam: Camera, target_peak: float = 220.0,
                              tolerance: float = 10.0, max_iters: int = 15,
                              sleep_fn=time.sleep) -> float:
    """Peak-targeted exposure servo (``calibrate_shift_grid.py:309-329``)."""
    for _ in range(max_iters):
        frame = np.asarray(cam.capture_raw(), dtype=np.float64)
        peak = frame.max()
        if abs(peak - target_peak) <= tolerance:
            break
        scale = target_peak / max(peak, 1.0)
        cam.exposure = float(np.clip(cam.exposure * scale, 10.0, 1e6))
        # let the new exposure take effect before the next probe frame (a
        # real camera's queued frame was exposed with the old setting)
        sleep_fn(0.05)
    return cam.exposure


def run_sweep(xpr: BeamSteering, cam: Camera, tilt_angles: Sequence[float],
              sweep_axis: str, out_dir: Optional[str] = None,
              num_repeats: int = NUM_REPEATS,
              settle_ms: float = SETTLING_TIME_MS,
              sleep_fn=time.sleep, save_images: bool = True,
              device="cuda"):
    """Single-axis tilt sweep over the 9-position grid
    (``calibrate_shift_grid.py:104-191``); the pinhole centres of each
    repeat's 9 frames are fitted as one batch on ``device``.

    Returns (results dict keyed by tilt, centers csv rows).
    """
    resolve_device(device)  # no card: raise before the first capture
    results: Dict[float, Dict] = {}
    csv_rows: List[List] = []
    for tilt in tilt_angles:
        dx, dy = (tilt, 0.0) if sweep_axis == "x" else (0.0, tilt)
        positions = [(sx * dx, sy * dy) for sx, sy in GRID_SIGNS]
        combo = f"sweep{sweep_axis}_tilt{tilt:.5f}deg"
        if out_dir and save_images:
            os.makedirs(os.path.join(out_dir, combo), exist_ok=True)

        shifts_all = []
        for r in range(num_repeats):
            images = []
            for p, (ax, ay) in enumerate(positions):
                xpr.set_angles(ax, ay)
                sleep_fn(settle_ms / 1000.0)
                img = cam.capture_raw()
                if r == 0 and out_dir and save_images:
                    label = GRID_LABELS[p].replace(" ", "")
                    save_png(np.asarray(img),
                             os.path.join(out_dir, combo,
                                          f"pos{p}_{label}.png"))
                images.append(img)
            centers = dict(enumerate(find_pinhole_centers(images,
                                                          device=device)))
            for p, (ax, ay) in enumerate(positions):
                cx, cy = centers[p]
                csv_rows.append([sweep_axis, tilt, r, p, GRID_LABELS[p],
                                 ax, ay, cx, cy])
            ref_cx, ref_cy = centers[CENTER_IDX]
            shifts_all.append({p: (centers[p][0] - ref_cx,
                                   centers[p][1] - ref_cy)
                               for p in range(9) if p != CENTER_IDX})

        mean_shifts = {}
        for p in range(9):
            if p == CENTER_IDX:
                continue
            dxs = [shifts_all[r][p][0] for r in range(num_repeats)]
            dys = [shifts_all[r][p][1] for r in range(num_repeats)]
            mean_shifts[p] = {
                "pos": p, "label": GRID_LABELS[p],
                "dx_mean": float(np.mean(dxs)), "dx_std": float(np.std(dxs)),
                "dy_mean": float(np.mean(dys)), "dy_std": float(np.std(dys)),
            }
        results[float(tilt)] = {"tilt_angle": float(tilt),
                                "sweep_axis": sweep_axis,
                                "mean_shifts": mean_shifts}
        xpr.set_home()
    return results, csv_rows


def save_centers_csv(csv_rows: List[List], path: str) -> None:
    """``centers.csv`` schema (``calibrate_shift_grid.py`` writer)."""
    with open(path, "w", newline="") as fp:
        w = csv.writer(fp, quoting=csv.QUOTE_NONNUMERIC)
        w.writerow(["sweep_axis", "tilt_angle", "repeat", "position",
                    "label", "angle_x", "angle_y", "cx", "cy"])
        w.writerows(csv_rows)


def save_shifts_csv(results_by_axis: Dict[str, Dict], path: str) -> None:
    """``shifts.csv`` schema (``calibrate_shift_grid.py:277-292``) —
    consumed by collection's expected-shift lookup and tilt interpolation."""
    with open(path, "w", newline="") as fp:
        fp.write("sweep_axis,tilt_angle_deg,position,label,"
                 "dx_mean_px,dx_std_px,dy_mean_px,dy_std_px\n")
        for axis, results in results_by_axis.items():
            for tilt in sorted(results):
                for p, s in sorted(results[tilt]["mean_shifts"].items()):
                    fp.write(f'{axis},{tilt:.5f},{p},"{s["label"]}",'
                             f'{s["dx_mean"]:.4f},{s["dx_std"]:.4f},'
                             f'{s["dy_mean"]:.4f},{s["dy_std"]:.4f}\n')


def run_calibration(xpr: BeamSteering, cam: Camera, out_dir: str,
                    tilt_min: float = 0.02, tilt_max: float = 0.30,
                    tilt_steps: int = 15, num_repeats: int = NUM_REPEATS,
                    settle_ms: float = SETTLING_TIME_MS,
                    sleep_fn=time.sleep, save_images: bool = True,
                    device="cuda") -> Dict:
    """Full calibration run: auto-exposure, x sweep, y sweep, artifacts
    (``calibrate_shift_grid.py:295-391``); the centre fits on
    ``device``."""
    resolve_device(device)  # no card: raise before anything is written
    os.makedirs(out_dir, exist_ok=True)
    tilts = np.linspace(tilt_min, tilt_max, tilt_steps)

    exposure = closed_loop_auto_exposure(cam, sleep_fn=sleep_fn)

    x_results, x_rows = run_sweep(xpr, cam, tilts, "x", out_dir, num_repeats,
                                  settle_ms, sleep_fn, save_images, device)
    y_results, y_rows = run_sweep(xpr, cam, tilts, "y", out_dir, num_repeats,
                                  settle_ms, sleep_fn, save_images, device)

    save_centers_csv(x_rows + y_rows, os.path.join(out_dir, "centers.csv"))
    save_shifts_csv({"x": x_results, "y": y_results},
                    os.path.join(out_dir, "shifts.csv"))

    summary = {
        "exposure_us": exposure,
        "tilt_angles": [float(t) for t in tilts],
        "num_repeats": num_repeats,
        "settling_time_ms": settle_ms,
        "x_sweep": {f"{t:.5f}": r["mean_shifts"]
                    for t, r in x_results.items()},
        "y_sweep": {f"{t:.5f}": r["mean_shifts"]
                    for t, r in y_results.items()},
    }
    with open(os.path.join(out_dir, "results.json"), "w") as fp:
        json.dump(summary, fp, indent=2)
    return summary
