"""Capture orchestration: software- and hardware-triggered collection.

Re-implements the reference's L4 layer against the hardware protocols:

  * :func:`run_sw_triggered` — 9-position grid capture over tilt sweeps
    with per-image expected-shift tagging from calibration
    (``data_collection/collect_sw_triggered.py``).
  * :func:`run_hw_triggered` — 4-corner diagonal pattern, settle-time x
    tilt sweep grid, GPIO-pulse hardware triggering, camera-type-dependent
    shift target, and the "special" run whose per-corner tilts are
    interpolated from calibration to hit the target shift exactly
    (``data_collection/collect_hw_triggered.py``).

Artifacts match the reference schemas: per-combo folders of
``corner{c}_rep{NN}.png`` + ``metadata.json`` (consumed by the SR loaders),
plus run-level ``results.json`` and ``images.csv``.

The port's copy of ``enph459_super_resolution_tpu/hw/collect.py``: host
code over the hardware protocols (the frames render wherever the camera's
rig does).
"""

from __future__ import annotations

import csv
import json
import os
import time
from datetime import datetime
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..data.io import save_png
from .protocols import BeamSteering, Camera

CORNER_SIGNS = [(-1, +1), (+1, +1), (-1, -1), (+1, -1)]
CORNER_LABELS = ["(-x,+y)", "(+x,+y)", "(-x,-y)", "(+x,-y)"]
# corner index -> calibration 3x3 grid position (``collect_hw_triggered.py:64-69``)
CORNER_TO_CAL_POS = {0: 0, 1: 2, 2: 6, 3: 8}

TARGET_SHIFT_PX_COLOR = 1.0
TARGET_SHIFT_PX_MONO = 0.5


# ---------------------------------------------------------------------------
# calibration consumption
# ---------------------------------------------------------------------------

def load_calibration(csv_path: str) -> Dict:
    """shifts.csv -> {(axis, tilt_str, position): (dx_mean, dy_mean)}
    (``collect_hw_triggered.py:70-77``)."""
    cal = {}
    with open(csv_path) as fp:
        for row in csv.DictReader(fp):
            key = (row["sweep_axis"], row["tilt_angle_deg"],
                   int(row["position"]))
            cal[key] = (float(row["dx_mean_px"]), float(row["dy_mean_px"]))
    return cal


def lookup_expected_shift(cal: Dict, tilt_x: float, tilt_y: float,
                          corner_idx: int) -> Tuple[float, float]:
    """Nearest-tilt calibration lookup per axis
    (``collect_hw_triggered.py:120-148``)."""
    cal_pos = CORNER_TO_CAL_POS[corner_idx]
    exp_dx = exp_dy = 0.0
    tx = sorted({float(k[1]) for k in cal if k[0] == "x" and k[2] == cal_pos})
    if tx:
        closest = min(tx, key=lambda t: abs(t - tilt_x))
        entry = cal.get(("x", f"{closest:.5f}", cal_pos))
        if entry:
            exp_dx = entry[0]
    ty = sorted({float(k[1]) for k in cal if k[0] == "y" and k[2] == cal_pos})
    if ty:
        closest = min(ty, key=lambda t: abs(t - tilt_y))
        entry = cal.get(("y", f"{closest:.5f}", cal_pos))
        if entry:
            exp_dy = entry[1]
    return exp_dx, exp_dy


def interpolate_tilt_for_corner(csv_path: str, target_px: float,
                                corner_idx: int) -> Tuple[float, float]:
    """Invert the calibration curves: the (tilt_x, tilt_y) that produce
    ``target_px`` of |shift| at this corner (``collect_hw_triggered.py:79-118``)."""
    cal_pos = CORNER_TO_CAL_POS[corner_idx]
    tilts_x, shifts_x, tilts_y, shifts_y = [], [], [], []
    with open(csv_path) as fp:
        for row in csv.DictReader(fp):
            if int(row["position"]) != cal_pos:
                continue
            tilt = float(row["tilt_angle_deg"])
            if row["sweep_axis"] == "x":
                tilts_x.append(tilt)
                shifts_x.append(abs(float(row["dx_mean_px"])))
            elif row["sweep_axis"] == "y":
                tilts_y.append(tilt)
                shifts_y.append(abs(float(row["dy_mean_px"])))
    if not tilts_x or not tilts_y:
        raise ValueError(f"missing calibration data for corner {corner_idx}")
    ox = np.argsort(shifts_x)
    tilt_x = float(np.interp(target_px, np.asarray(shifts_x)[ox],
                             np.asarray(tilts_x)[ox]))
    oy = np.argsort(shifts_y)
    tilt_y = float(np.interp(target_px, np.asarray(shifts_y)[oy],
                             np.asarray(tilts_y)[oy]))
    return tilt_x, tilt_y


# ---------------------------------------------------------------------------
# hardware-triggered collection (4-corner)
# ---------------------------------------------------------------------------

def _folder_metadata(tilt_x: float, tilt_y: float, settle_ms: float,
                     cal: Dict, positions, cam_type: str,
                     per_corner: Optional[List[Tuple[float, float]]] = None
                     ) -> Dict:
    meta = {
        "camera_type": cam_type,
        "tilt_x_deg": tilt_x,
        "tilt_y_deg": tilt_y,
        "settling_time_ms": settle_ms,
        "positions": [
            {"index": c, "label": CORNER_LABELS[c],
             "commanded_x_deg": float(ax), "commanded_y_deg": float(ay)}
            for c, (ax, ay) in enumerate(positions)
        ],
        "expected_shifts": {},
    }
    for c in range(4):
        tx, ty = per_corner[c] if per_corner else (tilt_x, tilt_y)
        exp_dx, exp_dy = lookup_expected_shift(cal, tx, ty, c)
        meta["expected_shifts"][CORNER_LABELS[c]] = {"dx_px": exp_dx,
                                                     "dy_px": exp_dy}
    return meta


def capture_corner_sweep(xpr: BeamSteering, cam: Camera, tilt_x: float,
                         tilt_y: float, settle_ms: float, cal: Dict,
                         out_dir: str, label: str, cam_type: str,
                         num_repeats: int = 5, trigger_pulse_us: float = 100.0,
                         sleep_fn=time.sleep,
                         per_corner_tilts: Optional[List] = None) -> List[Dict]:
    """One 4-corner capture combo (``collect_hw_triggered.py:173-215``)."""
    if per_corner_tilts is not None:
        positions = [(sx * per_corner_tilts[c][0], sy * per_corner_tilts[c][1])
                     for c, (sx, sy) in enumerate(CORNER_SIGNS)]
    else:
        positions = [(sx * tilt_x, sy * tilt_y) for sx, sy in CORNER_SIGNS]

    folder = os.path.join(out_dir, label)
    os.makedirs(folder, exist_ok=True)
    meta = _folder_metadata(tilt_x, tilt_y, settle_ms, cal, positions,
                            cam_type, per_corner_tilts)
    with open(os.path.join(folder, "metadata.json"), "w") as fp:
        json.dump(meta, fp, indent=2)

    saved = []
    for r in range(num_repeats):
        for c, (ax, ay) in enumerate(positions):
            xpr.set_angles(ax, ay)
            sleep_fn(settle_ms / 1000.0)
            xpr.send_trigger_pulse(trigger_pulse_us)
            img = cam.capture_raw()
            fname = f"{label}/corner{c}_rep{r:02d}.png"
            save_png(np.asarray(img), os.path.join(out_dir, fname))
            tx, ty = (per_corner_tilts[c] if per_corner_tilts
                      else (tilt_x, tilt_y))
            exp_dx, exp_dy = lookup_expected_shift(cal, tx, ty, c)
            saved.append({
                "path": fname, "tilt_x_deg": tilt_x, "tilt_y_deg": tilt_y,
                "settling_time_ms": settle_ms, "corner": c,
                "label": CORNER_LABELS[c], "commanded_x_deg": float(ax),
                "commanded_y_deg": float(ay), "repeat": r,
                "expected_dx_px": exp_dx, "expected_dy_px": exp_dy,
            })
    xpr.set_home()
    return saved


def run_hw_triggered(xpr: BeamSteering, cam: Camera, out_base: str,
                     calibration_csv: Optional[str] = None,
                     tilt_min: float = 0.26, tilt_max: float = 0.36,
                     tilt_steps: int = 6,
                     settling_times_ms=(5.0, 50.0, 500.0),
                     num_repeats: int = 5, gain: float = 0.0,
                     exposure: Optional[float] = None,
                     special_run: bool = True,
                     sleep_fn=time.sleep,
                     timestamp: Optional[str] = None) -> Dict:
    """Full hardware-triggered run (``collect_hw_triggered.py:217-293``).

    The caller provides the camera already in hardware-trigger mode with
    exposure pre-determined (the reference runs auto-exposure in SW-trigger
    mode first; with the simulator the same camera object serves both).
    """
    run_ts = timestamp or datetime.now().strftime("%Y%m%d_%H%M%S")
    out = os.path.join(out_base, run_ts)
    os.makedirs(out, exist_ok=True)

    cal = {}
    if calibration_csv and os.path.exists(calibration_csv):
        cal = load_calibration(calibration_csv)

    cam.gain = gain
    if exposure is not None:
        cam.exposure = exposure

    cam_type = "color" if cam.is_color else "mono"
    target_shift = (TARGET_SHIFT_PX_COLOR if cam.is_color
                    else TARGET_SHIFT_PX_MONO)

    xpr.setup_trigger_output()
    tilt_angles = np.linspace(tilt_min, tilt_max, tilt_steps)
    all_images: List[Dict] = []
    combos: List[str] = []

    for settle in settling_times_ms:
        for tilt in tilt_angles:
            label = f"tilt{tilt:.5f}_settle{settle:g}ms"
            all_images += capture_corner_sweep(
                xpr, cam, tilt, tilt, settle, cal, out, label, cam_type,
                num_repeats, sleep_fn=sleep_fn)
            combos.append(label)

    special = None
    if special_run and cal and calibration_csv:
        per_corner = [interpolate_tilt_for_corner(calibration_csv,
                                                  target_shift, c)
                      for c in range(4)]
        label = f"special_target{target_shift:g}px_settle50ms"
        all_images += capture_corner_sweep(
            xpr, cam, float(np.mean([t[0] for t in per_corner])),
            float(np.mean([t[1] for t in per_corner])), 50.0, cal, out,
            label, cam_type, num_repeats, sleep_fn=sleep_fn,
            per_corner_tilts=per_corner)
        combos.append(label)
        special = {"target_shift_px": target_shift,
                   "per_corner_tilts": per_corner}

    results = {
        "timestamp": run_ts,
        "camera_type": cam_type,
        "exposure_us": float(cam.exposure),
        "gain_db": float(gain),
        "tilt_angles_deg": [float(t) for t in tilt_angles],
        "settling_times_ms": list(settling_times_ms),
        "num_repeats": num_repeats,
        "target_shift_px": target_shift,
        "special_run": special,
        "combos": combos,
        "images": all_images,
    }
    with open(os.path.join(out, "results.json"), "w") as fp:
        json.dump(results, fp, indent=2)
    _write_images_csv(all_images, os.path.join(out, "images.csv"))
    return results


# ---------------------------------------------------------------------------
# software-triggered collection (9-position grid)
# ---------------------------------------------------------------------------

def run_sw_triggered(xpr: BeamSteering, cam: Camera, out_base: str,
                     calibration_csv: Optional[str] = None,
                     tilt_min: float = 0.02, tilt_max: float = 0.30,
                     tilt_steps: int = 15, num_repeats: int = 5,
                     settle_ms: float = 20.0, sleep_fn=time.sleep,
                     timestamp: Optional[str] = None) -> Dict:
    """9-position grid capture over tilt sweeps with expected-shift tagging
    (``data_collection/collect_sw_triggered.py:34-148,208-248``)."""
    from .calibrate import CENTER_IDX, GRID_LABELS, GRID_SIGNS

    run_ts = timestamp or datetime.now().strftime("%Y%m%d_%H%M%S")
    out = os.path.join(out_base, run_ts)
    os.makedirs(out, exist_ok=True)

    cal = {}
    if calibration_csv and os.path.exists(calibration_csv):
        cal = load_calibration(calibration_csv)

    def expected_for(axis: str, tilt: float, pos: int):
        if not cal:
            return 0.0, 0.0
        tilts = sorted({float(k[1]) for k in cal
                        if k[0] == axis and k[2] == pos})
        if not tilts:
            return 0.0, 0.0
        closest = min(tilts, key=lambda t: abs(t - tilt))
        return cal.get((axis, f"{closest:.5f}", pos), (0.0, 0.0))

    tilt_angles = np.linspace(tilt_min, tilt_max, tilt_steps)
    all_images = []
    for axis in ("x", "y"):
        for tilt in tilt_angles:
            dx, dy = (tilt, 0.0) if axis == "x" else (0.0, tilt)
            combo = f"sweep{axis}_tilt{tilt:.5f}deg"
            os.makedirs(os.path.join(out, combo), exist_ok=True)
            for r in range(num_repeats):
                for p, (sx, sy) in enumerate(GRID_SIGNS):
                    ax, ay = sx * dx, sy * dy
                    xpr.set_angles(ax, ay)
                    sleep_fn(settle_ms / 1000.0)
                    img = cam.capture_raw()
                    fname = f"{combo}/pos{p}_rep{r:02d}.png"
                    save_png(np.asarray(img), os.path.join(out, fname))
                    exp_dx, exp_dy = expected_for(axis, tilt, p)
                    if p == CENTER_IDX:
                        exp_dx = exp_dy = 0.0
                    all_images.append({
                        "path": fname, "sweep_axis": axis,
                        "tilt_angle_deg": float(tilt), "position": p,
                        "label": GRID_LABELS[p], "repeat": r,
                        "commanded_x_deg": float(ax),
                        "commanded_y_deg": float(ay),
                        "expected_dx_px": float(exp_dx),
                        "expected_dy_px": float(exp_dy),
                    })
            xpr.set_home()

    results = {
        "timestamp": run_ts,
        "tilt_angles_deg": [float(t) for t in tilt_angles],
        "num_repeats": num_repeats,
        "settling_time_ms": settle_ms,
        "exposure_us": float(cam.exposure),
        "images": all_images,
    }
    with open(os.path.join(out, "results.json"), "w") as fp:
        json.dump(results, fp, indent=2)
    _write_images_csv(all_images, os.path.join(out, "images.csv"))
    return results


def _write_images_csv(images: List[Dict], path: str) -> None:
    """Manifest writer (``collect_sw_triggered.py:236-248`` style)."""
    if not images:
        return
    keys = list(images[0].keys())
    with open(path, "w", newline="") as fp:
        w = csv.DictWriter(fp, fieldnames=keys)
        w.writeheader()
        w.writerows(images)
