"""Autofocus: focus metrics + coarse->fine sweep + depth-of-field analysis.

The port's counterpart of ``enph459_super_resolution_tpu/hw/autofocus.py``.
Headless re-implementation of the reference's PyQt autofocus tool
(``calibration_autofocus/calibrate_autofocus.py``): the four focus metrics
(``:30-86``) are vectorizable array ops; the sweep worker (``:233-285``) is
a pure function over the Camera/Stage protocols; the DoF analysis
(``plot_depth_of_field.py:13-31``) operates on the focus curve.  An
interactive GUI can wrap these, but all logic is drivable and testable
without a display or PyQt.

The Laplacian variance runs on ``device`` in float32 (CUDA unless the
caller asks for the CPU); the other metrics, the sweep's bookkeeping and
the DoF analysis are host numpy, as in the reference.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device


def _crop(gray: np.ndarray, roi) -> np.ndarray:
    if roi is None:
        return gray
    x, y, w, h = roi
    return gray[y:y + h, x:x + w]


def laplacian_variance(gray: np.ndarray, roi=None, device="cuda") -> float:
    """Variance of the 3x3 Laplacian (cv2.Laplacian equivalent; the
    reference's default metric), in float32 on ``device``."""
    from ..ops.conv import laplacian

    g = _crop(np.asarray(gray), roi)
    if g.size == 0:
        return 0.0
    x = torch.as_tensor(np.ascontiguousarray(g), dtype=torch.float32,
                        device=resolve_device(device))
    return float(torch.var(laplacian(x), correction=0))


def peak_intensity(gray: np.ndarray, roi=None) -> float:
    g = _crop(np.asarray(gray), roi)
    return float(g.max()) if g.size else 0.0


def encircled_energy_ratio(gray: np.ndarray, roi=None,
                           radius: float = 5.0) -> float:
    """Energy fraction within ``radius`` px of the centroid."""
    g = _crop(np.asarray(gray), roi).astype(np.float64)
    if g.size == 0:
        return 0.0
    total = g.sum()
    if total == 0:
        return 0.0
    ys, xs = np.mgrid[: g.shape[0], : g.shape[1]]
    cx = (xs * g).sum() / total
    cy = (ys * g).sum() / total
    core = g[(xs - cx) ** 2 + (ys - cy) ** 2 <= radius ** 2].sum()
    return float(core / total)


def normalized_variance(gray: np.ndarray, roi=None) -> float:
    g = _crop(np.asarray(gray), roi).astype(np.float64)
    if g.size == 0:
        return 0.0
    mean = g.mean()
    return float(g.var() / mean) if mean else 0.0


FOCUS_METRICS: Dict[str, Callable] = {
    "Laplacian Variance": laplacian_variance,
    "Peak Intensity": peak_intensity,
    "Encircled Energy": encircled_energy_ratio,
    "Normalized Variance": normalized_variance,
}
DEFAULT_METRIC = "Laplacian Variance"


def focus_metric(name: str, gray: np.ndarray, roi=None,
                 device="cuda") -> float:
    """The focus metric ``name`` of one frame: the Laplacian variance on
    ``device``, the others on the host."""
    fn = FOCUS_METRICS[name]
    if fn is laplacian_variance:
        return fn(gray, roi, device=device)
    return fn(gray, roi)


def autofocus_sweep(cam, stage, start_mm: float, stop_mm: float,
                    coarse_points: int = 15, fine_points: int = 11,
                    metric: str = DEFAULT_METRIC, roi=None,
                    settle_s: float = 0.05, sleep_fn=time.sleep,
                    progress: Optional[Callable] = None,
                    axis: Optional[str] = None, device="cuda") -> Dict:
    """Coarse sweep, then a fine sweep +/-1 coarse step around the peak,
    then move to the global best (``calibrate_autofocus.py:248-285``).

    ``axis`` names which stage axis to drive on a 3-axis rig
    (:class:`~.real.ZaberStage` / :class:`~.sim.SimStage3Axis` — the
    reference sweeps the axis picked in its GUI combo, default Z,
    ``calibrate_autofocus.py:390-392,590``); ``None`` uses the stage's
    Stage-protocol surface (its configured focus axis, or a single-axis
    stage).

    ``device`` is where the Laplacian-variance metric runs.

    Returns {best_pos_mm, best_metric, positions, values, metric[, axis]}.
    """
    if metric not in FOCUS_METRICS:
        raise KeyError(metric)
    if axis is not None:
        if not hasattr(stage, "move_axis"):
            raise ValueError(f"axis={axis!r} requires a multi-axis stage "
                             "(move_axis/axis_position)")

        class _AxisView:
            def move_absolute(self, mm, _s=stage, _a=axis):
                _s.move_axis(_a, mm)

            def get_position(self, _s=stage, _a=axis):
                return _s.axis_position(_a)

        stage = _AxisView()

    def measure(positions):
        vals = []
        for pos in positions:
            stage.move_absolute(float(pos))
            sleep_fn(settle_s)
            frame = cam.capture_raw()
            v = focus_metric(metric, np.asarray(frame), roi, device)
            vals.append(v)
            if progress is not None:
                progress(float(pos), v)
        return np.asarray(vals)

    coarse = np.linspace(start_mm, stop_mm, coarse_points)
    cvals = measure(coarse)
    ci = int(np.argmax(cvals))
    cstep = coarse[1] - coarse[0] if coarse_points > 1 else 0.0
    lo = max(start_mm, coarse[ci] - cstep)
    hi = min(stop_mm, coarse[ci] + cstep)
    fine = np.linspace(lo, hi, fine_points)
    fvals = measure(fine)

    positions = np.concatenate([coarse, fine])
    values = np.concatenate([cvals, fvals])
    order = np.argsort(positions)
    positions, values = positions[order], values[order]
    best = int(np.argmax(values))
    stage.move_absolute(float(positions[best]))
    out = {
        "best_pos_mm": float(positions[best]),
        "best_metric": float(values[best]),
        "positions": positions.tolist(),
        "values": values.tolist(),
        "metric": metric,
    }
    if axis is not None:
        out["axis"] = axis
    return out


def depth_of_field(positions: Sequence[float], values: Sequence[float],
                   threshold_frac: float = 0.5
                   ) -> Tuple[float, Tuple[float, float]]:
    """Usable depth of field: the span where the focus metric stays >=
    ``threshold_frac`` x peak (``plot_depth_of_field.py:13-31``).

    Returns (dof_mm, (lo_mm, hi_mm))."""
    positions = np.asarray(positions, dtype=np.float64)
    values = np.asarray(values, dtype=np.float64)
    order = np.argsort(positions)
    positions, values = positions[order], values[order]
    thresh = values.max() * threshold_frac
    ok = values >= thresh
    if not ok.any():
        return 0.0, (float("nan"), float("nan"))
    lo = positions[ok][0]
    hi = positions[ok][-1]
    return float(hi - lo), (float(lo), float(hi))


def save_autofocus_result(result: Dict, out_dir: str) -> str:
    """Persist the focus curve like the reference's
    ``autofocus_data.json``."""
    os.makedirs(out_dir, exist_ok=True)
    dof, span = depth_of_field(result["positions"], result["values"])
    payload = dict(result)
    payload["dof_mm"] = dof
    payload["dof_span_mm"] = list(span)
    path = os.path.join(out_dir, "autofocus_data.json")
    with open(path, "w") as fp:
        json.dump(payload, fp, indent=2)
    return path
