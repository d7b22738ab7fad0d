"""Slanted-edge MTF (ISO-12233-style) — the scripted, testable form of the
cal-target notebooks' ROI-2 measurement (protocol defined by
``mono_cal_target/analysis.ipynb`` cells 7-10; golden-pinned on the
reference's real checked-in results in ``tests/test_cal_target_golden.py``).

Measurement protocol (the numbers are only comparable across methods if
every step matches, so each constant is part of the metric definition):

  1. edge pixels = Sobel gradient magnitude of a sigma-1.5-smoothed ROI
     above its 85th percentile;
  2. a least-squares centre line through all edge pixels splits them into
     the two sides of the (thick) line; the requested side's cluster is
     re-fit to get the single edge;
  3. every ROI pixel is projected onto the edge's unit normal; samples
     within the (-8, +10) px band become a 4x-oversampled mean-binned ESF;
  4. LSF = d(ESF)/dx, Hann-windowed; MTF = |FFT|, DC-normalized.

Per SURVEY.md §7 this stays host-side numpy (data-dependent clustering and
thresholds); the gradient filters run through the shared torch ops on
``device`` (CUDA unless the caller asks for the CPU), in float64 as the
reference runs them under ``jax_enable_x64``.  The notebook's per-bin
Python loop is a vectorized ``bincount`` here.  The port's counterpart of
``enph459_super_resolution_tpu/eval/slanted_edge.py``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

GRAD_SIGMA = 1.5
BAND = (-8.0, 10.0)        # plateau on both sides, short of the 2nd edge
OVERSAMPLE = 4


class EdgeNotFound(RuntimeError):
    """Too few edge pixels in the ROI.  A ``RuntimeError``, as the
    reference raises; its own class so that a caller that records it never
    swallows a device error, which torch also raises as ``RuntimeError``."""


def _edge_points(roi: np.ndarray, grad_percentile: float,
                 device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """(rows, cols) of pixels whose smoothed Sobel gradient magnitude is
    above the given percentile."""
    import torch

    from ..ops.conv import gaussian_filter, sobel

    smooth = gaussian_filter(torch.as_tensor(np.asarray(roi, np.float64),
                                             device=device), GRAD_SIGMA)
    g_row = sobel(smooth, axis=0).cpu().numpy()
    g_col = sobel(smooth, axis=1).cpu().numpy()
    mag = np.hypot(g_row, g_col)
    return np.nonzero(mag > np.percentile(mag, grad_percentile))


class _EdgeLine:
    """A least-squares line through a point cloud, parameterized in the
    better-conditioned frame (ordinate regressed on whichever coordinate
    spans more pixels, so near-vertical and near-horizontal edges are both
    well posed)."""

    def __init__(self, rows, cols, row_is_abscissa: bool):
        self.row_is_abscissa = row_is_abscissa
        t, u = (rows, cols) if row_is_abscissa else (cols, rows)
        self.slope, self.intercept = np.polyfit(t, u, 1)
        self._inv_norm = 1.0 / np.hypot(1.0, self.slope)

    @classmethod
    def through(cls, rows, cols, row_is_abscissa=None) -> "_EdgeLine":
        if row_is_abscissa is None:
            row_is_abscissa = np.ptp(rows) >= np.ptp(cols)
        return cls(rows, cols, row_is_abscissa)

    def normal_distance(self, rows, cols) -> np.ndarray:
        """Signed perpendicular distance of (rows, cols) from the line."""
        t, u = (rows, cols) if self.row_is_abscissa else (cols, rows)
        return (u - self.slope * t - self.intercept) * self._inv_norm

    @property
    def angle_deg(self) -> float:
        """Edge angle w.r.t. the row axis (the notebook's convention:
        atan2(1, m) when rows are the abscissa, atan2(m, 1) otherwise)."""
        m = self.slope
        a = np.arctan2(1.0, m) if self.row_is_abscissa else np.arctan2(m, 1.0)
        return float(np.degrees(a))


def _binned_mean(dist: np.ndarray, val: np.ndarray,
                 oversample: int) -> Tuple[np.ndarray, np.ndarray]:
    """Mean of ``val`` in 1/oversample-wide distance bins; empty bins are
    filled by linear interpolation."""
    width = 1.0 / oversample
    edges = np.arange(dist.min(), dist.max() + width, width)
    centers = 0.5 * (edges[:-1] + edges[1:])
    which = np.clip(np.digitize(dist, edges) - 1, 0, len(centers) - 1)
    total = np.bincount(which, weights=val, minlength=len(centers))
    count = np.bincount(which, minlength=len(centers))
    mean = np.where(count > 0, total / np.maximum(count, 1), np.nan)
    filled = ~np.isnan(mean)
    if filled.sum() > 2:
        mean = np.interp(centers, centers[filled], mean[filled])
    return centers, mean


def slanted_edge_esf(roi: np.ndarray, side: str = "left",
                     band=BAND, oversample: int = OVERSAMPLE,
                     grad_percentile: float = 85.0, device="cuda"):
    """Oversampled edge-spread function of ONE edge of a slanted line.

    ``side`` picks the cluster of edge pixels with negative ('left') or
    positive ('right') signed distance from the centre line.  Returns
    (esf_x, esf_y, edge_angle_deg) with the bright side oriented right.
    The gradient filters run on ``device``.
    """
    roi = np.asarray(roi, dtype=np.float64)
    rows, cols = _edge_points(roi, grad_percentile, device)
    if len(rows) < 20:
        raise EdgeNotFound("too few edge pixels detected")

    centre = _EdgeLine.through(rows, cols)
    signed = centre.normal_distance(rows, cols)
    keep = signed < 0 if side == "left" else signed > 0
    if keep.sum() < 10:
        raise EdgeNotFound(f"too few edge pixels on {side} side")
    # re-fit on the chosen cluster only, in the centre line's frame (the
    # cluster alone could span the axes differently and flip frames)
    edge = _EdgeLine.through(rows[keep], cols[keep],
                             row_is_abscissa=centre.row_is_abscissa)

    rr, cc = np.mgrid[: roi.shape[0], : roi.shape[1]]
    dist = edge.normal_distance(rr.ravel(), cc.ravel())
    val = roi.ravel()
    in_band = (dist > band[0]) & (dist < band[1])
    esf_x, esf_y = _binned_mean(dist[in_band], val[in_band], oversample)

    if esf_y[-1] < esf_y[0]:  # orient bright side to the right
        esf_x = -esf_x[::-1]
        esf_y = esf_y[::-1]
    return esf_x, esf_y, edge.angle_deg


def esf_to_mtf(esf_x, esf_y) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """ESF -> LSF (gradient) -> Hann-windowed |FFT| -> normalized MTF.

    Returns (freq [cycles/px of the ESF grid], mtf, lsf).
    """
    lsf = np.gradient(esf_y, esf_x)
    lsf_w = lsf * np.hanning(len(lsf))
    n = len(lsf_w)
    mtf = np.abs(np.fft.fft(lsf_w))[: n // 2]
    if mtf[0] > 0:
        mtf = mtf / mtf[0]
    dx = float(np.mean(np.diff(esf_x)))
    freq = np.fft.fftfreq(n, d=dx)[: n // 2]
    return freq, mtf, lsf


def slanted_edge_mtf(roi, pixel_pitch_mm: float = None, side: str = "left",
                     device="cuda"):
    """Convenience: ROI -> (freq, mtf) with optional cycles/mm conversion
    (``analysis.ipynb`` cell 9: HR pitch = sensor pitch / upsample)."""
    esf_x, esf_y, angle = slanted_edge_esf(roi, side, device=device)
    freq, mtf, lsf = esf_to_mtf(esf_x, esf_y)
    if pixel_pitch_mm is not None:
        freq = freq / pixel_pitch_mm
    return {"freq": freq, "mtf": mtf, "lsf": lsf, "esf_x": esf_x,
            "esf_y": esf_y, "angle_deg": angle}
