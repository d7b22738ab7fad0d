"""Host-side cubic B-spline pieces the banded-operator construction needs.

Counterpart of the host part of ``enph459_super_resolution_tpu/ops/
resample.py`` (its ``_prefilter_halfwidth``, ``bspline_prefilter_kernel``,
``cubic_bspline_weights``, ``_map_index`` and ``zoom_coords``), copied so
that the port imports nothing of the JAX package.  Everything here is
float64 numpy and produces the same numbers as the reference.

The cubic direct B-spline transform is the inverse of
``B(z) = (z + 4 + z^-1) / 6``; its impulse response
``h[n] = sqrt(3) * z1^|n|`` (pole ``z1 = sqrt(3) - 2``) decays below the
working dtype's epsilon in a few dozen taps, so the prefilter is an exact
(to machine precision) short symmetric FIR.
"""

from __future__ import annotations

import functools
import math

import numpy as np

# Pole of the cubic B-spline direct transform.
CUBIC_POLE = math.sqrt(3.0) - 2.0


def _prefilter_halfwidth(dtype) -> int:
    """Taps needed for the FIR prefilter to reach machine precision."""
    eps = float(np.finfo(dtype).eps)
    # |h[n]| = sqrt(3) |z1|^n ; solve sqrt(3)|z1|^K < eps/8 for margin.
    k = math.ceil(math.log(eps / (8.0 * math.sqrt(3.0))) / math.log(abs(CUBIC_POLE)))
    return max(k, 8)


@functools.lru_cache(maxsize=None)
def bspline_prefilter_kernel(dtype_name: str = "float32") -> np.ndarray:
    """Symmetric FIR impulse response of the cubic direct B-spline transform,
    truncated at the dtype's epsilon and normalized to unit DC gain."""
    dtype = np.dtype(dtype_name)
    hw = _prefilter_halfwidth(dtype)
    n = np.abs(np.arange(-hw, hw + 1, dtype=np.float64))
    h = math.sqrt(3.0) * (CUBIC_POLE ** n)
    h /= h.sum()
    return h


def cubic_bspline_weights(t: np.ndarray) -> np.ndarray:
    """4 interpolation weights at fractional offset ``t`` in [0, 1), for taps
    at offsets (-1, 0, +1, +2) relative to ``floor(sample_position)``."""
    t = np.asarray(t, dtype=np.float64)
    t2 = t * t
    t3 = t2 * t
    omt = 1.0 - t
    w0 = omt * omt * omt / 6.0
    w1 = 2.0 / 3.0 - t2 + 0.5 * t3
    w3 = t3 / 6.0
    w2 = 1.0 - (w0 + w1 + w3)
    return np.stack([w0, w1, w2, w3], axis=-1)


def _map_index(idx, n, mode):
    """SciPy's out-of-range coefficient index mapping per boundary mode."""
    if mode in ("nearest", "constant"):
        return np.clip(idx, 0, n - 1)
    if mode == "mirror":
        if n == 1:
            return np.zeros_like(idx)
        period = 2 * (n - 1)
        idx = np.abs(idx) % period
        return np.where(idx >= n, period - idx, idx)
    if mode == "reflect":
        period = 2 * n
        idx = np.where(idx < 0, -idx - 1, idx) % period
        return np.where(idx >= n, period - idx - 1, idx)
    if mode in ("wrap", "grid-wrap"):
        return idx % n
    raise ValueError(f"unsupported mode {mode!r}")


def zoom_coords(in_size: int, factor: float):
    """SciPy ``ndimage.zoom`` (grid_mode=False) output size + sample coords."""
    out_size = int(round(in_size * factor))
    if out_size <= 1 or in_size <= 1:
        return out_size, np.zeros((max(out_size, 0),), dtype=np.float64)
    step = (in_size - 1) / (out_size - 1)
    return out_size, np.arange(out_size, dtype=np.float64) * step
