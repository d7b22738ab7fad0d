"""Order-3 (cubic) B-spline resampling: the host pieces the banded
operators are built from, and the device functions of the conv engine.

Counterpart of ``enph459_super_resolution_tpu/ops/resample.py``, copied so
that the port imports nothing of the JAX package.  The host part
(``_prefilter_halfwidth`` .. ``zoom_coords``) is float64 numpy and produces
the same numbers as the reference.  The device part (:func:`spline_shift`,
:func:`spline_coefficients`, :func:`spline_map_coordinates_separable`,
:func:`spline_zoom`) replicates ``scipy.ndimage.shift`` / ``zoom`` /
``map_coordinates`` with ``order=3`` on torch tensors: a uniform shift is
one separable correlation per axis (prefilter FIR fused with the 4 cubic
taps, :mod:`.conv`), arbitrary-grid sampling two dense matmuls.

SciPy compatibility, as in the reference: SciPy mode names map to numpy pad
modes for the prefilter (:data:`PAD_MODE`: ``nearest`` -> ``symmetric``,
``mirror`` -> ``reflect``, ``reflect`` -> ``symmetric``, ``grid-wrap`` ->
``wrap``); ``nearest`` is pre-padded with 12 edge values first (SciPy's
``_prepad_for_spline_filter``), widened for shifts past it; out-of-range
evaluation taps are index-mapped per mode (:func:`_map_index`).

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
import torch

from .conv import correlate1d, pad_axis

# Pole of the cubic B-spline direct transform.
CUBIC_POLE = math.sqrt(3.0) - 2.0

# SciPy boundary-mode name -> numpy pad mode for the prefilter (SciPy's
# prefilter init for 'nearest' is the symmetric extension; 'constant'
# prefilters with mirror extension).
PAD_MODE = {
    "nearest": "symmetric",
    "mirror": "reflect",
    "reflect": "symmetric",
    "grid-wrap": "wrap",
    "wrap": "wrap",
    "constant": "reflect",
}


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


def _dtype_name(x: torch.Tensor) -> str:
    return str(x.dtype).replace("torch.", "")


@functools.lru_cache(maxsize=None)
def shift_kernel_1d(delta: float, dtype_name: str = "float32"):
    """Prefilter + cubic sampling as one correlation kernel for a uniform
    1-D shift, ``out[i] = spline(x)(i - delta)``: ``(kernel, offset)`` with
    ``out[i] = sum_j kernel[j] * x_ext[i + offset + j]``."""
    h = bspline_prefilter_kernel(dtype_name)
    hw = (len(h) - 1) // 2
    s = -float(delta)
    m = math.floor(s)
    w = cubic_bspline_weights(np.float64(s - m))
    return np.convolve(h, w), (m - 1) - hw


def _apply_axis_kernel(x: torch.Tensor, kernel_np, offset: int, axis: int,
                       mode: str, out_len: int, stride: int = 1):
    """``out[i] = sum_j kernel[j] * ext(x)[i*stride + offset + j]`` for ``i``
    in ``[0, out_len)``, ``ext`` the ``mode`` extension of ``x``."""
    length = len(kernel_np)
    n = x.shape[axis]
    pad_left = max(0, -offset)
    pad_right = max(0, (out_len - 1) * stride + offset + length - n)
    xp = pad_axis(x, axis, pad_left, pad_right, PAD_MODE[mode])
    start = offset + pad_left
    xp = xp.narrow(axis % x.dim(), start, (out_len - 1) * stride + length)
    return correlate1d(xp, kernel_np, axis=axis, stride=stride)


def spline_shift(x: torch.Tensor, shift, mode: str = "nearest",
                 out_shape=None, strides=(1, 1)) -> torch.Tensor:
    """``scipy.ndimage.shift(x, (dy, dx), order=3, mode=mode)`` of the
    trailing two axes (reference ``mono_barcodes/run_sr.py:194,207,217``),
    optionally sampled on a strided output grid: ``result[i, j] =
    shifted[i * sy, j * sx]`` (the forward model's decimation).

    ``nearest`` pre-pads 12 edge values (SciPy's pre-pad), or ``|shift| +
    16`` for shifts past ``12 - 4``, before the symmetric prefilter.
    """
    dy, dx = float(shift[0]), float(shift[1])
    h_out, w_out = out_shape if out_shape is not None else x.shape[-2:]
    sy, sx = strides
    name = _dtype_name(x)
    npad = 12 if mode == "nearest" else 0
    if npad:
        if max(abs(dy), abs(dx)) > npad - 4:
            npad = int(max(abs(dy), abs(dx))) + 16
        for axis in (-2, -1):
            x = pad_axis(x, axis, npad, npad, "edge")
    ky, oy = shift_kernel_1d(dy, name)
    kx, ox = shift_kernel_1d(dx, name)
    x = _apply_axis_kernel(x, ky, oy + npad, -2, mode, -(-h_out // sy),
                           stride=sy)
    return _apply_axis_kernel(x, kx, ox + npad, -1, mode, -(-w_out // sx),
                              stride=sx)


def spline_coefficients(x: torch.Tensor, mode: str = "nearest",
                        axes=(-2, -1)) -> torch.Tensor:
    """Cubic spline coefficients of ``x`` (``scipy.ndimage.spline_filter``):
    the truncated-FIR prefilter over a boundary-extended copy."""
    h = bspline_prefilter_kernel(_dtype_name(x))
    hw = (len(h) - 1) // 2
    for ax in axes:
        x = _apply_axis_kernel(x, h, -hw, ax, mode, x.shape[ax])
    return x


@functools.lru_cache(maxsize=None)
def _sampling_matrix(in_size: int, coords_key, mode: str,
                     dtype_name: str) -> np.ndarray:
    """Dense (out, in) cubic sampling matrix with SciPy's tap index
    mapping."""
    coords = np.asarray(coords_key, dtype=np.float64)
    j = np.floor(coords).astype(np.int64)
    w = cubic_bspline_weights(coords - j)  # (out, 4)
    m = np.zeros((len(coords), in_size), dtype=np.float64)
    rows = np.arange(len(coords))
    for k in range(4):
        np.add.at(m, (rows, _map_index(j - 1 + k, in_size, mode)), w[:, k])
    return m.astype(np.dtype(dtype_name))


def spline_map_coordinates_separable(x: torch.Tensor, coords_y, coords_x,
                                     mode: str = "nearest",
                                     prefilter: bool = True) -> torch.Tensor:
    """``scipy.ndimage.map_coordinates`` of the trailing two axes on the
    outer product grid ``coords_y x coords_x`` (host numpy coordinates): one
    dense (out, in) matmul per axis, in full float32 on the card (TF32 is
    off by default for matmuls and the solve keeps it off)."""
    if prefilter:
        x = spline_coefficients(x, mode=mode)
    name = _dtype_name(x)
    my = torch.as_tensor(_sampling_matrix(
        x.shape[-2], tuple(np.asarray(coords_y, np.float64)), mode, name),
        device=x.device)
    mx = torch.as_tensor(_sampling_matrix(
        x.shape[-1], tuple(np.asarray(coords_x, np.float64)), mode, name),
        device=x.device)
    return torch.matmul(torch.matmul(my, x), mx.T)


def spline_zoom(x: torch.Tensor, factor: float,
                mode: str = "mirror") -> torch.Tensor:
    """``scipy.ndimage.zoom(x, factor, order=3)`` of the trailing two axes
    (reference ``mono_barcodes/run_sr.py:216,315``): endpoint-aligned
    coordinates, SciPy's default ``constant`` mode prefiltering with mirror
    boundaries."""
    _, cy = zoom_coords(x.shape[-2], factor)
    _, cx = zoom_coords(x.shape[-1], factor)
    return spline_map_coordinates_separable(x, cy, cx, mode=mode)
