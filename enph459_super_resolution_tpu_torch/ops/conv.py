"""Convolution primitives on images shaped ``(..., H, W)``.

Counterpart of ``enph459_super_resolution_tpu/ops/conv.py``: the same
functions over torch tensors (float32 or float64, any device).  The
reference unrolls each small kernel into a tap sum of strided slices; here
each correlation is one ``F.conv2d`` of a single channel (cuDNN on the
card), which computes the same cross-correlation with the sums in another
order.  No Pallas kernel backs any of this in the reference.  On the card
the convolutions run in strict float32: TF32 is switched off before each.

Boundary extension (:func:`pad_axis`) gathers an index built by
``numpy.pad`` of ``arange(n)``, so every numpy pad mode the reference uses
(``edge``, ``symmetric``, ``reflect``, ``wrap``) is exact at any pad width;
torch's own ``F.pad`` has no ``symmetric`` mode and its ``reflect`` needs a
pad narrower than the axis.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..device import no_tf32


def _kernel_scalars(kernel) -> np.ndarray:
    """Host-side kernel values as contiguous float64 numpy."""
    return np.ascontiguousarray(kernel, dtype=np.float64)


def pad_axis(x: torch.Tensor, axis: int, before: int, after: int,
             mode: str) -> torch.Tensor:
    """``numpy.pad`` of ``x`` along ``axis`` in a numpy pad ``mode``
    (``constant`` pads zeros)."""
    axis = axis % x.dim()
    if before == 0 and after == 0:
        return x
    n = x.shape[axis]
    if mode == "constant":
        shape = list(x.shape)
        parts = []
        for width in (before, after):
            shape[axis] = width
            parts.append(x.new_zeros(shape))
        return torch.cat([parts[0], x, parts[1]], dim=axis)
    idx = np.pad(np.arange(n), (before, after), mode=mode)
    return torch.index_select(x, axis, torch.as_tensor(idx, device=x.device))


def correlate1d(x: torch.Tensor, kernel, axis: int,
                stride: int = 1) -> torch.Tensor:
    """VALID 1-D correlation along ``axis``: ``out[i] = sum_j k[j]
    x[i*s+j]``; ``kernel`` is host numpy."""
    axis = axis % x.dim()
    k = _kernel_scalars(kernel)
    no_tf32(x)
    xt = x.movedim(axis, -1)
    lead = xt.shape[:-1]
    w = torch.as_tensor(k, dtype=x.dtype, device=x.device).reshape(1, 1, 1,
                                                                   -1)
    out = F.conv2d(xt.reshape(-1, 1, 1, xt.shape[-1]), w, stride=(1, stride))
    return out.reshape(*lead, out.shape[-1]).movedim(-1, axis)


def correlate2d_same(x: torch.Tensor, kernel, strides=(1, 1)) -> torch.Tensor:
    """SAME (zero-padded) 2-D correlation of (..., H, W) with a host 2-D
    ``kernel``."""
    k = _kernel_scalars(kernel)
    kh, kw = k.shape
    no_tf32(x)
    lead, (h, w) = x.shape[:-2], x.shape[-2:]
    xp = F.pad(x.reshape(-1, 1, h, w),
               (kw // 2, (kw - 1) // 2, kh // 2, (kh - 1) // 2))
    wt = torch.as_tensor(k, dtype=x.dtype, device=x.device)[None, None]
    out = F.conv2d(xp, wt, stride=tuple(strides))
    return out.reshape(*lead, *out.shape[-2:])


def conv2d_same(x: torch.Tensor, kernel) -> torch.Tensor:
    """True 2-D convolution (kernel flipped), SAME padding with zeros: the
    reference's ``scipy.signal.fftconvolve(x, kernel, mode='same')`` PSF
    blur (``mono_barcodes/run_sr.py:188-189``), evaluated directly."""
    kernel = _kernel_scalars(kernel)
    return correlate2d_same(x, kernel[::-1, ::-1])


@functools.lru_cache(maxsize=None)
def gaussian_kernel_1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """SciPy-compatible 1-D Gaussian kernel (``ndimage.gaussian_filter``)."""
    radius = int(truncate * float(sigma) + 0.5)
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (xs / float(sigma)) ** 2)
    return k / k.sum()


def _pad_both(x: torch.Tensor, width: int, mode: str) -> torch.Tensor:
    from .resample import PAD_MODE

    for axis in (-2, -1):
        x = pad_axis(x, axis, width, width, PAD_MODE[mode])
    return x


def gaussian_filter(x: torch.Tensor, sigma: float, mode: str = "reflect",
                    truncate: float = 4.0) -> torch.Tensor:
    """Separable Gaussian blur matching ``scipy.ndimage.gaussian_filter``
    (the reference's pinhole peak finding,
    ``data_collection/psf_mtf_utils.py:42-45``)."""
    k = gaussian_kernel_1d(float(sigma), truncate)
    xp = _pad_both(x, (len(k) - 1) // 2, mode)
    xp = correlate1d(xp, k, axis=-2)
    return correlate1d(xp, k, axis=-1)


def sobel(x: torch.Tensor, axis: int = -1, mode: str = "reflect"):
    """``scipy.ndimage.sobel`` (derivative x smoothing kernels)."""
    deriv = np.array([-1.0, 0.0, 1.0])  # a correlation: no flip
    smooth = np.array([1.0, 2.0, 1.0])
    axis = axis % x.dim()
    xp = _pad_both(x, 1, mode)
    if axis == x.dim() - 1:
        return correlate1d(correlate1d(xp, deriv, axis=-1), smooth, axis=-2)
    return correlate1d(correlate1d(xp, deriv, axis=-2), smooth, axis=-1)


def laplacian(x: torch.Tensor) -> torch.Tensor:
    """3x3 Laplacian (OpenCV ``cv2.Laplacian`` ksize=1 kernel), zero-padded
    (the reference's focus metric,
    ``calibration_autofocus/calibrate_autofocus.py:36``)."""
    k = np.array([[0.0, 1.0, 0.0], [1.0, -4.0, 1.0], [0.0, 1.0, 0.0]])
    return correlate2d_same(x, k)
