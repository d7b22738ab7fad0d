"""Image quality metrics: PSNR, SSIM, Michelson local contrast.

Counterpart of ``enph459_super_resolution_tpu/eval/metrics.py``, on torch
tensors (any device; numpy inputs are taken as CPU tensors).  SSIM filters
with the port's ``ops.conv.correlate1d``; ``local_contrast`` is the
reference's numpy code.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def psnr(pred, target, max_val: float = 255.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB over the full array."""
    pred, target = _f32(pred), _f32(target)
    mse = torch.mean(torch.square(pred - target))
    return 10.0 * torch.log10(max_val * max_val / torch.clamp(mse, min=1e-12))


@functools.lru_cache(maxsize=None)
def _ssim_window(size: int, sigma: float) -> np.ndarray:
    xs = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-0.5 * (xs / sigma) ** 2)
    g /= g.sum()
    return g


def ssim(pred, target, max_val: float = 255.0, win_size: int = 11,
         sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03):
    """Mean structural similarity (Wang et al. 2004): 11x11 Gaussian window
    (sigma 1.5), valid-region mean -- the standard SR-paper protocol.

    Accepts (H, W), (H, W, C) or batched (..., H, W[, C]); channels and
    batch are averaged.
    """
    from ..ops.conv import correlate1d

    pred, target = _f32(pred), _f32(target)
    if pred.dim() >= 3 and pred.shape[-1] in (1, 3, 4):  # move channels out
        pred = torch.movedim(pred, -1, 0)
        target = torch.movedim(target, -1, 0)

    g = _ssim_window(win_size, sigma)

    def filt(x):
        x = correlate1d(x, g, axis=x.dim() - 2)
        return correlate1d(x, g, axis=x.dim() - 1)

    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    mu_x = filt(pred)
    mu_y = filt(target)
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    mu_xy = mu_x * mu_y
    sig_xx = filt(pred * pred) - mu_xx
    sig_yy = filt(target * target) - mu_yy
    sig_xy = filt(pred * target) - mu_xy
    s = ((2 * mu_xy + c1) * (2 * sig_xy + c2)) / (
        (mu_xx + mu_yy + c1) * (sig_xx + sig_yy + c2))
    return torch.mean(s)


def local_contrast(profile, window: int = 20) -> np.ndarray:
    """Sliding-window Michelson contrast ``(max-min)/(max+min)`` along a
    1-D profile (``mono_cal_target/analysis.ipynb`` cell 4 semantics: the
    window is ``profile[i-w//2 : i+w//2]``, zero outside the valid span)."""
    profile = np.asarray(profile, dtype=np.float64)
    n = len(profile)
    hw = window // 2
    out = np.zeros(n)
    if n < 2 * hw:
        return out
    win = np.lib.stride_tricks.sliding_window_view(profile, 2 * hw)
    mx = win.max(axis=1)
    mn = win.min(axis=1)
    out[hw:n - hw] = ((mx - mn) / (mx + mn + 1e-9))[:n - 2 * hw]
    return out


def y_channel(img_rgb) -> torch.Tensor:
    """ITU-R BT.601 luma (the SR-paper convention for PSNR/SSIM on Y)."""
    img_rgb = _f32(img_rgb)
    w = torch.tensor([65.481, 128.553, 24.966], dtype=torch.float32,
                     device=img_rgb.device) / 255.0
    return torch.tensordot(img_rgb, w, dims=([-1], [0])) + 16.0


def log_spectral_distance(pred, target, n_bins: int = 32) -> torch.Tensor:
    """L1 distance between radially-averaged log-amplitude spectra.

    A distribution-level sharpness/texture metric for the perception-
    distortion regime: an L1/MMSE-optimal SR prediction suppresses the
    stochastic high-frequency band, which PSNR rewards but which leaves a
    gap in the amplitude spectrum.  Both inputs are 2-D (e.g. the Y
    channel); returns the mean |delta log-amplitude| over ``n_bins`` radial
    frequency bins up to Nyquist.
    """
    pred, target = _f32(pred), _f32(target)
    h, w = pred.shape[-2], pred.shape[-1]
    dev = pred.device
    fy = torch.fft.fftfreq(h, device=dev)[:, None]
    fx = torch.fft.rfftfreq(w, device=dev)[None, :]
    r = torch.hypot(fy, fx)
    idx = torch.clamp((r / 0.5 * n_bins).to(torch.int64), 0, n_bins - 1)

    def curve(x):
        amp = torch.abs(torch.fft.rfft2(x))
        zeros = torch.zeros(n_bins, device=dev)
        sums = zeros.index_add(0, idx.ravel(), amp.ravel())
        cnts = zeros.index_add(0, idx.ravel(), torch.ones_like(amp.ravel()))
        return torch.log(sums / torch.clamp(cnts, min=1.0) + 1e-6)

    return torch.mean(torch.abs(curve(pred) - curve(target)))


def shave_border(img, border: int):
    """Crop ``border`` pixels all around (standard before SR metrics)."""
    if border == 0:
        return img
    return img[..., border:-border, border:-border] \
        if img.ndim == 2 or img.shape[-1] > 4 \
        else img[..., border:-border, border:-border, :]
