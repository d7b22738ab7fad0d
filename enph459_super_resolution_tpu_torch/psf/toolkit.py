"""PSF/MTF characterization toolkit.

The port's counterpart of ``enph459_super_resolution_tpu/psf/toolkit.py``,
which re-designs the reference's per-image numpy loops
(``data_collection/psf_mtf_utils.py:34-190``,
``calibration_psf/analyze_psf_mtf.py:37-205``) as batched device
pipelines: peak finding, MTF-via-FFT and radial averaging run over the
whole image stack at once on ``device`` (CUDA unless the caller asks for
the CPU); the 2-D Gaussian fit is one batched Levenberg-Marquardt solve
instead of per-image ``scipy.curve_fit``.  Small/branchy pieces (ROI
percentile background, crossing interpolation) stay host-side numpy.

Precision: the device pieces compute in float64, the dtype of the numpy
input, as the reference's do under ``jax_enable_x64`` (its CLIs, with x64
off, compute them in float32).  :func:`find_peak` stays float32, as in the
reference, so that ties resolve alike.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import no_tf32
from ..ops.conv import gaussian_filter

LM_ITERATIONS = 40
N_PARAMS = 7


# ---------------------------------------------------------------------------
# extraction (host-side: tiny ROIs, data-dependent percentiles)
# ---------------------------------------------------------------------------

def find_peak(img, smooth_sigma: float = 2.0,
              device="cuda") -> Tuple[int, int]:
    """(row, col) of the PSF peak after light Gaussian smoothing
    (``psf_mtf_utils.py:42-45``): a float32 filter and argmax on
    ``device`` (the first maximum in row-major order)."""
    x = torch.as_tensor(np.asarray(img), dtype=torch.float32, device=device)
    no_tf32(x)
    sm = gaussian_filter(x, smooth_sigma)
    flat = int(sm.argmax())
    return tuple(int(v) for v in np.unravel_index(flat, tuple(sm.shape)))


def extract_psf(img: np.ndarray, center, radius: int,
                bg_percentile: float = 50.0,
                noise_floor_sigma: Optional[float] = 3.0) -> np.ndarray:
    """Background-subtracted ROI centred on the peak.

    Annulus-percentile background (``psf_mtf_utils.py:48-65``) plus the
    sparse-noise floor at ``noise_floor_sigma`` x background std added by
    ``analyze_psf_mtf.py:66-71`` (pass None to disable, matching the plain
    psf_mtf_utils behavior).
    """
    r, c = center
    h, w = img.shape
    r0, r1 = max(r - radius, 0), min(r + radius + 1, h)
    c0, c1 = max(c - radius, 0), min(c + radius + 1, w)
    roi = np.array(img[r0:r1, c0:c1], dtype=np.float64)

    yy, xx = np.ogrid[: roi.shape[0], : roi.shape[1]]
    cy, cx = roi.shape[0] // 2, roi.shape[1] // 2
    annulus = ((yy - cy) ** 2 + (xx - cx) ** 2) >= (radius * 0.6) ** 2
    bg = np.percentile(roi[annulus], bg_percentile)
    roi -= bg
    roi[roi < 0] = 0
    if noise_floor_sigma is not None:
        bg_std = float(np.std(roi[annulus]))
        if bg_std > 0:
            roi[roi < noise_floor_sigma * bg_std] = 0
    return roi


def subpixel_centre(psf) -> Tuple[float, float]:
    """Thresholded centre of mass (``psf_mtf_utils.py:68-72``)."""
    psf = np.asarray(psf, dtype=np.float64)
    masked = np.where(psf > psf.max() * 0.1, psf, 0.0)
    total = masked.sum()
    yy, xx = np.mgrid[: psf.shape[0], : psf.shape[1]]
    return float((masked * yy).sum() / total), float((masked * xx).sum() / total)


# ---------------------------------------------------------------------------
# radial statistics (host numpy for one profile; torch for batched stacks)
# ---------------------------------------------------------------------------

def radial_average(data, center=None, max_radius: Optional[int] = None):
    """Azimuthal mean profile, integer-truncated radii bins
    (``psf_mtf_utils.py:75-96``), computed with one bincount instead of a
    per-radius mask loop.  Returns (radii, profile)."""
    data = np.asarray(data, dtype=np.float64)
    h, w = data.shape
    cy, cx = (h / 2.0, w / 2.0) if center is None else center
    yy, xx = np.mgrid[:h, :w]
    r = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2).astype(int)
    if max_radius is None:
        max_radius = int(min(cy, cx, h - cy, w - cx))
    flat_r = r.ravel()
    sums = np.bincount(flat_r, weights=data.ravel(),
                       minlength=max_radius)[:max_radius]
    counts = np.bincount(flat_r, minlength=max_radius)[:max_radius]
    profile = np.where(counts > 0, sums / np.maximum(counts, 1), 0.0)
    return np.arange(max_radius), profile


def _radial_average_dev(data: torch.Tensor, cy: float, cx: float,
                        max_radius: int) -> torch.Tensor:
    """Radial mean of each image of a (N, h, w) stack on its device, fixed
    bin count: one ``index_add_`` of the stack into ``max_radius + 1`` bins
    (the last one the overflow bin), the reference's ``segment_sum``."""
    n, h, w = data.shape
    yy = torch.arange(h, dtype=data.dtype, device=data.device)[:, None]
    xx = torch.arange(w, dtype=data.dtype, device=data.device)[None, :]
    r = torch.sqrt((xx - cx) ** 2 + (yy - cy) ** 2).to(torch.int64)
    r = torch.clamp(r, max=max_radius).reshape(-1)  # overflow bin
    sums = data.new_zeros(n, max_radius + 1).index_add_(
        1, r, data.reshape(n, -1))[:, :max_radius]
    counts = torch.bincount(r, minlength=max_radius + 1)[:max_radius]
    return sums / torch.clamp(counts, min=1).to(data.dtype)


def encircled_energy(profile, radii):
    """Cumulative ring-weighted energy fraction
    (``analyze_psf_mtf.py:251-253``)."""
    ee = np.cumsum(np.asarray(profile) * np.asarray(radii) * 2 * np.pi)
    total = ee[-1] if ee[-1] > 0 else 1.0
    return ee / total


# ---------------------------------------------------------------------------
# MTF (batched on device)
# ---------------------------------------------------------------------------

def _mtf_dev(psf_stack: torch.Tensor, pad: int):
    """Batched |OTF| + radial profile for a stack of PSFs (N, h, w)."""
    n, h, w = psf_stack.shape
    r0, c0 = (pad - h) // 2, (pad - w) // 2
    padded = psf_stack.new_zeros(n, pad, pad)
    padded[:, r0:r0 + h, c0:c0 + w] = psf_stack
    s = padded.sum(dim=(1, 2), keepdim=True)
    padded = torch.where(s > 0, padded / s, padded)
    otf = torch.fft.fftshift(torch.fft.fft2(
        torch.fft.ifftshift(padded, dim=(1, 2))), dim=(1, 2))
    mtf2d = otf.abs()
    mx = mtf2d.amax(dim=(1, 2), keepdim=True)
    mtf2d = torch.where(mx > 0, mtf2d / mx, mtf2d)
    prof = _radial_average_dev(mtf2d, pad / 2.0, pad / 2.0, pad // 2)
    return mtf2d, prof


def compute_mtf(psf, pixel_pitch_um: Optional[float] = None, device="cuda"):
    """MTF from a PSF via zero-padded FFT + radial average
    (``psf_mtf_utils.py:129-163``), on ``device``.

    Returns (freq, mtf_radial, mtf_2d, freq_label, nyquist).  Accepts a
    single (h, w) PSF or a batched (N, h, w) stack (batched outputs).
    """
    psf = np.asarray(psf, dtype=np.float64)
    single = psf.ndim == 2
    stack = psf[None] if single else psf
    pad = max(256, stack.shape[1], stack.shape[2])
    mtf2d, prof = _mtf_dev(torch.as_tensor(stack, device=device), pad)
    mtf2d, prof = mtf2d.cpu().numpy(), prof.cpu().numpy()
    freq_cpp = np.arange(pad // 2, dtype=np.float64) / pad
    if pixel_pitch_um is not None:
        freq = freq_cpp / (pixel_pitch_um * 1e-3)
        label, nyquist = "cycles/mm", 1.0 / (2.0 * pixel_pitch_um * 1e-3)
    else:
        freq, label, nyquist = freq_cpp, "cycles/pixel", 0.5
    if single:
        return freq, prof[0], mtf2d[0], label, nyquist
    return freq, prof, mtf2d, label, nyquist


def mtf_at_fraction(freq, mtf, fraction: float = 0.5) -> float:
    """First linear-interpolated crossing below ``fraction``
    (``psf_mtf_utils.py:166-179``)."""
    freq = np.asarray(freq)
    mtf = np.asarray(mtf)
    above = mtf >= fraction
    if not above.any() or above.all():
        return float("nan")
    idx = np.where(np.diff(above.astype(int)) == -1)[0]
    if len(idx) == 0:
        return float("nan")
    i = idx[0]
    f0, f1, m0, m1 = freq[i], freq[i + 1], mtf[i], mtf[i + 1]
    if abs(m1 - m0) < 1e-12:
        return float(f0)
    return float(f0 + (fraction - m0) * (f1 - f0) / (m1 - m0))


# ---------------------------------------------------------------------------
# batched 2-D Gaussian fit (Levenberg-Marquardt on the device)
# ---------------------------------------------------------------------------

def gauss2d_model(params, xx, yy):
    """Rotated 2-D Gaussian, parameterization per ``psf_mtf_utils.py:99-106``:
    params = (amp, x0, y0, sigma_x, sigma_y, theta, offset), a (7,)
    tensor."""
    amp, x0, y0, sx, sy, th, off = params.unbind(0)
    a = torch.cos(th) ** 2 / (2 * sx ** 2) + torch.sin(th) ** 2 / (2 * sy ** 2)
    b = -torch.sin(2 * th) / (4 * sx ** 2) + torch.sin(2 * th) / (4 * sy ** 2)
    c = torch.sin(th) ** 2 / (2 * sx ** 2) + torch.cos(th) ** 2 / (2 * sy ** 2)
    dx, dy = xx - x0, yy - y0
    return off + amp * torch.exp(-(a * dx * dx + 2 * b * dx * dy
                                   + c * dy * dy))


def _lm_fit_batch(psfs: torch.Tensor, p0s: torch.Tensor,
                  n_iter: int = LM_ITERATIONS) -> torch.Tensor:
    """Levenberg-Marquardt on the 7-param Gaussian for every PSF of a
    (N, h, w) stack at once, from (N, 7) starts; a fixed iteration count
    (no data-dependent exit), each iteration one batched step: residuals
    and their Jacobian (forward-mode ``jacfwd`` under ``vmap``, as the
    reference's ``jax.jacfwd`` under ``jax.vmap``: the same derivative
    arithmetic, which keeps the ill-conditioned directions of a round spot
    (theta, the offset) on the reference's path), the damped normal
    equations ``JᵀJ + λ·diag(JᵀJ) + 1e-12·I`` solved as one batched 7x7
    system, the step kept where it lowers the squared error, λ halved
    there and x4 elsewhere."""
    from torch.func import jacfwd, vmap

    n, h, w = psfs.shape
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=psfs.dtype, device=psfs.device),
        torch.arange(w, dtype=psfs.dtype, device=psfs.device), indexing="ij")
    targets = psfs.reshape(n, -1)

    def residual(p, target):
        return gauss2d_model(p, xx, yy).reshape(-1) - target

    residuals = vmap(residual)
    jacobians = vmap(jacfwd(residual))
    eye = torch.eye(N_PARAMS, dtype=psfs.dtype, device=psfs.device)
    p = p0s
    lam = psfs.new_full((n,), 1e-2)
    for _ in range(n_iter):
        r = residuals(p, targets)
        jac = jacobians(p, targets)  # (N, npix, 7)
        jt = jac.transpose(1, 2)
        jtj = jt @ jac
        jtr = (jt @ r[:, :, None])[:, :, 0]
        damp = lam[:, None, None] * torch.diag_embed(
            torch.diagonal(jtj, dim1=1, dim2=2))
        step = torch.linalg.solve_ex(jtj + damp + 1e-12 * eye, jtr)[0]
        p_new = p - step
        better = ((residuals(p_new, targets) ** 2).sum(dim=1)
                  < (r ** 2).sum(dim=1))
        p = torch.where(better[:, None], p_new, p)
        lam = torch.where(better, lam * 0.5, lam * 4.0)
    return p


def fit_gaussian_psf(psf, device="cuda"):
    """Fit one PSF; returns (params, fit_image) like the reference
    (``psf_mtf_utils.py:109-126``), or (None, None) on failure."""
    params = fit_gaussian_psf_batch(np.asarray(psf)[None], device)[0]
    if not np.all(np.isfinite(params)):
        return None, None
    h, w = psf.shape
    yy, xx = np.mgrid[:h, :w]

    def dev(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    fit = gauss2d_model(dev(params), dev(xx), dev(yy)).cpu().numpy()
    return params, fit


def fit_gaussian_psf_batch(psfs, device="cuda") -> np.ndarray:
    """Batched Gaussian fit: (N, h, w) -> (N, 7) params.

    All N fits run as one batched LM solve on ``device``.  sigma_x/sigma_y
    are returned as absolute values (the model is even in their sign).
    """
    psfs = np.asarray(psfs, dtype=np.float64)
    n = psfs.shape[0]
    p0s = np.zeros((n, 7))
    for i, p in enumerate(psfs):
        cy, cx = subpixel_centre(p)
        p0s[i] = [p.max(), cx, cy, 2.0, 2.0, 0.0, 0.0]
    params = _lm_fit_batch(torch.as_tensor(psfs, device=device),
                           torch.as_tensor(p0s, device=device)).cpu().numpy()
    params[:, 3] = np.abs(params[:, 3])
    params[:, 4] = np.abs(params[:, 4])
    # Canonicalize the (sx, sy, theta) <-> (sy, sx, theta +/- pi/2)
    # degeneracy: fold theta into [-pi/4, pi/4), swapping sigmas per fold.
    # (scipy curve_fit leaves the labeling arbitrary; see the reference npz
    # where pos4 sx/sy appear swapped between runs.)
    th = np.mod(params[:, 5] + np.pi / 4, np.pi) - np.pi / 4
    swap = th >= np.pi / 4
    th = np.where(swap, th - np.pi / 2, th)
    sx = np.where(swap, params[:, 4], params[:, 3])
    sy = np.where(swap, params[:, 3], params[:, 4])
    params[:, 3], params[:, 4], params[:, 5] = sx, sy, th
    return params
