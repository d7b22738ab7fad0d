"""PSF kernel construction: analytic Gaussian and measured-from-calibration.

Counterpart of ``enph459_super_resolution_tpu/psf/kernels.py``; reference:
``mono_barcodes/run_sr.py:135-183``.
"""

from __future__ import annotations

import os

import numpy as np

from ..data.io import load_gray
from ..sr.classical import PSF_HALFWIDTH, make_gaussian_psf  # re-export

__all__ = ["make_gaussian_psf", "load_measured_psf"]


def load_measured_psf(psf_dir: str, halfwidth: int = PSF_HALFWIDTH,
                      margin_extra: int = 6, verbose: bool = True) -> np.ndarray:
    """Average peak-aligned ``pos4_(0,0).png`` pinhole patches from beam-shift
    calibration sweep directories into a normalized PSF kernel.

    Behavior per ``mono_barcodes/run_sr.py:145-183``: peak-align on argmax,
    skip patches whose peak is within the crop margin of an edge, average,
    subtract the mean of the four 3x3 corner regions as background, clip to
    >= 0, normalize to unit sum, crop to ``(2*halfwidth+1)`` square.
    """
    margin = halfwidth + margin_extra
    patches = []
    for sweep in sorted(os.listdir(psf_dir)):
        full = os.path.join(psf_dir, sweep)
        if not os.path.isdir(full):
            continue
        path = os.path.join(full, "pos4_(0,0).png")
        if not os.path.exists(path):
            continue
        img = load_gray(path, dtype=np.float64)
        pr, pc = np.unravel_index(int(img.argmax()), img.shape)
        if (pr < margin or pr + margin + 1 > img.shape[0]
                or pc < margin or pc + margin + 1 > img.shape[1]):
            if verbose:
                print(f"  PSF skip (peak too close to edge): {path}")
            continue
        patches.append(img[pr - margin:pr + margin + 1,
                           pc - margin:pc + margin + 1])
    if not patches:
        raise FileNotFoundError(f"no pos4_(0,0).png found under {psf_dir}")

    avg = np.mean(patches, axis=0)
    kernel = avg[margin - halfwidth:margin + halfwidth + 1,
                 margin - halfwidth:margin + halfwidth + 1].copy()
    corners = np.concatenate([
        kernel[:3, :3].ravel(), kernel[:3, -3:].ravel(),
        kernel[-3:, :3].ravel(), kernel[-3:, -3:].ravel(),
    ])
    kernel -= corners.mean()
    kernel = np.clip(kernel, 0.0, None)
    kernel /= kernel.sum()
    if verbose:
        print(f"  PSF: averaged {len(patches)} pos4 patches -> {kernel.shape}")
    return kernel
