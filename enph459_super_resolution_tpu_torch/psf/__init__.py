"""PSF/MTF characterization toolkit: analytic Gaussian and measured PSF
kernels, peak finding, radial profiles, the batched MTF and the batched
Gaussian fit (the exports of ``enph459_super_resolution_tpu/psf``)."""

from .kernels import load_measured_psf, make_gaussian_psf
from .toolkit import (
    compute_mtf,
    encircled_energy,
    extract_psf,
    find_peak,
    fit_gaussian_psf,
    fit_gaussian_psf_batch,
    gauss2d_model,
    mtf_at_fraction,
    radial_average,
    subpixel_centre,
)

__all__ = [
    "load_measured_psf", "make_gaussian_psf", "compute_mtf",
    "encircled_energy", "extract_psf", "find_peak", "fit_gaussian_psf",
    "fit_gaussian_psf_batch", "gauss2d_model", "mtf_at_fraction",
    "radial_average", "subpixel_centre",
]
