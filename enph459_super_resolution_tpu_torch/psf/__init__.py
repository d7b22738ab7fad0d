"""PSF kernels: analytic Gaussian and measured from calibration."""
