"""Image quality metrics (PSNR, SSIM, local contrast, Y channel,
log-spectral distance)."""
