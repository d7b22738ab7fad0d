"""Evaluation: PSNR/SSIM, slanted-edge MTF, contrast, decode confidence.

The exports of ``enph459_super_resolution_tpu/eval/__init__.py``; the
barcode codecs (``code128``, ``ean13``) and the analysis CLIs
(``barcode_analysis``, ``cal_target_analysis``) are submodules, and
``log_spectral_distance`` is in ``eval.metrics``."""

from . import ean13
from .decode import (
    HAVE_ZXING,
    decode_confidence,
    jitter_offsets,
    jittered_crops,
)
from .metrics import local_contrast, psnr, shave_border, ssim, y_channel
from .slanted_edge import esf_to_mtf, slanted_edge_esf, slanted_edge_mtf

__all__ = [
    "ean13",
    "HAVE_ZXING", "decode_confidence", "jitter_offsets", "jittered_crops",
    "local_contrast", "psnr", "shave_border", "ssim", "y_channel",
    "esf_to_mtf", "slanted_edge_esf", "slanted_edge_mtf",
]
