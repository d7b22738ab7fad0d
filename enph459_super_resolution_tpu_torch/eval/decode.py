"""Barcode decode-confidence harness (``rgb_barcodes/analysis.ipynb`` cell 8).

Protocol: decode the centre ROI for the text, then decode ``n_trials``
crops jittered by up to ``max_jitter`` px (seeded RNG); confidence is the
success fraction.  zxing-cpp is a host-side C++ decoder and stays an
optional dependency (SURVEY.md §2.9); the jittered-crop batch generation is
importable separately.

The port's copy of ``enph459_super_resolution_tpu/eval/decode.py`` (host
numpy, no device op): the same seeded jitter protocol, so confidences are
the reference's to the bit.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

try:
    import zxingcpp  # type: ignore

    HAVE_ZXING = True
except ImportError:  # gated: not in this environment's image
    zxingcpp = None
    HAVE_ZXING = False

N_TRIALS = 25
MAX_JITTER = 2
DEFAULT_SEED = 42


def jitter_offsets(n_trials: int = N_TRIALS, max_jitter: int = MAX_JITTER,
                   seed: int = DEFAULT_SEED) -> np.ndarray:
    """(n_trials, 2) integer (dr, dc) offsets, reference RNG protocol
    (``default_rng(42)``, inclusive +/-max_jitter)."""
    rng = np.random.default_rng(seed)
    return rng.integers(-max_jitter, max_jitter + 1, size=(n_trials, 2))


def jittered_crops(img: np.ndarray, roi: Tuple[int, int, int, int],
                   offsets: np.ndarray) -> List[np.ndarray]:
    """Crops at each jitter offset, clamped to the image bounds."""
    r0, r1, c0, c1 = roi
    h, w = img.shape[:2]
    crops = []
    for dr, dc in offsets:
        rr0, rr1 = max(0, r0 + int(dr)), min(h, r1 + int(dr))
        rc0, rc1 = max(0, c0 + int(dc)), min(w, c1 + int(dc))
        crops.append(img[rr0:rr1, rc0:rc1])
    return crops


def decode(img: np.ndarray) -> Optional[str]:
    """Decode one grayscale uint8 image; returns the text or None."""
    if not HAVE_ZXING:
        raise ImportError(
            "zxing-cpp is not installed; decode confidence requires the "
            "optional 'zxingcpp' wheel (host-side eval dependency)")
    res = zxingcpp.read_barcodes(np.ascontiguousarray(img))
    return res[0].text if res else None


def decode_confidence(img: np.ndarray, roi: Tuple[int, int, int, int],
                      n_trials: int = N_TRIALS, max_jitter: int = MAX_JITTER,
                      seed: int = DEFAULT_SEED,
                      decoder=None) -> Tuple[Optional[str], float]:
    """(decoded text at centre ROI, jittered decode success fraction).

    ``decoder`` overrides the zxing decode fn (img -> text|None), which also
    makes the harness testable without the native wheel.
    """
    dec = decoder if decoder is not None else decode
    r0, r1, c0, c1 = roi
    text = dec(img[r0:r1, c0:c1])
    successes = 0
    for crop in jittered_crops(img, roi, jitter_offsets(n_trials, max_jitter,
                                                        seed)):
        if crop.size > 0 and dec(crop) is not None:
            successes += 1
    return text, successes / n_trials
