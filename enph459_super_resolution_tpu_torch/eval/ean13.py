"""Self-contained EAN-13 barcode encoder/decoder.

The reference's end metric is zxing-cpp decode confidence
(``rgb_barcodes/analysis.ipynb`` cell 8), but zxing is an optional native
wheel that is absent in many environments (including this CI).  This module
provides a dependency-free 1-D symbology so the decode-confidence harness
(``eval.decode``) and the simulator can exercise the *complete* reference
story — synthesize a barcode scene, capture shifted LR frames, super-
resolve, decode — hermetically.  For production decoding of arbitrary
symbologies, install zxing-cpp (``eval.decode`` uses it when present).

The port's copy of ``enph459_super_resolution_tpu/eval/ean13.py`` (host
numpy, no device op).

EAN-13 structure: start guard 101, six left digits encoded in L/G parity
(the parity pattern encodes the 13th/leading digit), middle guard 01010,
six right digits in R parity, end guard 101; 95 modules total; mod-10
checksum on the final digit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# L-code element widths are derivable from these 7-bit patterns.
_L_CODES = ["0001101", "0011001", "0010011", "0111101", "0100011",
            "0110001", "0101111", "0111011", "0110111", "0001011"]
_R_CODES = ["".join("1" if c == "0" else "0" for c in p) for p in _L_CODES]
_G_CODES = [p[::-1] for p in _R_CODES]
# First (implicit) digit -> parity pattern of the six left digits.
_PARITY = ["LLLLLL", "LLGLGG", "LLGGLG", "LLGGGL", "LGLLGG",
           "LGGLLG", "LGGGLL", "LGLGLG", "LGLGGL", "LGGLGL"]


def checksum(digits12: str) -> int:
    """EAN-13 check digit for the first 12 digits."""
    s = sum(int(d) * (3 if i % 2 else 1) for i, d in enumerate(digits12))
    return (10 - s % 10) % 10


def encode_bits(digits: str) -> np.ndarray:
    """13-digit string -> 95-module bit array (1 = bar/dark)."""
    if len(digits) == 12:
        digits = digits + str(checksum(digits))
    if len(digits) != 13 or not digits.isdigit():
        raise ValueError("EAN-13 needs 12 or 13 digits")
    if int(digits[12]) != checksum(digits[:12]):
        raise ValueError("bad EAN-13 check digit")
    parity = _PARITY[int(digits[0])]
    bits = "101"
    for p, d in zip(parity, digits[1:7]):
        bits += (_L_CODES if p == "L" else _G_CODES)[int(d)]
    bits += "01010"
    for d in digits[7:13]:
        bits += _R_CODES[int(d)]
    bits += "101"
    return np.array([int(b) for b in bits], dtype=np.uint8)


def render(digits: str, module_px: int = 3, height_px: int = 60,
           quiet_modules: int = 9, dark: float = 20.0,
           light: float = 235.0) -> np.ndarray:
    """Rasterize an EAN-13 barcode to a grayscale image (0..255 floats)."""
    bits = encode_bits(digits)
    row = np.full((len(bits) + 2 * quiet_modules,), light)
    row[quiet_modules:quiet_modules + len(bits)] = np.where(bits, dark, light)
    row = np.repeat(row, module_px)
    return np.broadcast_to(row, (height_px, len(row))).copy()


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

def _digit_tables():
    def widths(pattern):
        runs, last, n = [], pattern[0], 1
        for c in pattern[1:]:
            if c == last:
                n += 1
            else:
                runs.append(n)
                last, n = c, 1
        runs.append(n)
        return tuple(runs)

    tables = {}
    for name, codes in [("L", _L_CODES), ("G", _G_CODES), ("R", _R_CODES)]:
        tables[name] = {widths(p): i for i, p in enumerate(codes)}
    return tables


_TABLES = _digit_tables()


def _match_digit(widths4, tables=("L", "G")) -> Optional[tuple]:
    """Match 4 element widths (in modules) against the digit tables,
    choosing the nearest integer-width pattern within tolerance."""
    total = sum(widths4)
    if total <= 0:
        return None
    scaled = [w * 7.0 / total for w in widths4]
    best = None
    for name in tables:
        for pat, digit in _TABLES[name].items():
            err = sum(abs(s - p) for s, p in zip(scaled, pat))
            if best is None or err < best[0]:
                best = (err, name, digit)
    if best is None or best[0] > 1.4:  # > ~0.35 module/element mean error
        return None
    return best[1], best[2]


def decode_profile(profile: np.ndarray) -> Optional[str]:
    """Decode a 1-D intensity profile (dark bars on light background)."""
    profile = np.asarray(profile, dtype=np.float64)
    lo, hi = profile.min(), profile.max()
    if hi - lo < 20:
        return None
    binary = profile < (lo + hi) / 2.0  # True = bar

    # run-length encode
    changes = np.flatnonzero(np.diff(binary.astype(np.int8))) + 1
    starts = np.concatenate([[0], changes])
    ends = np.concatenate([changes, [len(binary)]])
    runs = [(bool(binary[s]), e - s) for s, e in zip(starts, ends)]

    # candidate starts: any bar run could begin the 1-1-1 start guard;
    # an EAN-13 spans 59 bar/space elements from there
    idx = [i for i, (v, _) in enumerate(runs) if v]
    for s in idx:
        elems = runs[s:]
        if len(elems) < 59:
            continue
        widths = np.array([w for _, w in elems[:59]], dtype=np.float64)
        module = (widths[0] + widths[1] + widths[2]) / 3.0
        if module <= 0:
            continue
        # guard sanity: start 1,1,1; middle at 27..31 = 1,1,1,1,1; end 1,1,1
        def near(i, m=1.0, tol=0.6):
            return abs(widths[i] / module - m) <= tol
        if not (near(0) and near(1) and near(2) and near(56) and near(57)
                and near(58) and all(near(i) for i in range(27, 32))):
            continue
        left = widths[3:27].reshape(6, 4)
        right = widths[32:56].reshape(6, 4)
        parity = ""
        digits = ""
        ok = True
        for w4 in left:
            m = _match_digit(w4 / module, ("L", "G"))
            if m is None:
                ok = False
                break
            parity += m[0]
            digits += str(m[1])
        if not ok:
            continue
        for w4 in right:
            m = _match_digit(w4 / module, ("R",))
            if m is None:
                ok = False
                break
            digits += str(m[1])
        if not ok or parity not in _PARITY:
            continue
        first = str(_PARITY.index(parity))
        full = first + digits
        if int(full[12]) != checksum(full[:12]):
            continue
        return full
    return None


def decode(img: np.ndarray) -> Optional[str]:
    """Decode an EAN-13 from a grayscale image crop.

    Averages rows in horizontal strips (tolerates tilt/noise) and tries a
    few strip heights; also tries the mirrored profile.
    """
    img = np.asarray(img, dtype=np.float64)
    if img.ndim == 3:
        img = img.mean(axis=2)
    h = img.shape[0]
    strips = [slice(0, h), slice(h // 4, max(h // 4 + max(h // 2, 1), 1)),
              slice(h // 3, max(2 * h // 3, h // 3 + 1))]
    for sl in strips:
        prof = img[sl].mean(axis=0)
        for p in (prof, prof[::-1]):
            text = decode_profile(p)
            if text is not None:
                return text
    return None
