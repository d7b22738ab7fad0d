"""Hermetic pure-Python Code 128 decoder (host-side eval metric).

The reference scores SR quality by zxing-cpp decode confidence on its real
barcode sheets (``rgb_barcodes/analysis.ipynb`` cell 8); the ``zxingcpp``
wheel is an optional dependency that is absent in this environment, and
run-length analysis of the checked-in sheets shows they are Code 128
symbols (four element-width classes, 6-runs-per-symbol structure — EAN-13
would be exactly 59 runs).  This module decodes that symbology from
scratch so the full capture -> SR -> decode-confidence protocol runs
hermetically, like ``eval.ean13`` does for EAN-13.

Decoder design (scanline, the classic 1-D approach):
  * scan several rows of the crop; per row: contrast-gated midpoint
    binarization -> run-length encoding;
  * locate a start symbol (A/B/C) at any bar-aligned offset;
  * per symbol, fit-and-remove a per-window ink-spread bias (bars
    uniformly wider by d px, spaces narrower by d — the real sheets
    measure |d| ~ 2 px) and L1-score the de-biased widths against every
    table pattern.  Bias-corrected matching is unambiguous by the
    symbology's design: two patterns indistinguishable under unknown d
    would differ by a uniform +/-a on bars and -/+a on spaces, which for
    odd a flips the (always even) bar-module parity and for a >= 2 needs
    three spaces >= 3 leaving < 1 module/bar — neither exists in the
    table;
  * require the stop pattern and a valid mod-103 checksum, then decode
    code sets A/B/C with SHIFT/CODE switches (FNC symbols skipped).

A checksum-valid read from ANY scanned row wins; disagreeing rows never
merge.  This is deliberately zxing-shaped so confidence numbers are
comparable in kind, though an independent implementation.

The port's copy of ``enph459_super_resolution_tpu/eval/code128.py`` (host
numpy, no device op).  One change of order, none of result: a start
candidate's quiet zone is checked before its window is classified (both
must hold), which skips most classifications of a noisy scanline.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

# value -> 6 element widths (bar, space, ...), 11 modules per symbol.
# 103/104/105 are Start A/B/C; the stop pattern (below) has 7 elements.
_PATTERNS = [
    "212222", "222122", "222221", "121223", "121322", "131222", "122213",
    "122312", "132212", "221213", "221312", "231212", "112232", "122132",
    "122231", "113222", "123122", "123221", "223211", "221132", "221231",
    "213212", "223112", "312131", "311222", "321122", "321221", "312212",
    "322112", "322211", "212123", "212321", "232121", "111323", "131123",
    "131321", "112313", "132113", "132311", "211313", "231113", "231311",
    "112133", "112331", "132131", "113123", "113321", "133121", "313121",
    "211331", "231131", "213113", "213311", "213131", "311123", "311321",
    "331121", "312113", "312311", "332111", "314111", "221411", "431111",
    "111224", "111422", "121124", "121421", "141122", "141221", "112214",
    "112412", "122114", "122411", "142112", "142211", "241211", "221114",
    "413111", "241112", "134111", "111242", "121142", "121241", "114212",
    "124112", "124211", "411212", "421112", "421211", "212141", "214121",
    "412121", "111143", "111341", "131141", "114113", "114311", "411113",
    "411311", "113141", "114131", "311141", "411131",
    "211412", "211214", "211232",  # 103/104/105 = Start A/B/C
]
STOP = "2331112"

CODE_SHIFT = 98
CODE_C, CODE_B, CODE_A = 99, 100, 101
FNC1, FNC2, FNC3 = 102, 97, 96
START_A, START_B, START_C = 103, 104, 105

_PAT_MAT = np.array([[int(c) for c in p] for p in _PATTERNS], float)
_SIGN6 = np.array([1.0, -1.0] * 3)  # bar/space ink-spread sign, 6 runs
_STOP_W = np.array([int(c) for c in STOP], float)
_SIGN7 = np.array([1.0, -1.0, 1.0, -1.0, 1.0, -1.0, 1.0])


def encode_values(text: str) -> List[int]:
    """ASCII text -> symbol values incl. start code and mod-103 checksum
    (no stop — that is a pattern, not a value).  Code set B by default,
    switching to C for even digit runs of >= 4 (the density choice any
    standard encoder makes — and what the reference's real sheets use for
    their numeric payload segments)."""
    values: List[int] = []
    mode: Optional[str] = None
    i, n = 0, len(text)
    while i < n:
        run = 0
        while i + run < n and text[i + run].isdigit():
            run += 1
        if run >= 4:
            use = run - (run % 2)
            if mode is None:
                values.append(START_C)
            elif mode != "C":
                values.append(CODE_C)
            mode = "C"
            values.extend(int(text[j:j + 2]) for j in range(i, i + use, 2))
            i += use
        else:
            if mode is None:
                values.append(START_B)
            elif mode != "B":
                values.append(CODE_B)
            mode = "B"
            c = ord(text[i])
            if not 32 <= c < 127:
                raise ValueError(f"not encodable in code set B: {text[i]!r}")
            values.append(c - 32)
            i += 1
    if not values:
        raise ValueError("empty payload")
    check = (values[0] + sum(k * v for k, v
                             in enumerate(values[1:], 1))) % 103
    return values + [check]


def render(text: str, module_px: int = 3, height: int = 40,
           quiet_modules: int = 10, ink_spread_px: int = 0) -> np.ndarray:
    """Render ``text`` to a grayscale Code 128 image (0 = bar, 255 =
    space), ``module_px`` px/module with ``quiet_modules`` of quiet zone
    each side.  ``ink_spread_px`` widens every bar by that many px per
    side at the spaces' expense (the real sheets' dot-gain distortion the
    decoder's bias fit removes) — must leave every space >= 1 px."""
    widths: List[int] = []
    for v in encode_values(text):
        widths.extend(int(c) for c in _PATTERNS[v])
    widths.extend(int(c) for c in STOP)
    row = np.full((sum(widths) + 2 * quiet_modules) * module_px, 255.0)
    x = quiet_modules * module_px
    for k, w in enumerate(widths):
        if k % 2 == 0:  # bar
            a = x - ink_spread_px
            b = (x + w * module_px) + ink_spread_px
            if k + 1 < len(widths) and widths[k + 1] * module_px \
                    <= 2 * ink_spread_px:
                raise ValueError("ink spread erases a space")
            row[max(a, 0):b] = 0.0
        x += w * module_px
    return np.tile(row, (height, 1))


def _symbol_value(widths, max_resid: float = 1.6) -> Optional[int]:
    """Classify one 6-run symbol window (pixel widths) to a table value.

    The 6-run total is 11 modules regardless of ink spread (3 bars at
    +d cancel 3 spaces at -d), so module = total/11 is bias-free.  For
    each candidate pattern the best per-window bias is the signed mean
    residual; the L1 score after removing it is spread-invariant.
    """
    w = np.asarray(widths, float)
    total = w.sum()
    if total <= 0:
        return None
    nw = w * (11.0 / total)
    d = nw - _PAT_MAT                       # (107, 6)
    delta = (d * _SIGN6).mean(axis=1)       # fitted bias per pattern
    resid = np.abs(d - delta[:, None] * _SIGN6).sum(axis=1)
    best = int(resid.argmin())
    return best if resid[best] < max_resid else None


def _is_stop(widths, max_resid: float = 1.8) -> bool:
    """Stop-pattern test, joint (module, bias) least squares.

    The stop has 4 bars vs 3 spaces, so its 7-run total is NOT
    bias-invariant — fit widths = module * pattern + sign * bias by LS,
    then L1-score the de-biased residual in module units.
    """
    w = np.asarray(widths, float)
    if w.sum() <= 0 or len(w) != 7:
        return False
    a = float(_STOP_W @ _STOP_W)
    b = float(_STOP_W @ _SIGN7)
    c = float(_SIGN7 @ _SIGN7)  # = 7
    det = a * c - b * b
    m = (c * float(_STOP_W @ w) - b * float(_SIGN7 @ w)) / det
    if m <= 0:
        return False
    delta = (a * float(_SIGN7 @ w) - b * float(_STOP_W @ w)) / det
    resid = np.abs(w - m * _STOP_W - delta * _SIGN7).sum() / m
    return bool(resid < max_resid)


def _values_to_text(values: List[int]) -> Optional[str]:
    """Code-set state machine (A/B/C, SHIFT, CODE switches, FNC skipped)."""
    start = values[0]
    if start not in (START_A, START_B, START_C):
        return None
    code_set = {START_A: "A", START_B: "B", START_C: "C"}[start]
    out: List[str] = []
    shift: Optional[str] = None
    for v in values[1:]:
        cs = shift or code_set
        shift = None
        if cs == "C":
            if v < 100:
                out.append(f"{v:02d}")
            elif v == CODE_B:
                code_set = "B"
            elif v == CODE_A:
                code_set = "A"
            elif v == FNC1:
                pass
            else:
                return None
        else:  # A or B
            if v < 64 or (cs == "B" and v < 96):
                out.append(chr(v + 32))
            elif cs == "A" and v < 96:
                out.append(chr(v - 64))  # control characters
            elif v == CODE_C:
                code_set = "C"
            elif v == CODE_B:
                code_set = "B"
            elif v == CODE_A:
                code_set = "A"
            elif v == CODE_SHIFT:
                shift = "A" if cs == "B" else "B"
            elif v in (FNC1, FNC2, FNC3):
                pass
            else:
                return None
    return "".join(out)


def _decode_runs(widths: List[int], kinds: List[int]) -> Optional[str]:
    """Decode one run-length-encoded scanline (any alignment)."""
    n = len(widths)
    for i in range(0, n - 25, 1):
        if kinds[i] != 1:  # symbols start on a bar
            continue
        module = sum(widths[i:i + 6]) / 11.0
        # quiet zone: >= 5 modules of space before the start.  A scanline
        # that begins exactly on a bar (i == 0) carries ZERO quiet-zone
        # evidence — treat it as a zero-width margin and reject, matching
        # the zxing semantics the confidence protocol claims comparability
        # to (a crop must include its quiet zone to decode).
        if i == 0 or widths[i - 1] < 5 * module:
            continue
        v = _symbol_value(widths[i:i + 6])
        if v not in (START_A, START_B, START_C):
            continue
        values = [v]
        j = i + 6
        while j + 7 <= n:
            if _is_stop(widths[j:j + 7]):
                if len(values) < 3:
                    break
                check = values[-1]
                total = values[0] + sum(k * val for k, val
                                        in enumerate(values[1:-1], 1))
                if total % 103 != check:
                    break
                return _values_to_text(values[:-1])
            v = _symbol_value(widths[j:j + 6])
            if v is None:
                break
            values.append(v)
            j += 6
    return None


def _runs(row: np.ndarray, thr: float) -> Tuple[List[int], List[int]]:
    bits = (row < thr).astype(np.int8)  # 1 = bar (dark)
    change = np.flatnonzero(np.diff(bits)) + 1
    edges = np.concatenate([[0], change, [len(bits)]])
    widths = np.diff(edges).tolist()
    kinds = bits[edges[:-1]].tolist()
    return widths, kinds


def decode(img: np.ndarray, n_rows: int = 16) -> Optional[str]:
    """Decode a grayscale crop; returns the text or None.

    Scans band-averaged column profiles first (the bars are vertical, so
    averaging rows trades no information for a large SNR gain on noisy
    SR output — quarter-height bands keep sub-degree skew below a pixel
    of smear), then ``n_rows`` evenly spaced single rows (middle
    outward).  The first checksum-valid read wins — the zxing-style
    any-scanline contract the confidence protocol counts.
    """
    img = np.asarray(img, dtype=np.float64)
    if img.ndim == 3:
        img = img.mean(-1)
    if img.ndim != 2 or img.size == 0:
        return None
    h = img.shape[0]
    scans = []
    if h >= 8:
        q = h // 4
        scans += [img[(h - q) // 2:(h + q) // 2].mean(axis=0),
                  img[:q].mean(axis=0), img[-q:].mean(axis=0),
                  img.mean(axis=0)]
    order = np.argsort(np.abs(np.arange(h) - h / 2))
    rows = order[np.linspace(0, len(order) - 1,
                             min(n_rows, h)).astype(int)]
    scans += [img[r] for r in rows]
    for row in scans:
        lo, hi = np.percentile(row, [5, 95])
        if hi - lo < 24:  # contrast gate
            continue
        for q_thr in (0.5, 0.4, 0.6):
            widths, kinds = _runs(row, lo + q_thr * (hi - lo))
            text = _decode_runs(widths, kinds)
            if text is None:  # both scan directions, like any 1-D reader
                text = _decode_runs(widths[::-1], kinds[::-1])
            if text:
                return text
    return None
