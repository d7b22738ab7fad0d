"""ctypes binding for the native libpng codec (``native/png_loader.cpp``).

The port's counterpart of ``enph459_super_resolution_tpu/native/
png_loader.py``, with its return conventions: :func:`load` and
:func:`load_batch` give ``None`` and :func:`save` ``False`` when the
library is unavailable, and the caller falls back (``data.io``: PIL, then
the stdlib-zlib codec).  The library builds at first use
(:func:`.build.build`); where ``g++`` or libpng's headers are missing,
:func:`available` is ``False`` and :func:`build_error` keeps the reason.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

_LOCK = threading.Lock()
_LIB = None
_TRIED = False
_ERROR: Optional[str] = None

_U8P = ctypes.POINTER(ctypes.c_uint8)
_INTP = ctypes.POINTER(ctypes.c_int)


def reset() -> None:
    """Forget the last probe, so the next call loads (or builds) anew."""
    global _LIB, _TRIED, _ERROR
    with _LOCK:
        _LIB, _TRIED, _ERROR = None, False, None


def _load_lib():
    global _LIB, _TRIED, _ERROR
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        from .build import build

        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError) as exc:
            _ERROR = str(exc)
            return None
        lib.srpng_load.restype = ctypes.c_int
        lib.srpng_load.argtypes = [ctypes.c_char_p, _INTP, _INTP, _INTP,
                                   ctypes.POINTER(_U8P)]
        lib.srpng_free.restype = None
        lib.srpng_free.argtypes = [_U8P]
        lib.srpng_load_batch.restype = ctypes.c_int
        lib.srpng_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            _INTP, _INTP, _INTP, ctypes.POINTER(_U8P)]
        lib.srpng_write.restype = ctypes.c_int
        lib.srpng_write.argtypes = [ctypes.c_char_p, _U8P, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int]
        _LIB = lib
        return _LIB


def available() -> bool:
    """Whether the library is built and loaded (building it if needed)."""
    return _load_lib() is not None


def build_error() -> Optional[str]:
    """Why the library is unavailable (the compiler's or the loader's
    message), or ``None``."""
    _load_lib()
    return _ERROR


def _take(lib, buf, h: int, w: int, c: int) -> np.ndarray:
    """Copy a library buffer into numpy (``(H, W)`` for one channel) and
    free it."""
    try:
        arr = np.ctypeslib.as_array(buf, shape=(h * w * c,)).copy()
    finally:
        lib.srpng_free(buf)
    arr = arr.reshape(h, w, c)
    return arr[:, :, 0] if c == 1 else arr


def load(path: str) -> Optional[np.ndarray]:
    """Decode a PNG via libpng: ``uint8 (H, W[, C])`` (16-bit samples scaled
    to 8 bits by ``png_set_scale_16``), or ``None`` when unavailable, not a
    ``.png`` path, or not decodable."""
    lib = _load_lib()
    if lib is None or not path.lower().endswith(".png"):
        return None
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    buf = _U8P()
    rc = lib.srpng_load(path.encode(), ctypes.byref(h), ctypes.byref(w),
                        ctypes.byref(c), ctypes.byref(buf))
    if rc != 0:
        return None
    return _take(lib, buf, h.value, w.value, c.value)


def load_batch(paths, n_threads: int = 8):
    """Decode many PNGs on the library's pool of ``n_threads`` threads.

    Returns a list of uint8 arrays in the order of ``paths`` (``None`` for
    each failure), or ``None`` when the library is unavailable.
    """
    lib = _load_lib()
    if lib is None:
        return None
    n = len(paths)
    if n == 0:
        return []
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    hs, ws, cs = ((ctypes.c_int * n)() for _ in range(3))
    bufs = (_U8P * n)()
    lib.srpng_load_batch(c_paths, n, int(n_threads), hs, ws, cs, bufs)
    return [_take(lib, bufs[i], hs[i], ws[i], cs[i]) if bufs[i] else None
            for i in range(n)]


def save(path: str, img: np.ndarray, compress_level: int = 1) -> bool:
    """Encode a uint8 ``(H, W[, C])`` array via libpng at zlib level
    ``compress_level`` with the Sub filter.  Returns ``False`` (the caller
    falls back) when the library is unavailable or the shape is none of
    gray, gray+alpha, RGB and RGBA, or when the write fails."""
    lib = _load_lib()
    if lib is None:
        return False
    arr = np.ascontiguousarray(img, dtype=np.uint8)
    if arr.ndim == 2:
        (h, w), c = arr.shape, 1
    elif arr.ndim == 3 and arr.shape[-1] in (1, 2, 3, 4):
        h, w, c = arr.shape
    else:
        return False
    rc = lib.srpng_write(path.encode(), arr.ctypes.data_as(_U8P), int(h),
                         int(w), int(c), int(compress_level))
    return rc == 0
