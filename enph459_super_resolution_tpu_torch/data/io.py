"""Host-side image IO and channel extraction.

Counterpart of ``enph459_super_resolution_tpu/data/io.py``.  PNGs decode
and encode with the native libpng codec (``native/``, built with ``g++`` at
first use) where it builds: one file, or a batch on its thread pool
(:func:`load_gray_batch`), and artifacts written at zlib level 1 with the
Sub filter.  Without it, PIL; without PIL, the stdlib-``zlib`` + numpy
codec below, which reads and writes 8-bit, non-interlaced gray and RGB
PNGs.  The three give the same pixels (16-bit samples scale to 8 bits
alike only through libpng; the PIL path scales by 255/65535 in float).
Reference behaviors: ``load_gray`` (RGB-mean to gray,
``mono_barcodes/run_sr.py:84-86``) and RGGB red-plane extraction
(``rgb_barcodes/run_sr.py:97-99``).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from ..native import png_loader

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3}  # PNG color type -> samples per pixel (gray, RGB)


def _pil():
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def _unfilter_slow(kind: int, line: np.ndarray, prior: np.ndarray,
                   bpp: int) -> np.ndarray:
    """Average (3) and Paeth (4) scanline filters: each byte depends on the
    reconstructed byte ``bpp`` to its left, so this runs byte by byte."""
    out = bytearray(line.tobytes())
    up = prior.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        if kind == 3:
            pred = (a + b) >> 1
        else:
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), dtype=np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """Decode an 8-bit, non-interlaced gray or RGB PNG to ``uint8[H, W]`` or
    ``uint8[H, W, 3]`` (all five scanline filter types)."""
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(f"unsupported PNG (bit depth {depth}, color type "
                         f"{color}, interlace {interlace}): the zlib codec "
                         "reads 8-bit non-interlaced gray/RGB only")
    ch = _CHANNELS[color]
    stride = width * ch
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8)
    raw = raw[: height * (stride + 1)].reshape(height, stride + 1)
    img = np.empty((height, stride), dtype=np.uint8)
    prior = np.zeros(stride, dtype=np.uint8)
    for y in range(height):
        kind, line = int(raw[y, 0]), raw[y, 1:]
        if kind == 0:
            rec = line
        elif kind == 1:  # Sub: running sum per channel, mod 256
            rec = np.cumsum(line.reshape(width, ch), axis=0,
                            dtype=np.uint8).reshape(stride)
        elif kind == 2:  # Up
            rec = line + prior
        elif kind in (3, 4):
            rec = _unfilter_slow(kind, line, prior, ch)
        else:
            raise ValueError(f"bad PNG filter type {kind} in row {y}")
        img[y] = rec
        prior = img[y]
    return img.reshape(height, width, ch) if ch > 1 else img


def encode_png(img: np.ndarray, level: int = 1) -> bytes:
    """Encode ``uint8[H, W]`` or ``uint8[H, W, 3]`` as a PNG, every scanline
    with the Sub filter (1)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        color, ch = 0, 1
    elif img.ndim == 3 and img.shape[2] == 3:
        color, ch = 2, 3
    else:
        raise ValueError(f"zlib codec writes gray or RGB, got {img.shape}")
    height, width = img.shape[:2]
    px = img.reshape(height, width, ch)
    sub = np.empty_like(px)
    sub[:, :1] = px[:, :1]
    np.subtract(px[:, 1:], px[:, :-1], out=sub[:, 1:])  # wraps mod 256
    raw = np.empty((height, width * ch + 1), dtype=np.uint8)
    raw[:, 0] = 1
    raw[:, 1:] = sub.reshape(height, width * ch)

    def chunk(ctype: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))

    return (_PNG_SIG
            + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, color,
                                         0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + chunk(b"IEND", b""))


def load_image(path: str, dtype=np.float32) -> np.ndarray:
    """Decode an image file to a float array (0..255 scale), preserving
    channels.  The native decode comes first (>8-bit PNGs scaled by
    ``png_set_scale_16``); through PIL, >8-bit sources are scaled by
    255/65535."""
    arr = png_loader.load(path)
    if arr is not None:
        return arr.astype(dtype)
    image = _pil()
    if image is None:
        with open(path, "rb") as fp:
            return decode_png(fp.read()).astype(dtype)
    arr = np.asarray(image.open(path))
    if arr.dtype == np.uint16 or (arr.dtype.kind in "iu"
                                  and arr.dtype.itemsize > 1):
        arr = arr.astype(np.float64) * (255.0 / 65535.0)
    return arr.astype(dtype)


def load_gray(path: str, dtype=np.float32) -> np.ndarray:
    """Float grayscale: RGB images are channel-averaged (reference parity)."""
    img = load_image(path, dtype=np.float64)
    if img.ndim == 3:
        img = img.mean(axis=2)
    return img.astype(dtype)


def load_gray_batch(paths, dtype=np.float32, n_threads: int = 8):
    """:func:`load_gray` over many paths: on the native decoder's pool of
    ``n_threads`` threads when it is available and every path is a
    ``.png`` (a file it cannot decode raises ``FileNotFoundError``), else
    one file after another."""
    paths = list(paths)
    if png_loader.available() and all(p.lower().endswith(".png")
                                      for p in paths):
        out = []
        for p, arr in zip(paths, png_loader.load_batch(paths, n_threads)):
            if arr is None:
                raise FileNotFoundError(f"failed to decode {p}")
            a = arr.astype(np.float64)
            if a.ndim == 3:
                a = a.mean(axis=2)
            out.append(a.astype(dtype))
        return out
    return [load_gray(p, dtype) for p in paths]


def extract_red(img: np.ndarray, row_offset: int = 0, col_offset: int = 0):
    """Red plane of an RGGB Bayer mosaic: even rows / even cols by default."""
    return img[..., row_offset::2, col_offset::2]


def save_png(img: np.ndarray, path: str) -> None:
    """Save a uint8 (or clip-truncated float, reference parity) image: the
    native libpng writer at zlib level 1 where it is available, else PIL's
    encoder, else :func:`encode_png` (the same pixels every way)."""
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if png_loader.save(path, img):
        return
    image = _pil()
    if image is not None:
        image.fromarray(img).save(path)
        return
    with open(path, "wb") as fp:
        fp.write(encode_png(img))
