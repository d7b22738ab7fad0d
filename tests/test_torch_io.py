"""The port's stdlib-zlib PNG codec (used where PIL does not import):
round trips, and decoding of every scanline filter type identically to
PIL."""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from enph459_super_resolution_tpu_torch.data import io as tio


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filtered_png(img: np.ndarray, kinds) -> bytes:
    """A PNG of ``img`` whose row y uses filter ``kinds[y % len(kinds)]``
    (a forward filter written out byte by byte, independent of the codec
    under test)."""
    h = img.shape[0]
    ch = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, -1).astype(int)
    raw = bytearray()
    for y in range(h):
        kind = kinds[y % len(kinds)]
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        raw.append(kind)
        for i in range(len(cur)):
            a = cur[i - ch] if i >= ch else 0
            c = up[i - ch] if i >= ch else 0
            pred = [0, a, up[i], (a + up[i]) // 2, _paeth(a, up[i], c)][kind]
            raw.append((cur[i] - pred) % 256)

    def chunk(t, body):
        return (struct.pack(">I", len(body)) + t + body
                + struct.pack(">I", zlib.crc32(t + body) & 0xFFFFFFFF))

    color = 0 if ch == 1 else 2
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", img.shape[1], h, 8,
                                         color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


def _image(shape, seed):
    rng = np.random.default_rng(seed)
    smooth = np.cumsum(rng.integers(-9, 10, shape), axis=1) % 256
    return smooth.astype(np.uint8)


@pytest.mark.parametrize("shape", [(13, 17), (9, 11, 3)])
def test_encode_decode_round_trip(shape, tmp_path):
    img = _image(shape, 1)
    data = tio.encode_png(img)
    np.testing.assert_array_equal(tio.decode_png(data), img)
    path = tmp_path / "x.png"
    path.write_bytes(data)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


@pytest.mark.parametrize("kinds", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4]])
@pytest.mark.parametrize("shape", [(12, 15), (7, 10, 3)])
def test_decodes_every_filter_type_like_pil(kinds, shape, tmp_path):
    img = _image(shape, 2)
    path = tmp_path / "f.png"
    path.write_bytes(_filtered_png(img, kinds))
    want = np.asarray(Image.open(path))
    np.testing.assert_array_equal(want, img)  # the file itself is valid
    np.testing.assert_array_equal(tio.decode_png(path.read_bytes()), want)


@pytest.mark.parametrize("shape", [(40, 57), (31, 23, 3)])
def test_decodes_pil_written_files(shape, tmp_path):
    img = _image(shape, 3)
    path = tmp_path / "pil.png"
    Image.fromarray(img).save(path)
    np.testing.assert_array_equal(tio.decode_png(path.read_bytes()),
                                  np.asarray(Image.open(path)))


def test_io_without_pil_uses_the_zlib_codec(tmp_path, monkeypatch):
    # neither PIL nor the native libpng codec (which comes first where it
    # builds): the stdlib-zlib codec reads and writes
    monkeypatch.setattr(tio, "_pil", lambda: None)
    monkeypatch.setattr(tio.png_loader, "load", lambda path: None)
    monkeypatch.setattr(tio.png_loader, "save", lambda *a, **k: False)
    gray, rgb = _image((20, 30), 4), _image((8, 6, 3), 5)
    tio.save_png(gray, str(tmp_path / "g.png"))
    tio.save_png(rgb.astype(np.float32) + 0.7, str(tmp_path / "c.png"))
    np.testing.assert_array_equal(tio.load_image(str(tmp_path / "g.png")),
                                  gray.astype(np.float32))
    np.testing.assert_array_equal(tio.load_gray(str(tmp_path / "c.png")),
                                  rgb.astype(np.float64).mean(axis=2)
                                  .astype(np.float32))
    with pytest.raises(ValueError):
        tio.decode_png(b"GIF89a")
