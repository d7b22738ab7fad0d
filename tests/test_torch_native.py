"""The port's native libpng codec (``native/``) against the JAX package's and
PIL: decode, 16-bit scaling, the threaded batch, the writer, the ``setjmp``
error path, the fallbacks, and the session loaders of both packages.

The JAX package's ``png_loader`` is driven on a library compiled here from
its own ``png_loader.cpp`` into a temporary directory (its module is pointed
there), so nothing is written into the JAX package.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from enph459_super_resolution_tpu.data import io as jio
from enph459_super_resolution_tpu.data import sessions as jsessions
from enph459_super_resolution_tpu.native import png_loader as jpng
from enph459_super_resolution_tpu_torch.data import io as tio
from enph459_super_resolution_tpu_torch.data import sessions as tsessions
from enph459_super_resolution_tpu_torch.native import build as tbuild
from enph459_super_resolution_tpu_torch.native import png_loader as tpng

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """JAX's ``png_loader`` bound to a library built from JAX's source in a
    temporary directory; the module's state is restored afterwards."""
    if shutil.which("g++") is None:
        pytest.fail("no g++: the native codec cannot be built here")
    out = tmp_path_factory.mktemp("jax_native")
    src = REPO / "enph459_super_resolution_tpu" / "native" / "png_loader.cpp"
    subprocess.run(["g++", "-O2", "-fPIC", "-shared", "-std=c++17", str(src),
                    "-lpng", "-lpthread", "-o", str(out / "libsrpng.so")],
                   check=True)
    saved = (jpng.__file__, jpng._LIB, jpng._TRIED)
    jpng.__file__, jpng._LIB, jpng._TRIED = str(out / "png_loader.py"), \
        None, False
    assert jpng.available()
    yield jpng
    jpng.__file__, jpng._LIB, jpng._TRIED = saved


@pytest.fixture(scope="module")
def native():
    """The port's library, built at first use."""
    tpng.reset()
    assert tpng.available(), tpng.build_error()
    return tpng


def _random(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


def test_builds_into_build_out_only(native):
    """The library sits in ``_build_out`` under a name keyed by the source
    and the flags; nothing is written beside the sources."""
    lib = tbuild.library_path()
    assert lib.exists() and lib.parent == tbuild.BUILD_DIR
    assert lib.parent.name == "_build_out"
    assert lib.name.startswith("libsrpng_") and len(lib.stem) == 9 + 16
    assert sorted(p.name for p in tbuild.SOURCE.parent.iterdir()
                  if p.name != "__pycache__") == [
        "__init__.py", "build.py", "png_loader.cpp", "png_loader.py"]
    assert native.build_error() is None


def test_build_cli_prints_its_library():
    res = subprocess.run(
        [sys.executable, "-m", "enph459_super_resolution_tpu_torch.native."
         "build"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert f"built: {tbuild.library_path()} loadable: True" in res.stdout


@pytest.mark.parametrize("shape", [(37, 53), (21, 33, 3)],
                         ids=["gray", "rgb"])
def test_decode_bit_exact(native, jax_native, tmp_path, shape):
    arr = _random(shape, 0)
    p = str(tmp_path / "img.png")
    Image.fromarray(arr).save(p)
    got = native.load(p)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, np.asarray(Image.open(p)))
    np.testing.assert_array_equal(got, jax_native.load(p))
    np.testing.assert_array_equal(tio.load_image(p), jio.load_image(p))


def test_16bit_scaling_equals_jax(native, jax_native, tmp_path):
    arr = (np.arange(64, dtype=np.uint16).reshape(8, 8) * 1031)
    p = str(tmp_path / "g16.png")
    Image.fromarray(arr).save(p)  # mode I;16
    got = native.load(p)
    assert got.dtype == np.uint8 and got.shape == (8, 8)
    np.testing.assert_array_equal(got, jax_native.load(p))
    np.testing.assert_array_equal(tio.load_image(p), jio.load_image(p))
    # png_set_scale_16: within half a count of v * 255 / 65535
    assert np.abs(got - arr * (255 / 65535)).max() <= 0.5 + 1e-9


@pytest.mark.parametrize("n_threads", [1, 4])
def test_batch_order_and_failures(native, jax_native, tmp_path, n_threads):
    paths, arrays = [], []
    for i in range(6):
        arr = _random((16 + i, 20) if i % 2 else (16 + i, 20, 3), i)
        p = str(tmp_path / f"img{i}.png")
        Image.fromarray(arr).save(p)
        paths.append(p)
        arrays.append(arr)
    paths.insert(3, str(tmp_path / "missing.png"))
    got = native.load_batch(paths, n_threads=n_threads)
    want = jax_native.load_batch(paths, n_threads=n_threads)
    assert got[3] is None and want[3] is None
    for g, w, a in zip(got[:3] + got[4:], want[:3] + want[4:], arrays):
        np.testing.assert_array_equal(g, a)
        np.testing.assert_array_equal(g, w)
    assert native.load_batch([]) == []


def test_non_png_gives_none(native, tmp_path):
    p = str(tmp_path / "img.jpg")
    Image.fromarray(_random((8, 8), 2)).save(p)
    assert native.load(p) is None
    assert jpng.load(p) is None  # the JAX convention, whatever its state


@pytest.mark.parametrize("shape", [(64, 80), (48, 56, 3), (9, 7, 4)])
def test_writer_round_trip_is_lossless(native, tmp_path, shape):
    img = _random(shape, 5)
    p = str(tmp_path / "w.png")
    assert native.save(p, img)
    np.testing.assert_array_equal(np.asarray(Image.open(p)), img)
    assert not native.save(str(tmp_path / "bad.png"),
                           np.zeros((2, 3, 5), np.uint8))


def test_writer_uses_level_1_and_the_sub_filter(native, tmp_path):
    """zlib level 1 (the deflate stream's FLEVEL bits read 0) and every
    scanline filtered with Sub (1)."""
    import zlib

    img = _random((12, 10), 6)
    p = tmp_path / "w.png"
    assert native.save(str(p), img)
    data = p.read_bytes()
    i = data.index(b"IDAT")
    length = int.from_bytes(data[i - 4:i], "big")
    stream = data[i + 4:i + 4 + length]
    assert stream[1] >> 6 == 0  # FLEVEL 0: the fastest levels
    raw = np.frombuffer(zlib.decompress(stream), np.uint8).reshape(12, 11)
    assert (raw[:, 0] == 1).all()


@pytest.mark.parametrize("shape", [(32, 40), (24, 30, 3)])
def test_save_png_gives_the_same_pixels_every_way(native, tmp_path,
                                                  monkeypatch, shape):
    """``save_png`` through libpng, PIL and the zlib codec: equal pixels
    (a float image clipped and truncated alike)."""
    img = np.random.default_rng(6).uniform(-20, 280, shape)
    paths = [str(tmp_path / f"{k}.png") for k in ("native", "pil", "zlib")]
    tio.save_png(img, paths[0])
    monkeypatch.setattr(tpng, "save", lambda *a, **k: False)
    tio.save_png(img, paths[1])
    monkeypatch.setattr(tio, "_pil", lambda: None)
    tio.save_png(img, paths[2])
    with open(paths[0], "rb") as fp:
        assert fp.read(8) == b"\x89PNG\r\n\x1a\n"
    want = np.clip(img, 0, 255).astype(np.uint8)
    for p in paths:
        np.testing.assert_array_equal(np.asarray(Image.open(p)), want)
    # the libpng file reads back through the zlib codec too
    with open(paths[0], "rb") as fp:
        np.testing.assert_array_equal(tio.decode_png(fp.read()), want)


def test_corrupt_file_returns_none_five_times(native, tmp_path):
    """A valid signature before garbage errors inside libpng, through the
    setjmp/longjmp path: ``None`` every time, no crash, no leaked state."""
    p = str(tmp_path / "corrupt.png")
    with open(p, "wb") as fp:
        fp.write(b"\x89PNG\r\n\x1a\n" + b"\x00" * 64)
    for _ in range(5):
        assert native.load(p) is None
    assert native.load_batch([p] * 5, n_threads=4) == [None] * 5
    with pytest.raises(FileNotFoundError, match="failed to decode"):
        tio.load_gray_batch([p])


@pytest.mark.parametrize("n_threads", [1, 3, 8])
def test_load_gray_batch_equals_jax(native, jax_native, tmp_path,
                                    n_threads):
    paths = []
    for i in range(5):
        arr = _random((24, 30, 3) if i % 2 else (24, 30), 10 + i)
        p = str(tmp_path / f"f{i}.png")
        Image.fromarray(arr).save(p)
        paths.append(p)
    got = tio.load_gray_batch(paths, n_threads=n_threads)
    want = jio.load_gray_batch(paths, n_threads=n_threads)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        tio.load_gray_batch(paths, np.float64)[1],
        np.asarray(Image.open(paths[1])).astype(np.float64).mean(axis=2))


@pytest.mark.parametrize("bayer_red,average_reps", [(False, False),
                                                    (True, True)])
def test_corner_rep_session_loads_equal_to_jax(native, jax_native, tmp_path,
                                               bayer_red, average_reps):
    session = tmp_path / "cal_target_synthetic"
    session.mkdir()
    for c in range(4):
        for r in range(3):
            Image.fromarray(_random((32, 48), 100 + 3 * c + r)).save(
                session / f"corner{c}_rep{r:02d}.png")
    got = tsessions.load_corner_rep_sessions(
        str(session), bayer_red=bayer_red, average_reps=average_reps)
    want = jsessions.load_corner_rep_sessions(
        str(session), bayer_red=bayer_red, average_reps=average_reps)
    assert len(got) == len(want) == (1 if average_reps else 3)
    for g, w in zip(got, want):
        assert (g.name, g.rep, g.shifts) == (w.name, w.rep, w.shifts)
        np.testing.assert_array_equal(g.frames, np.asarray(w.frames))


def test_without_a_compiler_the_callers_fall_back(tmp_path, monkeypatch):
    """No ``g++`` on PATH and nothing built: ``available()`` is False, the
    reason is kept, and decode and encode go through PIL with the same
    pixels."""
    monkeypatch.setattr(tbuild, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    tpng.reset()
    try:
        assert not tpng.available()
        assert "g++" in tpng.build_error()
        assert tpng.load_batch(["x.png"]) is None
        img = _random((10, 12), 7)
        p = str(tmp_path / "a.png")
        assert not tpng.save(p, img)
        tio.save_png(img, p)
        np.testing.assert_array_equal(tio.load_gray_batch([p])[0],
                                      img.astype(np.float32))
    finally:
        monkeypatch.undo()
        tpng.reset()
    assert tpng.available()


def test_a_failed_build_is_recorded_and_retried_on_request(tmp_path,
                                                           monkeypatch):
    """A failed build leaves its message in ``libsrpng_<hash>.err``; later
    builds raise that message without running ``g++``, and ``retry=True``
    (the module's ``main``) builds anew and removes the record."""
    monkeypatch.setattr(tbuild, "BUILD_DIR", tmp_path / "build")
    path = os.environ["PATH"]
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ did not run"):
        tbuild.build()
    err = tbuild.library_path().with_suffix(".err")
    assert err.exists() and "g++" in err.read_text()
    monkeypatch.setenv("PATH", path)

    def no_compiler(*args, **kwargs):
        raise AssertionError("g++ ran again")

    with monkeypatch.context() as m:
        m.setattr(subprocess, "run", no_compiler)
        with pytest.raises(RuntimeError, match="g\\+\\+ did not run"):
            tbuild.build()
    assert tbuild.build(retry=True) == tbuild.library_path()
    assert tbuild.library_path().exists() and not err.exists()
