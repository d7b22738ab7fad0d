"""The port's conv engine on the CPU: every ``ops/conv.py`` function and the
device part of ``ops/resample.py`` against the JAX functions (float32, abs
1e-4 on 0..255) and SciPy (float64, as ``tests/test_resample.py`` holds the
JAX ones), then ``solve(engine="conv")`` against the JAX conv engine and
against the port's banded engine."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import scipy.signal
import torch

from enph459_super_resolution_tpu import ops as JO
from enph459_super_resolution_tpu.sr import classical as JC
from enph459_super_resolution_tpu_torch.ops import conv as TCONV
from enph459_super_resolution_tpu_torch.ops import resample as TR
from enph459_super_resolution_tpu_torch.sr import classical as TC

SHIFTS = ((+0.5, -0.5), (+0.5, +0.5), (-0.5, -0.5), (-0.5, +0.5))
# float32 sums in another order: 1e-4 on 0..255, scaled with the values
# (spline coefficients and sharp kernels leave that range)
F32_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    intra-op pool on top of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _image(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, size=shape)


def _both(img, dtype=np.float32):
    """The same array for the JAX function and for the port's."""
    a = np.asarray(img, dtype=dtype)
    return jnp.asarray(a), torch.as_tensor(a)


def _close_to_jax(got, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()) / 255.0)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL * scale,
                               rtol=0)


@pytest.mark.parametrize("mode", ["nearest", "mirror", "reflect", "wrap"])
def test_spline_coefficients(mode):
    img = _image((41, 53))
    scipy_mode = {"wrap": "grid-wrap"}.get(mode, mode)
    want = ndi.spline_filter(img, order=3, mode=scipy_mode)
    got = TR.spline_coefficients(torch.as_tensor(img), mode=mode).numpy()
    np.testing.assert_allclose(got, want, atol=1e-9)
    j, t = _both(img)
    _close_to_jax(TR.spline_coefficients(t, mode=mode),
                  JO.spline_coefficients(j, mode=mode))


@pytest.mark.parametrize("shift", [(0.5, -0.5), (-1.0, 1.0), (0.37, -2.41),
                                   (0.0, 0.0), (-0.5, 0.25), (9.3, -11.6)])
def test_spline_shift(shift):
    """Up to the borders, SciPy's NPAD=12 edge pre-pad included; the last
    shift is past NPAD - 4, where the pre-pad widens as the reference's
    does (and SciPy's symmetric extension beyond its 12 is approximated)."""
    img = _image((64, 72), 1)
    want = ndi.shift(img, shift, order=3, mode="nearest")
    got = TR.spline_shift(torch.as_tensor(img), shift).numpy()
    wide = max(abs(v) for v in shift) > 12 - 4
    np.testing.assert_allclose(got, want, atol=1e-5 if wide else 1e-9)
    np.testing.assert_allclose(
        got, np.asarray(JO.spline_shift(jnp.asarray(img), shift)), atol=1e-9)
    j, t = _both(img)
    _close_to_jax(TR.spline_shift(t, shift), JO.spline_shift(j, shift))


def test_spline_shift_strided_and_batched():
    imgs = _image((3, 48, 56), 2)
    j, t = _both(imgs)
    got = TR.spline_shift(t, (0.7, -0.3), strides=(2, 2))
    assert tuple(got.shape) == (3, 24, 28)
    _close_to_jax(got, JO.spline_shift(j, (0.7, -0.3), strides=(2, 2)))
    full = TR.spline_shift(t, (0.7, -0.3))
    np.testing.assert_allclose(full.numpy()[:, ::2, ::2], got.numpy(),
                               atol=1e-5)
    want = np.stack([ndi.shift(im, (0.7, -0.3), order=3, mode="nearest")
                     for im in imgs])
    np.testing.assert_allclose(full.numpy(), want, atol=1e-3)


@pytest.mark.parametrize("mode", ["nearest", "mirror"])
def test_map_coordinates_separable(mode):
    img = _image((40, 44), 3)
    cy = np.linspace(0, img.shape[0] - 1, 83)
    cx = np.linspace(0, img.shape[1] - 1, 91)
    gy, gx = np.meshgrid(cy, cx, indexing="ij")
    want = ndi.map_coordinates(ndi.spline_filter(img, order=3, mode=mode),
                               [gy, gx], order=3, mode=mode, prefilter=False)
    got = TR.spline_map_coordinates_separable(torch.as_tensor(img), cy, cx,
                                              mode=mode).numpy()
    np.testing.assert_allclose(got, want, atol=1e-9)
    j, t = _both(img)
    _close_to_jax(TR.spline_map_coordinates_separable(t, cy, cx, mode=mode),
                  JO.spline_map_coordinates_separable(j, cy, cx, mode=mode))


@pytest.mark.parametrize("factor", [2.0, 2])
def test_spline_zoom(factor):
    img = _image((33, 47), 4)
    want = ndi.zoom(img, factor, order=3)
    got = TR.spline_zoom(torch.as_tensor(img), factor).numpy()
    np.testing.assert_allclose(got, want, atol=1e-7)
    j, t = _both(_image((2, 33, 47), 5))
    _close_to_jax(TR.spline_zoom(t, factor), JO.spline_zoom(j, factor))


@pytest.mark.parametrize("shape", [(7, 7), (5, 7)])
def test_conv2d_same(shape):
    img = _image((50, 60), 6)
    k = np.random.default_rng(7).uniform(size=shape)
    k /= k.sum()
    want = scipy.signal.fftconvolve(img, k, mode="same")
    got = TCONV.conv2d_same(torch.as_tensor(img), k).numpy()
    np.testing.assert_allclose(got, want, atol=1e-9)
    j, t = _both(img)
    _close_to_jax(TCONV.conv2d_same(t, k), JO.conv2d_same(j, k))
    _close_to_jax(TCONV.correlate2d_same(t, k, strides=(2, 3)),
                  JO.correlate2d_same(j, k, strides=(2, 3)))


@pytest.mark.parametrize("axis,stride", [(-1, 1), (-2, 1), (-1, 2), (0, 3)])
def test_correlate1d(axis, stride):
    j, t = _both(_image((12, 30, 41), 8))
    k = np.random.default_rng(9).normal(size=9)
    k[4] = 0.0  # a zero tap, which the reference skips
    _close_to_jax(TCONV.correlate1d(t, k, axis, stride),
                  JO.correlate1d(j, k, axis, stride))


def test_gaussian_sobel_laplacian():
    img = _image((40, 42), 10)
    t = torch.as_tensor(img)
    np.testing.assert_allclose(TCONV.gaussian_filter(t, 2.0).numpy(),
                               ndi.gaussian_filter(img, sigma=2.0),
                               atol=1e-10)
    np.testing.assert_array_equal(TCONV.gaussian_kernel_1d(1.5),
                                  JO.gaussian_kernel_1d(1.5))
    for axis in (0, 1):
        np.testing.assert_allclose(TCONV.sobel(t, axis=axis - 2).numpy(),
                                   ndi.sobel(img, axis=axis), atol=1e-10)
    k = np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]], dtype=np.float64)
    np.testing.assert_allclose(
        TCONV.laplacian(t).numpy(),
        scipy.signal.correlate2d(img, k, mode="same", boundary="fill"),
        atol=1e-10)
    j, t32 = _both(img)
    _close_to_jax(TCONV.gaussian_filter(t32, 1.3, mode="mirror"),
                  JO.gaussian_filter(j, 1.3, mode="mirror"))
    _close_to_jax(TCONV.sobel(t32, axis=-2), JO.sobel(j, axis=-2))


@pytest.mark.parametrize("mode", ["edge", "symmetric", "reflect", "wrap",
                                  "constant"])
def test_pad_axis_is_numpy_pad_at_any_width(mode):
    x = np.arange(15.0).reshape(3, 5)
    for before, after in ((2, 3), (7, 11)):  # wider than the axis too
        got = TCONV.pad_axis(torch.as_tensor(x), -1, before, after, mode)
        np.testing.assert_array_equal(
            got.numpy(), np.pad(x, ((0, 0), (before, after)), mode=mode))


def _frames(seed=0):
    rng = np.random.default_rng(seed)
    scene = ndi.gaussian_filter(rng.uniform(0, 255, (64, 80)), 1.2)
    return np.clip(scene + rng.normal(0, 2, (4,) + scene.shape), 0,
                   255).astype(np.float32)


def test_conv_engine_solve_matches_jax_and_mm():
    frames = _frames()
    psf = JC.make_gaussian_psf()
    want = {k: np.asarray(v) for k, v in
            JC.solve(jnp.asarray(frames), psf, SHIFTS, n_iter=5,
                     engine="conv").items()}
    got = TC.solve(frames, psf, SHIFTS, n_iter=5, device="cpu",
                   engine="conv")
    mm = TC.solve(frames, psf, SHIFTS, n_iter=5, device="cpu")
    for k in ("lr_mean", "native", "saa", "ibp"):
        assert got[k].shape == want[k].shape
        diff = np.abs(TC.to_uint8(got[k]).astype(int)
                      - TC.to_uint8(want[k]).astype(int)).max()
        assert diff <= 1, (k, diff)
        np.testing.assert_allclose(got[k], mm[k], atol=2e-3 * 255)
    np.testing.assert_allclose(got["mse_history"], want["mse_history"],
                               rtol=1e-3)
    np.testing.assert_allclose(got["mse_history"], mm["mse_history"],
                               rtol=3e-3)


def test_conv_engine_solve_batch_solves_units_one_by_one():
    stacks = np.stack([_frames(1), _frames(2)])
    psf = JC.make_gaussian_psf()
    got = TC.solve_batch(stacks, psf, SHIFTS, n_iter=3, device="cpu",
                         engine="conv")
    assert got["ibp"].shape == (2, 128, 160)
    assert got["mse_history"].shape == (2, 3)
    single = TC.solve(stacks[1], psf, SHIFTS, n_iter=3, device="cpu",
                      engine="conv")
    np.testing.assert_array_equal(got["ibp"][1], single["ibp"])


def test_conv_engine_ignores_banded_knobs():
    """As in the reference, the conv engine runs strict float32 whatever the
    banded engine's knobs say; an unknown engine raises."""
    frames, psf = _frames(), JC.make_gaussian_psf()
    want = TC.solve(frames, psf, SHIFTS, n_iter=1, device="cpu",
                    engine="conv")
    for kw in ({"band_store": "bf16"}, {"fused": "on"},
               {"mm_precision": "HIGH"}):
        got = TC.solve(frames, psf, SHIFTS, n_iter=1, device="cpu",
                       engine="conv", **kw)
        np.testing.assert_array_equal(got["ibp"], want["ibp"])
    with pytest.raises(ValueError, match="engine"):
        TC.solve(frames, psf, SHIFTS, n_iter=1, device="cpu", engine="fft")
