"""The port's ``ops/resize.py`` against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through both.  Tolerances:
``resize_matrix`` is a copy of the reference's float64 numpy code and must
be equal entry for entry; the resizes and the Keys samplers run in float32
and are held within 1e-3 absolute on 0..255 (in practice they agree bit for
bit: the same taps summed in the same order).  ``keys_shift2d`` covers
integer, fractional and per-image shifts, shifts past the tap window where
the reference's ``dynamic_slice`` wraps and clamps its start, and the
gradient with respect to the shift."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enph459_super_resolution_tpu.ops import resize as J
from enph459_super_resolution_tpu_torch.ops import resize as T

ATOL = 1e-3


def _img(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(
        np.float32)


@pytest.mark.parametrize("n_in,n_out,antialias", [
    (16, 8, True), (16, 8, False), (12, 3, True), (8, 16, True),
    (8, 32, True), (7, 5, True), (5, 9, True), (4, 4, True), (3, 7, True),
    (48, 12, True)])
@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
def test_resize_matrix_is_exact(n_in, n_out, antialias, dtype_name):
    got = T.resize_matrix(n_in, n_out, antialias, dtype_name)
    want = J.resize_matrix(n_in, n_out, antialias, dtype_name)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,out_shape,antialias", [
    ((24, 30), (24, 30), True),        # identity
    ((16, 20, 3), (64, 80), True),     # NHWC up
    ((16, 20, 3), (4, 5), True),       # NHWC down, antialiased
    ((14, 22), (7, 11), False),
    ((14, 22), (28, 44), True),
    ((14, 22), (10, 15), True),        # non-integer ratio
    ((2, 24, 32, 1), (6, 8), True),    # batch of 1-channel images
])
def test_resize_matches_jax(shape, out_shape, antialias):
    x = _img(shape, 1)
    want = np.asarray(J.resize(jnp.asarray(x), out_shape, antialias))
    got = T.resize(torch.from_numpy(x), out_shape, antialias).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_resize_float64_matches_jax():
    x = np.random.default_rng(7).uniform(0, 255, (14, 22))
    want = np.asarray(J.resize(jnp.asarray(x), (10, 15)))
    got = T.resize(torch.from_numpy(x), (10, 15)).numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_degrade_and_upsample_match_jax(scale):
    hr = _img((2, 24, 36, 3), scale)
    want = np.asarray(J.bicubic_degrade(jnp.asarray(hr), scale))
    got = T.bicubic_degrade(torch.from_numpy(hr), scale).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    want_up = np.asarray(J.bicubic_upsample(jnp.asarray(want), scale))
    got_up = T.bicubic_upsample(torch.from_numpy(got), scale).numpy()
    assert got_up.shape == hr.shape
    np.testing.assert_allclose(got_up, want_up, rtol=0, atol=ATOL)


def test_degrade_refuses_indivisible():
    with pytest.raises(ValueError):
        T.bicubic_degrade(torch.zeros(10, 12), 4)


def test_stripes_antialias_protocol():
    """tests/test_train_data.py's high-frequency case: the antialiased
    downsample averages Nyquist stripes out."""
    x = np.zeros((64, 64), np.float32)
    x[:, ::2] = 255.0
    got = T.bicubic_degrade(torch.from_numpy(x), 4).numpy()
    want = np.asarray(J.bicubic_degrade(jnp.asarray(x), 4))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert abs(got.mean() - x.mean()) < 2.0 and got.std() < 12.0


SHIFTS = [(2.0, -3.0), (0.3, -0.7), (-1.25, 0.5), (5.5, -5.9),
          # past pad - 2 = 6: the reference wraps and clamps its start
          (7.3, 0.0), (9.0, 12.0), (-9.0, -12.0)]


@pytest.mark.parametrize("shift", SHIFTS)
def test_keys_shift2d_matches_jax(shift):
    x = _img((20, 24), 2)
    want = np.asarray(J.keys_shift2d(jnp.asarray(x),
                                     jnp.asarray(shift, jnp.float32)))
    got = T.keys_shift2d(torch.from_numpy(x), shift).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_keys_shift2d_integer_is_a_translation():
    x = _img((20, 24), 3)
    got = T.keys_shift2d(torch.from_numpy(x), (2.0, -3.0)).numpy()
    np.testing.assert_allclose(got[2:, :-3], x[:-2, 3:], rtol=0, atol=1e-4)


def test_keys_shift2d_per_image_and_stride():
    """One shift per image of a batch is one op; ``stride`` keeps the
    decimated samples of the full output."""
    x = _img((2, 3, 18, 22), 4)
    s = np.random.default_rng(5).uniform(-2, 2, (2, 3, 2)).astype(np.float32)
    shift_one = jax.vmap(jax.vmap(J.keys_shift2d))
    want = np.asarray(shift_one(jnp.asarray(x), jnp.asarray(s)))
    got = T.keys_shift2d(torch.from_numpy(x), torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    dec = T.keys_shift2d(torch.from_numpy(x), torch.from_numpy(s),
                         stride=2).numpy()
    np.testing.assert_array_equal(dec, got[..., ::2, ::2])
    # one shift for every frame of a stack, broadcast from the right
    want = np.asarray(jax.vmap(J.keys_shift2d, (0, None))(
        jnp.asarray(x[0]), jnp.asarray(s[0, 1])))
    got = T.keys_shift2d(torch.from_numpy(x[0]),
                         torch.from_numpy(s[0, 1])).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_keys_shift2d_gradient_wrt_shift():
    x = _img((16, 18), 6)
    w = np.random.default_rng(8).standard_normal((16, 18)).astype(np.float32)
    s0 = np.array([0.37, -1.21], np.float32)
    want = np.asarray(jax.grad(lambda s: jnp.sum(
        J.keys_shift2d(jnp.asarray(x), s) * jnp.asarray(w)))(
            jnp.asarray(s0)))
    s = torch.tensor(s0, requires_grad=True)
    (T.keys_shift2d(torch.from_numpy(x), s) * torch.from_numpy(w)).sum() \
        .backward()
    np.testing.assert_allclose(s.grad.numpy(), want, rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("shift", [(0.5, -0.5), (0.0, 0.0), (2.4, -2.9),
                                   (-3.0, 3.0), (4.5, -5.0), (7.3, -9.1)])
@pytest.mark.parametrize("factor", [2, 3])
def test_keys_register_phases_matches_jax(shift, factor):
    x = _img((14, 18), 9)
    want = np.asarray(J.keys_register_phases(
        jnp.asarray(x), jnp.asarray(shift, jnp.float32), factor))
    got = T.keys_register_phases(torch.from_numpy(x), shift, factor).numpy()
    assert got.shape == (14, 18, factor * factor)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    hr = T.phases_to_hr(torch.from_numpy(got), factor).numpy()
    np.testing.assert_array_equal(
        hr, np.asarray(J.phases_to_hr(jnp.asarray(got), factor)))


def test_keys_register_phases_per_image():
    x = _img((3, 12, 16), 10)
    s = np.random.default_rng(11).uniform(-2.5, 2.5, (3, 2)).astype(
        np.float32)
    want = np.asarray(jax.vmap(J.keys_register_phases, (0, 0, None))(
        jnp.asarray(x), jnp.asarray(s), 2))
    got = T.keys_register_phases(torch.from_numpy(x), torch.from_numpy(s),
                                 2).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_keys_phase_max_shift():
    assert T.keys_phase_max_shift() == J.keys_phase_max_shift() == 3.0
    assert T.keys_phase_max_shift(8) == J.keys_phase_max_shift(8)
