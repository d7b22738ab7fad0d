"""The port's ``eval/metrics.py`` and ``train/losses.py`` against the JAX
package's, on the CPU: the same numpy inputs, made from a seed, through
both.  Tolerances: float32 reductions in another order, rtol 1e-5 (PSNR,
the losses) and 1e-4 absolute for SSIM (the SR-paper metric's own
reporting precision); ``local_contrast`` and ``shave_border`` are the
reference's numpy code and must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enph459_super_resolution_tpu.eval import metrics as JM
from enph459_super_resolution_tpu.train import losses as JL
from enph459_super_resolution_tpu_torch.eval import metrics as TM
from enph459_super_resolution_tpu_torch.train import losses as TL


def _pair(shape, seed, noise=10.0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 255, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, noise, shape), 0, 255).astype(np.float32)
    return a, b


@pytest.mark.parametrize("shape", [(32, 40), (2, 24, 28, 3), (20, 22, 1)])
def test_psnr_and_ssim_match_jax(shape):
    a, b = _pair(shape, 1)
    np.testing.assert_allclose(float(TM.psnr(a, b)),
                               float(JM.psnr(a, b)), rtol=1e-5)
    np.testing.assert_allclose(float(TM.ssim(torch.from_numpy(a),
                                             torch.from_numpy(b))),
                               float(JM.ssim(a, b)), rtol=0, atol=1e-4)


def test_y_channel_log_spectral_distance_match_jax():
    a, b = _pair((2, 16, 18, 3), 2)
    np.testing.assert_allclose(TM.y_channel(a).numpy(),
                               np.asarray(JM.y_channel(a)), atol=1e-3)
    ya, yb = _pair((48, 40), 3, noise=30.0)
    np.testing.assert_allclose(float(TM.log_spectral_distance(ya, yb)),
                               float(JM.log_spectral_distance(ya, yb)),
                               rtol=1e-4)


def test_local_contrast_and_shave_border_are_the_reference():
    prof = np.random.default_rng(4).uniform(10, 250, 97)
    for window in (4, 20):
        np.testing.assert_array_equal(TM.local_contrast(prof, window),
                                      JM.local_contrast(prof, window))
    for shape in [(10, 12), (10, 12, 3), (2, 10, 12, 1), (3, 10, 12)]:
        x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
        np.testing.assert_array_equal(TM.shave_border(x, 2),
                                      np.asarray(JM.shave_border(x, 2)))


@pytest.mark.parametrize("name", sorted(JL.PIXEL_LOSSES))
def test_pixel_losses_and_psnr_match_jax(name):
    a, b = _pair((2, 12, 14, 1), 5)
    want = float(JL.PIXEL_LOSSES[name](jnp.asarray(a), jnp.asarray(b)))
    got = float(TL.PIXEL_LOSSES[name](torch.from_numpy(a),
                                      torch.from_numpy(b)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(float(TL.psnr(torch.from_numpy(a),
                                             torch.from_numpy(b))),
                               float(JL.psnr(jnp.asarray(a),
                                             jnp.asarray(b))), rtol=1e-5)


def test_ragan_and_perceptual_losses_match_jax():
    rng = np.random.default_rng(6)
    real, fake = (rng.normal(0, 2, (8, 1)).astype(np.float32)
                  for _ in range(2))
    for fn in ("ragan_discriminator_loss", "ragan_generator_loss"):
        np.testing.assert_allclose(
            float(getattr(TL, fn)(torch.from_numpy(real),
                                  torch.from_numpy(fake))),
            float(getattr(JL, fn)(jnp.asarray(real), jnp.asarray(fake))),
            rtol=1e-5)
    a, b = _pair((2, 16, 18, 1), 7)
    np.testing.assert_allclose(
        float(TL.PerceptualLoss()(torch.from_numpy(a), torch.from_numpy(b))),
        float(JL.PerceptualLoss()(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-5)
    feats = TL.gradient_feature_fn(torch.from_numpy(a))
    assert [tuple(f.shape) for f in feats] == [
        tuple(f.shape) for f in JL.gradient_feature_fn(jnp.asarray(a))]
