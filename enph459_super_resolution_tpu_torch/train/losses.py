"""Losses for neural SR training: pixel, perceptual, and (relativistic) GAN.

Counterpart of ``enph459_super_resolution_tpu/train/losses.py`` on torch
tensors.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F


def l1_loss(pred, target):
    return torch.mean(torch.abs(pred - target))


def l2_loss(pred, target):
    return torch.mean(torch.square(pred - target))


def charbonnier_loss(pred, target, eps: float = 1e-3):
    """Smooth L1 used by many SR trainers (LapSRN et al.)."""
    return torch.mean(torch.sqrt(torch.square(pred - target) + eps * eps))


PIXEL_LOSSES = {"l1": l1_loss, "l2": l2_loss, "charbonnier": charbonnier_loss}


def psnr(pred, target, max_val: float = 255.0):
    mse = torch.mean(torch.square(pred - target))
    return 10.0 * torch.log10(max_val * max_val / torch.clamp(mse, min=1e-12))


# --------------------------------------------------------------------------
# Relativistic average GAN (ESRGAN objective)
# --------------------------------------------------------------------------

def _ra_logits(real_logits, fake_logits):
    d_real = real_logits - torch.mean(fake_logits)
    d_fake = fake_logits - torch.mean(real_logits)
    return d_real, d_fake


def ragan_discriminator_loss(real_logits, fake_logits):
    """D maximizes: real more realistic than average fake, and vice versa."""
    d_real, d_fake = _ra_logits(real_logits, fake_logits)
    loss_real = torch.mean(F.softplus(-d_real))   # BCE(D_ra(xr, xf), 1)
    loss_fake = torch.mean(F.softplus(d_fake))    # BCE(D_ra(xf, xr), 0)
    return 0.5 * (loss_real + loss_fake)


def ragan_generator_loss(real_logits, fake_logits):
    """G's adversarial term (symmetric relativistic form)."""
    d_real, d_fake = _ra_logits(real_logits, fake_logits)
    loss_real = torch.mean(F.softplus(d_real))    # BCE(D_ra(xr, xf), 0)
    loss_fake = torch.mean(F.softplus(-d_fake))   # BCE(D_ra(xf, xr), 1)
    return 0.5 * (loss_real + loss_fake)


# --------------------------------------------------------------------------
# Perceptual loss
# --------------------------------------------------------------------------

class PerceptualLoss:
    """Feature-space L1 given a feature extractor ``feat_fn(img)->features``.

    The canonical extractor is pre-activation VGG19 conv5_4 (the VGG
    extractor comes with the ``train.loop`` slice); without VGG weights,
    :func:`gradient_feature_fn` is a weight-free edge/structure extractor,
    the default here as in the reference.
    """

    def __init__(self, feat_fn: Optional[Callable] = None):
        self.feat_fn = feat_fn or gradient_feature_fn

    def __call__(self, pred, target):
        fp = self.feat_fn(pred)
        ft = self.feat_fn(target)
        if not isinstance(fp, (list, tuple)):
            fp, ft = [fp], [ft]
        return sum(torch.mean(torch.abs(a - b)) for a, b in zip(fp, ft))


def gradient_feature_fn(x):
    """Weight-free structural features: multi-scale image gradient maps.

    Input is NHWC; returns a list of gradient maps at scales 1 and 2.
    """
    feats = []
    for s in (1, 2):
        xs = x[:, ::s, ::s, :]
        feats.append(xs[:, 1:, :, :] - xs[:, :-1, :, :])
        feats.append(xs[:, :, 1:, :] - xs[:, :, :-1, :])
    return feats
