"""Shared building blocks of the neural SR models.

Counterpart of ``enph459_super_resolution_tpu/models/common.py``.  Tensors
are NHWC ``[B, H, W, C]`` at every module's boundary, as in the JAX
package, so the two are compared array for array.  Inside, :class:`Conv`
hands ``F.conv2d`` the NCHW view of the same memory (``permute``, no copy),
which cuDNN takes as a channels-last tensor.

Module and parameter names mirror flax's automatic names (``Conv_0``,
``ResBlock_3``, ``Upsampler_0/Conv_1``, ``PReLU_2``), so a flax parameter
tree maps onto a module's ``state_dict`` by one rule
(:func:`..convert.flax_state_dict`).  Weights are float32; the models run
in float32 (the bf16 serving path is ``models/fused.py``).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from ..device import no_tf32

# DIV2K RGB channel means (0..1 scale), the standard EDSR normalization.
DIV2K_RGB_MEAN = (0.4488, 0.4371, 0.4040)

# flax lecun_normal: a normal truncated to +-2 std, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """Sub-pixel upsample ``[..., H, W, C*r*r] -> [..., H*r, W*r, C]``.

    Channels are grouped ``(r, r, C)`` as in the JAX package: input channel
    ``(i*r + j)*C + c`` goes to sub-pixel ``(i, j)``.  ``torch.nn.
    PixelShuffle`` groups them ``(C, r, r)`` and is not this function.
    """
    *lead, h, w, c = x.shape
    if c % (r * r) != 0:
        raise ValueError(f"channels {c} not divisible by r^2={r * r}")
    c_out = c // (r * r)
    x = x.reshape(*lead, h, w, r, r, c_out)
    n = len(lead)
    # (..., H, W, rh, rw, C) -> (..., H, rh, W, rw, C)
    x = x.permute(*range(n), n, n + 2, n + 1, n + 3, n + 4)
    return x.reshape(*lead, h * r, w * r, c_out)


def channel_mean(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """The DIV2K channel means in ``x``'s scale; on an input that is not
    3-channel (a 1-channel image), the mean of the three means."""
    mean = torch.tensor(DIV2K_RGB_MEAN, dtype=x.dtype, device=x.device) * scale
    if x.shape[-1] != len(DIV2K_RGB_MEAN):
        mean = mean.mean(dim=0, keepdim=True)
    return mean


class MeanShift(nn.Module):
    """Subtract (``sign=-1``) or add back (``+1``) the DIV2K channel means,
    in the input's scale (``scale`` is the data range, 1.0 or 255.0)."""

    def __init__(self, sign: int = -1, scale: float = 1.0):
        super().__init__()
        self.sign = sign
        self.scale = scale

    def forward(self, x):
        return x + self.sign * channel_mean(x, self.scale)


class Conv(nn.Conv2d):
    """flax ``nn.Conv`` with an odd square kernel: NHWC in and out, 'SAME'
    zero padding, stride 1, bias.  The weight is OIHW (flax's kernel is
    HWIO).  It is zero until :func:`init_flax_default` draws it."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 zero_init: bool = False):
        self.zero_init = zero_init
        super().__init__(in_features, features, kernel, padding=kernel // 2)

    def reset_parameters(self) -> None:
        # no draw from the global generator; init_flax_default draws
        nn.init.zeros_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        no_tf32(x)
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class PReLU(nn.Module):
    """flax ``nn.PReLU``: one learned scalar slope, initialised to 0.01."""

    def __init__(self):
        super().__init__()
        self.negative_slope = nn.Parameter(torch.tensor(0.01))

    def forward(self, x):
        return torch.where(x >= 0, x, self.negative_slope.to(x.dtype) * x)


def init_flax_default(module: nn.Module, generator: torch.Generator) -> None:
    """flax's default initialisation, drawn from ``generator`` in module
    order: every :class:`Conv` kernel lecun-normal (a truncated normal of
    variance 1/fan_in), or zero where the conv is ``zero_init``; every bias
    zero.  The values differ from flax's, whose generator is another."""
    with torch.no_grad():
        for m in module.modules():
            if not isinstance(m, Conv):
                continue
            m.bias.zero_()
            if m.zero_init:
                m.weight.zero_()
                continue
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            # inverse-CDF draw of a standard normal truncated to [-2, 2]
            lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
            u = torch.rand(m.weight.shape, generator=generator,
                           device=generator.device)
            z = torch.erfinv(2.0 * (lo + u * (1.0 - 2.0 * lo)) - 1.0)
            m.weight.copy_((z * math.sqrt(2.0) * std).clamp_(-2 * std,
                                                             2 * std))


class ResBlock(nn.Module):
    """EDSR residual block: conv-relu-conv, residual-scaled, no batchnorm."""

    def __init__(self, features: int, res_scale: float = 1.0):
        super().__init__()
        self.res_scale = res_scale
        self.Conv_0 = Conv(features, features, 3)
        self.Conv_1 = Conv(features, features, 3)

    def forward(self, x):
        r = self.Conv_1(torch.relu(self.Conv_0(x)))
        return x + r * self.res_scale


def upsampler_stages(scale: int) -> Tuple[int, ...]:
    """Pixel-shuffle factors of an EDSR upsampler: x4 as (2, 2), x8 as
    (2, 2, 2)."""
    if scale in (2, 3):
        return (scale,)
    if scale == 4:
        return (2, 2)
    if scale == 8:
        return (2, 2, 2)
    raise ValueError(f"unsupported scale {scale}")


class Upsampler(nn.Module):
    """Pixel-shuffle upsampler: per stage, a conv to ``C*r*r`` channels and
    a :func:`pixel_shuffle`, staged as EDSR stages it."""

    def __init__(self, scale: int, features: int):
        super().__init__()
        self.stages = upsampler_stages(scale)
        for i, r in enumerate(self.stages):
            self.add_module(f"Conv_{i}", Conv(features, features * r * r, 3))

    def convs(self):
        return [getattr(self, f"Conv_{i}") for i in range(len(self.stages))]

    def forward(self, x):
        for conv, r in zip(self.convs(), self.stages):
            x = pixel_shuffle(conv(x), r)
        return x
