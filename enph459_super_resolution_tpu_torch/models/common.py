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
in float32, the burst models also in bfloat16 (a :class:`Conv`'s compute
``dtype``), and the fused bf16 serving path is ``models/fused.py``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
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
    """flax ``nn.Conv``: NHWC in and out, 'SAME' zero padding, bias.  The
    weight is OIHW (flax's kernel is HWIO).  It is zero until
    :func:`init_flax_default` draws it, with variance ``init_variance /
    fan_in`` (1: flax's lecun_normal default).

    An odd kernel at stride 1 pads ``kernel // 2`` on every side.  Any other
    (an even kernel, a stride) pads as flax's 'SAME' does, by the input's
    size: ``ceil(n / stride)`` outputs, the total padding
    ``max((ceil(n / stride) - 1) * stride + kernel - n, 0)`` split with the
    extra element after (a 4x4 stride-2 conv pads (1, 1) on an even side,
    (1, 2) on an odd one).

    ``dtype`` is the compute type, as flax's ``dtype=``: the weights stay
    float32, and a bfloat16 conv casts its input, weight and bias to
    bfloat16 and returns bfloat16."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 zero_init: bool = False, dtype: torch.dtype = torch.float32,
                 stride: int = 1, init_variance: float = 1.0):
        self.zero_init = zero_init
        self.compute_dtype = dtype
        self.init_variance = init_variance
        self.same_by_size = stride != 1 or kernel % 2 == 0
        super().__init__(in_features, features, kernel, stride=stride,
                         padding=0 if self.same_by_size else kernel // 2)

    def reset_parameters(self) -> None:
        # no draw from the global generator; init_flax_default draws
        nn.init.zeros_(self.weight)
        nn.init.zeros_(self.bias)

    @staticmethod
    def _pads(sizes, kernels, strides):
        pads = []
        for n, k, s in zip(sizes, kernels, strides):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            pads.append((total // 2, total - total // 2))
        return pads

    def _same_pad(self, x):
        (top, bottom), (left, right) = self._pads(
            x.shape[-2:], self.kernel_size, self.stride)
        return F.pad(x, (left, right, top, bottom))

    def forward(self, x):
        if not isinstance(x, torch.Tensor):  # a parallel.spmd.MeshTensor
            return x.apply_layer(self)
        return self.conv_nhwc(x, self.weight, self.bias)

    def conv_nhwc(self, x, weight, bias, rows_padded: bool = False):
        """This conv of NHWC ``x`` with ``weight`` and ``bias`` (its own, or
        a mesh position's slice of them).  ``rows_padded``: ``x`` already
        holds the rows its window needs above and below (a row tile
        extended by its neighbours' rows), so only the columns are
        padded."""
        no_tf32(x)
        x = x.permute(0, 3, 1, 2)
        padding = self.padding
        if rows_padded:
            if self.same_by_size:
                (left, right), = self._pads(x.shape[-1:], self.kernel_size[1:],
                                            self.stride[1:])
                x = F.pad(x, (left, right))
                padding = 0
            else:
                padding = (0, self.kernel_size[1] // 2)
        elif self.same_by_size:
            x = self._same_pad(x)
        dt = self.compute_dtype
        if dt != torch.float32:
            x, weight, bias = x.to(dt), weight.to(dt), bias.to(dt)
        return F.conv2d(x, weight, bias, self.stride, padding).permute(
            0, 2, 3, 1)


class Dense(nn.Linear):
    """flax ``nn.Dense``: ``x @ kernel + bias`` on the last axis; the weight
    is ``[out, in]`` (flax's kernel is ``[in, out]``), zero until
    :func:`init_flax_default` draws it (lecun_normal)."""

    init_variance = 1.0

    def reset_parameters(self) -> None:
        nn.init.zeros_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        if not isinstance(x, torch.Tensor):  # a parallel.spmd.MeshTensor
            return x.apply_layer(self)
        return self.linear(x, self.weight, self.bias)

    def linear(self, x, weight, bias):
        """This layer on ``x`` with ``weight`` and ``bias`` (its own, or a
        mesh position's slice of them)."""
        no_tf32(x)
        return F.linear(x, weight, bias)


class GroupNorm(nn.GroupNorm):
    """flax ``nn.GroupNorm``: groups of consecutive channels of an NHWC
    tensor, epsilon 1e-6 (torch's default is 1e-5), scale 1 and bias 0 at
    initialisation (flax's ``scale`` is the ``weight`` here)."""

    def __init__(self, num_groups: int, features: int, eps: float = 1e-6):
        super().__init__(num_groups, features, eps=eps)

    def forward(self, x):
        if not isinstance(x, torch.Tensor):  # a parallel.spmd.MeshTensor
            return x.apply_layer(self)
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
    order: every :class:`Conv` and :class:`Dense` weight a truncated normal
    of variance ``init_variance / fan_in`` (lecun_normal at 1; the ESRGAN
    dense blocks' scaled He init at ``2 * 0.1**2``), or zero where the conv
    is ``zero_init``; every bias zero.  :class:`GroupNorm` keeps scale 1 and
    bias 0.  The values differ from flax's, whose generator is another."""
    with torch.no_grad():
        for m in module.modules():
            if not isinstance(m, (Conv, Dense)):
                continue
            m.bias.zero_()
            if getattr(m, "zero_init", False):
                m.weight.zero_()
                continue
            # per slice of a stacked weight [n, ...] (a scanned trunk, the
            # experts): a conv's in x kh x kw, a dense layer's in
            fan_in = math.prod(m.weight.shape[-3:] if isinstance(m, Conv)
                               else m.weight.shape[-1:])
            std = math.sqrt(m.init_variance / fan_in) / _TRUNC_STD
            # inverse-CDF draw of a standard normal truncated to [-2, 2]
            lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
            u = torch.rand(m.weight.shape, generator=generator,
                           device=generator.device)
            z = torch.erfinv(2.0 * (lo + u * (1.0 - 2.0 * lo)) - 1.0)
            m.weight.copy_((z * math.sqrt(2.0) * std).clamp_(-2 * std,
                                                             2 * std))


class ConvBlock(nn.Module):
    """Conv -> optional activation, NHWC (the JAX package's ``ConvBlock``,
    which no model of either package uses).  flax infers the input
    channels; here they are ``in_features``.  The conv is named ``conv``, as
    flax names it, so ``convert.load_flax_params`` carries its
    ``conv/kernel`` and ``conv/bias`` across."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 act=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act = act
        self.conv = Conv(in_features, features, kernel, dtype=dtype)

    def forward(self, x):
        x = self.conv(x)
        if self.act is not None:
            x = self.act(x)
        return x


class ResBlock(nn.Module):
    """EDSR residual block: conv-relu-conv, residual-scaled, no batchnorm;
    in the convs' compute ``dtype``."""

    def __init__(self, features: int, res_scale: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.res_scale = res_scale
        self.Conv_0 = Conv(features, features, 3, dtype=dtype)
        self.Conv_1 = Conv(features, features, 3, dtype=dtype)

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


def stack_parameters(module: nn.Module, n: int) -> nn.Module:
    """Give every parameter of ``module`` a leading dim of ``n``: ``n``
    modules' weights under one module's names, as flax's ``nn.scan`` and
    ``nn.vmap`` over the params axis 0 lay them out.  Run copy ``i`` with
    :func:`call_stacked`.  Returns ``module``."""
    for m in module.modules():
        for name, p in list(m.named_parameters(recurse=False)):
            setattr(m, name, nn.Parameter(
                p.detach().unsqueeze(0).repeat((n,) + (1,) * p.dim())))
    return module


def call_stacked(module: nn.Module, params: Dict[str, torch.Tensor], i: int,
                 x):
    """``module`` on ``x`` with slice ``i`` of the stacked ``params``
    (name -> ``[n, ...]``, e.g. ``dict(module.named_parameters())`` after
    :func:`stack_parameters`); a slice keeps the placement of the dims it
    has (``parallel.spmd.index_placed``)."""
    from ..parallel.spmd import index_placed

    return torch.func.functional_call(
        module, {k: index_placed(v, i) for k, v in params.items()}, (x,))
