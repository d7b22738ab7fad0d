"""Fused-trunk serving paths for the conv-trunk models.

Counterpart of ``enph459_super_resolution_tpu/models/fused.py``: the EDSR
and BurstFusionLR forward passes with the residual trunk on the CUDA kernel
of ``ops/trunk.py`` (two launches per residual block) and the thin head,
tail, upsampler and output convs in ``F.conv2d``, as the JAX package runs
them in XLA outside Pallas.  The same network as the modules of
``models/zoo.py``: same weights, 'SAME' zero padding, and in bfloat16 the
rounding points of the JAX package's ``_conv``.

This is a serving path: nothing here takes gradients.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import no_tf32
from ..ops import trunk
from .common import channel_mean, pixel_shuffle


def _operands(conv, dtype):
    """A conv's weight rounded to ``dtype`` and held as float32 OIHW, and
    its float32 bias."""
    return (conv.weight.detach().to(dtype).float(),
            conv.bias.detach().float())


def _conv(x, operands, dtype):
    """The JAX package's ``_conv``: operands cast to ``dtype``, exact
    products summed in float32 (``F.conv2d`` in float32, TF32 off), the
    float32 bias added, the result cast to ``dtype``.  NHWC in and out."""
    w, b = operands
    x = x.to(dtype).float()
    no_tf32(x)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, padding=w.shape[-1] // 2)
    return y.permute(0, 2, 3, 1).to(dtype)


def _trunk_pack(model, dtype):
    """The model's residual blocks' convs, HWIO, packed for the kernel."""
    convs = [(c.weight.detach().permute(2, 3, 1, 0), c.bias.detach())
             for block in model.blocks() for c in (block.Conv_0, block.Conv_1)]
    return trunk.pack_trunk(convs, dtype, model.Conv_0.weight.device)


def make_edsr_fused_apply(model, *, dtype: torch.dtype = torch.bfloat16):
    """Serving ``fn(x)`` for a ``models/zoo.py`` EDSR with the fused trunk.

    ``fn`` maps ``[B, H, W, C]`` float32 in 0..rgb_range, on the model's
    device, to ``[B, H*s, W*s, C]`` float32, as ``model(x)`` does, to the
    precision of ``dtype`` (float32 or bfloat16).  The weights are packed
    and rounded once, here.
    """
    if getattr(model, "scan_trunk", False):
        raise ValueError("fused serving expects the unrolled trunk layout")
    pack = _trunk_pack(model, dtype)
    head = _operands(model.Conv_0, dtype)
    tail = _operands(model.Conv_1, dtype)
    ups = [_operands(c, dtype) for c in model.Upsampler_0.convs()]
    out = _operands(model.Conv_2, dtype)
    stages = model.Upsampler_0.stages
    rgb_range, res_scale = float(model.rgb_range), float(model.res_scale)

    @torch.no_grad()
    def apply_fn(x):
        mean = channel_mean(x, scale=rgb_range)
        h = _conv(x - mean, head, dtype)
        t = trunk.fused_resblocks_packed(h, pack, res_scale=res_scale)
        t = _conv(t, tail, dtype) + h
        for ops, r in zip(ups, stages):
            t = pixel_shuffle(_conv(t, ops, dtype), r)
        return _conv(t, out, dtype).float() + mean

    return apply_fn


def make_burst_lr_fused_apply(model, *, dtype: torch.dtype = torch.bfloat16):
    """Serving ``fn(phases)`` for a ``models/zoo.py`` BurstFusionLR with the
    fused trunk: phases ``[B, h, w, N*f*f]`` -> HR ``[B, h*f, w*f, 1]``
    float32."""
    if getattr(model, "scan_trunk", False):
        raise ValueError("fused serving expects the unrolled trunk layout")
    pack = _trunk_pack(model, dtype)
    head = _operands(model.Conv_0, dtype)
    out = _operands(model.Conv_1, dtype)
    rgb_range = float(model.rgb_range)

    @torch.no_grad()
    def apply_fn(x):
        model.check_input(x)
        h = _conv((x - rgb_range / 2) / rgb_range, head, dtype)
        h = trunk.fused_resblocks_packed(h, pack)
        res = pixel_shuffle(_conv(h, out, dtype).float(), model.factor)
        return model.shift_and_add(x) + res * rgb_range

    return apply_fn
