"""Neural SR model zoo: the models ported so far.

Counterpart of ``enph459_super_resolution_tpu/models/zoo.py``.  Every model
maps NHWC ``lr[B, h, w, C]`` (0..rgb_range) to ``hr[B, h*s, w*s, C]``
float32, with float32 weights named as flax names them (see
``models/common.py``).  A model is built on ``device`` (default ``"cuda"``,
through :func:`..device.resolve_device`) with flax's default
initialisation drawn from ``generator`` (default: seed 0); trained weights
come in through :func:`..convert.load_flax_params`.

Ported: SRCNN, ESPCN, FSRCNN, EDSR (unrolled trunk) and BurstFusionLR.
EDSR's ``scan_trunk`` and ``remat``, EDSRMoE, RRDBNet, the VGG-style
discriminator and BurstFusion come with the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from .common import (Conv, MeanShift, PReLU, ResBlock, Upsampler,
                     init_flax_default, pixel_shuffle)


def _place(model: nn.Module, device, generator: Optional[torch.Generator]):
    """Draw the default initialisation on the CPU, then move to ``device``."""
    init_flax_default(model, generator if generator is not None
                      else torch.Generator().manual_seed(0))
    return model.to(resolve_device(device) if isinstance(device, str)
                    else device)


class SRCNN(nn.Module):
    """9-5-5 conv net on a pre-upsampled (bicubic) input: the data pipeline
    does the scaling, so it maps (B,H,W,C) -> (B,H,W,C)."""

    def __init__(self, channels: int = 1, f1: int = 64, f2: int = 32,
                 rgb_range: float = 255.0, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.channels, self.rgb_range = channels, rgb_range
        self.Conv_0 = Conv(channels, f1, 9)
        self.Conv_1 = Conv(f1, f2, 5)
        self.Conv_2 = Conv(f2, channels, 5)
        _place(self, device, generator)

    def forward(self, x):
        x = x / self.rgb_range
        x = torch.relu(self.Conv_0(x))
        x = torch.relu(self.Conv_1(x))
        return self.Conv_2(x) * self.rgb_range


class ESPCN(nn.Module):
    """Efficient sub-pixel CNN: a small trunk on the LR grid, then an
    ``r*r``-channel conv and a pixel shuffle."""

    def __init__(self, scale: int = 4, channels: int = 1,
                 rgb_range: float = 255.0, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.scale, self.channels, self.rgb_range = scale, channels, rgb_range
        self.Conv_0 = Conv(channels, 64, 5)
        self.Conv_1 = Conv(64, 32, 3)
        self.Conv_2 = Conv(32, channels * scale ** 2, 3)
        _place(self, device, generator)

    def forward(self, x):
        x = x / self.rgb_range
        x = torch.tanh(self.Conv_0(x))
        x = torch.tanh(self.Conv_1(x))
        return pixel_shuffle(self.Conv_2(x), self.scale) * self.rgb_range


class FSRCNN(nn.Module):
    """Feature (5x5, d) -> shrink (1x1, s) -> m x map (3x3, s) -> expand
    (1x1, d) -> sub-pixel head: the paper's 9x9 deconvolution realised as a
    9x9 conv to ``C*r*r`` channels and a pixel shuffle, as in the JAX
    package.  Each PReLU carries one scalar slope."""

    def __init__(self, scale: int = 4, channels: int = 1, d: int = 56,
                 s: int = 12, m: int = 4, rgb_range: float = 255.0, *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.scale, self.channels, self.m = scale, channels, m
        self.rgb_range = rgb_range
        widths = [(channels, d, 5), (d, s, 1)] + [(s, s, 3)] * m + [(s, d, 1)]
        for i, (cin, cout, k) in enumerate(widths):
            self.add_module(f"Conv_{i}", Conv(cin, cout, k))
            self.add_module(f"PReLU_{i}", PReLU())
        self.n_prelu = len(widths)
        self.add_module(f"Conv_{self.n_prelu}",
                        Conv(d, channels * scale ** 2, 9))
        _place(self, device, generator)

    def forward(self, x):
        x = x / self.rgb_range
        for i in range(self.n_prelu):
            x = getattr(self, f"PReLU_{i}")(getattr(self, f"Conv_{i}")(x))
        x = getattr(self, f"Conv_{self.n_prelu}")(x)
        return pixel_shuffle(x, self.scale) * self.rgb_range


class EDSR(nn.Module):
    """EDSR-baseline: 16 residual blocks, 64 features, res_scale 1.0, with
    the unrolled trunk layout (``ResBlock_0`` .. ``ResBlock_{n-1}``)."""

    def __init__(self, scale: int = 4, channels: int = 3,
                 n_resblocks: int = 16, n_feats: int = 64,
                 res_scale: float = 1.0, rgb_range: float = 255.0, *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.scale, self.channels = scale, channels
        self.n_resblocks, self.n_feats = n_resblocks, n_feats
        self.res_scale, self.rgb_range = res_scale, rgb_range
        self.MeanShift_0 = MeanShift(sign=-1, scale=rgb_range)
        self.Conv_0 = Conv(channels, n_feats, 3)
        for i in range(n_resblocks):
            self.add_module(f"ResBlock_{i}", ResBlock(n_feats, res_scale))
        self.Conv_1 = Conv(n_feats, n_feats, 3)
        self.Upsampler_0 = Upsampler(scale, n_feats)
        self.Conv_2 = Conv(n_feats, channels, 3)
        self.MeanShift_1 = MeanShift(sign=+1, scale=rgb_range)
        _place(self, device, generator)

    def blocks(self):
        return [getattr(self, f"ResBlock_{i}")
                for i in range(self.n_resblocks)]

    def forward(self, x):
        x = head = self.Conv_0(self.MeanShift_0(x))
        for block in self.blocks():
            x = block(x)
        x = self.Conv_1(x) + head
        x = self.Conv_2(self.Upsampler_0(x))
        return self.MeanShift_1(x)


class BurstFusionLR(nn.Module):
    """Burst fusion with the trunk on the LR grid.

    Input ``(B, h, w, N*f*f)``: each of the N frames' registered HR image
    packed as ``f*f`` LR-grid phase channels.  The mean over frames of the
    phase stack, pixel-shuffled, is the shift-and-add estimate; the trunk
    adds a residual through a zero-initialised head, so the untrained model
    reproduces shift-and-add.  Output ``(B, h*f, w*f, 1)``.
    """

    def __init__(self, n_frames: int = 4, factor: int = 2,
                 n_feats: int = 64, n_resblocks: int = 8,
                 rgb_range: float = 255.0, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_frames, self.factor = n_frames, factor
        self.n_feats, self.n_resblocks = n_feats, n_resblocks
        self.rgb_range = rgb_range
        ff = factor * factor
        self.Conv_0 = Conv(n_frames * ff, n_feats, 3)
        for i in range(n_resblocks):
            self.add_module(f"ResBlock_{i}", ResBlock(n_feats))
        self.Conv_1 = Conv(n_feats, ff, 3, zero_init=True)
        _place(self, device, generator)

    def blocks(self):
        return [getattr(self, f"ResBlock_{i}")
                for i in range(self.n_resblocks)]

    def check_input(self, x) -> None:
        want = self.n_frames * self.factor ** 2
        if x.shape[-1] != want:
            raise ValueError(
                f"expected {want} phase channels ({self.n_frames} frames x "
                f"{self.factor ** 2} phases), got {x.shape[-1]}")

    def shift_and_add(self, x):
        """The pixel-shuffled mean over frames of the phase stack."""
        phases = x.reshape(x.shape[:-1] + (self.n_frames, self.factor ** 2))
        return pixel_shuffle(phases.mean(dim=-2), self.factor)

    def forward(self, x):
        self.check_input(x)
        h = self.Conv_0((x - self.rgb_range / 2) / self.rgb_range)
        for block in self.blocks():
            h = block(h)
        res = pixel_shuffle(self.Conv_1(h), self.factor)
        return self.shift_and_add(x) + res * self.rgb_range


MODELS = {
    "srcnn": SRCNN,
    "espcn": ESPCN,
    "fsrcnn": FSRCNN,
    "burstfusion_lr": BurstFusionLR,
    "edsr": EDSR,
}


def create_model(name: str, **kwargs) -> nn.Module:
    return MODELS[name](**kwargs)
