"""Neural SR model zoo: the models ported so far.

Counterpart of ``enph459_super_resolution_tpu/models/zoo.py``.  Every model
maps NHWC ``lr[B, h, w, C]`` (0..rgb_range) to ``hr[B, h*s, w*s, C]``
float32, with float32 weights named as flax names them (see
``models/common.py``).  A model is built on ``device`` (default ``"cuda"``,
through :func:`..device.resolve_device`) with flax's default
initialisation drawn from ``generator`` (default: seed 0); trained weights
come in through :func:`..convert.load_flax_params`.

Ported: SRCNN, ESPCN, FSRCNN, EDSR (unrolled trunk or, with
``scan_trunk``, the stacked trunk of the pp mesh; both with ``remat``),
EDSRMoE (the gated-expert trunk of the ep mesh), the ESRGAN generator
RRDBNet and its VGG-style discriminator, and the burst models BurstFusion
and BurstFusionLR with a compute ``dtype`` (float32 or bfloat16) as
flax's.

Every model also runs on a ``parallel.spmd.MeshTensor`` (a batch split
over a training mesh): its layers take their mesh rules from it, and an
EDSRMoE whose experts were placed over an ep axis
(``parallel.moe.shard_params_ep_named``) computes each ep position's
experts there (``parallel.moe.moe_combine``).

``remat`` recomputes each residual block (EDSR) or RRDB (RRDBNet) in the
backward pass (``torch.utils.checkpoint``), as flax's ``nn.remat``: the
same gradients for a trunk's activation memory.  flax names a rematted
block ``CheckpointResBlock_i`` / ``CheckpointRRDB_i``, and so does the port.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from .common import (Conv, Dense, GroupNorm, MeanShift, PReLU, ResBlock,
                     Upsampler, call_stacked, init_flax_default,
                     pixel_shuffle, stack_parameters)

def _place(model: nn.Module, device, generator: Optional[torch.Generator]):
    """Draw the default initialisation on the CPU, then move to ``device``."""
    init_flax_default(model, generator if generator is not None
                      else torch.Generator().manual_seed(0))
    return model.to(resolve_device(device) if isinstance(device, str)
                    else device)


def _run_blocks(blocks, x, remat: bool):
    """``x`` through ``blocks`` in turn, each recomputed in the backward
    pass when ``remat`` (and gradients are being recorded)."""
    remat = remat and torch.is_grad_enabled()
    for block in blocks:
        x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
    return x


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


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


class ScanTrunk(nn.Module):
    """flax's ``nn.scan`` over one residual block: ``ResBlock_0``'s
    parameters are stacked ``[n, ...]`` (block ``i`` is slice ``i``), and
    the forward runs the blocks in turn, each recomputed in the backward
    pass with ``remat``."""

    def __init__(self, n: int, features: int, res_scale: float = 1.0,
                 remat: bool = False):
        super().__init__()
        self.n, self.remat = n, remat
        self.ResBlock_0 = stack_parameters(ResBlock(features, res_scale), n)

    def stacked(self) -> Dict[str, torch.Tensor]:
        """name -> stacked parameter ``[n, ...]``."""
        return dict(self.ResBlock_0.named_parameters())

    def run(self, x, params: Optional[Dict[str, torch.Tensor]] = None):
        """``x`` through the blocks of ``params`` (default: all of this
        trunk's), a stacked ``[k, ...]`` subset such as one pipeline
        stage's."""
        params = self.stacked() if params is None else params
        count = next(iter(params.values())).shape[0]
        blocks = [functools.partial(call_stacked, self.ResBlock_0, params, i)
                  for i in range(count)]
        return _run_blocks(blocks, x, self.remat)

    def forward(self, x):
        return self.run(x)


class EDSR(nn.Module):
    """EDSR-baseline: 16 residual blocks, 64 features, res_scale 1.0.

    The unrolled trunk layout (``ResBlock_0`` .. ``ResBlock_{n-1}``, or
    ``CheckpointResBlock_i`` with ``remat``) is the default.
    ``scan_trunk=True`` is flax's stacked layout: named submodules
    ``head``, ``trunk`` (:class:`ScanTrunk`, leaves ``[n_resblocks,
    ...]``), ``tail_conv``, ``upsampler``, ``out_conv`` -- the same
    function, the layout that pipeline parallelism splits over a pp axis
    (``parallel.pipeline.make_pipelined_edsr_apply``).  The two layouts'
    checkpoints are not interchangeable, as in the JAX package."""

    def __init__(self, scale: int = 4, channels: int = 3,
                 n_resblocks: int = 16, n_feats: int = 64,
                 res_scale: float = 1.0, rgb_range: float = 255.0,
                 remat: bool = False, scan_trunk: bool = False, *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.scale, self.channels = scale, channels
        self.n_resblocks, self.n_feats = n_resblocks, n_feats
        self.res_scale, self.rgb_range = res_scale, rgb_range
        self.remat, self.scan_trunk = remat, scan_trunk
        self.MeanShift_0 = MeanShift(sign=-1, scale=rgb_range)
        if scan_trunk:
            self.head = Conv(channels, n_feats, 3)
            self.trunk = ScanTrunk(n_resblocks, n_feats, res_scale, remat)
            self.tail_conv = Conv(n_feats, n_feats, 3)
            self.upsampler = Upsampler(scale, n_feats)
            self.out_conv = Conv(n_feats, channels, 3)
        else:
            self.block_prefix = "CheckpointResBlock" if remat else "ResBlock"
            self.Conv_0 = Conv(channels, n_feats, 3)
            for i in range(n_resblocks):
                self.add_module(f"{self.block_prefix}_{i}",
                                ResBlock(n_feats, res_scale))
            self.Conv_1 = Conv(n_feats, n_feats, 3)
            self.Upsampler_0 = Upsampler(scale, n_feats)
            self.Conv_2 = Conv(n_feats, channels, 3)
        self.MeanShift_1 = MeanShift(sign=+1, scale=rgb_range)
        _place(self, device, generator)

    def blocks(self):
        if self.scan_trunk:
            raise ValueError("the scan-trunk layout has one stacked block "
                             "(EDSR.trunk); blocks() is the unrolled one's")
        return [getattr(self, f"{self.block_prefix}_{i}")
                for i in range(self.n_resblocks)]

    def forward(self, x):
        if self.scan_trunk:
            x = head = self.head(self.MeanShift_0(x))
            x = self.tail_conv(self.trunk(x)) + head
            return self.MeanShift_1(self.out_conv(self.upsampler(x)))
        x = head = self.Conv_0(self.MeanShift_0(x))
        x = _run_blocks(self.blocks(), x, self.remat)
        x = self.Conv_1(x) + head
        x = self.Conv_2(self.Upsampler_0(x))
        return self.MeanShift_1(x)


class _ExpertBranch(nn.Module):
    """One expert's residual branch (conv-relu-conv, no skip: the skip and
    res_scale live in :class:`MoEResBlock`, so the gated blend stays a pure
    residual)."""

    def __init__(self, features: int):
        super().__init__()
        self.Conv_0 = Conv(features, features, 3)
        self.Conv_1 = Conv(features, features, 3)

    def forward(self, x):
        return self.Conv_1(torch.relu(self.Conv_0(x)))


class MoEResBlock(nn.Module):
    """Spatially gated mixture-of-experts residual block: a 1x1 ``gate``
    conv and a softmax over experts (in float32) give each pixel its
    weights; ``experts`` (flax's ``nn.vmap``: one :class:`_ExpertBranch`
    whose parameters are stacked ``[n_experts, ...]``) all see the whole
    input, and the blend is ``einsum("ebhwc,bhwe->bhwc")``.

    On a ``MeshTensor`` whose experts are placed over a mesh axis, each
    position of that axis computes its ``n_experts / ep`` experts and the
    gated partial blends are added up (``parallel.moe.moe_combine``)."""

    def __init__(self, features: int, n_experts: int = 4,
                 res_scale: float = 1.0):
        super().__init__()
        self.n_experts, self.res_scale = n_experts, res_scale
        self.gate = Conv(features, n_experts, 1)
        self.experts = stack_parameters(_ExpertBranch(features), n_experts)

    def forward(self, x):
        # softmax in float32, as the JAX package's, then the trunk's type
        gate = torch.softmax(self.gate(x).float(), dim=-1).to(x.dtype)
        params = dict(self.experts.named_parameters())
        if isinstance(x, torch.Tensor):
            ys = torch.stack([call_stacked(self.experts, params, e, x)
                              for e in range(self.n_experts)])
            r = torch.einsum("ebhwc,bhwe->bhwc", ys, gate)
        else:
            from ..parallel.moe import expert_axis, moe_combine

            r = moe_combine(
                functools.partial(call_stacked, self.experts, params),
                gate, x, axis=expert_axis(params.values(), x.mesh))
        return x + r * self.res_scale


class EDSRMoE(nn.Module):
    """EDSR-class network with gated mixture-of-experts residual blocks:
    :class:`EDSR`'s head, tail and upsampler, every trunk block a
    :class:`MoEResBlock`.  8 blocks x 64 features x 4 experts by default.
    The expert-parallel product surface (``train.loop --model edsr_moe
    --mesh dp=2,ep=4``), not a quality recommendation (RESULTS.md's
    matched-FLOP ablation)."""

    def __init__(self, scale: int = 4, channels: int = 3,
                 n_resblocks: int = 8, n_feats: int = 64, n_experts: int = 4,
                 res_scale: float = 1.0, rgb_range: float = 255.0, *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.scale, self.channels = scale, channels
        self.n_resblocks, self.n_feats = n_resblocks, n_feats
        self.n_experts, self.res_scale = n_experts, res_scale
        self.rgb_range = rgb_range
        self.MeanShift_0 = MeanShift(sign=-1, scale=rgb_range)
        self.Conv_0 = Conv(channels, n_feats, 3)
        for i in range(n_resblocks):
            self.add_module(f"MoEResBlock_{i}",
                            MoEResBlock(n_feats, n_experts, res_scale))
        self.Conv_1 = Conv(n_feats, n_feats, 3)
        self.Upsampler_0 = Upsampler(scale, n_feats)
        self.Conv_2 = Conv(n_feats, channels, 3)
        self.MeanShift_1 = MeanShift(sign=+1, scale=rgb_range)
        _place(self, device, generator)

    def blocks(self):
        return [getattr(self, f"MoEResBlock_{i}")
                for i in range(self.n_resblocks)]

    def forward(self, x):
        x = head = self.Conv_0(self.MeanShift_0(x))
        for block in self.blocks():
            x = block(x)
        x = self.Conv_1(x) + head
        return self.MeanShift_1(self.Conv_2(self.Upsampler_0(x)))


class DenseBlock(nn.Module):
    """ESRGAN residual dense block: 5 convs with dense connections, leaky
    relu 0.2, the sum scaled by 0.2 onto the input.  Its convs draw the
    ESRGAN 'smaller initialisation' (He, weights x ``init_scale``)."""

    def __init__(self, nf: int = 64, gc: int = 32, init_scale: float = 0.1):
        super().__init__()
        var = 2.0 * init_scale * init_scale
        for i in range(4):
            self.add_module(f"Conv_{i}", Conv(nf + i * gc, gc, 3,
                                              init_variance=var))
        self.Conv_4 = Conv(nf + 4 * gc, nf, 3, init_variance=var)

    def forward(self, x):
        feats = [x]
        for i in range(4):
            conv = getattr(self, f"Conv_{i}")
            feats.append(_lrelu(conv(torch.cat(feats, dim=-1))))
        return x + 0.2 * self.Conv_4(torch.cat(feats, dim=-1))


class RRDB(nn.Module):
    """Residual-in-residual dense block (3 dense blocks)."""

    def __init__(self, nf: int = 64, gc: int = 32, init_scale: float = 0.1):
        super().__init__()
        for i in range(3):
            self.add_module(f"DenseBlock_{i}", DenseBlock(nf, gc, init_scale))

    def forward(self, x):
        r = x
        for i in range(3):
            r = getattr(self, f"DenseBlock_{i}")(r)
        return x + 0.2 * r


#: nearest-neighbour x2 stages of RRDBNet's upsampler, by scale
RRDB_STAGES = {2: (2,), 4: (2, 2), 8: (2, 2, 2)}


class RRDBNet(nn.Module):
    """ESRGAN generator: conv -> ``nb`` x RRDB -> trunk conv (+ skip) ->
    per x2 stage a nearest-neighbour upsample and a conv -> HR conv ->
    output conv.  ``x / rgb_range`` in, ``* rgb_range`` out."""

    def __init__(self, scale: int = 4, channels: int = 3, nf: int = 64,
                 nb: int = 23, gc: int = 32, init_scale: float = 0.1,
                 rgb_range: float = 255.0, remat: bool = False, *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        if scale not in RRDB_STAGES:
            raise ValueError(f"RRDBNet scale {scale}: use one of "
                             f"{sorted(RRDB_STAGES)}")
        self.scale, self.channels = scale, channels
        self.nf, self.nb, self.gc = nf, nb, gc
        self.rgb_range, self.remat = rgb_range, remat
        self.stages = RRDB_STAGES[scale]
        self.block_prefix = "CheckpointRRDB" if remat else "RRDB"
        self.Conv_0 = Conv(channels, nf, 3)
        for i in range(nb):
            self.add_module(f"{self.block_prefix}_{i}",
                            RRDB(nf, gc, init_scale))
        # Conv_1 trunk, Conv_2.. one per stage, then the HR and output convs
        for i in range(1, len(self.stages) + 3):
            self.add_module(f"Conv_{i}", Conv(nf, nf, 3))
        n = len(self.stages) + 3
        self.add_module(f"Conv_{n}", Conv(nf, channels, 3))
        _place(self, device, generator)

    def blocks(self):
        return [getattr(self, f"{self.block_prefix}_{i}")
                for i in range(self.nb)]

    def forward(self, x):
        fea = self.Conv_0(x / self.rgb_range)
        trunk = _run_blocks(self.blocks(), fea, self.remat)
        fea = fea + self.Conv_1(trunk)
        for i, r in enumerate(self.stages):
            fea = fea.repeat_interleave(r, dim=1).repeat_interleave(r, dim=2)
            fea = _lrelu(getattr(self, f"Conv_{2 + i}")(fea))
        n = len(self.stages)
        fea = _lrelu(getattr(self, f"Conv_{2 + n}")(fea))
        return getattr(self, f"Conv_{3 + n}")(fea) * self.rgb_range


class VGGStyleDiscriminator(nn.Module):
    """ESRGAN discriminator: 8 convs (3x3 stride 1 and 4x4 stride 2 in
    turn, widths nf, nf, 2nf, 2nf, 4nf, 4nf, 8nf, 8nf), GroupNorm (8
    groups) after all but the first, leaky relu 0.2; the mean over H and W,
    then Dense(100), leaky relu, Dense(1).  Logits ``[B, 1]`` float32."""

    def __init__(self, nf: int = 64, rgb_range: float = 255.0,
                 channels: int = 3, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.nf, self.rgb_range = nf, rgb_range
        widths = [nf, nf, nf * 2, nf * 2, nf * 4, nf * 4, nf * 8, nf * 8]
        cin = channels
        for i, f in enumerate(widths):
            self.add_module(f"Conv_{i}", Conv(
                cin, f, 3 if i % 2 == 0 else 4, stride=1 + i % 2))
            if i > 0:
                self.add_module(f"GroupNorm_{i - 1}", GroupNorm(8, f))
            cin = f
        self.n_convs = len(widths)
        self.Dense_0 = Dense(cin, 100)
        self.Dense_1 = Dense(100, 1)
        _place(self, device, generator)

    def forward(self, x):
        x = x / self.rgb_range
        for i in range(self.n_convs):
            x = getattr(self, f"Conv_{i}")(x)
            if i > 0:
                x = getattr(self, f"GroupNorm_{i - 1}")(x)
            x = _lrelu(x)
        x = x.mean(dim=(1, 2))
        return self.Dense_1(_lrelu(self.Dense_0(x))).float()


class BurstFusion(nn.Module):
    """Multi-frame (burst) fusion SR with the trunk on the HR grid:
    N sub-pixel-shifted LR frames -> one HR image.

    The caller registers each frame onto the HR grid with the known shifts
    (``sr.fusion.register_burst``); input is the registered stack
    ``(B, H, W, N)`` (0..255), output ``(B, H, W, 1)``: a residual over the
    stack mean (the shift-and-add estimate) through a zero-initialised
    head, so the untrained model reproduces shift-and-add.  ``dtype`` is
    the trunk's compute type (float32 or bfloat16); the mean and the
    output stay float32.
    """

    def __init__(self, n_frames: int = 4, n_feats: int = 48,
                 n_resblocks: int = 6, rgb_range: float = 255.0,
                 dtype: torch.dtype = torch.float32, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_frames, self.n_feats = n_frames, n_feats
        self.n_resblocks, self.rgb_range = n_resblocks, rgb_range
        self.dtype = dtype
        self.Conv_0 = Conv(n_frames, n_feats, 3, dtype=dtype)
        for i in range(n_resblocks):
            self.add_module(f"ResBlock_{i}", ResBlock(n_feats, dtype=dtype))
        self.Conv_1 = Conv(n_feats, 1, 3, zero_init=True, dtype=dtype)
        _place(self, device, generator)

    def blocks(self):
        return [getattr(self, f"ResBlock_{i}")
                for i in range(self.n_resblocks)]

    def shift_and_add(self, x):
        """The mean over the registered frames."""
        return x.mean(dim=-1, keepdim=True)

    def forward(self, x):
        h = ((x - self.rgb_range / 2) / self.rgb_range).to(self.dtype)
        h = self.Conv_0(h)
        for block in self.blocks():
            h = block(h)
        res = self.Conv_1(h).float()
        return self.shift_and_add(x) + res * self.rgb_range


class BurstFusionLR(nn.Module):
    """Burst fusion with the trunk on the LR grid.

    Input ``(B, h, w, N*f*f)``: each of the N frames' registered HR image
    packed as ``f*f`` LR-grid phase channels.  The mean over frames of the
    phase stack, pixel-shuffled, is the shift-and-add estimate; the trunk
    adds a residual through a zero-initialised head, so the untrained model
    reproduces shift-and-add.  Output ``(B, h*f, w*f, 1)``.  ``dtype`` is
    the trunk's compute type (float32 or bfloat16): the residual is cast
    back to float32 before it is added to the float32 base.
    """

    def __init__(self, n_frames: int = 4, factor: int = 2,
                 n_feats: int = 64, n_resblocks: int = 8,
                 rgb_range: float = 255.0,
                 dtype: torch.dtype = torch.float32, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_frames, self.factor = n_frames, factor
        self.n_feats, self.n_resblocks = n_feats, n_resblocks
        self.rgb_range = rgb_range
        self.dtype = dtype
        ff = factor * factor
        self.Conv_0 = Conv(n_frames * ff, n_feats, 3, dtype=dtype)
        for i in range(n_resblocks):
            self.add_module(f"ResBlock_{i}", ResBlock(n_feats, dtype=dtype))
        self.Conv_1 = Conv(n_feats, ff, 3, zero_init=True, dtype=dtype)
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
        h = ((x - self.rgb_range / 2) / self.rgb_range).to(self.dtype)
        h = self.Conv_0(h)
        for block in self.blocks():
            h = block(h)
        res = pixel_shuffle(self.Conv_1(h).float(), self.factor)
        return self.shift_and_add(x) + res * self.rgb_range


MODELS = {
    "srcnn": SRCNN,
    "espcn": ESPCN,
    "fsrcnn": FSRCNN,
    "burstfusion": BurstFusion,
    "burstfusion_lr": BurstFusionLR,
    "edsr": EDSR,
    "edsr_moe": EDSRMoE,
    "rrdbnet": RRDBNet,
}


def create_model(name: str, **kwargs) -> nn.Module:
    return MODELS[name](**kwargs)
