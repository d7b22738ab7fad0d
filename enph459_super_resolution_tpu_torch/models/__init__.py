"""Neural SR models: the zoo (SRCNN, ESPCN, FSRCNN, EDSR with either trunk
layout, EDSRMoE, RRDBNet and the VGG-style discriminator, BurstFusion,
BurstFusionLR), the fused-trunk serving paths and tiled inference."""

from .common import (DIV2K_RGB_MEAN, MeanShift, ResBlock, Upsampler,
                     pixel_shuffle)
from .zoo import (EDSR, ESPCN, FSRCNN, MODELS, RRDB, SRCNN, BurstFusion,
                  BurstFusionLR, DenseBlock, EDSRMoE, MoEResBlock, RRDBNet,
                  ScanTrunk, VGGStyleDiscriminator, create_model)

__all__ = [
    "DIV2K_RGB_MEAN", "MeanShift", "ResBlock", "Upsampler", "pixel_shuffle",
    "EDSR", "ESPCN", "FSRCNN", "MODELS", "SRCNN", "BurstFusion",
    "BurstFusionLR", "DenseBlock", "EDSRMoE", "MoEResBlock", "RRDB",
    "RRDBNet", "ScanTrunk",
    "VGGStyleDiscriminator", "create_model",
]
