"""Neural SR models: the zoo ported so far (SRCNN, ESPCN, FSRCNN, EDSR,
RRDBNet and the VGG-style discriminator, BurstFusion, BurstFusionLR), the
fused-trunk serving paths and tiled inference."""

from .common import (DIV2K_RGB_MEAN, MeanShift, ResBlock, Upsampler,
                     pixel_shuffle)
from .zoo import (EDSR, ESPCN, FSRCNN, MODELS, RRDB, SRCNN, BurstFusion,
                  BurstFusionLR, DenseBlock, RRDBNet, VGGStyleDiscriminator,
                  create_model)

__all__ = [
    "DIV2K_RGB_MEAN", "MeanShift", "ResBlock", "Upsampler", "pixel_shuffle",
    "EDSR", "ESPCN", "FSRCNN", "MODELS", "SRCNN", "BurstFusion",
    "BurstFusionLR", "DenseBlock", "RRDB", "RRDBNet",
    "VGGStyleDiscriminator", "create_model",
]
