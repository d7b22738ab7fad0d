"""VGG19 feature extractor for the paper-exact ESRGAN perceptual loss.

Counterpart of ``enph459_super_resolution_tpu/train/vgg.py``.  The ESRGAN
recipe (Wang et al. 2018) defines the perceptual term as an L1 distance
between *pre-activation* VGG19 conv5_4 features of SR and HR.  Without
pretrained weights :class:`~.losses.PerceptualLoss` falls back to
weight-free gradient features; with a torchvision ``vgg19`` checkpoint,
:func:`load_torch_vgg19` and :func:`make_vgg_feature_fn` make the loss the
paper's.

:class:`VGG19Features` is laid out as torchvision's ``vgg19().features``
(``features.{idx}``, the convs at :data:`_TORCH_CONV_INDICES`), so a
torchvision state dict loads as it is.  NHWC in and out at the boundary
(the features come back NHWC, as the JAX package's); inputs in
``[0, rgb_range]`` are normalised with the ImageNet statistics the
torchvision weights were trained with.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from ..device import no_tf32, resolve_device

# (block, convs-in-block, width) -- the VGG19 "E" configuration.
VGG19_BLOCKS: Tuple[Tuple[int, int, int], ...] = (
    (1, 2, 64), (2, 2, 128), (3, 4, 256), (4, 4, 512), (5, 4, 512))

# torchvision ``vgg19().features`` module indices of each conv layer, in
# network order.
_TORCH_CONV_INDICES = (0, 2, 5, 7, 10, 12, 14, 16,
                       19, 21, 23, 25, 28, 30, 32, 34)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def conv_names() -> Tuple[str, ...]:
    """('conv1_1', 'conv1_2', 'conv2_1', ..., 'conv5_4') in network order."""
    names = []
    for block, n_convs, _ in VGG19_BLOCKS:
        names.extend(f"conv{block}_{i + 1}" for i in range(n_convs))
    return tuple(names)


class _Conv3x3(nn.Conv2d):
    """A 3x3 'SAME' conv, zero until weights are loaded (no draw from the
    global generator)."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 3, padding=1)

    def reset_parameters(self) -> None:
        nn.init.zeros_(self.weight)
        nn.init.zeros_(self.bias)


class VGG19Features(nn.Module):
    """VGG19 trunk returning the requested intermediate feature maps.

    Args:
      layers: conv names whose outputs to return (in network order); the
        forward stops at the last of them.
      pre_activation: return conv outputs BEFORE ReLU (the ESRGAN choice;
        ``False`` gives the older SRGAN post-activation features).
      rgb_range: input scale (255 for this framework's pipelines).

    A 1-channel input is repeated to RGB.  The weights are zero until a
    state dict is loaded (:func:`make_vgg_feature_fn`).
    """

    def __init__(self, layers: Sequence[str] = ("conv5_4",),
                 pre_activation: bool = True, rgb_range: float = 255.0):
        super().__init__()
        unknown = set(layers) - set(conv_names())
        if unknown:
            raise ValueError(f"unknown VGG19 layers: {sorted(unknown)}")
        self.layers = tuple(layers)
        self.pre_activation = pre_activation
        self.rgb_range = rgb_range
        mods, cin = [], 3
        for _, n_convs, width in VGG19_BLOCKS:
            for _ in range(n_convs):
                mods += [_Conv3x3(cin, width), nn.ReLU()]
                cin = width
            mods.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*mods)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD),
                             persistent=False)

    def forward(self, x):
        no_tf32(x)
        if x.shape[-1] == 1:  # grayscale pipelines: replicate to RGB
            x = x.repeat(1, 1, 1, 3)
        x = ((x.float() / self.rgb_range - self.mean) / self.std)
        x = x.permute(0, 3, 1, 2)
        wanted = set(self.layers)
        names = dict(zip(_TORCH_CONV_INDICES, conv_names()))
        # the conv's own index, or its relu's (one after it)
        shift = 0 if self.pre_activation else 1
        stop = max(_TORCH_CONV_INDICES[conv_names().index(n)]
                   for n in wanted) + shift
        feats: Dict[str, torch.Tensor] = {}
        for idx, mod in enumerate(self.features):
            x = mod(x)
            name = names.get(idx - shift)
            if name in wanted:
                feats[name] = x.permute(0, 2, 3, 1)
            if idx == stop:
                break
        return [feats[n] for n in self.layers]


def features_state_dict(state_dict) -> Dict[str, torch.Tensor]:
    """The ``features.{idx}.weight`` / ``.bias`` entries of a torchvision
    ``vgg19`` state dict (the classifier's are dropped), as float32."""
    return {f"features.{i}.{k}": torch.as_tensor(
        state_dict[f"features.{i}.{k}"]).float()
        for i in _TORCH_CONV_INDICES for k in ("weight", "bias")}


def load_torch_vgg19(path: str) -> Dict[str, torch.Tensor]:
    """Read a torchvision ``vgg19`` checkpoint (.pth, tensors only) as the
    feature trunk's state dict."""
    return features_state_dict(torch.load(path, map_location="cpu",
                                          weights_only=True))


def make_vgg_feature_fn(state_dict, layers: Sequence[str] = ("conv5_4",),
                        pre_activation: bool = True,
                        rgb_range: float = 255.0, device="cuda"):
    """Feature fn for :class:`~.losses.PerceptualLoss` on ``device``:
    ``PerceptualLoss(make_vgg_feature_fn(load_torch_vgg19(path)))`` is the
    paper-exact ESRGAN perceptual objective.  The VGG weights take no
    gradient; the input does."""
    device = resolve_device(device) if isinstance(device, str) else device
    model = VGG19Features(layers, pre_activation, rgb_range)
    model.load_state_dict(features_state_dict(state_dict), strict=True)
    model = model.to(device).eval().requires_grad_(False)
    return model
