"""VGG16 perceptual features (counterpart of tgsr_tpu/models/vgg.py).

The ManiGAN losses take a VGG callable that returns a list of feature maps
(miscc/losses.py:656-662); the reference ships no VGG network. This is
torchvision's VGG16 `features` tower, its convs and ReLUs in one
`nn.Sequential` at torchvision's indices, so a user's torchvision `vgg16`
`.pth` loads with strict=True once its `classifier.` keys are dropped
(`load_torchvision_vgg16`), and JAX's `convert_vgg16` reads this module's
state dict. The taps are relu1_2, relu2_2, relu3_3, relu4_3 and relu5_3, a
2 x 2 max-pool between the blocks. Weights here are seeded: none is fetched.
"""

from __future__ import annotations

from typing import List, Mapping

import torch
from torch import nn

# torchvision vgg16's `features`: (width, convs) per block
_CFG = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _layers() -> List[nn.Module]:
    layers: List[nn.Module] = []
    cin = 3
    for width, n in _CFG:
        for _ in range(n):
            layers += [nn.Conv2d(cin, width, 3, padding=1), nn.ReLU()]
            cin = width
        layers.append(nn.MaxPool2d(2, 2))
    return layers


# the Sequential indices of the 13 convs, and of the ReLU each tap follows
CONV_INDICES = tuple(i for i, m in enumerate(_layers()) if isinstance(m, nn.Conv2d))
TAP_INDICES = tuple(i - 1 for i, m in enumerate(_layers()) if isinstance(m, nn.MaxPool2d))


class VGG16Features(nn.Module):
    """x in [-1, 1] NCHW -> the five taps (NCHW), after the last ReLU of each
    block and before its pool. The input is brought to ImageNet's
    normalisation first."""

    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(*_layers())
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD).view(1, 3, 1, 1),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = ((x + 1.0) / 2.0 - self.mean.to(x.dtype)) / self.std.to(x.dtype)
        taps = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in TAP_INDICES:
                taps.append(x)
                if len(taps) == len(_CFG):
                    break
        return taps


def load_torchvision_vgg16(sd: Mapping[str, torch.Tensor]) -> dict:
    """A torchvision `vgg16` state dict -> this module's (its `classifier.`
    dropped), for `load_state_dict(strict=True)`."""
    return {k: v for k, v in sd.items() if k.startswith("features.")}
