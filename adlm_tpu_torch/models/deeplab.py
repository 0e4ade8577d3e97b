"""DeepLabV2: dilated ResNet-101 (output stride 8) + ASPP
(counterpart of ``adlm_tpu.models.deeplab``).

NCHW modules; the module names are the reference's state_dict keys
(``layer1.conv1.{conv,bn}``,
``layer{2..5}.block{n}.{reduce,conv3x3,increase,shortcut}.{conv,bn}``,
``aspp.c0..c3``; reference deeplab_features.py:8-60,
segmentation/module.py:335-343):

* stem: 7x7/2 conv + BN + relu + 3x3/2 ceil-mode max pool;
* layers 2-5: caffe-style bottlenecks (stride on the 1x1 reduce conv),
  strides (1, 2, 1, 1), dilations (1, 1, 2, 4) → output stride 8;
* ASPP: four parallel 3x3 convs at the atrous rates, summed.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from adlm_tpu_torch.models.layers import ConvBN, max_pool_ceil
from adlm_tpu_torch.ops.resize import resize_bilinear, resize_bilinear_factor


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, mid: int, out: int, stride: int,
                 dilation: int, shortcut: bool, s2b: bool = False):
        super().__init__()
        self.reduce = ConvBN(in_ch, mid, 1, stride, 1, relu=True)
        self.conv3x3 = ConvBN(mid, mid, 3, 1, dilation, relu=True, s2b=s2b)
        self.increase = ConvBN(mid, out, 1, 1, 1, relu=False)
        self.shortcut = (ConvBN(in_ch, out, 1, stride, 1, relu=False)
                         if shortcut else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.increase(self.conv3x3(self.reduce(x)))
        s = self.shortcut(x) if self.shortcut is not None else x
        return F.relu(h + s)


class ResLayer(nn.Sequential):
    def __init__(self, n_blocks: int, in_ch: int, mid: int, out: int,
                 stride: int, dilation: int, s2b: bool = False):
        super().__init__()
        for i in range(n_blocks):
            self.add_module(f"block{i + 1}", Bottleneck(
                in_ch if i == 0 else out, mid, out,
                stride if i == 0 else 1, dilation, shortcut=(i == 0),
                s2b=s2b))


class Stem(nn.Module):
    """7x7/2 conv+BN+relu, then the 3x3/2 ceil-mode max pool."""

    def __init__(self):
        super().__init__()
        self.conv1 = ConvBN(3, 64, 7, 2, 1, relu=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool_ceil(self.conv1(x), 3, 2, 1)


class ASPP(nn.Module):
    """Parallel dilated 3x3 convs with bias, summed."""

    def __init__(self, in_ch: int, out_ch: int,
                 rates: Sequence[int] = (6, 12, 18, 24)):
        super().__init__()
        self.n = len(rates)
        for i, r in enumerate(rates):
            self.add_module(f"c{i}", nn.Conv2d(in_ch, out_ch, 3, padding=r,
                                               dilation=r, bias=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return sum(getattr(self, f"c{i}")(x) for i in range(self.n))


class DeepLabV2(nn.Module):
    """Backbone: (B, 3, H, W) → (B, out_features, ~H/8, ~W/8)."""

    def __init__(self, out_features: int = 64,
                 n_blocks: Tuple[int, ...] = (3, 4, 23, 3),
                 atrous_rates: Tuple[int, ...] = (6, 12, 18, 24),
                 s2b_dilated: bool = False):
        super().__init__()
        self.layer1 = Stem()
        self.layer2 = ResLayer(n_blocks[0], 64, 64, 256, 1, 1)
        self.layer3 = ResLayer(n_blocks[1], 256, 128, 512, 2, 1)
        self.layer4 = ResLayer(n_blocks[2], 512, 256, 1024, 1, 2,
                               s2b=s2b_dilated)
        self.layer5 = ResLayer(n_blocks[3], 1024, 512, 2048, 1, 4,
                               s2b=s2b_dilated)
        self.aspp = ASPP(2048, out_features, atrous_rates)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        x = self.layer5(x)
        return self.aspp(x)


class MSC(nn.Module):
    """Multi-scale wrapper (reference segmentation/utils.py:64-101).

    Runs the base net at 1.0 and at ``scales`` (input resized with torch
    ``scale_factor`` semantics), upsamples the pyramid to the base grid
    and takes the pixel-wise max.  In training mode it returns
    ``[base] + pyramid + [max]``, in eval mode the max only.  With no
    extra scales it is a passthrough.
    """

    def __init__(self, base: nn.Module, scales: Tuple[float, ...] = ()):
        super().__init__()
        self.base = base
        self.scales = tuple(scales)

    def forward(self, x: torch.Tensor
                ) -> Union[torch.Tensor, List[torch.Tensor]]:
        logits = self.base(x)
        if not self.scales:
            return logits
        h, w = logits.shape[-2], logits.shape[-1]
        pyramid = [self.base(resize_bilinear_factor(x, s, channel_last=False))
                   for s in self.scales]
        interp = [resize_bilinear(p, (h, w), channel_last=False)
                  for p in pyramid]
        logits_max = torch.stack([logits] + interp).amax(dim=0)
        if self.training:
            return [logits] + pyramid + [logits_max]
        return logits_max
