"""Classification feature stems of the ProtoPNet image classifier
(counterpart of ``adlm_tpu.models.backbones``; reference model.py:19-36,
resnet_features.py, vgg_features.py, densenet_features.py).

ResNet-18/34/50/101/152, VGG-11/13/16/19 (with and without BN) and
DenseNet-121/161/169/201, NCHW, without their pooling heads.  The
module names are torchvision's, so a torchvision ImageNet stem's
state_dict (less ``fc``/``classifier`` and ``num_batches_tracked``)
and the ``features.*`` part of a reference classification PPNet load by
key:

* ResNet: ``conv1``, ``bn1``, ``layer{1..4}.{b}.{conv,bn}{1..3}``,
  ``layer{l}.0.downsample.{0,1}`` (stride on the 3x3, torchvision v1.5);
* VGG: ``features.{i}``, convs, BNs, ReLUs and pools at torchvision's
  Sequential indices;
* DenseNet: ``features.{conv0,norm0}``,
  ``features.denseblock{b}.denselayer{l}.{norm,conv}{1,2}``,
  ``features.transition{t}.{norm,conv}``, ``features.norm5`` (followed
  by a ReLU, as in the JAX package).

The BatchNorm is flax's ``nn.BatchNorm(momentum=0.9)`` (``FlaxBatchNorm``),
not torch's.  Initialization draws flax's defaults from an explicit
``torch.Generator``: lecun-normal conv kernels, zero conv biases,
identity BNs.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from adlm_tpu_torch.models.layers import lecun_normal_

ConvInfo = Tuple[List[int], List[int], List[int]]


class FlaxBatchNorm(nn.Module):
    """Trainable BatchNorm2d with the semantics of flax 0.12's
    ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``:

    * batch statistics in f32 (f64 for an f64 input) whatever the input
      dtype, the variance as ``max(E[x²] − E[x]², 0)``;
    * the running variance takes the BIASED batch variance, and
      ``ra = 0.9·ra + 0.1·batch`` (``F.batch_norm`` keeps the unbiased
      one);
    * ``y = (x − mean)·(rsqrt(var + eps)·scale) + bias`` in f32, cast
      to the input's dtype.

    The gradient flows through the batch statistics, as under
    ``jax.grad``.  Eval mode normalizes with the running statistics."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(dt)
        if self.training:
            mean = xf.mean((0, 2, 3))
            var = torch.clamp((xf * xf).mean((0, 2, 3)) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                for ra, batch in ((self.running_mean, mean), (self.running_var, var)):
                    ra.copy_(m * ra + (1.0 - m) * batch.to(ra.dtype))
        else:
            mean, var = self.running_mean.to(dt), self.running_var.to(dt)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(dt)
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias.to(dt)[:, None, None]
        return y.to(x.dtype)


def reset_stem(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """flax's default initializers over ``module``'s convs and BNs, in
    module order."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, FlaxBatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)


# ---------------------------------------------------------------------------
# ResNet (reference resnet_features.py:227-296)
# ---------------------------------------------------------------------------

class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, width: int, stride: int, project: bool):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, width, 3, stride, 1, bias=False)
        self.bn1 = FlaxBatchNorm(width)
        self.conv2 = nn.Conv2d(width, width, 3, 1, 1, bias=False)
        self.bn2 = FlaxBatchNorm(width)
        self.downsample = (nn.Sequential(nn.Conv2d(in_ch, width, 1, stride, bias=False),
                                         FlaxBatchNorm(width))
                           if project else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        s = self.downsample(x) if self.downsample is not None else x
        return F.relu(h + s)


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, mid: int, stride: int, project: bool):
        super().__init__()
        out = 4 * mid
        self.conv1 = nn.Conv2d(in_ch, mid, 1, bias=False)
        self.bn1 = FlaxBatchNorm(mid)
        self.conv2 = nn.Conv2d(mid, mid, 3, stride, 1, bias=False)
        self.bn2 = FlaxBatchNorm(mid)
        self.conv3 = nn.Conv2d(mid, out, 1, bias=False)
        self.bn3 = FlaxBatchNorm(out)
        self.downsample = (nn.Sequential(nn.Conv2d(in_ch, out, 1, stride, bias=False),
                                         FlaxBatchNorm(out))
                           if project else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        s = self.downsample(x) if self.downsample is not None else x
        return F.relu(h + s)


_RESNET_SPECS = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
    "resnet152": ("bottleneck", (3, 8, 36, 3)),
}


class ResNetFeatures(nn.Module):
    """7x7/2 conv, BN, relu, 3x3/2 max pool, four residual stages."""

    def __init__(self, arch: str):
        super().__init__()
        self.arch = arch
        kind, blocks = _RESNET_SPECS[arch]
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FlaxBatchNorm(64)
        in_ch = 64
        for li, (n, w) in enumerate(zip(blocks, (64, 128, 256, 512))):
            layer = nn.Sequential()
            for bi in range(n):
                stride = 2 if (li > 0 and bi == 0) else 1
                project = bi == 0 and (li > 0 or kind == "bottleneck")
                if kind == "basic":
                    layer.add_module(str(bi), BasicBlock(in_ch, w, stride, project))
                    in_ch = w
                else:
                    layer.add_module(str(bi), Bottleneck(in_ch, w, stride, project))
                    in_ch = 4 * w
            self.add_module(f"layer{li + 1}", layer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        for li in range(1, 5):
            x = getattr(self, f"layer{li}")(x)
        return x

    def conv_info(self) -> ConvInfo:
        """(kernel sizes, strides, paddings) for the RF calculator
        (reference resnet_features.py:207-225)."""
        kind, blocks = _RESNET_SPECS[self.arch]
        ks, ss, ps = [7, 3], [2, 2], [3, 1]
        for li, n in enumerate(blocks):
            for bi in range(n):
                stride = 2 if (li > 0 and bi == 0) else 1
                if kind == "basic":
                    ks += [3, 3]; ss += [stride, 1]; ps += [1, 1]
                else:
                    ks += [1, 3, 1]; ss += [1, stride, 1]; ps += [0, 1, 0]
        return ks, ss, ps


# ---------------------------------------------------------------------------
# VGG (reference vgg_features.py:104-271)
# ---------------------------------------------------------------------------

_VGG_SPECS = {
    "vgg11": (1, 1, 2, 2, 2),
    "vgg13": (2, 2, 2, 2, 2),
    "vgg16": (2, 2, 3, 3, 3),
    "vgg19": (2, 2, 4, 4, 4),
}
_VGG_WIDTHS = (64, 128, 256, 512, 512)


def vgg_layer_indices(arch: str) -> Dict[Tuple[str, int, int], int]:
    """torchvision's ``features`` Sequential index of each VGG layer:
    {("conv" | "bn", stage, conv in stage): index}.  Each conv is
    followed by its BN (``_bn`` archs) and a ReLU, each stage by a max
    pool."""
    use_bn = arch.endswith("_bn")
    out, idx = {}, 0
    for si, n in enumerate(_VGG_SPECS[arch.replace("_bn", "")]):
        for ci in range(n):
            out[("conv", si, ci)] = idx
            idx += 1
            if use_bn:
                out[("bn", si, ci)] = idx
                idx += 1
            idx += 1      # ReLU
        idx += 1          # MaxPool
    return out


class VGGFeatures(nn.Module):
    """3x3 conv (with bias) [+ BN] + relu stages, each closed by a 2x2/2
    max pool."""

    def __init__(self, arch: str):
        super().__init__()
        self.arch = arch
        use_bn = arch.endswith("_bn")
        layers: List[nn.Module] = []
        in_ch = 3
        for n, w in zip(_VGG_SPECS[arch.replace("_bn", "")], _VGG_WIDTHS):
            for _ in range(n):
                layers.append(nn.Conv2d(in_ch, w, 3, padding=1))
                if use_bn:
                    layers.append(FlaxBatchNorm(w))
                layers.append(nn.ReLU())
                in_ch = w
            layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.features(x)

    def conv_info(self) -> ConvInfo:
        ks, ss, ps = [], [], []
        for n in _VGG_SPECS[self.arch.replace("_bn", "")]:
            for _ in range(n):
                ks.append(3); ss.append(1); ps.append(1)
            ks.append(2); ss.append(2); ps.append(0)
        return ks, ss, ps


# ---------------------------------------------------------------------------
# DenseNet (reference densenet_features.py:178-311)
# ---------------------------------------------------------------------------

# growth rate, block config, init features
_DENSENET_SPECS = {
    "densenet121": (32, (6, 12, 24, 16), 64),
    "densenet161": (48, (6, 12, 36, 24), 96),
    "densenet169": (32, (6, 12, 32, 32), 64),
    "densenet201": (32, (6, 12, 48, 32), 64),
}


class DenseLayer(nn.Module):
    """BN-relu-1x1(4k)-BN-relu-3x3(k); returns the k new channels."""

    def __init__(self, in_ch: int, growth: int):
        super().__init__()
        self.norm1 = FlaxBatchNorm(in_ch)
        self.conv1 = nn.Conv2d(in_ch, 4 * growth, 1, bias=False)
        self.norm2 = FlaxBatchNorm(4 * growth)
        self.conv2 = nn.Conv2d(4 * growth, growth, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.relu(self.norm1(x)))
        return self.conv2(F.relu(self.norm2(h)))


class DenseBlock(nn.Module):
    def __init__(self, n_layers: int, in_ch: int, growth: int):
        super().__init__()
        for li in range(n_layers):
            self.add_module(f"denselayer{li + 1}", DenseLayer(in_ch + li * growth, growth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.children():
            x = torch.cat([x, layer(x)], dim=1)
        return x


class Transition(nn.Module):
    """BN-relu-1x1(half)-avgpool 2x2/2."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm = FlaxBatchNorm(in_ch)
        self.conv = nn.Conv2d(in_ch, out_ch, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(self.conv(F.relu(self.norm(x))), 2, 2)


class DenseNetFeatures(nn.Module):
    """7x7/2 conv + BN + relu + 3x3/2 max pool, dense blocks with
    transitions between them, a final BN + relu."""

    def __init__(self, arch: str):
        super().__init__()
        self.arch = arch
        growth, blocks, init_feats = _DENSENET_SPECS[arch]
        feats = nn.Sequential(OrderedDict([
            ("conv0", nn.Conv2d(3, init_feats, 7, 2, 3, bias=False)),
            ("norm0", FlaxBatchNorm(init_feats)),
            ("relu0", nn.ReLU()),
            ("pool0", nn.MaxPool2d(3, 2, 1)),
        ]))
        n = init_feats
        for bi, n_layers in enumerate(blocks):
            feats.add_module(f"denseblock{bi + 1}", DenseBlock(n_layers, n, growth))
            n += growth * n_layers
            if bi != len(blocks) - 1:
                feats.add_module(f"transition{bi + 1}", Transition(n, n // 2))
                n //= 2
        feats.add_module("norm5", FlaxBatchNorm(n))
        self.features = feats

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.features(x))

    def conv_info(self) -> ConvInfo:
        _, blocks, _ = _DENSENET_SPECS[self.arch]
        ks, ss, ps = [7, 3], [2, 2], [3, 1]
        for bi, n_layers in enumerate(blocks):
            for _ in range(n_layers):
                ks += [1, 3]; ss += [1, 1]; ps += [0, 1]
            if bi != len(blocks) - 1:
                ks += [1, 2]; ss += [1, 2]; ps += [0, 0]
        return ks, ss, ps


def build_classification_backbone(arch: str) -> nn.Module:
    if arch in _RESNET_SPECS:
        return ResNetFeatures(arch)
    if arch.replace("_bn", "") in _VGG_SPECS:
        return VGGFeatures(arch)
    if arch in _DENSENET_SPECS:
        return DenseNetFeatures(arch)
    raise NotImplementedError(
        f"backbone {arch!r} not implemented (have resnets, vggs, "
        f"densenets, deeplabv2_resnet101)")


def backbone_out_channels(arch: str) -> int:
    if arch in _RESNET_SPECS:
        return 512 if _RESNET_SPECS[arch][0] == "basic" else 2048
    if arch.replace("_bn", "") in _VGG_SPECS:
        return 512
    if arch in _DENSENET_SPECS:
        growth, blocks, init_feats = _DENSENET_SPECS[arch]
        n = init_feats
        for bi, n_layers in enumerate(blocks):
            n += growth * n_layers
            if bi != len(blocks) - 1:
                n = n // 2
        return n
    raise NotImplementedError(arch)
