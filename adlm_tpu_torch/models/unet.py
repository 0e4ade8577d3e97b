"""Parametric U-Net of U-Noise (counterpart of ``adlm_tpu.models.unet``).

The reference architecture (reference src/unet.py:37-81): ``depth``
conv-BN-relu ×2 blocks with a 2×2 max-pool between them, an up path of
nearest ×2 upsample + conv-BN-relu, concatenation with the skip and a
double conv, and a 1×1 head.  NCHW modules; the training steps feed them
channels-last tensors.

The modules carry the reference's torch names, so a reference state_dict
loads by stripping its lightning prefix (``utils/torch_import.py``):

* ``downs.{i}.{0,1,3,4}`` — the down blocks' convs and BNs;
* ``ups.{j}.up.{1,2}`` — conv and BN after the upsample, ``ups[0]``
  being the DEEPEST level (the reference builds ``ups`` over
  ``reversed(range(depth - 1))``);
* ``ups.{j}.conv.{0,1,3,4}`` — the double conv after the concatenation;
* ``conv1x1`` — the head.

The BatchNorm is trainable, with ``TorchBatchNorm``'s semantics
(``adlm_tpu/models/unet.py:20``): normalization by the biased batch
variance, the running variance accumulating the unbiased one, momentum
0.1 the weight of the new statistic, statistics and normalization in f32
whatever the input dtype, the output in the input's dtype.  Its
statistics come from ``F.batch_norm`` (Welford or cuDNN's algorithm,
where the JAX package takes the one-pass ``E[x²]−E[x]²``): the same
function up to f32 rounding.

Initialization draws from flax's defaults, not torch's: conv kernels
``lecun_normal`` (truncated normal, variance 1/fan_in), conv biases 0,
BN scale 1 and bias 0, running mean 0 and variance 1, all from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from adlm_tpu_torch.models.layers import lecun_normal_


class UNetBatchNorm(nn.Module):
    """Trainable BatchNorm2d with ``TorchBatchNorm``'s semantics.

    The affine parameters enter as f32 (f64 for an f64 input) whatever
    their own dtype: a bf16 forward (parameters cast to bf16 by the
    caller) normalizes with the bf16-rounded scale and bias, in f32, as
    the JAX package does."""

    def __init__(self, num_features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, torch.float32)
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight.to(dt), self.bias.to(dt),
                            self.training, self.momentum, self.eps)


def conv_block(in_ch: int, out_ch: int) -> nn.Sequential:
    """conv-BN-relu ×2 (``ConvBlock``): indices 0, 1, 3, 4 hold weights."""
    return nn.Sequential(
        nn.Conv2d(in_ch, out_ch, 3, padding=1), UNetBatchNorm(out_ch), nn.ReLU(inplace=True),
        nn.Conv2d(out_ch, out_ch, 3, padding=1), UNetBatchNorm(out_ch), nn.ReLU(inplace=True))


class Up(nn.Module):
    """Nearest ×2 upsample, conv-BN-relu, concatenation ``[x, skip]`` and
    a double conv."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.up = nn.Sequential(
            nn.Upsample(scale_factor=2, mode="nearest"),
            nn.Conv2d(in_ch, out_ch, 3, padding=1), UNetBatchNorm(out_ch),
            nn.ReLU(inplace=True))
        self.conv = conv_block(2 * out_ch, out_ch)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.conv(torch.cat([self.up(x), skip], dim=1))


class UNet(nn.Module):
    """``depth`` levels, the first with ``2**cf`` channels (the reference's
    arguments)."""

    def __init__(self, in_channels: int = 3, out_channels: int = 1, depth: int = 5,
                 cf: int = 6, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.depth, self.cf = depth, cf
        width = [2 ** (cf + i) for i in range(depth)]
        self.downs = nn.ModuleList(
            conv_block(in_channels if i == 0 else width[i - 1], width[i])
            for i in range(depth))
        self.ups = nn.ModuleList(Up(width[i + 1], width[i])
                                 for i in reversed(range(depth - 1)))
        self.conv1x1 = nn.Conv2d(width[0], out_channels, 1)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's default initializers, drawn module by module in order."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, generator)
                m.bias.zero_()
            elif isinstance(m, UNetBatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(bottleneck, skips shallowest first).  Max-pool floors odd
        sizes, as flax's VALID pooling."""
        skips = []
        for i, block in enumerate(self.downs):
            x = block(x)
            if i != self.depth - 1:
                skips.append(x)
                x = F.max_pool2d(x, 2)
        return x, skips

    def decode(self, x: torch.Tensor, skips: List[torch.Tensor]) -> torch.Tensor:
        for up, skip in zip(self.ups, reversed(skips)):
            x = up(x, skip)
        return self.conv1x1(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(*self.encode(x))


def forward_in(model: nn.Module, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``model(x)`` with the parameters cast to ``dtype`` inside the
    differentiated function, as the JAX package's bf16 steps do: the
    gradients come back in the parameters' own dtype (f32), the BN
    statistics stay f32.  ``x`` is cast to ``dtype`` too."""
    x = x.to(dtype)
    if all(p.dtype == dtype for p in model.parameters()):
        return model(x)
    params = {n: p.to(dtype) for n, p in model.named_parameters()}
    return torch.func.functional_call(model, params, (x,))


def num_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
