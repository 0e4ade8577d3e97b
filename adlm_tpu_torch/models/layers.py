"""Shared building blocks (counterpart of ``adlm_tpu.models.layers``).

NCHW modules, meant to run in ``torch.channels_last`` memory format.

* ``FrozenBatchNorm``: the reference freezes backbone BN every step
  (reference segmentation/module.py:127,278) and never optimizes its
  affine parameters, so BN is fully frozen: statistics and affine are
  buffers, folded to ``x*scale + bias``.
* ``max_pool_ceil``: the DeepLab stem's ``MaxPool2d(3, 2, 1,
  ceil_mode=True)`` (1024x2048 input → 129x257 feature grid).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


# std of a unit normal truncated to ±2 (flax's variance_scaling)
_TRUNC_STD = 0.87962566103423978
_ERF2 = math.erf(2.0 / math.sqrt(2.0))


def lecun_normal_(w: torch.Tensor, generator: Optional[torch.Generator]) -> None:
    """flax's default conv kernel init, ``lecun_normal``: a normal of
    variance 1/fan_in truncated to ±2 std, drawn as
    ``jax.random.truncated_normal`` draws it, the inverse CDF of one
    uniform draw per entry (torch's own ``trunc_normal_``
    rejection-samples, whose stream and cost depend on the torch
    version)."""
    std = math.sqrt(1.0 / w[0].numel()) / _TRUNC_STD
    w.uniform_(-_ERF2, _ERF2, generator=generator)
    w.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2.0 * std, 2.0 * std)


class FrozenBatchNorm(nn.Module):
    """BatchNorm with frozen statistics and frozen affine parameters.

    Buffers ``weight/bias/running_mean/running_var`` (torch BN names, so
    a BN state_dict loads as is), initialized to identity.  They stay
    float32 when the parameters are cast to bf16; the folded scale and
    bias are cast to the activation dtype, as in the JAX package.
    """

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        bias = self.bias - self.running_mean * scale
        return (x * scale.to(x.dtype)[None, :, None, None]
                + bias.to(x.dtype)[None, :, None, None])


def max_pool_ceil(x: torch.Tensor, window: int = 3, stride: int = 2,
                  padding: int = 1) -> torch.Tensor:
    """2-D max pool with ``ceil_mode=True`` (NCHW)."""
    return F.max_pool2d(x, window, stride, padding, ceil_mode=True)


class ConvBN(nn.Module):
    """conv → frozen BN → optional relu (the DeepLab body unit).

    ``s2b=True`` computes a dilated stride-1 conv by space-to-batch: the
    d² phase subgrids become batch entries, the conv runs dense, and the
    result goes back to space.  Numerically the dilated conv (each
    output reads the same taps; zero padding coincides), with the same
    parameters.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 dilation: int = 1, relu: bool = True, s2b: bool = False):
        super().__init__()
        self.dilation = dilation
        self.relu = relu
        self.s2b = s2b and dilation > 1 and stride == 1
        if self.s2b:
            self.conv = nn.Conv2d(in_ch, out_ch, kernel, 1,
                                  padding=(kernel - 1) // 2, bias=False)
        else:
            self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride,
                                  padding=dilation * (kernel - 1) // 2,
                                  dilation=dilation, bias=False)
        self.bn = FrozenBatchNorm(out_ch)

    def _space_to_batch_conv(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dilation
        B, C, H, W = x.shape
        Hp, Wp = -(-H // d) * d, -(-W // d) * d
        h = F.pad(x, (0, Wp - W, 0, Hp - H))
        h = (h.reshape(B, C, Hp // d, d, Wp // d, d)
             .permute(0, 3, 5, 1, 2, 4)
             .reshape(B * d * d, C, Hp // d, Wp // d))
        h = self.conv(h)
        Co = h.shape[1]
        h = (h.reshape(B, d, d, Co, Hp // d, Wp // d)
             .permute(0, 3, 4, 1, 5, 2)
             .reshape(B, Co, Hp, Wp))
        return h[:, :, :H, :W]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self._space_to_batch_conv(x) if self.s2b else self.conv(x)
        x = self.bn(x)
        return F.relu(x) if self.relu else x
