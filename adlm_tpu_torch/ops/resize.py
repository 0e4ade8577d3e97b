"""Resize ops (counterpart of ``adlm_tpu.ops.resize``).

The public functions keep the JAX package's channels-last layout, so
the tests compare like with like; inside they call ``F.interpolate`` on
an NCHW view.  A channels-last tensor's NCHW view has channels-last
strides, which ``F.interpolate`` handles without a copy.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def resize_label_nearest(label: torch.Tensor, size: Tuple[int, int]
                         ) -> torch.Tensor:
    """Nearest-neighbour label resize matching ``PIL.Image.resize(NEAREST)``:
    output pixel ``i`` reads input pixel ``floor((i + 0.5) * in/out)``.

    Args:
      label: (..., H, W) integer labels.
      size: (out_h, out_w).
    """
    h, w = label.shape[-2], label.shape[-1]
    oh, ow = size
    dev = label.device
    ys = torch.floor((torch.arange(oh, dtype=torch.float32, device=dev) + 0.5)
                     * (h / oh))
    xs = torch.floor((torch.arange(ow, dtype=torch.float32, device=dev) + 0.5)
                     * (w / ow))
    ys = ys.to(torch.int64).clamp(0, h - 1)
    xs = xs.to(torch.int64).clamp(0, w - 1)
    return label[..., ys, :][..., :, xs]


def _bilinear_nchw(x: torch.Tensor, **kw) -> torch.Tensor:
    return F.interpolate(x, mode="bilinear", align_corners=False,
                         antialias=False, **kw)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int],
                    channel_last: bool = True) -> torch.Tensor:
    """Half-pixel bilinear resize (``align_corners=False``, no antialias).

    Args:
      x: (B, H, W, C) if ``channel_last`` else (B, C, H, W).
      size: (out_h, out_w).
    """
    if not channel_last:
        return _bilinear_nchw(x, size=tuple(size))
    y = _bilinear_nchw(x.permute(0, 3, 1, 2), size=tuple(size))
    return y.permute(0, 2, 3, 1)


def resize_bilinear_factor(x: torch.Tensor, factor: float,
                           channel_last: bool = True) -> torch.Tensor:
    """Bilinear resize by a scale FACTOR with torch coordinate semantics:
    output ``o`` reads input ``(o + 0.5)/factor − 0.5`` with the GIVEN
    factor, not the realized out/in ratio (reference
    segmentation/utils.py:91, the MSC input pyramid).

    Output is (B, int(H·s), int(W·s), C) (or NCHW if not ``channel_last``).
    """
    if not channel_last:
        return _bilinear_nchw(x, scale_factor=factor)
    y = _bilinear_nchw(x.permute(0, 3, 1, 2), scale_factor=factor)
    return y.permute(0, 2, 3, 1)
