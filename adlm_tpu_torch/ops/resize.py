"""Resize ops (counterpart of ``adlm_tpu.ops.resize``).

The public functions keep the JAX package's channels-last layout, so
the tests compare like with like; inside they call ``F.interpolate`` on
an NCHW view.  A channels-last tensor's NCHW view has channels-last
strides, which ``F.interpolate`` handles without a copy.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

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


def bilinear_source_rows(n_out: int, n_in: int, lo: int, hi: int) -> Tuple[int, int]:
    """Input rows [first, last) that outputs [lo, hi) of a half-pixel
    bilinear resize of ``n_in`` rows to ``n_out`` read: their taps,
    widened by one row each way (within the image) so that any rounding
    of the source coordinate stays inside."""
    s = n_in / n_out
    first = math.floor(max((lo + 0.5) * s - 0.5, 0.0)) - 1
    last = math.floor(max((hi - 0.5) * s - 0.5, 0.0)) + 3
    return max(first, 0), min(last, n_in)


def resize_bilinear_rows(x: torch.Tensor, size: Tuple[int, int], lo: int, hi: int,
                         first_row: int = 0, in_h: Optional[int] = None) -> torch.Tensor:
    """Output rows [lo, hi) of ``resize_bilinear(x_full, size)`` from the
    rows of ``x_full`` that they read.

    ``x`` (B, h, W_in, C) holds rows [first_row, first_row + h) of the
    whole map, of height ``in_h`` (default: ``x`` is the whole map); it
    must hold ``bilinear_source_rows(size[0], in_h, lo, hi)``.  The rows
    go into a zero-filled map of the whole height, which is resized
    whole: ``F.interpolate`` computes each output from its own taps and
    the global scale, so the window equals the same rows of the
    whole-frame call bit for bit (the zero rows feed only outputs
    outside it).  Returns (B, hi − lo, W, C)."""
    in_h = x.shape[1] if in_h is None else in_h
    need = bilinear_source_rows(size[0], in_h, lo, hi)
    if need[0] < first_row or need[1] > first_row + x.shape[1]:
        raise ValueError(f"output rows [{lo}, {hi}) read rows [{need[0]}, {need[1]}), "
                         f"the map holds [{first_row}, {first_row + x.shape[1]})")
    if first_row or x.shape[1] != in_h:
        full = x.new_zeros((x.shape[0], in_h) + tuple(x.shape[2:]))
        full[:, first_row:first_row + x.shape[1]] = x
        x = full
    return resize_bilinear(x, size)[:, lo:hi]


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
