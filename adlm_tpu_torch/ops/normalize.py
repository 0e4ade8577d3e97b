"""On-device input normalization (counterpart of ``adlm_tpu.ops.normalize``).

Images arrive as raw uint8 and become ``(x/255 − mean)/std`` in float32
on the device, the same f32 op sequence as the host path (reference
dataset.py:119-173 Normalize): a quarter of the host→device bytes of
shipping f32.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def normalize(images: torch.Tensor,
              mean_std: Optional[Tuple[Sequence[float], Sequence[float]]] = None
              ) -> torch.Tensor:
    """uint8 (or f32 in [0, 255]) images (..., 3) → normalized float32.

    ``mean_std=None`` returns the input unchanged (already normalized).
    """
    if mean_std is None:
        return images
    mean = torch.tensor(mean_std[0], dtype=torch.float32, device=images.device)
    std = torch.tensor(mean_std[1], dtype=torch.float32, device=images.device)
    return (images.to(torch.float32) / 255.0 - mean) / std
