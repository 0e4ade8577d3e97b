"""ProtoSeg run pipeline (counterpart of ``adlm_tpu.train.pipeline``).

So far its start: the wire dtypes of the training windows.  The phase
orchestration (warmup → joint → push → finetune, resume, the divergence
guard) comes with a later slice.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from adlm_tpu_torch.core.config import ExperimentConfig


def ship_dtypes(cfg: ExperimentConfig) -> Tuple[torch.dtype, torch.dtype]:
    """Host→device wire dtypes of the train windows' (images, labels),
    for ``data/pipeline.py::device_prefetch(dtypes=...)``: uint8 images
    under ``wire_uint8`` (the loader's normalization inverted on the host
    by ``wire_uint8_images`` and re-applied on the device by the step),
    else bf16 images when the step computes in bf16 (it casts them
    anyway, so rounding on the host is the same), else f32; uint8 labels
    when the ids fit (the step widens them before the void shift).  The
    bf16 cast happens into the pinned buffer, never in numpy."""
    if cfg.train.wire_uint8:
        if cfg.data.cells:
            raise ValueError(
                "wire_uint8 requires /255-scaled inputs (cells=False): "
                "the on-device normalizer (ops/normalize.py) assumes them")
        img = torch.uint8
    elif cfg.train.compute_dtype == "bfloat16":
        img = torch.bfloat16
    else:
        img = torch.float32
    lab = torch.uint8 if cfg.model.num_classes < 255 else torch.int32
    return img, lab


def wire_uint8_images(images: np.ndarray, mean, std) -> np.ndarray:
    """Invert the loader's ``(x/255 − mean)/std`` back to raw uint8
    pixels for the wire (``TrainConfig.wire_uint8``).  The augmented
    values are bilinear blends of uint8 sources rounded to uint8 steps,
    so the round trip through ``ops/normalize.py`` loses at most 0.5/255
    per pixel."""
    px = (images * (np.asarray(std, np.float32) * 255.0)
          + np.asarray(mean, np.float32) * 255.0)
    return np.clip(np.rint(px), 0.0, 255.0).astype(np.uint8)
